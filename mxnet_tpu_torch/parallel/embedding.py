"""Row-sharded embedding training with a row-sparse gradient exchange
(counterpart of mxnet_tpu/parallel/embedding.py, ``mx.parallel.embedding``).

The JAX package runs one shard_map program over its mesh; the port runs
the same four stages over the replicas of its single-process mesh
(``parallel/mesh.py``), in replica order, where the JAX collectives
become explicit concatenations (``all_gather``) and sums (``psum``,
``psum_scatter``):

  lookup      each replica dedups its local batch's ids
              (``ops/sparse_ops.unique_rows``, static shape), the unique
              lists are concatenated, each replica serves the rows it owns
              (zeros elsewhere) and replica k gets the sum of everyone's
              k-th slice: exactly its unique rows. The (V, D) table is
              row-sharded 1/N a replica (padded so the shards are even),
              its optimizer state alike.
  backward    the loss is differentiated with respect to the gathered
              unique ROWS, never the table.
  exchange    the (rows, values) pairs are concatenated over the
              replicas (in a narrow wire dtype with ``compress``), the
              receiver dedups and segment-sums them, and the lazy
              ``rows_*`` updates touch only owned touched rows (others map
              to the trash row one past the shard).
  dense MLP   replicated; its gradients summed over the replicas, the same
              update formulas over whole tensors.

``exchange="dense"`` (``MXNET_EMBED_EXCHANGE=dense``) keeps the table
replicated and sums the dense (V, D) gradient: the A/B baseline. With
every row touched once (float32) the two exchanges are bit-identical:
the same forward values, the same per-row sums, the same update math.
``compress="bf16"|"fp8"`` (``MXNET_EMBED_COMPRESS``) casts the backward
values on the wire (fp8 e4m3 with a per-row max-abs scale, no residual).
``MXNET_EMBED_UNIQUE_CAP``: unique-row slots a replica (0: its local id
count, lossless).

A step reads nothing back to the host: the touched-row count ``nnz`` is
a device scalar that ``counters()`` reads when scraped. Sums of
duplicate rows are ordered (``index_put_(accumulate=True)``), so a step
repeats bit for bit on the card. The step runs eagerly (one card is one
replica; a CUDA graph is a later step). The first trainer
registers ``counters`` with ``profiler.register_counter_export("embed")``
(``_ensure_hook``), so ``/metrics`` and the step log carry them.

CLI: ``python -m mxnet_tpu_torch.parallel.embedding --selftest`` (tiny
DLRM: convergence, sparse-vs-dense bit identity, bf16/fp8 wires, resume
across an exchange and cap change, the analytic wire's scaling),
``--bench`` (the sparse and dense exchanges' steps/s, wire bytes from
``EmbeddingLayout.wire_bytes_per_step``), ``--ctx cpu`` for host
replicas; ``--hlo-check`` exits 2 (there is no XLA HLO here).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..ops import sparse_ops as sp
from ..ops.tensor import abs_
from .mesh import sum_to

__all__ = ["EmbeddingTrainer", "EmbeddingLayout", "counters",
           "resolve_exchange", "resolve_compress", "resolve_unique_cap"]

WIRE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
# fp8 per-row scale target: e4m3 tops out at 448; row maxima scaled to
# 240 leave the decode multiply headroom
_FP8_AMAX = 240.0


def resolve_exchange(value=None):
    """Exchange mode: explicit arg, else MXNET_EMBED_EXCHANGE, else
    sparse."""
    if value is None:
        from .. import config
        value = config.get("MXNET_EMBED_EXCHANGE", "sparse")
    mode = str(value or "sparse").strip().lower()
    if mode not in ("sparse", "dense"):
        raise MXNetError(
            f"MXNET_EMBED_EXCHANGE must be sparse|dense, got {value!r}")
    return mode


def resolve_compress(value=None):
    """Wire compression: none|bf16|fp8 (MXNET_EMBED_COMPRESS)."""
    if value is None:
        from .. import config
        value = config.get("MXNET_EMBED_COMPRESS", "none")
    mode = str(value or "none").strip().lower()
    if mode in ("", "0", "none", "off"):
        return "none"
    if mode not in WIRE_DTYPES:
        raise MXNetError(
            f"MXNET_EMBED_COMPRESS must be none|bf16|fp8, got {value!r}")
    return mode


def resolve_unique_cap(value=None):
    """Unique-row slots a replica a step (0 = the local id count, which
    never drops a row). A positive cap bounds the exchange; it must cover
    the largest local unique count, or the rows past it (the largest
    ids) read NaN, as the JAX package's ``jnp.take`` fill does."""
    if value is None:
        from .. import config
        value = config.get("MXNET_EMBED_UNIQUE_CAP", 0)
    try:
        cap = int(value)
    except (TypeError, ValueError):
        raise MXNetError(
            f"MXNET_EMBED_UNIQUE_CAP must be an int, got {value!r}")
    if cap < 0:
        raise MXNetError(f"MXNET_EMBED_UNIQUE_CAP must be >= 0, got {cap}")
    return cap


class EmbeddingLayout:
    """Row-shard layout of a (vocab, dim) table over N replicas and the
    analytic wire bytes of one step (the JAX package's class).

    The vocab is padded to a multiple of N so the shards are even; the
    sentinel (one past the padded vocab) marks unique-list slack. Ring
    accounting: an all-gather or reduce-scatter moves (N-1)/N of the
    global buffer a replica, an all-reduce twice that."""

    def __init__(self, vocab, dim, n_dev, unique, n_states):
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.n_dev = int(n_dev)
        self.unique = int(unique)           # unique slots a replica, U
        self.n_states = int(n_states)
        self.padded_vocab = self.vocab + (-self.vocab % self.n_dev)
        self.rows_per_dev = self.padded_vocab // self.n_dev
        self.sentinel = self.padded_vocab

    def wire_bytes_per_step(self, exchange, wire_itemsize, mlp_bytes):
        """Bytes a replica sends in one step. Sparse: the id gather and
        row reduce-scatter forward, the value gather (+ fp8 scales)
        backward, all scaling with N * U; dense: one table-sized float32
        all-reduce. Both: the MLP gradient's all-reduce."""
        n = self.n_dev
        frac = (n - 1) / n
        mlp = 2.0 * frac * mlp_bytes
        if exchange == "dense":
            return int(mlp + 2.0 * frac * self.padded_vocab * self.dim * 4)
        nu = n * self.unique
        table = (nu * 4 + nu * self.dim * 4 + nu * self.dim * wire_itemsize)
        if wire_itemsize == 1:
            table += nu * 4
        return int(mlp + frac * table)

    def ownership(self, mlp_names):
        """{array name: owning shard} for checkpoint placement: the table
        and its optimizer rows on shard 0, the replicated MLP arrays
        round-robin."""
        own = {"param:embed": 0}
        for j in range(self.n_states):
            own[f"opt:embed:{j}"] = 0
        for i, n in enumerate(mlp_names):
            k = i % self.n_dev
            own[f"param:{n}"] = k
            for j in range(self.n_states):
                own[f"opt:{n}:{j}"] = k
        return own


# -- live counters ------------------------------------------------------------

_COUNTERS = {"embed_wire_bytes": 0, "embed_steps": 0,
             "embed_unique_rows": 0, "embed_touched_frac": 0.0,
             "embed_vocab_rows": 0, "embed_sparse": 1,
             "embed_compress_bits": 32}
# the last step's global unique-row count, a device scalar: read when
# counters() is scraped, never on the step's path
_LAST_NNZ = {"dev": None, "vocab": 0}


def counters():
    """Host-side exchange counters: cumulative analytic wire bytes,
    steps, and the last step's touched rows (one device scalar read)."""
    dev, vocab = _LAST_NNZ["dev"], _LAST_NNZ["vocab"]
    if dev is not None and vocab:
        nnz = int(dev)
        _COUNTERS["embed_unique_rows"] = nnz
        _COUNTERS["embed_touched_frac"] = round(nnz / vocab, 6)
    return dict(_COUNTERS)


def _ensure_hook():
    from .. import profiler
    profiler.register_counter_export("embed", counters)


def _bce_logits(logit, y):
    """Sum of binary cross-entropy with logits, in the JAX package's
    form (max(z, 0) splits a tie's gradient, |z| passes +1 at 0)."""
    z = logit.to(torch.float32)
    return torch.sum(torch.maximum(z, z.new_zeros(())) - z * y
                     + torch.log1p(torch.exp(-abs_(z))))


def _writable_f32(a):
    """A float32 C-contiguous numpy array torch may wrap (a copy only
    when the source is read-only or of another layout or type)."""
    a = _np.ascontiguousarray(a, dtype=_np.float32)
    return a if a.flags.writeable else a.copy()


def _host(a):
    """A host copy (never a view of a live host tensor: the step updates
    the state in place)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.numpy().copy() if a.device.type == "cpu" \
            else a.cpu().numpy()
    return _np.asarray(a)


class EmbeddingTrainer:
    """One-table DLRM-style trainer: a row-sharded embedding over S
    categorical slots and an optional dense-feature input, concatenated
    into a replicated MLP ending in one click logit (sum-BCE loss).

    ``mesh``: a ``parallel.Mesh`` (default: the cards; raises without
    one). State is the tuple ``(tables, tstates, mlps, mstates, ts)``,
    each a list over the replicas (a sparse table shard carries a trash
    row past its rows); ``step`` updates it in place and returns it.
    ``host_params`` / ``export_training_state`` give whole arrays, the
    JAX package's, so checkpoints cross device counts, unique caps,
    exchange modes and the two packages."""

    def __init__(self, mesh=None, vocab=None, embed_dim=None, n_slots=None,
                 dense_dim=0, mlp_hidden=(32,), optimizer="sgd",
                 learning_rate=0.05, momentum=0.0, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 exchange=None, compress=None, unique_cap=None,
                 batch_size=None, program_tag=None):
        if optimizer not in ("sgd", "adam"):
            raise MXNetError(
                f"EmbeddingTrainer supports sgd|adam, got {optimizer!r}")
        if vocab is None or embed_dim is None or n_slots is None:
            raise MXNetError("EmbeddingTrainer needs vocab, embed_dim and "
                             "n_slots")
        if mesh is None:
            from .mesh import data_parallel_mesh
            mesh = data_parallel_mesh()
        self._mesh = mesh
        self._devs = list(mesh.replicas)
        self._n_dev = len(self._devs)
        self.vocab = int(vocab)
        self.dim = int(embed_dim)
        self.n_slots = int(n_slots)
        self.dense_dim = int(dense_dim)
        self.mlp_hidden = tuple(int(h) for h in mlp_hidden)
        self.optimizer = optimizer
        self._learning_rate = float(learning_rate)
        self._momentum = float(momentum)
        self._wd = float(wd)
        self._rescale = float(rescale_grad)
        self._clip = -1.0 if clip_gradient is None else float(clip_gradient)
        self._beta1, self._beta2, self._eps = \
            float(beta1), float(beta2), float(epsilon)
        self.exchange = resolve_exchange(exchange)
        self.compress = resolve_compress(compress)
        self._wire_dtype = WIRE_DTYPES.get(self.compress)
        self._wire_itemsize = (4 if self._wire_dtype is None else
                               torch.empty((), dtype=self._wire_dtype)
                               .element_size())
        cap = resolve_unique_cap(unique_cap)
        if batch_size is not None and int(batch_size) % self._n_dev:
            raise MXNetError(f"global batch {batch_size} must divide over "
                             f"{self._n_dev} replicas")
        self._batch = None if batch_size is None else int(batch_size)
        self._cap = cap
        self._n_states = {"sgd": 1 if self._momentum else 0,
                          "adam": 2}[optimizer]
        self._layout = None      # U is known at the first step
        suffix = {"none": "n", "bf16": "b", "fp8": "f"}[self.compress]
        mode = {"sparse": "sp", "dense": "dn"}[self.exchange]
        self.program_tag = program_tag or f"estep_{mode}{suffix}"
        _ensure_hook()

    # -- parameter surface ---------------------------------------------------

    @property
    def mlp_names(self):
        names = []
        for i in range(len(self.mlp_hidden) + 1):
            names += [f"mlp_w{i}", f"mlp_b{i}"]
        return names

    @property
    def param_names(self):
        return ["embed"] + self.mlp_names

    @property
    def layout(self):
        return self._layout

    def _mlp_shapes(self):
        dims = ([self.n_slots * self.dim + self.dense_dim]
                + list(self.mlp_hidden) + [1])
        shapes = []
        for i in range(len(dims) - 1):
            shapes += [(dims[i], dims[i + 1]), (dims[i + 1],)]
        return shapes

    def _mlp_bytes(self):
        return sum(4 * max(1, int(_np.prod(s))) for s in self._mlp_shapes())

    def _ensure_layout(self, n_local_ids):
        if self._layout is None:
            self._layout = EmbeddingLayout(
                self.vocab, self.dim, self._n_dev,
                self._cap or int(n_local_ids), self._n_states)
        return self._layout

    def _scratch_layout(self):
        # cap-independent fields only (padded vocab, ownership): caching
        # a layout before the first step would freeze U at a value
        # unrelated to the batch
        return self._layout or EmbeddingLayout(
            self.vocab, self.dim, self._n_dev, self._cap or self.n_slots,
            self._n_states)

    # -- state init / placement ----------------------------------------------

    def init_state(self, batch_size=None, seed=0, generator=None):
        """A fresh state. By default drawn on the host from
        ``numpy.random.RandomState(seed)``, the JAX package's values; with
        a ``torch.Generator`` drawn from it on its device (for tables too
        large to draw on the host). Table N(0, 0.01), MLP weights
        He-normal, biases and optimizer state 0, t 0."""
        b = self._batch if batch_size is None else int(batch_size)
        if b is None:
            raise MXNetError("init_state needs batch_size")
        if b % self._n_dev:
            raise MXNetError(f"global batch {b} must divide over "
                             f"{self._n_dev} replicas")
        self._batch = b
        L = self._ensure_layout(b // self._n_dev * self.n_slots)
        if generator is None:
            rng = _np.random.RandomState(seed)
            table = rng.normal(0.0, 0.01, size=(
                L.padded_vocab, self.dim)).astype(_np.float32)
            table[self.vocab:] = 0.0
            mlp = [rng.normal(0.0, _np.sqrt(2.0 / s[0]), size=s)
                   .astype(_np.float32) if len(s) == 2
                   else _np.zeros(s, _np.float32)
                   for s in self._mlp_shapes()]
        else:
            dev = generator.device
            table = torch.randn((L.padded_vocab, self.dim), device=dev,
                                generator=generator).mul_(0.01)
            table[self.vocab:] = 0.0
            mlp = [torch.randn(s, device=dev, generator=generator)
                   .mul_(float(_np.sqrt(2.0 / s[0]))) if len(s) == 2
                   else torch.zeros(s, device=dev)
                   for s in self._mlp_shapes()]
        return self._place(table, [None] * self._n_states, mlp,
                           [[None] * self._n_states for _ in mlp], 0.0)

    def _place(self, table, tstates, mlp, mstates, t):
        """Whole arrays (numpy or tensors; None = zeros) -> the state:
        table and table states row-sharded with a trash row (sparse) or
        replicated (dense), the MLP replicated."""
        L = self._scratch_layout()
        R = L.rows_per_dev
        sparse = self.exchange == "sparse"

        def put(a, dev, shape, lo=None):
            out = torch.zeros(shape, dtype=torch.float32, device=dev)
            if a is not None:
                src = a if isinstance(a, torch.Tensor) \
                    else torch.from_numpy(_writable_f32(a))
                if lo is not None:
                    src = src[lo:lo + R]
                out[:src.shape[0]].copy_(src)
            return out

        def put_table(a, k, dev):
            if sparse:
                return put(a, dev, (R + 1, self.dim), lo=k * R)
            return put(a, dev, (L.padded_vocab, self.dim))

        tables, tst, mlps, mst, ts = [], [], [], [], []
        for k, dev in enumerate(self._devs):
            tables.append(put_table(table, k, dev))
            tst.append(tuple(put_table(s, k, dev) for s in tstates))
            mlps.append(tuple(put(p, dev, s) for p, s in
                              zip(mlp, self._mlp_shapes())))
            mst.append(tuple(tuple(put(x, dev, s) for x in st)
                             for st, s in zip(mstates, self._mlp_shapes())))
            ts.append(torch.full((), float(t), dtype=torch.float32,
                                 device=dev))
        return (tables, tst, mlps, mst, ts)

    def shard_inputs(self, arrays):
        """[ids (B, S) int, dense (B, F) float, labels (B,) float] ->
        three lists of per-replica tensors (equal batch shards, int32 ids,
        float32 otherwise). Ids must lie in [0, vocab)."""
        out = []
        for a in arrays:
            a = _np.asarray(a)
            is_int = _np.issubdtype(a.dtype, _np.integer)
            if is_int and a.size and (int(a.min()) < 0
                                      or int(a.max()) >= self.vocab):
                raise MXNetError(
                    f"ids out of range [0, {self.vocab}) (min "
                    f"{int(a.min())}, max {int(a.max())})")
            if a.shape[0] % self._n_dev:
                raise MXNetError(f"batch {a.shape[0]} must divide over "
                                 f"{self._n_dev} replicas")
            a = a.astype(_np.int32 if is_int else _np.float32)
            out.append([torch.from_numpy(_np.ascontiguousarray(c)).to(dev)
                        for c, dev in zip(_np.split(a, self._n_dev),
                                          self._devs)])
        return tuple(out)

    # -- the step -------------------------------------------------------------

    def _update_rows_(self, weight, states, rows, grad_rows, lr):
        """One lazy row update in place (weight and states carry a trash
        row): the same math as the dense paths' ``_update_full_``."""
        kw = dict(wd=self._wd, rescale_grad=self._rescale,
                  clip_gradient=self._clip)
        if self.optimizer == "sgd":
            if self._n_states:
                sp.rows_sgd_mom_update_(weight, states[0], rows, grad_rows,
                                        lr, self._momentum, **kw)
            else:
                sp.rows_sgd_update_(weight, rows, grad_rows, lr, **kw)
            return
        sp.rows_adam_update_(weight, states[0], states[1], rows, grad_rows,
                             lr, self._beta1, self._beta2, self._eps, **kw)

    def _update_full_(self, weight, states, grad, lr):
        """The update of every row of a tensor in place (the dense
        exchange's table, the MLP): the rows_* math without the gather."""
        kw = dict(wd=self._wd, rescale_grad=self._rescale,
                  clip_gradient=self._clip)
        if self.optimizer == "sgd":
            if self._n_states:
                m_new = sp.sgd_mom_rows_math(weight, states[0], grad, lr,
                                             self._momentum, **kw)
                weight.add_(m_new.to(weight.dtype))
                states[0].copy_(m_new)
            else:
                weight.add_(sp.sgd_rows_math(weight, grad, lr, **kw)
                            .to(weight.dtype))
            return
        step, m_new, v_new = sp.adam_rows_math(
            weight, states[0], states[1], grad, lr, self._beta1,
            self._beta2, self._eps, **kw)
        weight.add_(step.to(weight.dtype))
        states[0].copy_(m_new)
        states[1].copy_(v_new)

    def _step_lr(self, t):
        if self.optimizer == "sgd":
            return self._learning_rate
        # Adam's bias correction folded into the step size, from the
        # device-carried update count
        return self._learning_rate * torch.sqrt(1.0 - self._beta2 ** t) \
            / (1.0 - self._beta1 ** t)

    def _mlp_forward(self, params, feat):
        h = feat
        n_layers = len(self.mlp_hidden) + 1
        for i in range(n_layers):
            h = h @ params[2 * i] + params[2 * i + 1]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h.reshape(-1)

    def _loss_and_grads(self, rows, inv, mlp, dense, labels):
        """Loss of one replica's batch and its gradients with respect to
        the gathered rows and the MLP."""
        with torch.enable_grad():
            rows = rows.detach().requires_grad_(True)
            params = [p.detach().requires_grad_(True) for p in mlp]
            emb = sp.take_rows(rows, inv)
            feat = emb.reshape(-1, self.n_slots * self.dim)
            if self.dense_dim:
                feat = torch.cat([feat, dense], dim=1)
            loss = _bce_logits(self._mlp_forward(params, feat), labels)
            grads = torch.autograd.grad(loss, [rows] + params)
        return loss.detach(), grads[0], grads[1:]

    def _encode_wire(self, g):
        """The backward wire cast: bf16 straight, fp8 e4m3 over a
        per-row max-abs scale sent beside it."""
        if self.compress == "bf16":
            return g.to(torch.bfloat16), None
        amax = g.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax > 0, amax / _FP8_AMAX,
                            torch.ones((), device=g.device))
        return (g / scale).to(self._wire_dtype), scale[:, 0]

    def _gather_values(self, g_rows, dev0):
        """The backward all-gather of every replica's row gradients, as
        float32 on ``dev0``."""
        if self._wire_dtype is None:
            return torch.cat([g.to(dev0) for g in g_rows])
        wires, scales = zip(*(self._encode_wire(g) for g in g_rows))
        vals = torch.cat([w.to(dev0).to(torch.float32) for w in wires])
        if scales[0] is not None:
            vals = vals * torch.cat([s.to(dev0) for s in scales])[:, None]
        return vals

    @torch.no_grad()
    def _step_sparse(self, state, ids, dense, labels):
        tables, tstates, mlps, mstates, ts = state
        L = self._layout
        n, U, R, sent = self._n_dev, L.unique, L.rows_per_dev, L.sentinel
        devs, dev0 = self._devs, self._devs[0]
        # [1] dedup, gather the unique lists, serve owned rows, and give
        # replica k the sum of everyone's k-th slice (the psum_scatter:
        # one owner a row, the others add exact zeros)
        uq = [sp.unique_rows(x.reshape(-1), U, sent) for x in ids]
        all_ids = torch.cat([u[0].to(dev0) for u in uq])
        contribs = []
        for k, dev in enumerate(devs):
            a = all_ids.to(dev)
            lo = k * R
            owned = (a >= lo) & (a < lo + R)
            got = tables[k].index_select(0, torch.where(owned, a - lo, 0)
                                         .long())
            contribs.append(torch.where(owned[:, None], got, 0.0))
        losses, g_rows, g_mlps = [], [], []
        for k, dev in enumerate(devs):
            rows = None
            for c in contribs:
                part = c[k * U:(k + 1) * U].to(dev)
                rows = part if rows is None else rows + part
            loss, g_r, g_m = self._loss_and_grads(
                rows, uq[k][1], mlps[k], dense[k], labels[k])
            losses.append(loss)
            g_rows.append(g_r)
            g_mlps.append(g_m)
        # [2] the row-sparse exchange: (rows, values) on the wire, the id
        # list already gathered in [1]
        vals = self._gather_values(g_rows, dev0)
        # [3] receiver dedup + segment sum, then local shard coordinates
        # (the trash row R for rows another replica owns, and for slack)
        uniq2, inv2, nnz = sp.unique_rows(all_ids, n * U, sent)
        # slack slots carry no gradient and their row is dropped below:
        # drop them from the sum too (each to its own trash row)
        gsum = sp.segment_sum_rows(
            vals, torch.where(all_ids == sent, n * U, inv2), n * U)
        lrs = self._advance(ts)
        for k, dev in enumerate(devs):
            u2 = uniq2.to(dev)
            lo = k * R
            rows2 = torch.where((u2 >= lo) & (u2 < lo + R), u2 - lo, R)
            self._update_rows_(tables[k], tstates[k], rows2, gsum.to(dev),
                               lrs[k])
        self._update_mlp(mlps, mstates, lrs, g_mlps)
        return sum_to(losses, dev0), nnz

    @torch.no_grad()
    def _step_dense(self, state, ids, dense, labels):
        tables, tstates, mlps, mstates, ts = state
        devs, dev0 = self._devs, self._devs[0]
        losses, g_tables, g_mlps = [], [], []
        for k in range(len(devs)):
            loss, g_t, g_m = self._loss_and_grads(
                tables[k], ids[k].reshape(-1), mlps[k], dense[k], labels[k])
            losses.append(loss)
            g_tables.append(g_t)
            g_mlps.append(g_m)
        lrs = self._advance(ts)
        for k, dev in enumerate(devs):
            self._update_full_(tables[k], tstates[k],
                               sum_to(g_tables, dev), lrs[k])
        self._update_mlp(mlps, mstates, lrs, g_mlps)
        nnz = torch.full((), self._layout.padded_vocab, dtype=torch.int32,
                         device=dev0)
        return sum_to(losses, dev0), nnz

    def _advance(self, ts):
        """t += 1 on every replica; the step sizes of this update."""
        for t in ts:
            t.add_(1.0)
        return [self._step_lr(t) for t in ts]

    def _update_mlp(self, mlps, mstates, lrs, g_mlps):
        # [4] the replicated MLP: gradients summed over the replicas, the
        # same update on each copy
        for i in range(len(g_mlps[0])):
            for k, dev in enumerate(self._devs):
                g = sum_to([gm[i] for gm in g_mlps], dev)
                self._update_full_(mlps[k][i], mstates[k][i], g, lrs[k])

    def step(self, state, inputs):
        """One train step: ``(state, loss, nnz)``, the state updated in
        place; ``loss`` (the batch's summed BCE) and ``nnz`` (the global
        touched rows) device scalars. Reads nothing back to the host."""
        ids, dense, labels = inputs
        self._ensure_layout(ids[0].shape[0] * self.n_slots)
        from ..telemetry import devstats
        b = int(ids[0].shape[0])
        devstats.on_dispatch(f"embed_{self.exchange}.step",
                             lambda: self._program(b), (b,), steps=1)
        step = self._step_sparse if self.exchange == "sparse" \
            else self._step_dense
        with torch.profiler.record_function(self.program_tag):
            loss, nnz = step(state, ids, dense, labels)
        self._tick_counters(nnz)
        return state, loss, nnz

    def _program(self, b):
        """A replica's costs of one step at local batch ``b`` (what
        ``devstats.on_dispatch`` records): the MLP's products forward and
        backward (2·b·in·out, twice that back) and the updates of its
        parameters and of the batch's table rows (every id of the batch
        counted: the unique rows are known only on the device)."""
        from ..telemetry.costs import update_costs
        opname = "adam_update" if self.optimizer == "adam" \
            else "sgd_update"
        shapes = self._mlp_shapes()
        prods = sum(2.0 * b * s[0] * s[1] for s in shapes if len(s) == 2)
        elems = sum(int(_np.prod(s)) for s in shapes) \
            + b * self.n_slots * self.dim
        uf, ub = update_costs(opname, elems)
        act = 4.0 * b * sum(s[-1] for s in shapes if len(s) == 2)
        return {"flops": 3 * prods + uf, "bytes": ub + 3 * act,
                "param_bytes": 4.0 * elems, "act_bytes": act,
                "input_bytes": 4.0 * b * (self.n_slots + self.dense_dim
                                          + 1)}

    def _tick_counters(self, nnz_dev):
        L = self._layout
        _COUNTERS["embed_wire_bytes"] += L.wire_bytes_per_step(
            self.exchange, self._wire_itemsize, self._mlp_bytes())
        _COUNTERS["embed_steps"] += 1
        _COUNTERS["embed_vocab_rows"] = self.vocab
        _COUNTERS["embed_sparse"] = int(self.exchange == "sparse")
        _COUNTERS["embed_compress_bits"] = self._wire_itemsize * 8
        _LAST_NNZ["dev"] = nnz_dev
        _LAST_NNZ["vocab"] = self.vocab

    # -- host views / checkpoint round trip ----------------------------------

    def _whole_table(self, parts):
        """Whole (vocab, dim) host array of a table-shaped state entry
        given per replica."""
        if self.exchange == "sparse":
            R = self._scratch_layout().rows_per_dev
            shards = [_host(p[:R]) for p in parts]
            full = shards[0] if len(shards) == 1 else _np.concatenate(shards)
        else:
            full = _host(parts[0])
        return full[:self.vocab]

    def host_params(self, state):
        """name -> whole float32 host arrays, the table trimmed to
        (vocab, dim) (pad rows depend on the replica count)."""
        out = {"embed": self._whole_table(state[0])}
        for n, p in zip(self.mlp_names, state[2][0]):
            out[n] = _host(p)
        return out

    def export_training_state(self, state):
        """checkpoint.TrainingState-ready ``(arrays, meta)``: the
        ``param:`` / ``opt:`` names with whole arrays (so a resume may
        change the replica count, the exchange or the cap, or the
        package), ``meta["embed"]`` the layout and the ownership map."""
        L = self._scratch_layout()
        arrays = {f"param:{n}": a for n, a in self.host_params(state).items()}
        for j in range(self._n_states):
            arrays[f"opt:embed:{j}"] = self._whole_table(
                [st[j] for st in state[1]])
            for n, st in zip(self.mlp_names, state[3][0]):
                arrays[f"opt:{n}:{j}"] = _host(st[j])
        meta = {
            "t": float(state[4][0]),
            "optimizer": self.optimizer,
            "embed": {
                "exchange": self.exchange,
                "compress": self.compress,
                "vocab": self.vocab, "dim": self.dim,
                "unique_cap": self._cap,
                "ownership": L.ownership(self.mlp_names),
            },
        }
        return arrays, meta

    def import_training_state(self, arrays, meta):
        """Inverse of export: the whole arrays (numpy or tensors) re-padded
        and placed for this trainer's replicas and exchange."""
        t = float((meta or {}).get("t", 0.0))
        table = arrays["param:embed"]
        if tuple(table.shape) != (self.vocab, self.dim):
            raise MXNetError(f"embed table shape {tuple(table.shape)} != "
                             f"{(self.vocab, self.dim)}")
        tstates = [arrays[f"opt:embed:{j}"] for j in range(self._n_states)]
        mlp = [arrays[f"param:{n}"] for n in self.mlp_names]
        mstates = [[arrays[f"opt:{n}:{j}"] for j in range(self._n_states)]
                   for n in self.mlp_names]
        return self._place(table, tstates, mlp, mstates, t)


# ============================================================================
# CLI: --selftest / --bench / --hlo-check
# ============================================================================

def _click_data(vocab, batch, slots, dense_dim, seed=0, structured=True):
    """Synthetic clicks with learnable structure: the label is the parity
    of two slots' ids XOR a dense margin, so a table + MLP can drive the
    BCE down."""
    rng = _np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(batch, slots)).astype(_np.int32)
    dense = rng.normal(size=(batch, dense_dim)).astype(_np.float32) \
        if dense_dim else _np.zeros((batch, 0), _np.float32)
    if structured:
        y = (((ids[:, 0] + ids[:, 1 % slots]) % 2)
             ^ (dense[:, 0] > 0 if dense_dim else 0)).astype(_np.float32)
    else:
        y = rng.randint(0, 2, size=(batch,)).astype(_np.float32)
    return ids, dense, y


def _permutation_data(vocab, batch, slots, dense_dim, seed=0):
    """Every row touched exactly once (ids a permutation of
    arange(vocab)): no exchange can reassociate a row's sum, so
    sparse-vs-dense bit identity is well posed."""
    assert batch * slots == vocab
    rng = _np.random.RandomState(seed)
    ids = rng.permutation(vocab).astype(_np.int32).reshape(batch, slots)
    dense = rng.normal(size=(batch, dense_dim)).astype(_np.float32) \
        if dense_dim else _np.zeros((batch, 0), _np.float32)
    y = rng.randint(0, 2, size=(batch,)).astype(_np.float32)
    return ids, dense, y


def _mk(mesh, vocab, batch, exchange, compress="none", optimizer="adam",
        lr=0.02, slots=4, dense_dim=4, dim=8, tag=None, cap=None,
        momentum=0.9):
    return EmbeddingTrainer(
        mesh, vocab=vocab, embed_dim=dim, n_slots=slots,
        dense_dim=dense_dim, mlp_hidden=(32,), optimizer=optimizer,
        learning_rate=lr, momentum=momentum if optimizer == "sgd" else 0.0,
        rescale_grad=1.0 / batch, exchange=exchange, compress=compress,
        batch_size=batch, program_tag=tag, unique_cap=cap)


def _run(tr, data, steps, state=None, seed=0):
    if state is None:
        state = tr.init_state(seed=seed)
    inputs = tr.shard_inputs(list(data))
    losses = []
    for _ in range(steps):
        state, loss, nnz = tr.step(state, inputs)
        losses.append(float(loss))
    return state, losses, int(nnz)


def _cli_mesh(ctx, devices):
    """``devices`` host replicas (ctx "cpu"), or the first ``devices``
    cards (raises without one)."""
    from .mesh import data_parallel_mesh, mesh_for_contexts
    if ctx == "cpu":
        from ..context import cpu
        return mesh_for_contexts([cpu(i) for i in range(devices)])
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device: pass --ctx cpu for host replicas")
    n = min(devices, torch.cuda.device_count())
    return data_parallel_mesh(n)


def selftest(devices=2, ctx="gpu"):
    """A/B of the sparse exchange against the dense one on a tiny DLRM,
    one ``embed_selftest`` JSON line: (1) sum-BCE falls > 30% over 60
    adam steps; (2) with every row touched once, sgd with momentum and
    adam leave table, MLP and optimizer state bit-identical across the
    exchanges; (3) bf16 stays near float32, fp8 converges; (4) export ->
    import across an exchange and cap change -> export gives an equal
    ``state_sha256``, and training goes on; (5) the analytic wire of a
    2-replica step: sparse bytes independent of the vocab, dense bytes
    proportional to it, sparse below dense."""
    import json
    mesh = _cli_mesh(ctx, devices)
    n_dev = len(mesh.replicas)
    results = {"metric": "embed_selftest", "devices": n_dev,
               "device": str(mesh.replicas[0])}

    vocab, batch, slots = 64, 32, 4
    data = _click_data(vocab, batch, slots, 4, seed=1)
    tr = _mk(mesh, vocab, batch, "sparse")
    state, ces, nnz = _run(tr, data, 60)
    results["ce_first"] = round(ces[0], 4)
    results["ce_last"] = round(ces[-1], 4)
    results["touched_rows"] = nnz
    results["converges"] = bool(
        _np.isfinite(ces[-1]) and ces[-1] < 0.7 * ces[0])

    pvocab = batch * slots
    pdata = _permutation_data(pvocab, batch, slots, 4, seed=2)
    for optimizer in ("sgd", "adam"):
        outs = []
        for exchange in ("sparse", "dense"):
            t = _mk(mesh, pvocab, batch, exchange, optimizer=optimizer)
            st, _, _ = _run(t, pdata, 10)
            outs.append(t.export_training_state(st)[0])
        results[f"bitwise_{optimizer}"] = bool(all(
            _np.array_equal(outs[0][k], outs[1][k]) for k in outs[0]))

    _, ce16, _ = _run(_mk(mesh, vocab, batch, "sparse", compress="bf16"),
                      data, 60)
    _, ce8, _ = _run(_mk(mesh, vocab, batch, "sparse", compress="fp8"),
                     data, 60)
    results["bf16_ce_last"] = round(ce16[-1], 4)
    results["fp8_ce_last"] = round(ce8[-1], 4)
    results["bf16_close"] = bool(abs(ce16[-1] - ces[-1]) <= 0.15 * ces[0])
    results["fp8_converges"] = bool(
        _np.isfinite(ce8[-1]) and ce8[-1] < 0.7 * ce8[0])

    from ..checkpoint.state import TrainingState, state_sha256
    arrays, meta = tr.export_training_state(state)
    sha0 = state_sha256(TrainingState(arrays, meta={"trainer": meta}))
    tr_dn = _mk(mesh, vocab, batch, "dense", cap=2 * batch * slots)
    st2 = tr_dn.import_training_state(arrays, meta)
    arrays2, meta2 = tr_dn.export_training_state(st2)
    sha1 = state_sha256(TrainingState(arrays2, meta={"trainer": meta2}))
    results["resume_sha_equal"] = bool(sha0 == sha1)
    _, cont, _ = _run(tr_dn, data, 3, state=st2)
    results["resume_continues"] = bool(_np.isfinite(cont[-1]))

    wire = {}
    for exchange in ("sparse", "dense"):
        for v in (2048, 4096):
            L = EmbeddingLayout(v, 8, max(2, n_dev),
                                batch // n_dev * slots, 2)
            wire[(exchange, v)] = L.wire_bytes_per_step(
                exchange, 4, tr._mlp_bytes())
    results["wire_sparse_bytes"] = [wire["sparse", 2048],
                                    wire["sparse", 4096]]
    results["wire_dense_bytes"] = [wire["dense", 2048], wire["dense", 4096]]
    results["wire_scales_with_rows"] = bool(
        wire["sparse", 2048] == wire["sparse", 4096]
        and wire["dense", 4096] > 1.5 * wire["dense", 2048]
        and wire["sparse", 2048] < wire["dense", 2048])
    results["wire_source"] = "analytic"

    keys = ("converges", "bitwise_sgd", "bitwise_adam", "bf16_close",
            "fp8_converges", "resume_sha_equal", "resume_continues",
            "wire_scales_with_rows")
    results["ok"] = bool(all(results[k] for k in keys))
    print(json.dumps(results), flush=True)
    return 0 if results["ok"] else 1


def bench(devices=1, steps=10, vocab=65536, dim=48, batch=256, slots=8,
          ctx="gpu"):
    """The sparse exchange (float32 and fp8 wires) against the dense one
    at <= 5% touched rows: steps/s (median of 3 windows after 2 warm-up
    steps, each window ending on a read of its last loss) and the
    analytic wire bytes a step. One ``embed_bench`` JSON line. Exits 0
    when every arm ran, the touched share is <= 5% and (over >= 2
    replicas) the sparse wire is below the dense one; the JAX lane's
    2x speed bar is reported (``meets_2x_bar``), not required."""
    import json
    import time
    mesh = _cli_mesh(ctx, devices)
    n_dev = len(mesh.replicas)
    data = _click_data(vocab, batch, slots, 8, seed=0)
    touched = len(_np.unique(data[0]))

    def _arm(exchange, compress="none"):
        tr = _mk(mesh, vocab, batch, exchange, compress=compress, dim=dim,
                 slots=slots, dense_dim=8)
        state, _, nnz = _run(tr, data, 2)
        inputs = tr.shard_inputs(list(data))
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                state, loss, _ = tr.step(state, inputs)
            float(loss)
            rates.append(steps / (time.perf_counter() - t0))
        wire = tr.layout.wire_bytes_per_step(exchange, tr._wire_itemsize,
                                             tr._mlp_bytes())
        return sorted(rates)[1], wire, nnz

    sp_sps, sp_wire, nnz = _arm("sparse")
    f8_sps, f8_wire, _ = _arm("sparse", "fp8")
    dn_sps, dn_wire, _ = _arm("dense")
    rec = {"metric": "embed_bench", "devices": n_dev,
           "device": str(mesh.replicas[0]),
           "vocab": vocab, "dim": dim, "batch": batch, "slots": slots,
           "touched_rows": int(touched),
           "touched_frac": round(touched / vocab, 4),
           "steps_per_window": steps,
           "dense_steps_per_s": round(dn_sps, 2),
           "sparse_steps_per_s": round(sp_sps, 2),
           "sparse_fp8_steps_per_s": round(f8_sps, 2),
           "speedup_sparse": round(sp_sps / dn_sps, 3),
           "speedup_sparse_fp8": round(f8_sps / dn_sps, 3),
           "wire_bytes_per_step_dense": dn_wire,
           "wire_bytes_per_step_sparse": sp_wire,
           "wire_bytes_per_step_sparse_fp8": f8_wire,
           "wire_reduction": round(dn_wire / max(1, sp_wire), 1),
           "wire_source": "analytic"}
    rec["meets_2x_bar"] = bool(rec["speedup_sparse"] >= 2.0)
    rec["ok"] = bool(
        all(_np.isfinite([sp_sps, f8_sps, dn_sps])) and nnz == touched
        and rec["touched_frac"] <= 0.05
        and (n_dev == 1 or sp_wire < dn_wire))
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


def main(argv=None):
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.parallel.embedding")
    ap.add_argument("--selftest", action="store_true",
                    help="tiny-DLRM A/B against the dense exchange")
    ap.add_argument("--bench", action="store_true",
                    help="sparse vs dense exchange: steps/s + wire bytes")
    ap.add_argument("--hlo-check", action="store_true",
                    help="(the JAX package's HLO check: not available)")
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--devices", type=int, default=None,
                    help="replicas (default: 2 for --selftest, 1 for "
                         "--bench)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--exchange", default="sparse",
                    choices=["sparse", "dense"])
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "fp8"])
    ap.add_argument("--vocab", type=int, default=2048)
    args = ap.parse_args(argv)
    if args.hlo_check:
        print("embedding --hlo-check reads the exchange's collectives and "
              "wire bytes out of XLA's post-partitioning HLO; the port "
              "compiles no HLO (its wire bytes are "
              "EmbeddingLayout.wire_bytes_per_step's, as --bench reports)",
              file=sys.stderr)
        return 2
    if args.bench:
        return bench(devices=args.devices or 1, steps=args.steps,
                     ctx=args.ctx)
    if args.selftest:
        return selftest(args.devices or 2, ctx=args.ctx)
    ap.print_help()
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
