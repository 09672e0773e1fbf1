"""ZeRO-sharded data parallelism (counterpart of mxnet_tpu/parallel/zero.py,
``mx.parallel.zero``).

Instead of every replica holding float32 masters and optimizer states for
every parameter, each replica owns a 1/N slice of flat per-bucket master
and optimizer buffers:

  stage 1  the gradients are summed over the replicas (``psum``) and
           each replica updates its own slice: the optimizer states are
           sharded, and float32 stage 1 is bit-identical to plain dp (the
           same sum in the same order, the same elementwise update);
  stage 2  the sum becomes a reduce-scatter (``psum_scatter``): each
           replica receives only its gradient slice, then the replicas
           all-gather the updated compute-dtype parameters.

Parameters are packed in declaration order into flat float32 buckets of
``MXNET_ZERO_BUCKET_MB`` (``ZeroLayout``, the JAX package's byte for
byte: the same buckets, padding, ownership and wire bytes); every fused
update op of ``dp._OPT_OPS`` is elementwise, so it applies to the flat
shards directly. ``MXNET_GRAD_COMPRESS=bf16|fp8`` casts each bucket's
gradient to the wire dtype before the sum, with a per-replica
error-feedback residual carried across steps, and the sum is taken in the
wire dtype (each partial sum rounded to it), as the JAX step's ``psum`` of
float8 or bfloat16 values.

The step is the JAX package's ``_zero_impl`` run once a replica, in
replica order, over the single-process mesh (``parallel/mesh.py``): the
compute-dtype parameters all-gathered from the master shards (cast before
the gather), a local forward and backward of the replica's batch shard
through the executor's one-device plan (so BatchNorm statistics are local
to the replica, and the aux states are ``pmean``'d after), the per-bucket
compress and reduce, and the update of the owned shard in float32 with
the registered update op. Under the fp16 loss scaler the finiteness is
global and a skipped step changes neither masters, states, residuals nor
aux. Adam's bias correction is folded into lr from the device ``t``.
Every replica draws from the same generator state, as the JAX step's
replicated key. The sums run from the last replica to the first: the
order in which autograd sums dp's replicas into one leaf, so stage 1
equals dp bit for bit, and stage 2 (the same sums, one slice a replica)
equals stage 1.

The step runs eagerly (a CUDA graph of it is later work); on one card a
mesh may list the card several times, and the replicas then share its
memory. On an N-D mesh (the planner's ``dpK.tpT+zero1|+zero2``) the
masters, states and residuals are split jointly over all D·T replicas
(in mesh order), the batch over the data axis only: the T replicas of a
data index compute the same gradients, so each is scaled by 1/T (exact
for a power-of-two T) before the joint reduce, and the loss, outputs and
BatchNorm statistics are the model index 0 replicas'. A 1-D mesh is the
same program as before, bit for bit.

Env: ``MXNET_ZERO_STAGE=0|1|2`` (0 = plain dp; > 0 reroutes
``DataParallelTrainer(...)`` here), ``MXNET_ZERO_BUCKET_MB`` (default 4),
``MXNET_GRAD_COMPRESS=none|bf16|fp8``, and the pure-zero plans
``MXNET_PLAN=zero1|zero2``.

CLI: ``python -m mxnet_tpu_torch.parallel.zero --selftest`` (stage-1
bitwise against dp, stage 2 against stage 1, fp8 convergence with a live
residual, the analytic wire bytes), ``--bench`` (dp, ZeRO-1, ZeRO-2 and
ZeRO-2 + fp8 over ``--devices`` replicas of the card: steps/s and the
analytic wire bytes), ``--ctx cpu`` for host replicas. ``--hlo-check``
reads XLA's HLO in the JAX package and exits 2 here.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

from .. import amp as _amp
from ..base import MXNetError
from ..ops.registry import AttrDict, OpCtx
from .dp import DataParallelTrainer, _tensor
from .mesh import (all_gather, axis_size, cast_wire, data_axis, pmean, psum,
                   psum_scatter, replica_coords, sum_to)

__all__ = ["ZeroTrainer", "ZeroLayout", "counters", "resolve_stage",
           "resolve_compress", "WIRE_DTYPES"]

# wire dtypes of MXNET_GRAD_COMPRESS: fp8 e4m3 keeps the most mantissa of
# the fp8 encodings; the residual carries what its 3 bits drop
WIRE_DTYPES = {
    "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}


def resolve_stage(value=None):
    """ZeRO stage: the explicit argument, else MXNET_ZERO_STAGE, else the
    stage a pure-zero MXNET_PLAN names (``zero1`` / ``zero2``, so that
    ``MXNET_PLAN=zero2`` reroutes a plain trainer construction without
    the planner), else 0: every other plan (``auto``, ``dp``, the tp
    forms, which ``planner.make_trainer`` builds) leaves a direct
    construction plain dp, as in the JAX package."""
    if value is None:
        from .. import config
        # unset / empty collapses to 0; an explicit "0" is the truthy
        # string "0" here, so it wins over the plan
        value = os.environ.get("MXNET_ZERO_STAGE") or 0
        if not value:
            plan = str(config.get("MXNET_PLAN", "auto")).strip().lower()
            if plan in ("zero1", "zero2"):
                return int(plan[-1])
    try:
        stage = int(value)
    except (TypeError, ValueError):
        raise MXNetError(f"MXNET_ZERO_STAGE must be 0|1|2, got {value!r}")
    if stage not in (0, 1, 2):
        raise MXNetError(f"MXNET_ZERO_STAGE must be 0|1|2, got {stage}")
    return stage


def resolve_compress(value=None):
    """Wire-compression mode: none|bf16|fp8 (MXNET_GRAD_COMPRESS)."""
    if value is None:
        from .. import config
        value = config.get("MXNET_GRAD_COMPRESS")
    mode = str(value or "none").strip().lower()
    if mode in ("", "0", "none", "off"):
        return "none"
    if mode not in WIRE_DTYPES:
        raise MXNetError(
            f"MXNET_GRAD_COMPRESS must be none|bf16|fp8, got {value!r}")
    return mode


def _resolve_bucket_bytes(mb=None):
    if mb is None:
        from .. import config
        mb = config.get("MXNET_ZERO_BUCKET_MB")
    try:
        b = int(float(mb) * (1 << 20))
    except (TypeError, ValueError):
        raise MXNetError(f"MXNET_ZERO_BUCKET_MB must be a number, got {mb!r}")
    return max(b, 1)


class ZeroLayout:
    """Flat-bucket layout of the parameter set over N replicas.

    Parameters are packed in declaration order into buckets of at most
    ``bucket_bytes`` float32 bytes (a parameter never splits across
    buckets; one larger than the threshold gets its own bucket). Each
    bucket's flat length is padded to a multiple of ``n_dev`` so the
    shards are even; the padding is zeros, and the elementwise update on
    zero gradients leaves it zeros.
    """

    def __init__(self, shapes, n_dev, bucket_bytes):
        self.shapes = [tuple(s) for s in shapes]
        self.n_dev = int(n_dev)
        self.sizes = [max(1, int(_np.prod(s))) if s else 1
                      for s in self.shapes]
        self.buckets = []
        cur, cur_bytes = [], 0
        for i, sz in enumerate(self.sizes):
            if cur and cur_bytes + 4 * sz > bucket_bytes:
                self.buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += 4 * sz
        if cur:
            self.buckets.append(cur)
        self.offsets, self.totals, self.padded, self.shard_len = \
            [], [], [], []
        for idxs in self.buckets:
            offs, o = [], 0
            for i in idxs:
                offs.append(o)
                o += self.sizes[i]
            self.offsets.append(offs)
            self.totals.append(o)
            p = o + (-o % self.n_dev)
            self.padded.append(p)
            self.shard_len.append(p // self.n_dev)

    @property
    def n_buckets(self):
        return len(self.buckets)

    def flatten(self, parts, b):
        """The flat (padded,) tensor of bucket b's per-parameter tensors
        (their dtype and device; zeros as padding)."""
        flat = [p.reshape(-1) for p in parts]
        pad = self.padded[b] - self.totals[b]
        if pad:
            flat.append(parts[0].new_zeros(pad))
        return torch.cat(flat)

    def unflatten(self, flat, b):
        """[(param index, view)] of bucket b's flat tensor."""
        return [(i, flat[off:off + self.sizes[i]].view(self.shapes[i]))
                for i, off in zip(self.buckets[b], self.offsets[b])]

    def owner(self, i):
        """The replica owning parameter i's shard (by its start offset):
        the checkpoint's ownership map."""
        b = next(k for k, idxs in enumerate(self.buckets) if i in idxs)
        off = self.offsets[b][self.buckets[b].index(i)]
        return min(off // self.shard_len[b], self.n_dev - 1)

    def wire_bytes_breakdown(self, stage, compute_itemsize, wire_itemsize):
        """(param all-gather bytes, gradient-reduce bytes) a replica a step,
        by ring accounting: an all-gather or a reduce-scatter moves (N-1)/N
        of the global buffer a replica, an all-reduce twice that."""
        n = self.n_dev
        frac = (n - 1) / n
        ag = red = 0.0
        for p in self.padded:
            ag += p * frac * compute_itemsize               # all-gather
            r = p * frac * wire_itemsize                    # grad reduce
            red += r if stage >= 2 else 2 * r               # ar = 2x rs
        return int(ag), int(red)

    def wire_bytes_per_step(self, stage, compute_itemsize, wire_itemsize):
        """Analytic wire bytes a replica a step: the breakdown's sum (the
        live ``zero_wire_bytes`` counter's increment)."""
        ag, red = self.wire_bytes_breakdown(stage, compute_itemsize,
                                            wire_itemsize)
        return ag + red

    def overlap_frac(self):
        """The share of gradient-reduce bytes whose bucket could start
        before the whole backward ends: every bucket but bucket 0 (the
        input-side parameters, the backward's last). Structural headroom:
        the port's eager step does not overlap them."""
        tot = sum(self.padded)
        if self.n_buckets < 2 or not tot:
            return 0.0
        return round(1.0 - self.padded[0] / tot, 4)

    def ownership(self, param_names, n_states):
        own = {}
        for i, n in enumerate(param_names):
            k = self.owner(i)
            own[f"param:{n}"] = k
            for j in range(n_states):
                own[f"opt:{n}:{j}"] = k
        return own


# -- live counter export (profiler hook "zero", read by the step log) --------

_COUNTERS = {"zero_wire_bytes": 0, "zero_steps": 0,
             "zero_wire_allgather_bytes": 0, "zero_wire_reduce_bytes": 0,
             "zero_flops_per_step": 0.0,
             "zero_overlap_frac": 0.0, "zero_stage": 0,
             "zero_buckets": 0, "zero_compress_bits": 32}
_HOOKED = False


def counters():
    """Host-side ZeRO counters (no device sync): cumulative analytic wire
    bytes, steps, the current stage, buckets, overlap share, and a
    replica's FLOPs of the last step (``telemetry.costs``)."""
    return dict(_COUNTERS)


def _ensure_hook():
    global _HOOKED
    if not _HOOKED:
        from .. import profiler
        profiler.register_counter_export("zero", counters)
        _HOOKED = True


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


class ZeroTrainer(DataParallelTrainer):
    """DataParallelTrainer with ZeRO-sharded masters and optimizer states.

    The same constructor (plus ``zero_stage`` / ``zero_bucket_mb`` /
    ``grad_compress``, from the environment when None) and the same
    step / step_k / init_state / export / import contract. The params
    and states it hands back are per-bucket float32 shards, one a replica
    (``params[b][k]``, ``states[b][j][k]``), opaque to the fused fits,
    which write back through ``device_params`` / ``host_params``; its
    exports carry the usual per-parameter arrays, so checkpoints cross
    between the stages, plain dp and the JAX package, and the stage may
    change across a resume. The tensors are the trainer's own, updated in
    place, as dp's are.
    """

    def __init__(self, symbol, mesh, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 learning_rate=0.01, momentum=0.0, wd=0.0,
                 rescale_grad=None, clip_gradient=None, loss_index=0,
                 dtype="float32", input_preproc=None, loss_scaler=None,
                 zero_stage=None, zero_bucket_mb=None, grad_compress=None,
                 **opt_kwargs):
        stage = resolve_stage(zero_stage)
        if stage == 0:
            # a direct construction is an explicit opt-in: stage 1 when
            # neither the argument nor the environment picked one
            stage = 1
        super().__init__(symbol, mesh, data_names=data_names,
                         label_names=label_names, optimizer=optimizer,
                         learning_rate=learning_rate, momentum=momentum,
                         wd=wd, rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient,
                         loss_index=loss_index, dtype=dtype,
                         input_preproc=input_preproc,
                         loss_scaler=loss_scaler, **opt_kwargs)
        self._zero_stage = stage
        self._bucket_bytes = _resolve_bucket_bytes(zero_bucket_mb)
        self._compress = resolve_compress(grad_compress)
        self._wire_dtype = (None if self._compress == "none"
                            else WIRE_DTYPES[self._compress])
        self._n_dev = len(self._devices)
        # N-D meshes: each replica's data index (its batch shard) and the
        # model factor T whose replicas compute the same gradients
        self._n_data = axis_size(self._mesh, data_axis(self._mesh))
        self._model_factor = self._n_dev // self._n_data
        dax = data_axis(self._mesh)
        coords = replica_coords(self._mesh)
        self._didx = [c[dax] for c in coords]
        self._first = [r for r, c in enumerate(coords)
                       if all(v == 0 for k, v in c.items() if k != dax)]
        self._flops = 0.0
        self._layout = None
        self._resid = ()
        self._wire_itemsize = (_itemsize(self._wire_dtype)
                               if self._wire_dtype is not None
                               else self._compute_itemsize)
        suffix = {"none": "n", "bf16": "b16", "fp8": "f8"}[self._compress]
        self._program_tag = (f"zstep_t{self._model_factor}s{stage}{suffix}"
                             if self._model_factor > 1
                             else f"zstep_s{stage}{suffix}")
        _ensure_hook()

    @property
    def layout(self):
        return self._layout

    def _graphed(self):
        return False

    def _dispatch_name(self, k=None):
        return "zero%d.step" % self._zero_stage if k is None \
            else "zero%d.step_k%d" % (self._zero_stage, k)

    # -- layout and sharded state ---------------------------------------------
    def _ensure_layout(self, shapes):
        if self._layout is None:
            self._layout = ZeroLayout(shapes, self._n_dev,
                                      self._bucket_bytes)
        return self._layout

    def _shards(self, flat, b):
        """A flat (padded,) tensor cut into the replicas' own copies."""
        sl = self._layout.shard_len[b]
        return tuple(flat[k * sl:(k + 1) * sl].to(d, copy=True)
                     for k, d in enumerate(self._devices))

    def _pack(self, params, states, aux):
        """Per-parameter float32 tensors into the trainer's sharded flat
        buckets (the residuals reset to zeros); returns the new state."""
        L = self._ensure_layout([tuple(p.shape) for p in params])
        f32 = lambda t: _tensor(t).detach().to(self._device, torch.float32)
        masters, zstates = [], []
        for b, idxs in enumerate(L.buckets):
            masters.append(self._shards(
                L.flatten([f32(params[i]) for i in idxs], b), b))
            zstates.append(tuple(
                self._shards(L.flatten([f32(states[i][j]) for i in idxs],
                                       b), b)
                for j in range(self._n_states)))
        self._params, self._states = tuple(masters), tuple(zstates)
        self._aux = tuple(f32(a).clone() for a in aux)
        if self._lr_dev is None:
            self._lr_dev = torch.tensor(self._lr, dtype=torch.float32,
                                        device=self._device)
            self._t_dev = torch.tensor(self._t, dtype=torch.float32,
                                       device=self._device)
        self._reset_residual()
        return self._params, self._states, self._aux

    def _reset_residual(self):
        if self._wire_dtype is None:
            self._resid = ()
            return
        L = self._layout
        self._resid = tuple(
            tuple(torch.zeros(L.padded[b], dtype=torch.float32, device=d)
                  for d in self._devices) for b in range(L.n_buckets))

    def _flat_state(self, params, states, aux):
        return [s for b in params for s in b] + \
            [s for b in states for st in b for s in st] + list(aux)

    def _adopt(self, params, states, aux):
        """Make (params, states, aux) the trainer's state: nothing when
        they are its own tensors, else a copy into them."""
        if self._params is None:
            raise MXNetError("ZeroTrainer.step before init_state/"
                             "import_training_state")
        own = self._flat_state(self._params, self._states, self._aux)
        given = self._flat_state(params, states, aux)
        if len(own) != len(given):
            raise MXNetError("ZeroTrainer: the state handed in is not this "
                             "trainer's layout")
        if all(a is b for a, b in zip(own, given)):
            return
        with torch.no_grad():
            for a, b in zip(own, given):
                a.copy_(b)

    def init_state(self, shape_kwargs, initializer=None, seed=0,
                   arg_params=None, aux_params=None):
        """dp's draw, packed into the sharded buckets: (masters, states,
        aux) with masters[b][k] replica k's float32 shard of bucket b."""
        params, states, aux = super().init_state(
            shape_kwargs, initializer=initializer, seed=seed,
            arg_params=arg_params, aux_params=aux_params)
        return self._pack(params, states, aux)

    # -- the step ---------------------------------------------------------------
    def _replica_grads(self, r, cast, chunks, gen, gen_state, scale):
        """Replica r's local forward and backward: the compute-dtype
        parameters all-gathered from the cast master shards, the replica's
        batch shard through the one-device plan. Returns (loss, outputs,
        aux updates, the per-bucket flat gradients)."""
        L, dev = self._layout, self._devices[r]
        cdt = self._compute_dtype
        leaves = [None] * len(self._param_names)
        for b in range(L.n_buckets):
            full = all_gather(cast[b], devices=[dev])[0]
            for i, view in L.unflatten(full, b):
                leaves[i] = view.detach().requires_grad_(True)
        args = dict(zip(self._param_names, leaves))
        for name, parts in zip(self._input_names, chunks):
            v = parts[self._didx[r]].to(dev)
            if self._input_preproc is not None:
                v = self._input_preproc(name, v)
            if cdt is not None and name in self._data_names and \
                    v.is_floating_point():
                v = v.to(cdt)
            args[name] = v
        aux = {n: a.to(dev) for n, a in zip(self._aux_names, self._aux)}
        if gen is not None:
            # every replica draws what the others draw (the JAX step's
            # replicated key)
            gen.set_state(gen_state)
        _amp._set_trace_loss_scale(scale)
        try:
            with torch.enable_grad():
                outs, updates = self._plan.run(args, aux, dev, gen)
                loss = outs[self._loss_index].sum().to(torch.float32)
                obj = loss * scale if self._has_ls else loss
                grads = torch.autograd.grad(obj, leaves, allow_unused=True)
        finally:
            _amp._set_trace_loss_scale(None)
        with torch.no_grad():
            flats = [L.flatten([torch.zeros_like(leaves[i])
                                if grads[i] is None else grads[i]
                                for i in L.buckets[b]], b)
                     for b in range(L.n_buckets)]
            if self._model_factor > 1:
                # the T model replicas' equal gradients: the joint sum
                # counts each T times
                scale = 1.0 / self._model_factor
                flats = [g * scale for g in flats]
        return (loss.detach(), [o.detach() for o in outs],
                dict((n, v.detach()) for n, v in updates), flats)

    def _compress_(self, flats, r, new_resid):
        """Error feedback and the wire cast of replica r's flat gradients,
        in place in ``flats``: acc = g + residual, the wire value
        c = acc in the wire dtype, the new residual acc - c."""
        for b, g in enumerate(flats):
            acc = g.to(torch.float32) + self._resid[b][r]
            c = cast_wire(acc, self._wire_dtype)
            nr = acc - c.to(torch.float32)
            if new_resid is None:
                self._resid[b][r].copy_(nr)
            else:
                new_resid[b][r] = nr
            flats[b] = c

    def _one(self, inputs):
        """One ZeRO step on the trainer's state, in place. Returns (loss,
        outputs)."""
        L, n = self._layout, self._n_dev
        cdt, has_ls, wire = self._compute_dtype, self._has_ls, self._wire_dtype
        scale = self._ls_dev[0] if has_ls else None
        # [1] each master shard in the compute dtype, cast before the
        # gather (a bf16 gather moves half-width words)
        cast = [[m if cdt is None else m.to(cdt) for m in self._params[b]]
                for b in range(L.n_buckets)]
        self._flops = self._step_costs(
            {nm: tuple(x.shape) for nm, x in zip(self._input_names,
                                                 inputs)})["flops"]
        chunks = [torch.chunk(x, self._n_data, dim=0) for x in inputs]
        gen = self._rng()
        gen_state = gen.get_state() if gen is not None else None
        # a skipped fp16 step must leave the residual as it was: keep the
        # new one aside until the finiteness is known
        new_resid = [[None] * n for _ in range(L.n_buckets)] \
            if wire is not None and has_ls else None
        losses, outs, auxes = [], [], []
        gflat = [[None] * n for _ in range(L.n_buckets)]
        for r in range(n):
            loss, o, upd, flats = self._replica_grads(r, cast, chunks, gen,
                                                      gen_state, scale)
            with torch.no_grad():
                if wire is not None:
                    self._compress_(flats, r, new_resid)
            for b, g in enumerate(flats):
                gflat[b][r] = g
            losses.append(loss)
            outs.append(o)
            auxes.append(upd)
        del cast
        with torch.no_grad():
            return self._reduce_update(gflat, new_resid, losses, outs,
                                       auxes, scale)

    def _reduce_update(self, gflat, new_resid, losses, outs, auxes, scale):
        L = self._layout
        n, devs, dev0 = self._n_dev, self._devices, self._device
        has_ls = self._has_ls
        # [2] per bucket: the sum in the wire (or compute) dtype, from the
        # last replica to the first (dp's autograd order), one slice a
        # replica (stage 2), or the whole sum and the own slice (stage 1)
        order = range(n - 1, -1, -1)
        gsh = []
        for b in range(L.n_buckets):
            if self._zero_stage >= 2:
                parts = psum_scatter(gflat[b], 0, order=order)
            else:
                sl = L.shard_len[b]
                parts = [t[k * sl:(k + 1) * sl] for k, t in
                         enumerate(psum(gflat[b], order=order))]
            gsh.append([p.to(torch.float32) for p in parts])
            gflat[b] = None
        finite = None
        if has_ls:
            # the skip is global: stage-2 slices differ a replica
            finite = torch.stack([torch.isfinite(g).all().to(dev0)
                                  for gs in gsh for g in gs]).all()
            self._t_dev.add_(finite.to(torch.float32))
            inv_scale = 1.0 / scale
        else:
            self._t_dev.add_(1.0)
        lr = self._lr_dev
        if self._is_adam:
            b1, b2 = self._attrs["beta1"], self._attrs["beta2"]
            lr = lr * torch.sqrt(1.0 - torch.pow(b2, self._t_dev)) \
                / (1.0 - torch.pow(b1, self._t_dev))
        fcompute = self._opt_schema.fcompute
        # [3] the elementwise update of each replica's own slice, in fp32
        for k, dev in enumerate(devs):
            attrs = AttrDict(self._attrs)
            attrs["lr"] = lr.to(dev)
            if self._has_t:
                attrs["t"] = self._t_dev.to(dev)
            octx = OpCtx(is_train=True, device=dev)
            fin = None if finite is None else finite.to(dev)
            keep = (lambda new, old: new) if fin is None else \
                (lambda new, old: torch.where(fin, new, old))
            for b in range(L.n_buckets):
                g = gsh[b][k]
                if has_ls:
                    g = g * inv_scale.to(dev)
                w = self._params[b][k]
                st = [s[k] for s in self._states[b]]
                res = fcompute(attrs, octx, w, g, *st)
                w.copy_(keep(res[0], w))
                for s, v in zip(st, res[1:]):
                    s.copy_(keep(v, s))
                if new_resid is not None:
                    r = self._resid[b][k]
                    r.copy_(keep(new_resid[b][k], r))
        # aux: an overflowed step keeps the old values; the replicas'
        # local statistics averaged back to one copy (pmean)
        first = self._first
        for i, name in enumerate(self._aux_names):
            if name not in auxes[0]:
                continue
            old = self._aux[i]
            vals = [auxes[r][name] if finite is None else
                    torch.where(finite.to(devs[r]), auxes[r][name],
                                old.to(devs[r])) for r in first]
            old.copy_(pmean(vals, devices=[dev0], count=False)[0])
        if has_ls:
            self._ls_dev.copy_(self._scaler.update_state(self._ls_dev,
                                                         finite))
        loss = sum_to([losses[r] for r in first], dev0)
        outputs = [torch.cat([outs[r][i].to(dev0) for r in first], 0)
                   for i in range(len(outs[0]))]
        self._tick_counters(1)
        return loss, outputs

    def _tick_counters(self, k):
        L = self._layout
        ag, red = L.wire_bytes_breakdown(self._zero_stage,
                                         self._compute_itemsize,
                                         self._wire_itemsize)
        _COUNTERS["zero_wire_bytes"] += (ag + red) * int(k)
        _COUNTERS["zero_wire_allgather_bytes"] += ag * int(k)
        _COUNTERS["zero_wire_reduce_bytes"] += red * int(k)
        _COUNTERS["zero_steps"] += int(k)
        _COUNTERS["zero_overlap_frac"] = L.overlap_frac()
        _COUNTERS["zero_stage"] = self._zero_stage
        _COUNTERS["zero_buckets"] = L.n_buckets
        _COUNTERS["zero_compress_bits"] = self._wire_itemsize * 8
        # a replica's FLOPs of one step, counted by telemetry.costs
        _COUNTERS["zero_flops_per_step"] = self._flops

    def wire_bytes_per_step(self):
        """The layout's analytic wire bytes of one step of this trainer."""
        return self._layout.wire_bytes_per_step(
            self._zero_stage, self._compute_itemsize, self._wire_itemsize)

    # -- views and the checkpoint round trip ----------------------------------
    def _whole(self, shards, b):
        """Bucket b's flat float32 tensor on the mesh's first device."""
        return torch.cat([s.detach().to(self._device, torch.float32)
                          for s in shards])[:self._layout.totals[b]]

    def _unflat_named(self, buckets):
        out = {}
        for b, shards in enumerate(buckets):
            for i, view in self._layout.unflatten(self._whole(shards, b),
                                                  b):
                out[self._param_names[i]] = view
        return out

    def device_params(self, params):
        """name -> full per-parameter float32 tensors on the mesh's first
        device, unflattened from the bucket shards (new tensors)."""
        return self._unflat_named(params)

    def host_params(self, params):
        """name -> full per-parameter float32 host arrays."""
        return {n: t.to("cpu").numpy().copy()
                for n, t in self.device_params(params).items()}

    def export_training_state(self, params, states, aux):
        """dp's array names (param:/opt:/aux:), so ZeRO commits restore
        into plain dp and back, and into the JAX package; meta gains the
        zero block (stage, compress, bucket bytes, ownership) and, under
        compression, ``zero_resid:{b}`` (n_dev, padded) holds the
        replicas' residuals."""
        L = self._layout
        arrays = {f"param:{n}": t
                  for n, t in self.device_params(params).items()}
        for j in range(self._n_states):
            st = self._unflat_named([s[j] for s in states])
            for n, t in st.items():
                arrays[f"opt:{n}:{j}"] = t
        for n, a in zip(self._aux_names, aux):
            arrays[f"aux:{n}"] = _tensor(a).detach().clone()
        meta = self._export_meta()
        meta["zero"] = {
            "stage": self._zero_stage,
            "compress": self._compress,
            "bucket_bytes": self._bucket_bytes,
            "ownership": L.ownership(self._param_names, self._n_states),
        }
        if self._wire_dtype is not None:
            for b, rs in enumerate(self._resid):
                arrays[f"zero_resid:{b}"] = torch.stack(
                    [r.to(self._device) for r in rs])
        return arrays, meta

    def import_training_state(self, arrays, meta):
        """Inverse of :meth:`export_training_state` from a ZeRO or plain
        dp snapshot of either package: repacked into this trainer's
        buckets; t and the fp16 scaler restored. The residuals are taken
        when the snapshot has them at this layout, else they start at
        zero (another replica count, another bucket size, a plain-dp or
        uncompressed snapshot: a bounded one-step compression error, not
        a wrong state)."""
        hp = [arrays[f"param:{n}"] for n in self._param_names]
        hs = [[arrays[f"opt:{n}:{j}"] for j in range(self._n_states)]
              for n in self._param_names]
        aux = [arrays[f"aux:{n}"] for n in self._aux_names]
        out = self._pack(hp, hs, aux)
        self._import_scalar_state(meta)
        if self._wire_dtype is not None:
            L = self._layout
            resid = []
            for b in range(L.n_buckets):
                r = arrays.get(f"zero_resid:{b}")
                if r is None or tuple(r.shape) != (self._n_dev,
                                                   L.padded[b]):
                    break
                r = _tensor(r).to(torch.float32)
                resid.append(tuple(r[k].to(d, copy=True)
                                   for k, d in enumerate(self._devices)))
            if len(resid) == L.n_buckets:
                self._resid = tuple(resid)
        return out


# ============================================================================
# CLI: --selftest / --bench / --hlo-check
# ============================================================================

def _wide_sym(dim=64, hidden=256, nclass=16):
    from .. import symbol as sym_mod
    net = sym_mod.FullyConnected(sym_mod.Variable("data"),
                                 num_hidden=hidden, name="zfc1")
    net = sym_mod.Activation(net, act_type="relu")
    net = sym_mod.FullyConnected(net, num_hidden=hidden, name="zfc2")
    net = sym_mod.Activation(net, act_type="relu")
    net = sym_mod.FullyConnected(net, num_hidden=nclass, name="zfc3")
    return sym_mod.SoftmaxOutput(net, name="softmax")


def _make_trainer(sym, mesh, stage, compress="none", dtype="float32",
                  batch=16, optimizer="sgd", bucket_mb=0.002, **kw):
    """stage 0: the plain dp baseline; > 0: a ZeroTrainer. The tiny
    default bucket threshold makes the selftest MLPs multi-bucket."""
    common = dict(optimizer=optimizer, learning_rate=0.1,
                  rescale_grad=1.0 / batch, dtype=dtype, **kw)
    if optimizer == "sgd":
        common["momentum"] = 0.9
    if stage == 0:
        return DataParallelTrainer(sym, mesh, zero_stage=0, **common)
    return ZeroTrainer(sym, mesh, zero_stage=stage, grad_compress=compress,
                       zero_bucket_mb=bucket_mb, **common)


def _ce_of(outs, y, n):
    p = outs[0].detach().to("cpu", torch.float32).numpy()
    return float(-_np.log(p[_np.arange(n), y.astype(int)] + 1e-8).mean())


def _cli_mesh(ctx, devices):
    """``devices`` replicas: host replicas with ``ctx="cpu"``, else the
    visible cards in turn, each listed again when there are fewer cards
    than replicas (one card: n replicas of it)."""
    from .mesh import build_mesh, mesh_for_contexts
    if ctx == "cpu":
        from ..context import cpu
        return mesh_for_contexts([cpu(i) for i in range(devices)])
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device: pass --ctx cpu for host replicas")
    cards = torch.cuda.device_count()
    return build_mesh({"data": devices},
                      [torch.device("cuda", i % cards)
                       for i in range(devices)])


def selftest(devices=2, ctx="gpu"):
    """An A/B against plain dp, one ``zero_selftest`` JSON line:
    (1) float32 stage 1 bit-identical to dp after 20 steps; (2) stage 2
    equal to stage 1; (3) stage 2 with the fp8 wire: the cross-entropy
    falls over 60 steps and the residual is non-zero; (4) the analytic
    wire: stage 2 below stage 1, fp8 a quarter of float32's reduce."""
    import json
    mesh = _cli_mesh(ctx, devices)
    n_dev = len(mesh.replicas)
    batch, dim, nclass = 16, 64, 16
    rng = _np.random.RandomState(0)
    x = rng.normal(size=(batch, dim)).astype(_np.float32)
    y = rng.randint(0, nclass, size=(batch,)).astype(_np.float32)
    sym = _wide_sym(dim=dim, nclass=nclass)
    results = {"metric": "zero_selftest", "devices": n_dev,
               "device": str(mesh.replicas[0])}

    def _train(stage, compress="none", steps=20):
        tr = _make_trainer(sym, mesh, stage, compress=compress, batch=batch)
        params, states, aux = tr.init_state(
            {"data": (batch, dim), "softmax_label": (batch,)})
        inputs = tr.shard_inputs([x, y])
        ces = []
        for _ in range(steps):
            params, states, aux, _, outs = tr.step(params, states, aux,
                                                   inputs)
            ces.append(_ce_of(outs, y, batch))
        return tr, tr.host_params(params), ces

    _, h0, _ = _train(0)
    tr1, h1, _ = _train(1)
    _, h2, _ = _train(2)
    results["stage1_fp32_bitwise"] = bool(
        all(_np.array_equal(h0[n], h1[n]) for n in h0))
    results["stage2_equals_stage1"] = bool(
        all(_np.array_equal(h1[n], h2[n]) for n in h1))
    tr8, _, ce8 = _train(2, compress="fp8", steps=60)
    resid = float(sum(r.abs().sum().item() for rs in tr8._resid
                      for r in rs))
    results["fp8_ce_first"] = ce8[0]
    results["fp8_ce_last"] = ce8[-1]
    results["fp8_converges"] = bool(_np.isfinite(ce8[-1])
                                    and ce8[-1] < ce8[0])
    results["fp8_residual_nonzero"] = bool(resid > 0)
    L = tr1.layout
    w1 = L.wire_bytes_breakdown(1, 4, 4)[1]
    w2 = L.wire_bytes_breakdown(2, 4, 4)[1]
    w8 = L.wire_bytes_breakdown(2, 4, 1)[1]
    results["wire_reduce_bytes"] = {"zero1": w1, "zero2": w2,
                                    "zero2_fp8": w8}
    results["wire_reduced"] = bool(n_dev == 1 or (w2 < w1
                                                  and 4 * w8 <= w1))
    results["wire_source"] = "analytic"
    keys = ("stage1_fp32_bitwise", "stage2_equals_stage1", "fp8_converges",
            "fp8_residual_nonzero", "wire_reduced")
    results["ok"] = bool(all(results[k] for k in keys))
    print(json.dumps(results), flush=True)
    return 0 if results["ok"] else 1


def bench(devices=4, steps=12, hidden=1024, batch=16, ctx="gpu"):
    """dp against ZeRO-1, ZeRO-2 and ZeRO-2 + fp8 over ``devices``
    replicas (of the card, or of the host with ``ctx="cpu"``): a
    big-parameter Adam MLP, steps/s (the median of 3 windows after 2
    warm-up steps, each window ending on a read of its last loss) and the
    analytic wire bytes a step. One ``zero_bench`` JSON line."""
    import json
    import time
    mesh = _cli_mesh(ctx, devices)
    n_dev = len(mesh.replicas)
    dim, nclass = 256, 16
    sym = _wide_sym(dim=dim, hidden=hidden, nclass=nclass)
    rng = _np.random.RandomState(0)
    x = rng.normal(size=(batch, dim)).astype(_np.float32)
    y = rng.randint(0, nclass, size=(batch,)).astype(_np.float32)

    def _arm(stage, compress):
        tr = _make_trainer(sym, mesh, stage, compress=compress,
                           batch=batch, optimizer="adam", bucket_mb=1.0)
        params, states, aux = tr.init_state(
            {"data": (batch, dim), "softmax_label": (batch,)})
        inputs = tr.shard_inputs([x, y])
        for _ in range(2):
            params, states, aux, loss, _ = tr.step(params, states, aux,
                                                   inputs)
        float(loss)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                params, states, aux, loss, _ = tr.step(params, states, aux,
                                                       inputs)
            float(loss)
            rates.append(steps / (time.perf_counter() - t0))
        if stage == 0:
            # dp's all-reduce of float32 gradients, by the same ring
            # accounting (no gather: the params are replicated)
            L = ZeroLayout([tuple(p.shape) for p in params], n_dev, 1 << 20)
            wire = L.wire_bytes_breakdown(1, 4, 4)[1]
        else:
            wire = tr.wire_bytes_per_step()
        return sorted(rates)[1], wire

    arms = {"dp": (0, "none"), "zero1": (1, "none"), "zero2": (2, "none"),
            "zero2_fp8": (2, "fp8")}
    got = {k: _arm(*v) for k, v in arms.items()}
    n_params = sum(int(_np.prod(s)) for n, s in zip(
        sym.list_arguments(),
        sym.infer_shape(data=(batch, dim), softmax_label=(batch,))[0])
        if n not in ("data", "softmax_label"))
    rec = {"metric": "zero_bench", "devices": n_dev,
           "device": str(mesh.replicas[0]), "params": int(n_params),
           "optimizer": "adam", "batch": batch, "steps_per_window": steps}
    for k, (sps, wire) in got.items():
        rec[f"{k}_steps_per_s"] = round(sps, 2)
        rec[f"wire_bytes_per_step_{k}"] = int(wire)
        if k != "dp":
            rec[f"speedup_{k}"] = round(sps / got["dp"][0], 3)
    rec["wire_source"] = "analytic"
    rec["ok"] = bool(all(_np.isfinite(v[0]) for v in got.values()))
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


def main(argv=None):
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.parallel.zero")
    ap.add_argument("--selftest", action="store_true",
                    help="A/B against unsharded dp")
    ap.add_argument("--hlo-check", action="store_true",
                    help="(the JAX package's HLO check: not available)")
    ap.add_argument("--bench", action="store_true",
                    help="dp vs ZeRO-1/2/fp8 steps/s + wire bytes")
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--devices", type=int, default=None,
                    help="replicas (default: 2 for --selftest, 4 for "
                         "--bench)")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)
    if args.hlo_check:
        print("zero --hlo-check reads the step's collectives and wire "
              "bytes out of XLA's post-partitioning HLO; the port compiles "
              "no HLO (its wire bytes are ZeroLayout.wire_bytes_per_step's, "
              "as --bench reports)", file=sys.stderr)
        return 2
    if args.bench:
        return bench(devices=args.devices or 4, steps=args.steps,
                     ctx=args.ctx)
    if args.selftest:
        return selftest(args.devices or 2, ctx=args.ctx)
    ap.print_help()
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
