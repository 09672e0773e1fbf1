"""Executor — binds a Symbol to arrays on one device and runs it
(counterpart of mxnet_tpu/executor.py).

The JAX package lowers the graph into one compiled function; here the
executor walks the topological order once per call, calling each op's
fcompute on tensors (``_build_runner``'s role, ``_Plan`` below). A
training forward runs under ``torch.enable_grad()`` with the
differentiated arguments as fresh leaves (detached views of the bound
arrays: no copy), so autograd records the step; any other forward runs
under ``torch.no_grad()`` and keeps no graph. ``backward`` reads the
gradients with ``torch.autograd.grad`` (loss heads seeded with ones, as
the JAX package does) and assigns them (``grad_req="write"``) or adds
them (``"add"``) into ``grad_dict``; nothing is left in ``.grad``. The
recorded graph lives until that backward or the next forward, whichever
comes first.

Two graph passes pick the same nodes as the JAX package's:
``_fuse_bn_relu`` folds an Activation('relu') into the BatchNorm that
feeds only it, and ``_dead_bias_convs`` gives a Convolution or
FullyConnected whose only consumer is a batch-statistics BatchNorm an
exact-zero bias gradient.

A data-parallel executor (``simple_bind(..., mesh=, sharded_args=)``,
Module over several contexts) keeps the JAX package's single program
over the mesh: one walk of the graph a call over the mesh's replicas in
lock step (``_run_mesh``). Each replica gets its equal shard of the
``sharded_args`` (axis 0) and a differentiable copy of every other
argument and aux state; the bound arrays stay single global arrays on
the first context's device, the counterpart of JAX's global arrays.
Whatever reduces over the batch axis reduces over the whole batch, as
GSPMD's inserted all-reduce makes it in the JAX package: BatchNorm's
training statistics and a loss head's normalisation (the ops' ``fmesh``
hooks), the parameter gradients (autograd sums the replicas' copies into
the one leaf) and the outputs (concatenated). Any other op that takes a
batch-carrying value must compute each sample alone and keep the batch
on axis 0 (``_per_sample_rules``: elementwise ops, Convolution, Pooling,
FullyConnected, a Reshape that keeps dim 0, softmax off axis 0, ...);
else it raises on a mesh instead of computing on one shard. A one-device
mesh is the one-device executor.

Not ported (each raises instead of being ignored): ``group2ctx`` model
parallelism (ROADMAP queue 1 item 8) and ``MXNET_BACKWARD_DO_MIRROR``.
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from .base import MXNetError
from .context import current_context, resolve_device
from .ops.registry import OpCtx

__all__ = ["Executor"]


def _graph_consumers(symbol, topo):
    """(node-output -> consumer nodes) index + the symbol's output set."""
    consumers = {}
    for n in topo:
        if n.op is None:
            continue
        for (src, i) in n.inputs:
            consumers.setdefault((id(src), i), []).append(n)
    out_entries = {(id(n), i) for (n, i) in symbol._outputs}
    return consumers, out_entries


def _fuse_bn_relu(symbol, topo):
    """BN+ReLU fusion pass: Activation('relu') nodes whose sole input is
    the data output of a BatchNorm that nothing else consumes. The BN
    then applies the relu and masks dy in its backward (ops/nn.py
    ``_BNTrain``). Returns (fused BN node ids, {relu id: bn id})."""
    consumers, out_entries = _graph_consumers(symbol, topo)
    fused, passthrough = set(), {}
    for n in topo:
        if n.op is None or n.op.name != "Activation":
            continue
        if n.attrs.get("act_type") != "relu":
            continue
        src, i = n.inputs[0]
        if i != 0 or src.op is None or src.op.name != "BatchNorm":
            continue
        if len(consumers.get((id(src), 0), [])) != 1 or \
                (id(src), 0) in out_entries:
            continue
        if n.user_attrs.get("ctx_group") != src.user_attrs.get("ctx_group"):
            continue
        fused.add(id(src))
        passthrough[id(n)] = id(src)
    return fused, passthrough


def _dead_bias_convs(symbol, topo):
    """Convolution / FullyConnected nodes whose bias gradient is exactly
    zero: a training-mode BatchNorm (batch statistics) on the same
    channel axis is their only consumer, and mean subtraction cancels a
    per-channel shift."""
    consumers, out_entries = _graph_consumers(symbol, topo)
    dead = set()
    for n in topo:
        if n.op is None or n.op.name not in ("Convolution",
                                             "FullyConnected"):
            continue
        if len(n.inputs) < 3:   # no_bias
            continue
        cons = consumers.get((id(n), 0), [])
        if len(cons) != 1 or (id(n), 0) in out_entries:
            continue
        bn = cons[0]
        if bn.op is None or bn.op.name != "BatchNorm":
            continue
        battrs = bn.op.parse_attrs(bn.attrs)
        if battrs["use_global_stats"]:
            continue
        if bn.inputs[0][0] is not n:
            continue
        # the bias must broadcast on the BN's channel axis: NCHW convs on
        # axis 1; FC on its last axis ((N, nh) when flatten, so 1 or -1)
        if n.op.name == "Convolution" and battrs["axis"] != 1:
            continue
        if n.op.name == "FullyConnected":
            fattrs = n.op.parse_attrs(n.attrs)
            if fattrs["flatten"]:
                if battrs["axis"] not in (1, -1):
                    continue
            elif battrs["axis"] != -1:
                continue
        dead.add(id(n))
    return dead


def _reduces_axis0(attrs, ndim):
    from .ops.tensor import _norm_axes
    axes = attrs["axis"]
    if axes is None and not attrs.get("exclude"):
        return True
    return 0 in _norm_axes(axes, ndim, attrs.get("exclude", False))


def _axis_not0(key):
    return lambda a, carried, xs: (a[key] is not None
                                   and a[key] % xs[0].ndim != 0)


@functools.lru_cache(maxsize=None)
def _per_sample_rules():
    """op name -> rule(attrs, positions of the inputs that carry the
    batch, the inputs): true where the op computes each sample from that
    sample alone and keeps the batch on axis 0. On a data-parallel mesh
    an op that takes a batch-carrying input and is neither here (with its
    rule true) nor has an ``fmesh`` hook raises (``_Plan.run_replicas``):
    run on one shard a replica it would give another result than the JAX
    package's one global array."""
    from .ops.tensor import ELEMENTWISE

    def always(a, carried, xs):
        return True

    def data_only(a, carried, xs):
        return carried == {0}

    def reduce_(a, carried, xs):
        return not _reduces_axis0(a, xs[0].ndim)

    def dot(a, carried, xs):
        return carried == {0} and not a["transpose_a"] and xs[0].ndim > 1

    def take(a, carried, xs):
        if 0 in carried:       # the data carries: gather off the batch
            return 1 not in carried and a["axis"] % xs[0].ndim != 0
        return a["axis"] % xs[0].ndim == 0      # indices carry

    def pick(a, carried, xs):
        return a["axis"] is not None and a["axis"] % xs[0].ndim != 0

    def transpose(a, carried, xs):
        return bool(a["axes"]) and a["axes"][0] % xs[0].ndim == 0

    def expand_dims(a, carried, xs):
        return a["axis"] % (xs[0].ndim + 1) != 0

    def squeeze(a, carried, xs):
        return a["axis"] is not None and all(
            ax % xs[0].ndim != 0 for ax in a["axis"])

    def slice_(a, carried, xs):
        begin, end, step = a["begin"], a["end"], a["step"] or ()
        return not begin or (begin[0] in (None, 0)
                             and (len(end) == 0 or end[0] is None)
                             and (len(step) == 0 or step[0] in (None, 1)))

    def norm(a, carried, xs):
        return a["axis"] is not None and not _reduces_axis0(a, xs[0].ndim)

    rules = {n: always for n in ELEMENTWISE}
    rules.update({n: data_only for n in (
        "Activation", "Dropout", "Flatten", "Pooling", "Convolution",
        "FullyConnected", "argmax_channel", "one_hot")})
    rules.update({n: reduce_ for n in (
        "sum", "_square_sum", "mean", "prod", "nansum", "nanprod", "max",
        "min")})
    rules.update({
        # a row-major reshape that keeps dim 0 keeps each sample's row
        # (the output check below holds dim 0)
        "Reshape": always, "broadcast_to": always, "batch_dot": always,
        "softmax": _axis_not0("axis"), "log_softmax": _axis_not0("axis"),
        "argmax": _axis_not0("axis"), "argmin": _axis_not0("axis"),
        "Concat": _axis_not0("dim"), "slice_axis": _axis_not0("axis"),
        "norm": norm, "dot": dot, "take": take, "pick": pick,
        "transpose": transpose, "expand_dims": expand_dims,
        "squeeze": squeeze, "slice": slice_})
    return rules


def _check_per_sample(op, attrs, name, carried, xs, outs=None):
    """Raise unless ``op`` runs per sample on a batch-carrying input
    (``_per_sample_rules``); with ``outs`` (the first replica's results),
    unless each output keeps the shard's batch on axis 0 (an elementwise
    op also its rank, so broadcasting cannot move the batch)."""
    b = xs[min(carried)].shape[0] if xs[min(carried)].ndim else None
    if outs is None:
        rule = _per_sample_rules().get(op.name)
        ok = b is not None and rule is not None and rule(attrs, carried, xs)
    else:
        from .ops.tensor import ELEMENTWISE
        rank = max(xs[j].ndim for j in carried)
        ok = all(o.ndim >= 1 and o.shape[0] == b
                 and (op.name not in ELEMENTWISE or o.ndim == rank)
                 for o in outs)
    if not ok:
        raise MXNetError(
            f"{op.name} ({name}) on a data-parallel mesh: with these attrs "
            "it mixes samples or moves the batch axis of a sharded value, "
            "and each replica holds one shard; only per-sample ops and "
            "ops with a whole-batch hook (BatchNorm, SoftmaxOutput) run "
            "there")


class _Plan:
    """One walk of the graph for a mode (training or not), resolved once:
    each op's parsed attrs (with the passes' flags), where its inputs come
    from, and which aux states it updates."""

    def __init__(self, symbol, is_train, fuse=True):
        topo = symbol._topo()
        _, aux_n = symbol._input_vars()
        aux_ids = {id(n): n.name for n in aux_n}
        pos = {id(n): i for i, n in enumerate(topo)}
        fused, passthrough = _fuse_bn_relu(symbol, topo) if fuse \
            else (set(), {})
        dead = _dead_bias_convs(symbol, topo) if is_train and fuse else set()
        self.n = len(topo)
        self.is_train = is_train
        self.variables = []        # (pos, "arg" | "aux", name)
        self.steps = []
        self.needs_rng = False
        for p, node in enumerate(topo):
            if node.op is None:
                kind = "aux" if id(node) in aux_ids else "arg"
                self.variables.append((p, kind, node.name))
                continue
            ins = [(pos[id(n2)], i2) for (n2, i2) in node.inputs]
            if id(node) in passthrough:
                self.steps.append((p, None, None, ins, 1, (), node.name))
                continue
            parsed = node.op.parse_attrs(node.attrs)
            if id(node) in fused:
                parsed["__fuse_relu__"] = True
            if id(node) in dead:
                parsed["__bias_grad_dead__"] = True
            n_out = node.num_outputs()
            aux_writes = ()
            if node.op.mutates_aux and (is_train or node.op.aux_always):
                aux_writes = tuple(
                    (n_out + j, aux_ids[id(node.inputs[ai][0])])
                    for j, ai in enumerate(node.op.aux_indices)
                    if id(node.inputs[ai][0]) in aux_ids)
            self.needs_rng |= node.op.needs_rng
            self.steps.append((p, node.op, parsed, ins, n_out, aux_writes,
                               node.name))
        self.outputs = [(pos[id(n)], i) for (n, i) in symbol._outputs]

    def run(self, args, aux, device, rng=None, monitor=None):
        """args / aux: name -> tensor. Returns (outputs, [(aux name, new
        value)])."""
        vals = [None] * self.n
        for p, kind, name in self.variables:
            vals[p] = ((aux if kind == "aux" else args)[name],)
        octx = OpCtx(is_train=self.is_train, rng=rng, device=device)
        updates = []
        for p, op, parsed, ins, n_out, aux_writes, name in self.steps:
            xs = [vals[q][i] for (q, i) in ins]
            if op is None:               # relu folded into its BatchNorm
                vals[p] = (xs[0],)
                continue
            res = op.fcompute(parsed, octx, *xs)
            vals[p] = res[:n_out]
            for j, aux_name in aux_writes:
                updates.append((aux_name, res[j]))
            if monitor is not None:
                for i in range(n_out):
                    monitor(f"{name}_output{i}" if n_out > 1
                            else f"{name}_output", res[i])
        return [vals[q][i] for (q, i) in self.outputs], updates

    def batch_carriers(self, sharded):
        """Positions whose values carry the batch axis of the ``sharded``
        arguments (an op's outputs do when any input does)."""
        carry = {p for p, kind, name in self.variables
                 if kind == "arg" and name in sharded}
        for p, op, parsed, ins, *_ in self.steps:
            if any(q in carry for q, _ in ins):
                carry.add(p)
        return carry

    def run_replicas(self, replicas, devices, carry, rng=None):
        """One walk over a mesh's replicas in lock step. ``replicas``: one
        (args, aux) pair of name -> tensor dicts a replica. An op with an
        ``fmesh`` hook sees every replica's inputs at once; any other op
        runs on each replica. Returns (each replica's outputs, [(aux name,
        new value)] of the first replica: the hooks give every replica the
        same global values)."""
        n = len(devices)
        vals = [None] * self.n
        for p, kind, name in self.variables:
            vals[p] = [((a if kind == "aux" else g)[name],)
                       for g, a in replicas]
        octxs = [OpCtx(is_train=self.is_train, rng=rng, device=d)
                 for d in devices]
        updates = []
        for p, op, parsed, ins, n_out, aux_writes, name in self.steps:
            xs = [[vals[q][r][i] for (q, i) in ins] for r in range(n)]
            if op is None:
                vals[p] = [(x[0],) for x in xs]
                continue
            carried = {j for j, (q, _) in enumerate(ins) if q in carry}
            if op.fmesh is not None:
                res = op.fmesh(parsed, octxs[0], xs)
            elif carried:
                _check_per_sample(op, parsed, name, carried, xs[0])
                res = [op.fcompute(parsed, octxs[0], *xs[0])]
                _check_per_sample(op, parsed, name, carried, xs[0],
                                  res[0][:n_out])
                res += [op.fcompute(parsed, octxs[r], *xs[r])
                        for r in range(1, n)]
            else:
                res = [op.fcompute(parsed, octxs[r], *xs[r])
                       for r in range(n)]
            vals[p] = [r_[:n_out] for r_ in res]
            for j, aux_name in aux_writes:
                updates.append((aux_name, res[0][j]))
        return [[vals[q][r][i] for (q, i) in self.outputs]
                for r in range(n)], updates


def _run_mesh(plan, args, aux, devices, sharded, rng=None):
    """A walk of ``plan`` over a mesh's replica ``devices``: ``args`` /
    ``aux`` are the global name -> tensor dicts on ``devices[0]``; each
    replica gets its equal shard (axis 0) of the ``sharded`` arguments and
    a differentiable copy (``Tensor.to``) of every other value, so
    autograd sums the replicas' gradients into the global tensors.
    Outputs that carry the batch axis are concatenated onto
    ``devices[0]``, others are the first replica's. One device: the plain
    walk. Returns (outputs, aux updates)."""
    if len(devices) == 1:
        return plan.run(args, aux, devices[0], rng)
    n = len(devices)
    chunks = {k: torch.chunk(v, n, dim=0) for k, v in args.items()
              if k in sharded}
    replicas = [({k: (chunks[k][r] if k in chunks else v).to(d)
                  for k, v in args.items()},
                 {k: v.to(d) for k, v in aux.items()})
                for r, d in enumerate(devices)]
    carry = plan.batch_carriers(sharded)
    outs, updates = plan.run_replicas(replicas, devices, carry, rng)
    dev0 = devices[0]
    merged = [torch.cat([o[i].to(dev0) for o in outs], 0)
              if plan.outputs[i][0] in carry else outs[0][i]
              for i in range(len(plan.outputs))]
    return merged, updates


def _unsupported(what, item):
    return MXNetError(f"{what} is not ported yet (ROADMAP queue 1 item "
                      f"{item}); it is refused rather than ignored")


class Executor:
    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req_dict,
                 aux_dict, mesh=None, sharded_args=(), group2ctx=None):
        from . import config
        if group2ctx:
            raise _unsupported("group2ctx model parallelism", 8)
        if config.get("MXNET_BACKWARD_DO_MIRROR"):
            raise MXNetError("MXNET_BACKWARD_DO_MIRROR (activation "
                             "mirroring) is not ported; unset it")
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self._device = resolve_device(self._ctx)
        # a data-parallel mesh: the replicas' devices (one: no mesh)
        from .parallel.mesh import Mesh
        if mesh is not None and not isinstance(mesh, Mesh):
            raise MXNetError(f"mesh must be a parallel.Mesh, not "
                             f"{type(mesh).__name__}")
        self._mesh = mesh
        self._sharded_args = frozenset(sharded_args)
        self._replicas = mesh.replicas if mesh is not None \
            else [self._device]
        if self._replicas[0] != self._device:
            raise MXNetError(f"the mesh's first device "
                             f"{self._replicas[0]} is not the executor's "
                             f"{self._device}")
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self._grad_req = grad_req_dict
        self.aux_dict = aux_dict
        self.arg_arrays = [arg_dict[n] for n in self._arg_names]
        self.grad_arrays = [grad_dict.get(n) for n in self._arg_names]
        self.aux_arrays = [aux_dict[n] for n in self._aux_names]
        self.outputs = []
        self._plans = {}
        self._monitor_callback = None
        self._monitor_all = False
        self._pending = None          # (graph outputs, leaves) of a train fwd
        self._diff_names = [n for n in self._arg_names
                            if grad_req_dict.get(n, "null") != "null"]

    # -- construction --------------------------------------------------------
    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     mesh=None, sharded_args=(), group2ctx=None):
        from .ndarray import ndarray as ndmod
        if group2ctx:
            raise _unsupported("group2ctx model parallelism", 8)
        ctx = ctx or current_context()
        resolve_device(ctx)             # no card: raise before allocating
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        type_dict = type_dict or {}
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, dict):
            reqs = {n: grad_req.get(n, "null") for n in arg_names}
        else:
            reqs = dict(zip(arg_names, grad_req))
        arg_dict, grad_dict = {}, {}
        for n, s in zip(arg_names, arg_shapes):
            dt = type_dict.get(n, "float32")
            arg_dict[n] = ndmod.zeros(s, ctx=ctx, dtype=dt)
            if reqs[n] != "null":
                grad_dict[n] = ndmod.zeros(s, ctx=ctx, dtype=dt)
        aux_dict = {n: ndmod.zeros(s, ctx=ctx)
                    for n, s in zip(aux_names, aux_shapes)}
        return Executor(symbol, ctx, arg_dict, grad_dict, reqs, aux_dict,
                        mesh=mesh, sharded_args=sharded_args)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states,
              group2ctx=None):
        from .ndarray import ndarray as ndmod
        if group2ctx:
            raise _unsupported("group2ctx model parallelism", 8)
        ctx = ctx or current_context()
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_dict = dict(zip(arg_names, args)) \
            if isinstance(args, (list, tuple)) else dict(args)
        missing = [n for n in arg_names if n not in arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        if args_grad is None:
            grad_dict = {}
        elif isinstance(args_grad, (list, tuple)):
            grad_dict = dict(zip(arg_names, args_grad))
        else:
            grad_dict = dict(args_grad)
        if args_grad is None:
            req = {n: "null" for n in arg_names}
        elif isinstance(grad_req, str):
            req = {n: (grad_req if n in grad_dict else "null")
                   for n in arg_names}
        elif isinstance(grad_req, dict):
            req = {n: grad_req.get(n, "null") for n in arg_names}
        else:
            req = dict(zip(arg_names, grad_req))
        if aux_states is None:
            aux_dict = {}
            if aux_names:
                _, _, aux_shapes = symbol.infer_shape(
                    **{n: a.shape for n, a in arg_dict.items()})
                aux_dict = {n: ndmod.zeros(s, ctx=ctx)
                            for n, s in zip(aux_names, aux_shapes)}
        elif isinstance(aux_states, (list, tuple)):
            aux_dict = dict(zip(aux_names, aux_states))
        else:
            aux_dict = dict(aux_states)
        return Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict)

    # -- execution -------------------------------------------------------------
    def _plan(self, is_train):
        key = (is_train, self._monitor_callback is None)
        plan = self._plans.get(key)
        if plan is None:
            # a monitored forward runs the unfused graph, so tapped
            # BatchNorm outputs are pre-ReLU (as in the JAX package)
            plan = _Plan(self._symbol, is_train, fuse=key[1])
            self._plans[key] = plan
        return plan

    def _feed(self, name, value):
        """Copy an input into its bound array: host batches go to the card
        without a sync (asynchronous from pinned memory)."""
        from .ndarray.ndarray import NDArray
        if name not in self.arg_dict:
            raise MXNetError(f"forward: unknown argument {name}")
        dst = self.arg_dict[name]
        src = value._data if isinstance(value, NDArray) else value
        if not isinstance(src, torch.Tensor):
            src = _from_numpy(src)
        n = len(self._replicas)
        if name in self._sharded_args and n > 1 and src.ndim and \
                src.shape[0] % n != 0:
            raise MXNetError(
                f"forward: batch size {src.shape[0]} of '{name}' must be "
                f"divisible by the {n}-device mesh (pad or drop the last "
                "batch, e.g. NDArrayIter(..., last_batch_handle='discard'))")
        if tuple(src.shape) == dst.shape:
            dst._data.copy_(src.detach(), non_blocking=True)
        else:
            dst._data = src.detach().to(device=self._device,
                                        dtype=dst._data.dtype, copy=True)

    def forward(self, is_train=False, **kwargs):
        self._pending = None            # a graph not backed through is freed
        for k, v in kwargs.items():
            self._feed(k, v)
        plan = self._plan(bool(is_train))
        rng = None
        if plan.needs_rng:
            from . import random as _random
            rng = _random.generator(self._device)
        aux = {n: a._data for n, a in self.aux_dict.items()}
        monitor = self._monitor_fn()
        if monitor is not None and len(self._replicas) > 1:
            raise MXNetError("a monitor callback on a data-parallel mesh "
                             "executor is not ported")

        def run(args):
            if monitor is not None:
                return plan.run(args, aux, self._device, rng, monitor)
            return _run_mesh(plan, args, aux, self._replicas,
                             self._sharded_args, rng)
        if is_train and self._diff_names:
            leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                      for n in self._diff_names}
            args = {n: leaves.get(n, a._data)
                    for n, a in self.arg_dict.items()}
            with torch.enable_grad():
                outs, updates = run(args)
            self._pending = (outs, leaves)
        else:
            args = {n: a._data for n, a in self.arg_dict.items()}
            with torch.no_grad():
                outs, updates = run(args)
        with torch.no_grad():
            for name, value in updates:
                self.aux_dict[name]._data.copy_(value)
        from .ndarray.ndarray import NDArray
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def _monitor_fn(self):
        if self._monitor_callback is None:
            return None
        from .ndarray.ndarray import NDArray
        cb = self._monitor_callback
        return lambda name, t: cb(name, NDArray(t.detach()))

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward's outputs into
        ``grad_dict``. ``out_grads`` default to ones (a loss head such as
        SoftmaxOutput ignores them)."""
        from .ndarray.ndarray import NDArray
        if not self._diff_names:
            return                       # every grad_req is 'null'
        if self._pending is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cts = []
            for o, g in zip(outs, out_grads):
                g = g._data if isinstance(g, NDArray) else g
                if not isinstance(g, torch.Tensor):
                    g = _from_numpy(g)
                cts.append(g.to(device=o.device, dtype=o.dtype))
        heads = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if heads:
            grads = torch.autograd.grad(
                [o for o, _ in heads], [leaves[n] for n in names],
                grad_outputs=[c for _, c in heads], allow_unused=True)
        with torch.no_grad():
            for n, g in zip(names, grads):
                if n not in self.grad_dict:
                    continue
                # written into the bound buffer: autograd may hand one
                # tensor to several leaves (a + b), or the caller's own
                # out_grads, and the gradients must not alias them
                dst = self.grad_dict[n]._data
                if self._grad_req.get(n) == "add":
                    if g is not None:
                        dst.add_(g)
                elif g is None:          # disconnected: zero, as jax.vjp
                    dst.zero_()
                else:
                    dst.copy_(g)

    # -- parity helpers ------------------------------------------------------
    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` with every node's output on each
        forward (the unfused graph runs while a callback is set)."""
        if monitor_all:
            raise MXNetError("monitor_all (tapping node inputs) is not "
                             "ported; monitor outputs only")
        self._monitor_callback = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                _copy_value(v, self.arg_dict[k])
            elif not allow_extra_params:
                raise MXNetError(f"unknown parameter {k}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _copy_value(v, self.aux_dict[k])
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """An executor for new input shapes; arrays whose shape is
        unchanged are shared with this one."""
        from .ndarray import ndarray as ndmod
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        arg_dict, grad_dict = {}, {}
        for n, s in zip(self._arg_names, arg_shapes):
            old = self.arg_dict[n]
            if tuple(old.shape) == tuple(s):
                arg_dict[n] = old
                if n in self.grad_dict:
                    grad_dict[n] = self.grad_dict[n]
            else:
                arg_dict[n] = ndmod.zeros(s, ctx=self._ctx,
                                          dtype=old._data.dtype)
                if n in self.grad_dict:
                    grad_dict[n] = ndmod.zeros(s, ctx=self._ctx,
                                               dtype=old._data.dtype)
        aux_dict = {n: (self.aux_dict[n]
                        if tuple(self.aux_dict[n].shape) == tuple(s)
                        else ndmod.zeros(s, ctx=self._ctx))
                    for n, s in zip(self._aux_names, aux_shapes)}
        return Executor(self._symbol, self._ctx, arg_dict, grad_dict,
                        dict(self._grad_req), aux_dict, mesh=self._mesh,
                        sharded_args=self._sharded_args)


def _copy_value(src, dst):
    """Write an NDArray, tensor or numpy array into the NDArray ``dst``
    (cast to its dtype, moved to its device)."""
    from .ndarray.ndarray import NDArray
    t = src._data if isinstance(src, NDArray) else src
    if not isinstance(t, torch.Tensor):
        t = _from_numpy(t)
    if tuple(t.shape) != dst.shape:
        raise MXNetError(f"shape {tuple(t.shape)} does not match the bound "
                         f"{dst.shape}")
    with torch.no_grad():
        dst._data.copy_(t.detach())


def _from_numpy(a):
    """A host tensor over a numpy array (copied when the array is
    read-only or not contiguous: torch shares only writable memory)."""
    a = _np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = _np.array(a)
    return torch.from_numpy(a)
