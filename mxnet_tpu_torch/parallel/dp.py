"""Data-parallel training: one training step over a device mesh
(counterpart of mxnet_tpu/parallel/dp.py).

The JAX package compiles forward, backward, the gradient all-reduce and
the optimizer update into one sharded XLA program. Here the step is the
executor's walk of the graph over the mesh's replicas
(``executor._run_mesh``: the batch inputs split on axis 0, the whole
batch's BatchNorm statistics, the replicas' gradients summed into one
tensor by autograd), ``torch.autograd.grad`` of the summed loss head, and
the registered update op (``ops/optimizer_ops.py``) on each parameter, in
place. The learning rate and the step count live in device tensors that
the update reads, so a schedule never re-captures and Adam's bias
correction is computed on the device from ``t`` (the JAX package folds it
into lr the same way).

On a one-device CUDA mesh the step is a CUDA graph: captured at the first
step for each set of input shapes and dtypes (after a warm-up step on a
side stream whose effect on the state is undone), then replayed;
``step_k`` replays it K times, copying slice k of the stacked block into
the graph's static input before each replay, with no host sync inside the
K steps. A replay raises the kernel launch counters (the wrappers', the
libraries') by what the capture moved them, as the decode plans do. The
parameters, optimizer states and aux states the step updates are the
trainer's own tensors, which the graphs read and write in place:
a step returns those same tensors every time, so a caller that keeps a
step's parameters clones them. Tensors handed in that are not the
trainer's (from ``init_state``, ``import_training_state``, a caller's
copy) are copied into them first. On the CPU, and on a mesh of several
devices, the step runs eagerly (the several-card walk is untested: the
port has been run on one card).

``dtype="bfloat16"`` is multi-precision training: fp32 master parameters
cast to bf16 outside the loss (the gradient is bf16, the replicas' sum
too), float data inputs cast to bf16 after ``input_preproc`` (labels and
integer inputs never), aux states fp32, the gradient widened into the
fp32 update. ``dtype="float16"`` is the same in fp16 with dynamic loss
scaling (``amp.DynamicLossScaler``): the scaler's state is a 3-element
tensor on the device; the step backpropagates ``loss * scale`` (below a
legacy loss head, which drops its cotangent, the scale is injected into
the head's input instead), takes one device boolean of the scaled
gradients' finiteness, unscales in fp32, and writes each parameter,
optimizer state and aux state back through ``torch.where(finite, new,
old)``, so an overflowed step changes nothing but the scaler (scale
backed off, skip counted) and ``t`` advances only on applied steps. No
value is read on the host inside the step, so it is captured and
replayed like the others. The update is any of the JAX package's eight
fused optimizers (sgd with or without momentum, adam, rmsprop,
rmspropalex, ftrl, signsgd, signum, ftml): their states are zeros on the
device, and FTML's step count is the device tensor ``t``, as Adam's bias
correction is. ``zero_stage > 0`` (or ``MXNET_ZERO_STAGE``, or
``MXNET_PLAN=zero1|zero2``) makes a direct construction a
``parallel.zero.ZeroTrainer``, as in the JAX package: the same
constructor and step contract over sharded masters and optimizer
states.

``param_specs`` (name -> a spec: a tuple of axis names or None, the
port's spelling of a ``PartitionSpec``, e.g. ``("model", None)``) is
tensor parallelism on a data x model mesh: the listed parameters and
their optimizer states live split over the model axis (a parameter is a
tuple of its model shards, shard k held by the replicas of model index
k), the batch is split over the data axis, and the step walks the graph
through ``executor._run_tp`` (Megatron column- and row-parallel layers,
the collectives over each replica's model group). The replicas'
gradients meet in the shards (split parameters: over their data group)
and in the replicated tensors (over the whole mesh). ``param_specs=None``
is the data-parallel program, unchanged. When every replica of the mesh
is the one card (a mesh may list a card several times), the step is
still a CUDA graph.

Each dispatch hands ``telemetry.devstats.on_dispatch`` its step's costs
(``telemetry.costs``, per replica), which the step log turns into MFU,
and the step adds its gradients' all-reduce to the mesh's wire counter
(``mesh.add_wire``; a replay adds what its capture counted).
"""
from __future__ import annotations

import time
import warnings

import numpy as _np
import torch

from .. import amp as _amp
from .. import operator as _operator
from ..base import MXNetError
from ..executor import _Plan, _from_numpy, _run_mesh, _run_tp, _spec_dim
from ..ops.launches import add as _add_launches, counts as _launch_counts
from ..ops.registry import AttrDict, OpCtx, get_op
from . import mesh as _mesh
from .mesh import axis_size, data_axis, mesh_descriptor

__all__ = ["DataParallelTrainer"]

# optimizer name -> fused update op (ops/optimizer_ops.py)
_OPT_OPS = {
    "sgd": lambda kw: ("sgd_mom_update" if kw.get("momentum")
                       else "sgd_update"),
    "adam": "adam_update",
    "rmsprop": "rmsprop_update",
    "rmspropalex": "rmspropalex_update",
    "ftrl": "ftrl_update",
    "signsgd": "signsgd_update",
    "signum": "signum_update",
    "ftml": "ftml_update",
}
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class _Graph:
    """One captured training step: static inputs, the graph, its static
    loss and outputs, what its capture cost, and the kernel launches a
    replay makes (what the counters moved by across the capture, as the
    decode plans count them)."""

    def __init__(self, static_in, graph, loss, outputs, capture_s,
                 peak_bytes, launches, wire=0.0):
        self.static_in = static_in
        self.graph = graph
        self.loss = loss
        self.outputs = outputs
        self.capture_s = capture_s
        self.peak_bytes = peak_bytes
        self.launches = launches
        self.wire = wire
        self.replays = 0


class DataParallelTrainer:
    """A full training step for a Symbol over a 1-D data mesh.

    Parameters are replicated; the ``data_names`` / ``label_names``
    inputs are split on axis 0 over the mesh's replicas. The optimizer
    update (any of ``_OPT_OPS``) is part of the step; lr and the step
    count are device tensors, so schedules never re-capture."""

    def __new__(cls, *args, **kwargs):
        # zero_stage > 0 (argument, MXNET_ZERO_STAGE or a pure-zero
        # MXNET_PLAN) makes a direct construction the ZeRO trainer (same
        # constructor and step contract); subclasses construct themselves
        if cls is DataParallelTrainer:
            from .zero import ZeroTrainer, resolve_stage
            if resolve_stage(kwargs.get("zero_stage")) > 0:
                return object.__new__(ZeroTrainer)
        return object.__new__(cls)

    def __init__(self, symbol, mesh, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 learning_rate=0.01, momentum=0.0, wd=0.0, rescale_grad=None,
                 clip_gradient=None, loss_index=0, dtype="float32",
                 input_preproc=None, loss_scaler=None, param_specs=None,
                 zero_stage=None, zero_bucket_mb=None, grad_compress=None,
                 **opt_kwargs):
        # zero_stage / zero_bucket_mb / grad_compress belong to the ZeRO
        # trainer (``__new__``); as in the JAX package a stage-0 run may
        # keep them in its kwargs
        if dtype not in _DTYPES:
            raise MXNetError("DataParallelTrainer dtype must be float32, "
                             "bfloat16 or float16")
        if optimizer not in _OPT_OPS:
            raise MXNetError(
                f"DataParallelTrainer: fused optimizer {optimizer!r} not "
                f"supported ({sorted(_OPT_OPS)}); use Module+kvstore for "
                "host-updated optimizers")
        self._symbol = symbol
        self._mesh = mesh
        self._data_axis = data_axis(mesh)
        self._devices = mesh.replicas
        self._device = self._devices[0]
        arg_names = symbol.list_arguments()
        self._arg_names = arg_names
        self._aux_names = symbol.list_auxiliary_states()
        input_names = list(data_names) + list(label_names)
        self._input_names = [n for n in arg_names if n in input_names]
        self._param_names = [n for n in arg_names if n not in input_names]
        self._data_names = frozenset(data_names)
        self._sharded = frozenset(self._input_names)
        self._lr = float(learning_rate)
        self._t = 0.0
        self._loss_index = loss_index
        self._dtype = dtype
        self._compute_dtype = _DTYPES[dtype]
        self._compute_itemsize = 4 if self._compute_dtype is None else \
            torch.empty((), dtype=self._compute_dtype).element_size()
        self._input_preproc = input_preproc
        # fp16's 5-bit exponent: dynamic loss scaling with the skipped
        # step; bf16 keeps fp32's exponent and needs none
        self._has_ls = dtype == "float16"
        if self._has_ls and loss_scaler is None:
            loss_scaler = _amp.DynamicLossScaler()
        self._scaler = loss_scaler if self._has_ls else None
        # [scale, good, skipped] on the device, read by the captured step
        self._ls_dev = self._scaler.state0(self._device) \
            if self._has_ls else None
        if self._has_ls:
            _amp._register_scale_source(self)

        hp = dict(opt_kwargs)
        if momentum:
            hp["momentum"] = momentum
        opt_op = _OPT_OPS[optimizer]
        schema = get_op(opt_op(hp) if callable(opt_op) else opt_op)
        self._opt_schema = schema
        self._n_states = len(schema.input_names) - 2
        attr_kwargs = {k: v for k, v in
                       {"lr": self._lr, "wd": wd,
                        "rescale_grad": 1.0 if rescale_grad is None
                        else rescale_grad,
                        "clip_gradient": clip_gradient,
                        "t": 1 if "t" in schema.params else None}.items()
                       if k in schema.params and v is not None}
        attr_kwargs.update(hp)
        self._attrs = schema.parse_attrs(attr_kwargs)
        self._is_adam = optimizer == "adam"
        self._has_t = "t" in schema.params
        self._plan = _Plan(symbol, is_train=True)
        self._opname = schema.name
        self._specs = None
        self._split = {}           # param index -> its split dimension
        if param_specs:
            if "model" not in mesh.axis_names:
                raise MXNetError(f"param_specs need a mesh with a 'model' "
                                 f"axis, not {mesh.shape}")
            unknown = sorted(set(param_specs) - set(self._param_names))
            if unknown:
                raise MXNetError(f"param_specs name no parameter: "
                                 f"{unknown}")
            self._specs = {str(k): None if v is None else tuple(v)
                           for k, v in dict(param_specs).items()}
            self._model_size = axis_size(mesh, "model")
            coords = _mesh.replica_coords(mesh)
            # shard k lives on the first replica of model index k
            self._shard_dev = [next(self._devices[r]
                                    for r, c in enumerate(coords)
                                    if c["model"] == k)
                               for k in range(self._model_size)]
        self._costs = {}

        # the trainer's own state (see the module docstring) and the
        # device-carried scalars
        self._params = self._states = self._aux = None
        self._lr_dev = self._t_dev = None
        self._gen = None
        # CUDA graphs: (input shapes, dtypes) -> _Graph, one pool
        self._graphs = {}
        self._pool = None
        self.captures = 0
        self._eager = None

    # -- names --------------------------------------------------------------
    @property
    def param_names(self):
        return list(self._param_names)

    @property
    def input_names(self):
        return list(self._input_names)

    @property
    def aux_names(self):
        return list(self._aux_names)

    def _graphed(self):
        return self._device.type == "cuda" and all(
            d == self._device for d in self._devices) \
            and not self._eager_reason()

    def _eager_reason(self):
        """Why a step on the card runs eagerly instead of as a CUDA graph
        replay: a ``Custom`` op's host call cannot be captured. Said once,
        in a warning; ``graph_stats()["eager_reason"]`` keeps it."""
        if self._eager is None:
            types = _operator.custom_types(self._plan)
            self._eager = "" if not types else (
                "the graph holds Custom op(s) %s: their host calls cannot "
                "be captured in a CUDA graph, so each step runs eagerly on "
                "the card" % ", ".join(repr(t) for t in types))
            if self._eager and self._device.type == "cuda":
                warnings.warn("DataParallelTrainer: " + self._eager,
                              stacklevel=3)
        return self._eager

    # -- tensor-parallel shards ---------------------------------------------
    def _shard_dims(self, shapes):
        """param index -> the dimension its spec splits (from the full
        shapes); checked to divide over the model axis."""
        out = {}
        for i, (n, s) in enumerate(zip(self._param_names, shapes)):
            dim = _spec_dim(self._specs.get(n), len(s), n)
            if dim is None:
                continue
            if s[dim] % self._model_size:
                raise MXNetError(f"param_specs[{n!r}]: dimension "
                                 f"{len(s) + dim} of {tuple(s)} does not "
                                 f"split {self._model_size} ways")
            out[i] = dim
        return out

    def _to_shards(self, i, t):
        """Parameter i's full tensor as its model shards (own copies)."""
        if i not in self._split:
            return t
        return tuple(c.to(d).contiguous().clone() for c, d in
                     zip(torch.chunk(t, self._model_size,
                                     dim=self._split[i]),
                         self._shard_dev))

    def _full(self, i, p):
        """Parameter i (or its state) as one tensor on the first device."""
        if isinstance(p, (tuple, list)):
            return torch.cat([c.detach().to(self._device) for c in p],
                             dim=self._split[i])
        return p

    # -- state --------------------------------------------------------------
    def init_state(self, shape_kwargs, initializer=None, seed=0,
                   arg_params=None, aux_params=None):
        """(params, states, aux) tuples of float32 tensors on the mesh's
        first device, from the input shapes: the JAX package's draw
        (``np.random.RandomState(seed)``, N(0, 0.01) in parameter order)
        unless ``arg_params`` / ``initializer`` give a value; optimizer
        states zero; aux from ``aux_params``, else moving variances one
        and the rest zero."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shape_kwargs)
        shapes = dict(zip(self._arg_names, arg_shapes))
        rng = _np.random.RandomState(seed)
        params = []
        for n in self._param_names:
            s = shapes[n]
            if arg_params is not None and n in arg_params:
                v = _host(arg_params[n])
            elif initializer is not None:
                from ..ndarray.ndarray import zeros as nd_zeros
                from ..context import cpu
                from ..initializer import InitDesc
                arr = nd_zeros(s, ctx=cpu())
                initializer(InitDesc(n), arr)
                v = arr.asnumpy()
            else:
                v = rng.normal(0, 0.01, size=s).astype(_np.float32)
            params.append(self._put(_np.asarray(v, _np.float32)))
        if self._specs:
            self._split = self._shard_dims([shapes[n]
                                            for n in self._param_names])
            params = [self._to_shards(i, p) for i, p in enumerate(params)]
        states = tuple(tuple(_zeros_like(p)
                             for _ in range(self._n_states))
                       for p in params)
        aux = tuple(self._put(
            _np.asarray(_host(aux_params[n]), _np.float32)
            if aux_params is not None and n in aux_params
            else _np.ones(s, _np.float32)
            if n.endswith(("moving_var", "running_var"))
            else _np.zeros(s, _np.float32))
            for n, s in zip(self._aux_names, aux_shapes))
        return tuple(params), states, aux

    def _put(self, a):
        return _from_numpy(a).to(self._device)

    def _adopt(self, params, states, aux):
        """Make (params, states, aux) the trainer's state: nothing when
        they are its own tensors, else a copy into them (allocated the
        first time)."""
        flat = _flat(params) + _flat(states) + list(aux)
        if self._params is not None:
            own = _flat(self._params) + _flat(self._states) \
                + list(self._aux)
            if len(own) == len(flat) and all(a is b
                                              for a, b in zip(own, flat)):
                return
            with torch.no_grad():
                for a, b in zip(own, flat):
                    a.copy_(b)
            return
        conv = lambda t: _tensor(t).to(self._device, torch.float32) \
            .detach().clone()
        conv_p = lambda p: tuple(c.detach().to(torch.float32).clone()
                                 for c in p) \
            if isinstance(p, (tuple, list)) else conv(p)
        self._params = tuple(conv_p(p) for p in params)
        self._states = tuple(tuple(conv_p(s) for s in st) for st in states)
        self._aux = tuple(conv(a) for a in aux)
        self._lr_dev = torch.tensor(self._lr, dtype=torch.float32,
                                    device=self._device)
        self._t_dev = torch.tensor(self._t, dtype=torch.float32,
                                   device=self._device)

    # -- inputs -------------------------------------------------------------
    def _check_batch(self, a, axis):
        n = axis_size(self._mesh, self._data_axis)
        if a.ndim > axis and a.shape[axis] % n != 0:
            raise MXNetError(
                f"batch axis {axis} of shape {tuple(a.shape)} must be "
                f"divisible by the {n}-way data axis")

    def shard_inputs(self, arrays, stacked=False):
        """Batch arrays onto the mesh, checked to split evenly over its
        replicas on the batch axis (axis 0; axis 1 of the stacked (K,
        batch, ...) blocks of ``step_k``). Each is one global tensor on
        the mesh's first device: the step splits it over the replicas."""
        out = []
        for a in arrays:
            t = _tensor(a)
            self._check_batch(t, 1 if stacked else 0)
            out.append(t.to(self._device))
        return tuple(out)

    def replicate_inputs(self, arrays):
        """Arrays onto the mesh's first device, whole (e.g. eval inputs)."""
        return tuple(_tensor(a).to(self._device) for a in arrays)

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        """Writes the device lr the step reads: nothing re-captures."""
        self._lr = float(lr)
        if self._lr_dev is not None:
            self._lr_dev.fill_(self._lr)

    # -- the step -----------------------------------------------------------
    def _body(self, inputs):
        """One training step on the trainer's state, in place: forward
        over the mesh, the gradient of the summed loss head, the update.
        Returns (loss, outputs)."""
        cdt = self._compute_dtype
        leaf = lambda p: (p.detach() if cdt is None else
                          p.detach().to(cdt)).requires_grad_(True)
        leaves = [tuple(leaf(c) for c in p) if isinstance(p, tuple)
                  else leaf(p) for p in self._params]
        args = dict(zip(self._param_names, leaves))
        for name, v in zip(self._input_names, inputs):
            if self._input_preproc is not None:
                v = self._input_preproc(name, v)
            if cdt is not None and name in self._data_names and \
                    v.is_floating_point():
                v = v.to(cdt)
            args[name] = v
        aux = dict(zip(self._aux_names, self._aux))
        scale = self._ls_dev[0] if self._has_ls else None
        # fp16: the executor's walk injects the scale below the legacy
        # loss heads while it is set (amp.cast_op_inputs)
        _amp._set_trace_loss_scale(scale)
        try:
            with torch.enable_grad():
                if self._specs:
                    outs, updates = _run_tp(
                        self._plan, args, aux, self._mesh, self._sharded,
                        self._specs, frozenset(self._param_names),
                        self._rng())
                else:
                    outs, updates = _run_mesh(self._plan, args, aux,
                                              self._devices, self._sharded,
                                              self._rng())
                # the loss head's sum, as the JAX package's value_and_grad
                # takes it (a SoftmaxOutput head drops the cotangent: its
                # "loss" is the sum of its probabilities)
                loss = outs[self._loss_index].sum().to(torch.float32)
                obj = loss * scale if self._has_ls else loss
                flat = _flat(leaves)
                got = torch.autograd.grad(obj, flat, allow_unused=True)
        finally:
            _amp._set_trace_loss_scale(None)
        grads, k = [], 0
        for lf in leaves:
            if isinstance(lf, tuple):
                grads.append(tuple(got[k:k + len(lf)]))
                k += len(lf)
            else:
                grads.append(got[k])
                k += 1
        _mesh.add_wire(self._reduce_wire())
        with torch.no_grad():
            finite = None
            if self._has_ls:
                # one device boolean over the scaled gradients: a skipped
                # step is no update, so t advances only on applied ones
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in _flat(grads)
                                      if g is not None]).all()
                self._t_dev.add_(finite.to(torch.float32))
                inv_scale = 1.0 / scale
            else:
                self._t_dev.add_(1.0)
            lr = self._lr_dev
            if self._is_adam:
                b1, b2 = self._attrs["beta1"], self._attrs["beta2"]
                lr = lr * torch.sqrt(1.0 - torch.pow(b2, self._t_dev)) \
                    / (1.0 - torch.pow(b1, self._t_dev))
            attrs = AttrDict(self._attrs)
            attrs["lr"] = lr
            if self._has_t:
                attrs["t"] = self._t_dev
            octx = OpCtx(is_train=True, device=self._device)
            fcompute = self._opt_schema.fcompute
            keep = (lambda new, old: new) if finite is None else \
                (lambda new, old: torch.where(finite, new, old))
            on = {self._device: (attrs, octx)}
            for w, g, st in _pieces(self._params, grads, self._states):
                g = torch.zeros_like(w) if g is None else g.to(torch.float32)
                if finite is not None:
                    # unscaled in fp32, so an overflow stays inf
                    g = g * inv_scale
                if w.device not in on:       # a shard on another card
                    a = AttrDict(attrs)
                    a["lr"] = lr.to(w.device)
                    if self._has_t:
                        a["t"] = self._t_dev.to(w.device)
                    on[w.device] = (a, OpCtx(is_train=True, device=w.device))
                res = fcompute(*on[w.device], w, g, *st)
                w.copy_(keep(res[0], w))
                for s, v in zip(st, res[1:]):
                    s.copy_(keep(v, s))
            # an overflowed forward would poison BatchNorm's statistics
            for name, v in updates:
                aux[name].copy_(keep(v, aux[name]))
            if finite is not None:
                self._ls_dev.copy_(self._scaler.update_state(self._ls_dev,
                                                             finite))
        return loss.detach(), [o.detach() for o in outs]

    def _reduce_wire(self):
        """Bytes a device of the gradients' all-reduce moves a step:
        replicated parameters over the whole mesh, split ones over their
        data group (ring accounting, in the gradients' type)."""
        n = len(self._devices)
        d = axis_size(self._mesh, self._data_axis)
        rep = split = 0
        for p in self._params:
            if isinstance(p, tuple):
                split += p[0].numel()
            else:
                rep += p.numel()
        return self._compute_itemsize * (
            2 * (n - 1) / n * rep
            + (2 * (d - 1) / d * split if d > 1 else 0.0))

    def _dispatch_name(self, k=None):
        return "dp.step" if k is None else "dp.step_k%d" % k

    def _step_costs(self, shapes):
        """A replica's costs of one step at these input shapes
        (``telemetry.costs.step_costs``, memoized)."""
        key = tuple(sorted(shapes.items()))
        got = self._costs.get(key)
        if got is None:
            from ..telemetry.costs import step_costs
            d = axis_size(self._mesh, self._data_axis)
            axes = {"data": d, "model": len(self._devices) // d}
            got = step_costs(
                self._symbol, dict(shapes), self._data_names,
                [n for n in self._input_names if n not in self._data_names],
                self._opname, axes=axes,
                zero_stage=getattr(self, "_zero_stage", 0),
                specs=self._specs, itemsize=self._compute_itemsize,
                bucket_bytes=getattr(self, "_bucket_bytes", None),
                wire_itemsize=getattr(self, "_wire_itemsize", None))
            self._costs[key] = got
        return got

    def _publish(self, inputs, k=None):
        """devstats: the dispatch's costs (memoized per input shapes)."""
        from ..telemetry import devstats
        if not devstats.enabled():
            return
        off = 0 if k is None else 1
        shapes = {n: tuple(x.shape[off:])
                  for n, x in zip(self._input_names, inputs)}
        steps = 1 if k is None else k

        def program():
            c = self._step_costs(shapes)
            return dict(c, flops=c["flops"] * steps,
                        bytes=c["bytes"] * steps,
                        input_bytes=sum(x.numel() * x.element_size()
                                        for x in inputs))
        devstats.on_dispatch(self._dispatch_name(k), program,
                             (tuple(sorted(shapes.items())), steps),
                             steps=steps, dtype=self._dtype)

    def _rng(self):
        if not self._plan.needs_rng:
            return None
        if self._gen is None:
            from .. import random as _random
            self._gen = _random.generator(self._device)
        return self._gen

    def _graph(self, inputs):
        """The captured step for these input shapes and dtypes (captured
        on first use: static inputs, a warm-up step on a side stream whose
        effect on the state is undone, the capture into the trainer's
        pool). Capture failure raises: the card has no eager fallback."""
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        g = self._graphs.get(key)
        if g is not None:
            return g
        from ..telemetry import devstats
        dev = self._device
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_in = [torch.empty_like(x) for x in inputs]
        for s, x in zip(static_in, inputs):
            s.copy_(x)
        state = _flat(self._params) + _flat(self._states) \
            + list(self._aux) + [self._t_dev] \
            + ([self._ls_dev] if self._has_ls else [])
        saved = [s.clone() for s in state]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # loads every kernel and sizes cuBLAS's workspace, none of
            # which may happen under capture
            self._body(static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for s, v in zip(state, saved):
                s.copy_(v)
        del saved
        torch.cuda.synchronize(dev)
        mark = devstats.capture_mark(self._pool, dev)
        graph = torch.cuda.CUDAGraph()
        if self._plan.needs_rng:
            graph.register_generator_state(self._rng())
        before = _launch_counts()
        wire0 = _mesh.wire_bytes()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            loss, outs = self._body(static_in)
        after = _launch_counts()
        wire = _mesh.wire_bytes() - wire0
        torch.cuda.synchronize(dev)
        g = _Graph(static_in, graph, loss, outs, time.perf_counter() - t0,
                   devstats.capture_peak(self._pool, dev, mark),
                   {k: after[k] - before.get(k, 0) for k in after
                    if after[k] != before.get(k, 0)}, wire)
        self._graphs[key] = g
        self.captures += 1
        if devstats.enabled():
            name = "dp.step[%s]" % ",".join(
                "x".join(map(str, s)) for s, _ in key)
            devstats.record_program(name, {
                "peak_bytes": g.peak_bytes,
                "resident_bytes": devstats.pool_bytes(self._pool, dev)},
                kind="training")
            devstats.note_compile(name)
        return g

    def _one(self, inputs):
        """One step on ``inputs`` (tensors on the mesh's first device):
        a replay of the captured step on the card, else the eager body.
        Returns the (loss, outputs) of the step, static on the card."""
        if not self._graphed():
            return self._body(inputs)
        g = self._graph(inputs)
        for s, x in zip(g.static_in, inputs):
            if s is not x:
                s.copy_(x, non_blocking=True)
        g.graph.replay()
        g.replays += 1
        if g.launches:
            _add_launches(g.launches)
        _mesh.add_wire(g.wire)
        return g.loss, g.outputs

    def _prepare(self, params, states, aux, inputs, rng):
        if rng is not None:
            if self._graphs and self._plan.needs_rng:
                raise MXNetError("a generator after the step's capture: "
                                 "pass rng= before the first step")
            self._gen = rng
        self._adopt(params, states, aux)
        return [_tensor(x).to(self._device, non_blocking=True)
                for x in inputs]

    def step(self, params, states, aux, inputs, rng=None):
        """One training step. Returns (params, states, aux, loss,
        outputs): the trainer's own state tensors, updated in place, and
        the step's loss and outputs (copies)."""
        inputs = self._prepare(params, states, aux, inputs, rng)
        self._publish(inputs)
        loss, outs = self._one(inputs)
        if self._graphed():
            loss, outs = loss.clone(), [o.clone() for o in outs]
        return (self._params, self._states, self._aux, loss, tuple(outs))

    def step_k(self, params, states, aux, inputs, rng=None,
               outputs_mode="none", unroll=False):
        """K training steps over (K, batch, ...) stacked ``inputs``, the
        same as K ``step`` calls: on the card K replays of the step's
        graph, slice k copied into its static input before replay k,
        nothing synchronised. Returns (params, states, aux, losses (K,),
        outputs): ``outputs`` () for ``outputs_mode="none"``, each symbol
        output of every step stacked on a leading K axis for "all".

        ``unroll`` is the JAX package's (``True``: the K steps unrolled
        into straight-line code, else ``max(1, int(unroll))`` steps a
        loop iteration of its scan). It is accepted and checked, and
        changes nothing here: K replays of the graph are already
        straight-line."""
        if outputs_mode not in ("none", "all"):
            raise MXNetError(f"outputs_mode must be 'none' or 'all', got "
                             f"{outputs_mode!r}")
        # the JAX package's normalisation: a value it refuses raises here
        unroll = "full" if unroll is True else max(1, int(unroll))
        inputs = self._prepare(params, states, aux, inputs, rng)
        k = int(inputs[0].shape[0])
        self._publish(inputs, k)
        losses = torch.empty(k, dtype=torch.float32, device=self._device)
        stacked = None
        for i in range(k):
            loss, outs = self._one([x[i] for x in inputs])
            losses[i].copy_(loss)
            if outputs_mode == "all":
                if stacked is None:
                    stacked = [torch.empty((k,) + tuple(o.shape),
                                           dtype=o.dtype, device=o.device)
                               for o in outs]
                for buf, o in zip(stacked, outs):
                    buf[i].copy_(o)
        return (self._params, self._states, self._aux, losses,
                tuple(stacked) if stacked is not None else ())

    # -- graphs -------------------------------------------------------------
    def graph_stats(self):
        """The captured steps: {input shapes: capture seconds, peak bytes
        during the capture, replays, launches a replay}, and the pool's
        bytes."""
        from ..telemetry import devstats
        pool = devstats.pool_bytes(self._pool, self._device) \
            if self._pool is not None else 0
        return {"captures": self.captures, "pool_bytes": pool,
                "eager_reason": self._eager_reason() or None,
                "graphs": {str([tuple(s) for s, _ in k]): {
                    "capture_s": g.capture_s, "peak_bytes": g.peak_bytes,
                    "replays": g.replays, "launches": dict(g.launches)}
                    for k, g in self._graphs.items()}}

    # -- host views ---------------------------------------------------------
    def device_params(self, params):
        """name -> the per-parameter tensors of a params tuple, on the
        device (the tuple's own tensors: no copy). The spelling a fused
        fit writes back through: a ZeRO trainer's params are flat bucket
        shards, and its override unflattens them; a tensor-parallel
        parameter's shards are concatenated (a new tensor)."""
        return {n: self._full(i, p)
                for i, (n, p) in enumerate(zip(self._param_names, params))}

    def host_params(self, params):
        """name -> host numpy array of a params tuple."""
        return {n: _host(self._full(i, p))
                for i, (n, p) in enumerate(zip(self._param_names, params))}

    def host_aux(self, aux):
        """name -> host numpy array of an aux tuple."""
        return {n: _host(a) for n, a in zip(self._aux_names, aux)}

    # -- the fp16 loss scale ------------------------------------------------
    @property
    def loss_scale(self):
        """The live fp16 loss scale (None without loss scaling; reads the
        device state: a sync)."""
        return float(self._ls_dev[0]) if self._has_ls else None

    @property
    def skipped_steps(self):
        """Steps skipped on non-finite fp16 gradients so far."""
        return int(self._ls_dev[2]) if self._has_ls else 0

    def _amp_counters(self):
        """amp's counter hook (``amp.counters`` sums these)."""
        return {"amp_scale": self.loss_scale,
                "amp_skipped_steps": self.skipped_steps}

    # -- checkpoint round trip ------------------------------------------------
    def _t_value(self):
        return float(self._t if self._t_dev is None else self._t_dev.item())

    def export_training_state(self, params, states, aux):
        """Snapshot of the training state with the JAX package's keys:
        ``param:<name>``, ``opt:<name>:<i>``, ``aux:<name>`` (copies made
        on the tensors' device, so later steps, which update the trainer's
        tensors in place, leave them alone; ``checkpoint`` moves them to
        the host on its saver thread), and meta {t, rng, loss_scaler,
        mesh}. ``rng`` is None: the port's generator states do not carry
        into the JAX package, whose restore reads a key there (the
        checkpoint keeps them under a key of its own)."""
        copy = lambda t: _tensor(t).detach().clone()
        arrays = {}
        for i, (n, p) in enumerate(zip(self._param_names, params)):
            arrays[f"param:{n}"] = copy(self._full(i, p))
        for i, (n, st) in enumerate(zip(self._param_names, states)):
            for j, s in enumerate(st):
                arrays[f"opt:{n}:{j}"] = copy(self._full(i, s))
        for n, a in zip(self._aux_names, aux):
            arrays[f"aux:{n}"] = copy(a)
        return arrays, self._export_meta()

    def _export_meta(self):
        """The device-carried scalars of every trainer variant's export:
        t, the fp16 scaler's state and the exporting mesh."""
        return {"t": self._t_value(), "rng": None,
                "loss_scaler": self._ls_dev.tolist() if self._has_ls
                else None,
                "mesh": mesh_descriptor(self._mesh)}

    def _import_scalar_state(self, meta):
        """Inverse of :meth:`_export_meta`: t and the fp16 scaler's state
        into the trainer's device tensors, in place."""
        self._t = float(meta.get("t", 0.0))
        if self._t_dev is not None:
            self._t_dev.fill_(self._t)
        ls = meta.get("loss_scaler")
        if ls is not None and self._has_ls:
            self._ls_dev.copy_(torch.tensor(ls, dtype=torch.float32))

    def import_training_state(self, arrays, meta):
        """Inverse of :meth:`export_training_state` (either package's):
        (params, states, aux) tensors, copied into the trainer's state at
        the next step, and ``t`` and the fp16 scaler's state written into
        the trainer's device tensors in place (a captured step keeps
        reading them). A ``rng`` entry (a JAX key) is not read."""
        put = lambda a: _tensor(a).detach().to(self._device, torch.float32) \
            .clone()
        full = [put(arrays[f"param:{n}"]) for n in self._param_names]
        if self._specs:
            # the full parameters in; each model rank takes its shard
            self._split = self._shard_dims([tuple(p.shape) for p in full])
        params = tuple(self._to_shards(i, p) for i, p in enumerate(full))
        states = tuple(tuple(self._to_shards(i, put(arrays[f"opt:{n}:{j}"]))
                             for j in range(self._n_states))
                       for i, n in enumerate(self._param_names))
        aux = tuple(put(arrays[f"aux:{n}"]) for n in self._aux_names)
        self._import_scalar_state(meta)
        return params, states, aux


def _flat(xs):
    """The tensors of a params / states structure (a tensor-parallel
    parameter's shards in model order)."""
    out = []
    for x in xs:
        if isinstance(x, (tuple, list)):
            out.extend(_flat(x))
        else:
            out.append(x)
    return out


def _zeros_like(p):
    if isinstance(p, tuple):
        return tuple(torch.zeros_like(c) for c in p)
    return torch.zeros_like(p)


def _pieces(params, grads, states):
    """(parameter, gradient, [states]) per tensor: a split parameter's
    shards one by one."""
    for w, g, st in zip(params, grads, states):
        if isinstance(w, tuple):
            for k, c in enumerate(w):
                yield c, g[k], [s[k] for s in st]
        else:
            yield w, g, list(st)


def _tensor(a):
    a = getattr(a, "_data", a)
    return a if isinstance(a, torch.Tensor) else _from_numpy(a)


def _host(a):
    t = _tensor(a)
    return t.detach().to("cpu", torch.float32).numpy().copy()
