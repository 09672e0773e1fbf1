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
K steps. The parameters, optimizer states and aux states the step updates
are the trainer's own tensors, which the graphs read and write in place:
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
fp32 update. ``dtype="float16"`` (dynamic loss scaling, ROADMAP queue 1
item 10), ``zero_stage > 0`` and ``param_specs`` (item 15) and the
optimizers whose update ops are not ported (item 4) raise.
"""
from __future__ import annotations

import os
import time

import numpy as _np
import torch

from ..base import MXNetError
from ..executor import _Plan, _from_numpy, _run_mesh
from ..ops.registry import AttrDict, OpCtx, get_op
from .mesh import axis_size, data_axis, mesh_descriptor

__all__ = ["DataParallelTrainer"]

# optimizer name -> fused update op (ops/optimizer_ops.py)
_OPT_OPS = {
    "sgd": lambda kw: ("sgd_mom_update" if kw.get("momentum")
                       else "sgd_update"),
    "adam": "adam_update",
}
# the JAX package's other fused optimizers, whose update ops the port
# does not have yet
_UNPORTED_OPT = ("rmsprop", "rmspropalex", "ftrl", "signsgd", "signum",
                 "ftml")
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _resolve_stage(value):
    """ZeRO stage: the explicit argument, else ``MXNET_ZERO_STAGE``."""
    if value is None:
        value = os.environ.get("MXNET_ZERO_STAGE") or 0
    try:
        return int(value)
    except (TypeError, ValueError):
        raise MXNetError(f"MXNET_ZERO_STAGE must be 0|1|2, got {value!r}")


class _Graph:
    """One captured training step: static inputs, the graph, its static
    loss and outputs, and what its capture cost."""

    def __init__(self, static_in, graph, loss, outputs, capture_s,
                 peak_bytes):
        self.static_in = static_in
        self.graph = graph
        self.loss = loss
        self.outputs = outputs
        self.capture_s = capture_s
        self.peak_bytes = peak_bytes
        self.replays = 0


class DataParallelTrainer:
    """A full training step for a Symbol over a 1-D data mesh.

    Parameters are replicated; the ``data_names`` / ``label_names``
    inputs are split on axis 0 over the mesh's replicas. The optimizer
    update (``sgd`` with or without momentum, ``adam``) is part of the
    step; lr and the step count are device tensors, so schedules never
    re-capture."""

    def __init__(self, symbol, mesh, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 learning_rate=0.01, momentum=0.0, wd=0.0, rescale_grad=None,
                 clip_gradient=None, loss_index=0, dtype="float32",
                 input_preproc=None, loss_scaler=None, param_specs=None,
                 zero_stage=None, zero_bucket_mb=None, grad_compress=None,
                 **opt_kwargs):
        # zero_bucket_mb / grad_compress belong to the ZeRO trainer; as in
        # the JAX package a stage-0 run may keep them in its kwargs
        if _resolve_stage(zero_stage) > 0:
            raise MXNetError("DataParallelTrainer: ZeRO (zero_stage > 0, "
                             "MXNET_ZERO_STAGE) is not ported yet (ROADMAP "
                             "queue 1 item 15)")
        if param_specs:
            raise MXNetError("DataParallelTrainer: param_specs (tensor "
                             "parallelism) is not ported yet (ROADMAP "
                             "queue 1 item 15)")
        if dtype == "float16":
            raise MXNetError("DataParallelTrainer: dtype='float16' needs "
                             "dynamic loss scaling, not ported yet (ROADMAP "
                             "queue 1 item 10); bfloat16 needs none")
        if dtype not in _DTYPES:
            raise MXNetError("DataParallelTrainer dtype must be float32, "
                             "bfloat16 or float16")
        if optimizer in _UNPORTED_OPT:
            raise MXNetError(
                f"DataParallelTrainer: fused optimizer {optimizer!r} is not "
                f"ported yet (its update op, ROADMAP queue 1 item 4); "
                f"supported: {sorted(_OPT_OPS)}")
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
        self._input_preproc = input_preproc

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
                        "clip_gradient": clip_gradient}.items()
                       if k in schema.params and v is not None}
        attr_kwargs.update(hp)
        self._attrs = schema.parse_attrs(attr_kwargs)
        self._is_adam = optimizer == "adam"
        self._plan = _Plan(symbol, is_train=True)

        # the trainer's own state (see the module docstring) and the
        # device-carried scalars
        self._params = self._states = self._aux = None
        self._lr_dev = self._t_dev = None
        self._gen = None
        # CUDA graphs: (input shapes, dtypes) -> _Graph, one pool
        self._graphs = {}
        self._pool = None
        self.captures = 0

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
        return len(self._devices) == 1 and self._device.type == "cuda"

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
        states = tuple(tuple(torch.zeros_like(p)
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
        flat = list(params) + [s for st in states for s in st] + list(aux)
        if self._params is not None:
            own = list(self._params) + [s for st in self._states
                                        for s in st] + list(self._aux)
            if len(own) == len(flat) and all(a is b
                                              for a, b in zip(own, flat)):
                return
            with torch.no_grad():
                for a, b in zip(own, flat):
                    a.copy_(b)
            return
        conv = lambda t: _tensor(t).to(self._device, torch.float32) \
            .detach().clone()
        self._params = tuple(conv(p) for p in params)
        self._states = tuple(tuple(conv(s) for s in st) for st in states)
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
        leaves = [(p.detach() if cdt is None else p.detach().to(cdt))
                  .requires_grad_(True) for p in self._params]
        args = dict(zip(self._param_names, leaves))
        for name, v in zip(self._input_names, inputs):
            if self._input_preproc is not None:
                v = self._input_preproc(name, v)
            if cdt is not None and name in self._data_names and \
                    v.is_floating_point():
                v = v.to(cdt)
            args[name] = v
        aux = dict(zip(self._aux_names, self._aux))
        with torch.enable_grad():
            outs, updates = _run_mesh(self._plan, args, aux, self._devices,
                                      self._sharded, self._rng())
            # the loss head's sum, as the JAX package's value_and_grad
            # takes it (a SoftmaxOutput head drops the cotangent: its
            # "loss" is the sum of its probabilities)
            loss = outs[self._loss_index].sum().to(torch.float32)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            self._t_dev.add_(1.0)
            lr = self._lr_dev
            if self._is_adam:
                b1, b2 = self._attrs["beta1"], self._attrs["beta2"]
                lr = lr * torch.sqrt(1.0 - torch.pow(b2, self._t_dev)) \
                    / (1.0 - torch.pow(b1, self._t_dev))
            attrs = AttrDict(self._attrs)
            attrs["lr"] = lr
            octx = OpCtx(is_train=True, device=self._device)
            fcompute = self._opt_schema.fcompute
            for w, g, st in zip(self._params, grads, self._states):
                g = torch.zeros_like(w) if g is None else g.to(torch.float32)
                res = fcompute(attrs, octx, w, g, *st)
                w.copy_(res[0])
                for s, v in zip(st, res[1:]):
                    s.copy_(v)
            for name, v in updates:
                aux[name].copy_(v)
        return loss.detach(), [o.detach() for o in outs]

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
        state = list(self._params) + [s for st in self._states for s in st] \
            + list(self._aux) + [self._t_dev]
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
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            loss, outs = self._body(static_in)
        torch.cuda.synchronize(dev)
        g = _Graph(static_in, graph, loss, outs, time.perf_counter() - t0,
                   devstats.capture_peak(self._pool, dev, mark))
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
        loss, outs = self._one(inputs)
        if self._graphed():
            loss, outs = loss.clone(), [o.clone() for o in outs]
        return (self._params, self._states, self._aux, loss, tuple(outs))

    def step_k(self, params, states, aux, inputs, rng=None,
               outputs_mode="none"):
        """K training steps over (K, batch, ...) stacked ``inputs``, the
        same as K ``step`` calls: on the card K replays of the step's
        graph, slice k copied into its static input before replay k,
        nothing synchronised. Returns (params, states, aux, losses (K,),
        outputs): ``outputs`` () for ``outputs_mode="none"``, each symbol
        output of every step stacked on a leading K axis for "all"."""
        if outputs_mode not in ("none", "all"):
            raise MXNetError(f"outputs_mode must be 'none' or 'all', got "
                             f"{outputs_mode!r}")
        inputs = self._prepare(params, states, aux, inputs, rng)
        k = int(inputs[0].shape[0])
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
        during the capture, replays}, and the pool's bytes."""
        from ..telemetry import devstats
        pool = devstats.pool_bytes(self._pool, self._device) \
            if self._pool is not None else 0
        return {"captures": self.captures, "pool_bytes": pool,
                "graphs": {str([tuple(s) for s, _ in k]): {
                    "capture_s": g.capture_s, "peak_bytes": g.peak_bytes,
                    "replays": g.replays} for k, g in self._graphs.items()}}

    # -- host views ---------------------------------------------------------
    def host_params(self, params):
        """name -> host numpy array of a params tuple."""
        return {n: _host(p) for n, p in zip(self._param_names, params)}

    def host_aux(self, aux):
        """name -> host numpy array of an aux tuple."""
        return {n: _host(a) for n, a in zip(self._aux_names, aux)}

    # -- checkpoint round trip ------------------------------------------------
    def _t_value(self):
        return float(self._t if self._t_dev is None else self._t_dev.item())

    def export_training_state(self, params, states, aux):
        """Host snapshot of the training state, with the JAX package's
        keys: ``param:<name>``, ``opt:<name>:<i>``, ``aux:<name>``, and
        meta {t, rng, loss_scaler, mesh}."""
        arrays = {}
        for n, p in zip(self._param_names, params):
            arrays[f"param:{n}"] = _host(p)
        for n, st in zip(self._param_names, states):
            for i, s in enumerate(st):
                arrays[f"opt:{n}:{i}"] = _host(s)
        for n, a in zip(self._aux_names, aux):
            arrays[f"aux:{n}"] = _host(a)
        meta = {"t": self._t_value(), "rng": None, "loss_scaler": None,
                "mesh": mesh_descriptor(self._mesh)}
        return arrays, meta

    def import_training_state(self, arrays, meta):
        """Inverse of :meth:`export_training_state`: (params, states,
        aux) tensors (copied into the trainer's state at the next step)
        and the step count ``t`` restored. The rng entry is ignored: a
        generator's state does not carry between the packages."""
        params = tuple(self._put(_np.asarray(arrays[f"param:{n}"],
                                             _np.float32))
                       for n in self._param_names)
        states = tuple(
            tuple(self._put(_np.asarray(arrays[f"opt:{n}:{j}"],
                                        _np.float32))
                  for j in range(self._n_states))
            for n in self._param_names)
        aux = tuple(self._put(_np.asarray(arrays[f"aux:{n}"], _np.float32))
                    for n in self._aux_names)
        self._t = float(meta.get("t", 0.0))
        if self._t_dev is not None:
            self._t_dev.fill_(self._t)
        return params, states, aux


def _tensor(a):
    a = getattr(a, "_data", a)
    return a if isinstance(a, torch.Tensor) else _from_numpy(a)


def _host(a):
    t = _tensor(a)
    return t.detach().to("cpu", torch.float32).numpy().copy()
