"""Gluon Trainer and ``fused_fit`` (counterpart of
mxnet_tpu/gluon/trainer.py).

``Trainer`` keeps the JAX package's constructor (``kvstore``,
``compression_params``, ``update_on_kvstore``), methods and assertions:
``step(batch_size, ignore_stale_grad)`` rescales gradients by 1 /
batch_size, all-reduces them through the kvstore, and applies the
optimizer to every parameter whose ``grad_req`` is not "null";
``allreduce_grads`` + ``update`` split the same. The kvstore comes from
``model._create_kvstore`` at the first step: none for one context
(unless a ``KVStore`` object is given), else one whose updater runs the
optimizer when ``update_on_kvstore`` holds (gradients pushed, weights
pulled), or which only sums the gradients (pushed and pulled back, with
2-bit compression when asked) before the local update. A parameter over
several contexts is one buffer under each (``Parameter``), so pushes and
updates are de-duplicated on the device buffer: it is pushed and
updated once. ``save_states`` / ``load_states`` go through the kvstore
when it updates, else the first updater; either package reads the
files. ``save_checkpoint`` / ``restore_checkpoint`` commit and restore
the whole state (parameters, optimizer states and counts, the random
state) through ``checkpoint.CheckpointManager``. Under amp the optimizer
keeps fp32 masters of half-precision weights (``multi_precision``).

``fused_fit`` is the JAX package's K-steps-a-dispatch training loop
for Gluon: net and loss traced into one Symbol, trained by a
``parallel.DataParallelTrainer`` over the contexts' mesh (on one card,
K replays of its CUDA graph a block), in amp's dtype unless one is
given, with checkpoints and resume.
"""
from __future__ import annotations

import logging

from ..base import MXNetError, atomic_write
from .. import optimizer as opt
from ..model import _create_kvstore
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer", "fused_fit"]

def _buffer_key(a):
    """The device buffer under an NDArray: a parameter over several
    contexts gives the same buffer under each."""
    t = a._data
    return (t.device, t.data_ptr())


def _unique(arrays):
    seen, out = set(), []
    for a in arrays:
        k = _buffer_key(a)
        if k not in seen:
            seen.add(k)
            out.append(a)
    return out


def fused_fit(net, loss, train_data, num_epoch, optimizer="sgd",
              optimizer_params=None, steps_per_dispatch=None,
              contexts=None, dtype=None, epoch_callback=None,
              checkpoint_dir=None, checkpoint_period=None, resume=False):
    """Train ``net`` (a HybridBlock) on ``loss`` over ``train_data``,
    K = ``steps_per_dispatch`` steps a dispatch; returns the epoch mean
    losses.

    ``net(Variable("data"))`` and ``loss(out, Variable("fused_label"))``
    are traced into one Symbol (a deferred-init net is finished on the
    first batch first) and trained by a ``DataParallelTrainer`` over
    ``mesh_for_contexts(contexts)`` (default: the current context) with
    ``rescale_grad`` 1 / batch unless given. K defaults to
    ``MXNET_FUSED_K``, else 8. ``train_data`` yields (data, label) pairs
    of one shape, a DataLoader say; each block of K batches is one
    ``step_k`` (the last block may be shorter). Blocks are staged on the
    device (stacked; host batches through pinned memory on a copy
    stream) by the device feed's thread (``pipeline.DeviceFeed``) while
    the card runs the block before; with ``MXNET_DEVICE_FEED=0`` the same
    staging runs inline. The host reads a block's losses one block late,
    with the next block queued behind it.
    Parameters and aux states are written back into ``net`` at every
    epoch end, before ``epoch_callback(epoch, net, mean_loss)``.

    ``dtype`` None follows amp (``amp.init`` / ``MXNET_AMP``: its dtype
    when on, else float32); "bfloat16" and "float16" train fp32 masters,
    float16 with the loss scaler on the card. Only the optimizers with a
    fused update op train here (``sgd``, ``adam``).

    ``checkpoint_dir`` commits the trainer's whole state (parameters,
    optimizer states, t, the fp16 scaler, the random state, the cursor)
    at every epoch end and every ``checkpoint_period`` steps (at block
    boundaries), asynchronously; ``resume=True`` restores the newest
    commit and continues bit-identically (the iterator replayed to a
    mid-epoch cursor). SIGTERM takes one final checkpoint at the next
    block boundary and exits 143.
    """
    import itertools

    import numpy as np
    import torch

    from .. import amp as _amp
    from .. import config
    from .. import symbol as sym_mod
    from ..checkpoint.state import (capture_fused_state, rescale_cursor,
                                    restore_rng)
    from ..module.base_module import _close_checkpoints, _open_checkpoints
    from ..context import current_context
    from ..ndarray.ndarray import NDArray, array as nd_array
    from ..parallel.dp import DataParallelTrainer
    from ..parallel.mesh import mesh_for_contexts
    from ..pipeline import (Staged, close_feed, feed_or_inline,
                            stack_to_device)
    from ..telemetry import maybe_step_logger
    from ..telemetry import tracing as _tracing

    if dtype is None:
        # an explicit dtype wins over amp's
        dtype = _amp.get_dtype() if _amp.is_enabled() else "float32"
    contexts = contexts or [current_context()]
    if not isinstance(contexts, (list, tuple)):
        contexts = [contexts]
    contexts = list(contexts)

    it = iter(train_data)
    try:
        first = next(it)
    except StopIteration:
        raise MXNetError("fused_fit: train_data is empty")
    x0, y0 = first[0], first[1]
    if not isinstance(x0, NDArray):
        x0 = nd_array(np.asarray(x0), ctx=contexts[0])
        y0 = nd_array(np.asarray(y0), ctx=contexts[0])
    # finish deferred init (shapes come from the first batch) before the
    # trace reads the parameters' shapes
    with contexts[0]:
        net(x0.as_in_context(contexts[0]))

    out_sym = net(sym_mod.Variable("data"))
    if isinstance(out_sym, (list, tuple)):
        out_sym = out_sym[0]
    loss_sym = loss(out_sym, sym_mod.Variable("fused_label"))
    if isinstance(loss_sym, (list, tuple)):
        loss_sym = loss_sym[0]

    batch = int(x0.shape[0])
    opt_params = dict(optimizer_params or {})
    lr = float(opt_params.pop("learning_rate", 0.01))
    mesh = mesh_for_contexts(contexts)
    trainer = DataParallelTrainer(
        loss_sym, mesh, data_names=("data",), label_names=("fused_label",),
        optimizer=optimizer, learning_rate=lr,
        momentum=float(opt_params.pop("momentum", 0.0)),
        wd=float(opt_params.pop("wd", 0.0)),
        rescale_grad=float(opt_params.pop("rescale_grad", 1.0 / batch)),
        clip_gradient=opt_params.pop("clip_gradient", None), dtype=dtype,
        **opt_params)
    pmap = {p.name: p for _, p in net.collect_params().items()}
    params, states, aux = trainer.init_state(
        {"data": tuple(x0.shape), "fused_label": tuple(y0.shape)},
        arg_params={n: pmap[n].list_data()[0] for n in trainer.param_names},
        aux_params={n: pmap[n].list_data()[0] for n in trainer.aux_names
                    if n in pmap})
    device = mesh.replicas[0]
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" \
        else None

    begin_epoch, gstep, ckpt_skip = 0, 0, 0
    ckpt_mgr, ckpt_state = _open_checkpoints(checkpoint_dir, resume,
                                             logging.getLogger(__name__))
    if ckpt_state is not None:
        if ckpt_state.meta.get("trainer") is not None:
            params, states, aux = trainer.import_training_state(
                ckpt_state.arrays, ckpt_state.meta["trainer"])
        restore_rng(ckpt_state.meta)
        begin_epoch = int(ckpt_state.meta.get("epoch", 0))
        gstep = int(ckpt_state.meta.get("step", 0))
        ckpt_skip = rescale_cursor(ckpt_state.meta, batch)

    def _ckpt_save(next_epoch, next_batch, step, metric=None,
                   blocking=None):
        ckpt_mgr.save(capture_fused_state(
            trainer, params, states, aux, "gluon_fused", next_epoch,
            next_batch, step, batch, dtype), step=step, metric=metric,
            blocking=blocking)

    if steps_per_dispatch is None:
        steps_per_dispatch = int(config.get("MXNET_FUSED_K")) or 8
    k = int(steps_per_dispatch)

    def _column(block, i):
        return [b[i]._data if isinstance(b[i], NDArray) else
                torch.from_numpy(np.ascontiguousarray(np.asarray(b[i])))
                for b in block]

    def _stage(block):
        """The block's (K, batch, ...) stacks on the mesh's first device
        with their copy event (a ``pipeline.Staged``). torch.stack copies,
        so the loader may reuse its buffers."""
        stacked, event = stack_to_device(
            [_column(block, 0), _column(block, 1)], device, copy_stream)
        return Staged((trainer.shard_inputs(stacked, stacked=True),
                       len(block)), stacked, event)

    def _blocks(stream):
        while True:
            block = list(itertools.islice(stream, k))
            if not block:
                return
            yield block

    def _writeback():
        # through the trainer: a ZeRO trainer's params are flat bucket
        # shards, unflattened by its device_params (dp's are its tensors)
        with torch.no_grad():
            for n, p in trainer.device_params(params).items():
                pmap[n].set_data(p)
            for n, a in zip(trainer.aux_names, aux):
                if n in pmap:
                    pmap[n].set_data(a)

    def _epoch(stream, epoch, gstep):
        """One epoch's blocks: (mean loss, the global step after it)."""
        nonlocal params, states, aux
        total, count, pending = 0.0, 0, None
        nbatch, last_ckpt = ckpt_skip, gstep
        feed = feed_or_inline(_blocks(stream), _stage,
                              name="gluon_fused_fit")
        try:
            for inputs, n_blk in feed:
                # "compute" span: the dispatch of the block's K replays and
                # the read of the block before's losses
                with _tracing.span("step.fused_dispatch", phase="compute",
                                   k=n_blk):
                    params, states, aux, losses, _ = trainer.step_k(
                        params, states, aux, inputs)
                    blk_loss = None
                    if pending is not None:
                        # the block before this one: the card has this
                        # block queued behind it while the host waits
                        blk_loss = float(pending[0].sum())
                        total += blk_loss
                # one record a block, for the block whose losses were read
                slog.step(samples=n_blk * batch, steps=n_blk,
                          loss=None if blk_loss is None
                          else blk_loss / max(pending[1] * batch, 1),
                          extra={"epoch": epoch})
                pending = (losses, n_blk)
                count += n_blk * batch
                nbatch += n_blk
                gstep += n_blk
                if ckpt_mgr is not None:
                    if checkpoint_period and \
                            gstep - last_ckpt >= int(checkpoint_period):
                        _ckpt_save(epoch, nbatch, gstep)
                        last_ckpt = gstep
                    if ckpt_mgr.preempted:
                        _ckpt_save(epoch, nbatch, gstep, blocking=True)
                        raise SystemExit(143)
        finally:
            close_feed(feed)
        if pending is not None:
            total += float(pending[0].sum())
        if count == 0:
            # a single-pass generator is exhausted after epoch 0
            raise MXNetError(
                f"fused_fit: epoch {epoch} yielded no batches (is "
                "train_data a single-pass generator? pass a re-iterable "
                "like a DataLoader or list)")
        return total / count, gstep

    epoch_losses = []
    slog = maybe_step_logger("gluon_fused_fit", meta={
        "optimizer": optimizer, "steps_per_dispatch": k,
        "batch_size": batch, "num_epoch": num_epoch,
        "amp_dtype": dtype if dtype != "float32" else None})
    if ckpt_mgr is not None:
        ckpt_mgr.install_sigterm_hook()
    try:
        for epoch in range(begin_epoch, num_epoch):
            stream = itertools.chain([first], it) if epoch == 0 \
                else iter(train_data)
            # a mid-epoch resume: the stream replayed to the cursor
            for _ in itertools.islice(stream, ckpt_skip):
                pass
            mean_loss, gstep = _epoch(stream, epoch, gstep)
            ckpt_skip = 0
            epoch_losses.append(mean_loss)
            _writeback()
            if epoch_callback is not None:
                epoch_callback(epoch, net, mean_loss)
            if ckpt_mgr is not None:
                _ckpt_save(epoch + 1, 0, gstep, metric=mean_loss)
                if ckpt_mgr.preempted:
                    ckpt_mgr.wait()
                    raise SystemExit(143)
    finally:
        # run_end carries the step program's counted costs (which program
        # the per-step MFU was measured against, the peaks in force)
        from ..telemetry import devstats as _devstats
        slog.close(**_devstats.fit_summary())
        _close_checkpoints(ckpt_mgr)
    return epoch_losses


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._kvstore_kind = kvstore

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError(
                    "All Parameters must be initialized on the same set of "
                    f"contexts, but Parameter {param.name} is initialized "
                    f"on {ctx} while previous Parameters are initialized "
                    f"on {contexts}.")
            contexts = ctx
        return contexts

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            from .. import amp as _amp
            if _amp.is_enabled():
                # half-precision weights need fp32 masters: amp turns them
                # on unless multi_precision is given
                optimizer_params = dict(optimizer_params)
                optimizer_params.setdefault("multi_precision", True)
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts or [None]]

    def _init_kvstore(self):
        arg_arrays = {param.name: param.data(self._contexts[0])
                      for param in self._params}
        kvstore, update_on_kvstore = _create_kvstore(
            self._kvstore_kind, len(self._contexts), arg_arrays)
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore is not None:
                update_on_kvstore = self._update_on_kvstore
            for i, param in enumerate(self._params):
                kvstore.init(i, param.data(self._contexts[0]))
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            self._kvstore = kvstore
            self._update_on_kvstore = update_on_kvstore
        else:
            self._kvstore = None
            self._update_on_kvstore = False
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1 / batch_size, all-reduce, update."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients through the kvstore (nothing without one)."""
        if not self._kv_initialized:
            self._init_kvstore()
        assert not (self._kvstore and self._update_on_kvstore), \
            "allreduce_grads() when parameters are updated on kvstore is " \
            "not supported. Try setting `update_on_kvstore` to False when " \
            "creating trainer."
        self._allreduce_grads()

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone (after ``allreduce_grads``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        assert not (self._kvstore and self._update_on_kvstore), \
            "update() when parameters are updated on kvstore is not " \
            "supported. Try setting `update_on_kvstore` to False when " \
            "creating trainer."
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _allreduce_grads(self):
        if self._kvstore and not self._update_on_kvstore:
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    grads = _unique(param.list_grad())
                    self._kvstore.push(i, grads, priority=-i)
                    self._kvstore.pull(i, grads, priority=-i)

    def _update(self, ignore_stale_grad=False):
        if self._kvstore and self._update_on_kvstore:
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    self._kvstore.push(i, _unique(param.list_grad()),
                                       priority=-i)
                    self._kvstore.pull(i, _unique(param.list_data()),
                                       priority=-i)
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            # one update a device buffer
            for upd, w, g in zip(self._updaters, _unique(param.list_data()),
                                 _unique(param.list_grad())):
                upd(i, g, w)

    def save_states(self, fname):
        """The optimizer's states and the optimizer, pickled under the
        JAX package's names (through the kvstore when it updates)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
        else:
            atomic_write(fname,
                         self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """States written by ``save_states`` of either package."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param in
                                      enumerate(self._params)}

    def save_checkpoint(self, directory, step, metric=None):
        """Commit the whole state (parameters, optimizer states with the
        fp32 masters and counts, the random state) through a
        ``checkpoint.CheckpointManager``, blocking. ``directory`` is a
        checkpoint root or a manager; returns the manager (reuse it across
        steps to keep its retention)."""
        from ..checkpoint import CheckpointManager
        from ..checkpoint.state import capture_trainer_state
        mgr = directory if hasattr(directory, "save") \
            else CheckpointManager(directory)
        mgr.save(capture_trainer_state(self, step=step), step=step,
                 metric=metric, blocking=True)
        return mgr

    def restore_checkpoint(self, directory, step=None):
        """Restore the newest commit (or exactly ``step``) into the
        Parameters and the optimizer. Returns the step restored, or None
        when there is none."""
        from ..checkpoint import CheckpointManager
        from ..checkpoint.state import restore_trainer_state
        mgr = directory if hasattr(directory, "restore") \
            else CheckpointManager(directory)
        state = mgr.restore(step)
        if state is None:
            return None
        restore_trainer_state(self, state)
        return state.step
