"""Module — symbolic training on a bound executor (counterpart of
mxnet_tpu/module/module.py).

``bind`` simple-binds the symbol on the module's context (the card by
default); ``init_params`` fills the bound arrays through an initializer
(with each variable's attrs) or from given params; ``init_optimizer``
creates the optimizer with the symbol's lr/wd multipliers and
``rescale_grad = 1 / batch``; ``update`` runs the updater once per
parameter. Several contexts bind one data-parallel executor over their
mesh (``parallel.mesh_for_contexts``: the batch split over the contexts,
BatchNorm's statistics and the gradients over the whole batch, as the
JAX package's sharded executor) and a kvstore (``model._create_kvstore``)
that runs the updater by default. ``fit(steps_per_dispatch=K)`` trains
through a ``parallel.DataParallelTrainer`` (``_fit_fused``).
``group2ctxs`` (ROADMAP queue 1 item 8) raises.
"""
from __future__ import annotations

import logging
import time
import warnings

import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import Uniform, InitDesc
from .. import optimizer as opt_mod
from ..model import (_create_kvstore, _initialize_kvstore,
                     _update_params_on_kvstore, _update_params,
                     load_checkpoint)
from ..io import DataDesc
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        context = list(context)
        if group2ctxs:
            raise MXNetError("Module(group2ctxs=) model parallelism is not "
                             "ported yet (ROADMAP queue 1 item 8)")
        for c in context:
            c.torch_device()            # no card: raise before binding
        self._context = context
        self._compression_params = compression_params
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) \
            if fixed_param_names is not None else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False

        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None

        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = None
        self._monitor = None

    # -- persistence ---------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._symbol.save(f"{prefix}-symbol.json")
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            if not self.optimizer_initialized:
                # the fused fit keeps the optimizer inside its trainer
                logging.warning(
                    "save_checkpoint: optimizer not initialized (fused "
                    "fit?); skipping optimizer states for %s", prefix)
                return
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    # -- properties ----------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return [(n, o.shape) for n, o in
                zip(self._output_names, self._exec.outputs)] \
            if self._exec.outputs else \
            list(zip(self._output_names,
                     self._symbol.infer_shape(
                         **dict((n, s) for n, s in self._data_shapes))[1]))

    # -- params --------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "init_params call ignored.", stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"

        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            """Initialize one param from cache or initializer."""
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    cache_arr.copyto(arr)
            else:
                if not allow_missing and cache is not None:
                    raise RuntimeError(f"{name} is not presented")
                if initializer is not None:
                    initializer(InitDesc(name, attrs=attrs.get(name, {})),
                                arr)
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            _impl(name, arr, arg_params)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            _impl(name, arr, aux_params)

        self.params_initialized = True
        self._params_dirty = True
        self._sync_params_from_devices()

    def _var_attrs(self, name):
        return self._symbol.attr_dict().get(name, {})

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "set_params call ignored.", stacklevel=2)
            return
        for name, arr in (arg_params or {}).items():
            if name in self._exec.arg_dict:
                arr.copyto(self._exec.arg_dict[name])
            elif not allow_extra:
                raise ValueError(f"unknown parameter {name}")
        for name, arr in (aux_params or {}).items():
            if name in self._exec.aux_dict:
                arr.copyto(self._exec.aux_dict[name])
            elif not allow_extra:
                raise ValueError(f"unknown aux state {name}")
        self.params_initialized = True
        self._params_dirty = True
        self._sync_params_from_devices()

    def _sync_params_from_devices(self):
        """Refresh the host-side param dicts from the bound executor
        (role of ExecutorGroup.get_params copy-out)."""
        self._arg_params = {n: self._exec.arg_dict[n].copy()
                            for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n].copy()
                            for n in self._aux_names}
        self._params_dirty = False

    # -- binding -------------------------------------------------------------
    @staticmethod
    def _norm_shapes(shapes):
        if shapes is None:
            return None
        out = []
        for s in shapes:
            if isinstance(s, DataDesc):
                out.append(s)
            else:
                name, shape = s[0], s[1]
                out.append(DataDesc(name, tuple(shape)))
        return out

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("bind(shared_module=) serves BucketingModule, "
                             "which is not ported yet (ROADMAP queue 1 "
                             "item 12)")

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert not (for_training is False and inputs_need_grad)

        self._data_shapes = self._norm_shapes(data_shapes)
        self._label_shapes = self._norm_shapes(label_shapes) \
            if label_shapes else []

        shape_kwargs = {d.name: d.shape for d in self._data_shapes}
        for d in self._label_shapes:
            shape_kwargs[d.name] = d.shape
        type_kwargs = {d.name: d.dtype for d in self._data_shapes}

        # grad_req per arg: params follow grad_req; data follows
        # inputs_need_grad; labels never need grads; fixed params are frozen
        reqs = {}
        for name in self._symbol.list_arguments():
            if name in self._param_names:
                reqs[name] = "null" if (not for_training or
                                        name in self._fixed_param_names) \
                    else grad_req
            elif name in self._data_names:
                reqs[name] = grad_req if inputs_need_grad else "null"
            else:
                reqs[name] = "null"
        self._grad_req = reqs

        # several contexts: one executor over their mesh (the JAX
        # package's sharded executor), inputs split on the batch axis
        mesh, sharded = None, ()
        if len(self._context) > 1:
            from ..parallel.mesh import mesh_for_contexts
            mesh = mesh_for_contexts(self._context)
            sharded = tuple(self._data_names) + tuple(self._label_names)
            n = len(self._context)
            for d in self._data_shapes + self._label_shapes:
                if d.shape and d.shape[0] % n != 0:
                    raise MXNetError(
                        f"batch size {d.shape[0]} of input '{d.name}' must "
                        f"be divisible by the number of contexts ({n})")
        self._exec = self._symbol.simple_bind(
            ctx=self._context[0], grad_req=reqs, type_dict=type_kwargs,
            mesh=mesh, sharded_args=sharded, **shape_kwargs)
        self.binded = True

        # already-initialized params (Module.load / rebind) must reach the
        # fresh executor (reference: bind → exec_group.set_params when
        # params_initialized, module.py:390)
        if self.params_initialized and self._arg_params is not None:
            self._exec.copy_params_from(self._arg_params,
                                        self._aux_params or {})

    # -- fused multi-step fit (steps_per_dispatch > 1) -----------------------
    def _fit_fused(self, train_data, eval_data, eval_metric,
                   epoch_end_callback, batch_end_callback, kvstore,
                   optimizer, optimizer_params, eval_end_callback,
                   eval_batch_end_callback, initializer, arg_params,
                   aux_params, allow_missing, force_rebind, force_init,
                   begin_epoch, num_epoch, validation_metric,
                   steps_per_dispatch):
        """The K-steps-a-dispatch training loop (the JAX package's
        ``Module._fit_fused``): a normal bind and ``init_params`` (the
        parameter draw of K = 1), then a ``DataParallelTrainer`` over the
        contexts' mesh fed K stacked batches a ``step_k(outputs_mode=
        "all")``, whose outputs update the training metric; parameters and
        aux written back into the module at every epoch end, before the
        epoch-end callbacks and validation. Returns False, with the JAX
        package's warning, for a configuration that cannot fuse."""
        import itertools
        from ..ndarray.ndarray import NDArray
        from ..parallel.dp import DataParallelTrainer, _OPT_OPS
        from ..parallel.mesh import mesh_for_contexts
        from .base_module import _as_list
        from .. import metric as metric_mod
        from ..model import BatchEndParam

        opt_params = dict(optimizer_params or {})
        blockers = []
        if not (isinstance(optimizer, str) and optimizer in _OPT_OPS):
            blockers.append(f"optimizer {optimizer!r} has no fused update "
                            f"op (supported: {sorted(_OPT_OPS)})")
        if not (kvstore is None or (isinstance(kvstore, str) and
                                    "dist" not in kvstore)):
            blockers.append(f"kvstore {kvstore!r} is distributed/custom")
        if "lr_scheduler" in opt_params:
            blockers.append("lr_scheduler (drive set_learning_rate "
                            "externally instead)")
        if self._state_names:
            blockers.append("state_names")
        if self._fixed_param_names:
            blockers.append("fixed_param_names")
        if not blockers:
            from ..ops.registry import get_op
            op_entry = _OPT_OPS[optimizer]
            opname = op_entry({"momentum": opt_params.get("momentum")}) \
                if callable(op_entry) else op_entry
            # the fused path keeps fp32 masters, so multi_precision holds
            handled = {"learning_rate", "momentum", "wd", "rescale_grad",
                       "clip_gradient", "multi_precision"}
            extra = [k for k in opt_params
                     if k not in handled and k not in get_op(opname).params]
            if extra:
                blockers.append(
                    f"optimizer_params {extra} not supported by the fused "
                    f"{opname} op")
        if blockers:
            self.logger.warning(
                "steps_per_dispatch>1 unsupported for this config (%s); "
                "falling back to per-batch dispatch", "; ".join(blockers))
            return False
        k = steps_per_dispatch

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        batch_callbacks = _as_list(batch_end_callback)
        epoch_callbacks = _as_list(epoch_end_callback)

        batch_size = self._data_shapes[0].shape[0]
        lr = float(opt_params.pop("learning_rate", 0.01))
        opt_params.pop("multi_precision", None)
        trainer = DataParallelTrainer(
            self._symbol, mesh_for_contexts(self._context),
            data_names=tuple(self._data_names),
            label_names=tuple(self._label_names), optimizer=optimizer,
            learning_rate=lr,
            momentum=float(opt_params.pop("momentum", 0.0)),
            wd=float(opt_params.pop("wd", 0.0)),
            rescale_grad=float(opt_params.pop("rescale_grad",
                                              1.0 / batch_size)),
            clip_gradient=opt_params.pop("clip_gradient", None),
            **opt_params)
        shape_kwargs = {d.name: d.shape for d in
                        self._data_shapes + (self._label_shapes or [])}
        params, states, aux = trainer.init_state(
            shape_kwargs, arg_params=self._arg_params,
            aux_params=self._aux_params)
        self.fused_trainer = trainer
        data_idx = {n: i for i, n in enumerate(self._data_names)}
        label_idx = {n: i for i, n in enumerate(self._label_names)}

        def _column(block, name):
            if name in data_idx:
                return [b.data[data_idx[name]]._data for b in block]
            return [b.label[label_idx[name]]._data for b in block]

        for epoch in range(begin_epoch, num_epoch):
            epoch_start = time.time()
            eval_metric.reset()
            src = iter(train_data)
            nbatch = 0
            while True:
                # torch.stack copies: the iterator may reuse its buffers
                block = list(itertools.islice(src, k))
                if not block:
                    break
                inputs = trainer.shard_inputs(
                    [torch.stack(_column(block, n))
                     for n in trainer.input_names], stacked=True)
                params, states, aux, _, outputs = trainer.step_k(
                    params, states, aux, inputs, outputs_mode="all")
                # the metric over the block's K batches at once, the scan
                # axis folded into the batch axis
                pred_dict = {name: NDArray(o.reshape((-1,) + o.shape[2:]))
                             for name, o in zip(self._output_names,
                                                outputs)}
                label_dict = {name: NDArray(torch.cat(
                    [b.label[i]._data for b in block]))
                    for name, i in label_idx.items()}
                eval_metric.update_dict(label_dict, pred_dict)
                nbatch += len(block)
                if batch_callbacks:
                    cb_param = BatchEndParam(epoch=epoch, nbatch=nbatch - 1,
                                             eval_metric=eval_metric,
                                             locals=locals())
                    for callback in batch_callbacks:
                        callback(cb_param)

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - epoch_start)
            # the trainer's state written back (copies: the trainer keeps
            # updating its own tensors), so callbacks, checkpoints and
            # validation see what K = 1 would
            self.set_params(
                {n: NDArray(torch.from_numpy(v))
                 for n, v in trainer.host_params(params).items()},
                {n: NDArray(torch.from_numpy(v))
                 for n, v in trainer.host_aux(aux).items()})
            snapshot_args, snapshot_aux = self.get_params()
            for callback in epoch_callbacks:
                callback(epoch, self.symbol, snapshot_args, snapshot_aux)
            if eval_data is not None:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
        return True

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._data_shapes[0].shape[0]
        rescale_grad = 1.0 / batch_size

        idx2name = {i: n for i, n in enumerate(self._param_names)}
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        else:
            assert isinstance(optimizer, opt_mod.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s). Is this intended?"
                    % (optimizer.rescale_grad, rescale_grad), stacklevel=2)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            _initialize_kvstore(
                kvstore=kvstore,
                param_arrays=[[self._exec.arg_dict[n]]
                              for n in self._param_names],
                arg_params=self._arg_params, param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- computation ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training

        # reshape executor on shape change (reference Module.forward reshape)
        new_shapes = {}
        for name, arr in zip(self._data_names, data_batch.data):
            bound = self._exec.arg_dict[name].shape
            if tuple(arr.shape) != tuple(bound):
                new_shapes[name] = arr.shape
        if new_shapes:
            shape_kwargs = {d.name: d.shape for d in self._data_shapes}
            for d in (self._label_shapes or []):
                shape_kwargs[d.name] = d.shape
            shape_kwargs.update(new_shapes)
            if data_batch.label:
                for name, arr in zip(self._label_names, data_batch.label):
                    shape_kwargs[name] = arr.shape
            self._exec = self._exec.reshape(**shape_kwargs)
            self._data_shapes = [
                DataDesc(d.name, shape_kwargs.get(d.name, d.shape), d.dtype)
                for d in self._data_shapes]
            if self._label_shapes:
                self._label_shapes = [
                    DataDesc(d.name, shape_kwargs.get(d.name, d.shape),
                             d.dtype)
                    for d in self._label_shapes]

        kwargs = {}
        for name, arr in zip(self._data_names, data_batch.data):
            kwargs[name] = arr
        if data_batch.label:
            for name, arr in zip(self._label_names, data_batch.label):
                kwargs[name] = arr
        self._exec.forward(is_train=is_train, **kwargs)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One update per parameter with a gradient: through the kvstore
        (push, pull) when it runs the updater, else the updater here, at
        the JAX package's indices (``i * len(context)`` for parameter i:
        its one global array is device 0's, while ``idx2name`` maps i, so
        with several contexts the lr/wd multipliers of another parameter
        are read, as in the JAX package)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        params = [[self._exec.arg_dict[n]] for n in self._param_names]
        grads = [[self._exec.grad_dict.get(n)] for n in self._param_names]
        if self._update_on_kvstore:
            _update_params_on_kvstore(params, grads, self._kvstore,
                                      self._param_names)
        else:
            _update_params(params, grads, updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if isinstance(labels, (list, tuple)):
            label_dict = dict(zip(self._label_names, labels))
        else:
            label_dict = labels
        pred_dict = dict(zip(self._output_names, self._exec.outputs))
        eval_metric.update_dict(label_dict, pred_dict)

    # -- state ---------------------------------------------------------------
    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        if states is not None:
            for name, arr in zip(self._state_names, states):
                arr.copyto(self._exec.arg_dict[name])
        else:
            for name in self._state_names:
                self._exec.arg_dict[name][:] = value

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        from ..base import atomic_write
        atomic_write(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def install_monitor(self, mon):
        raise MXNetError("monitor.Monitor is not ported yet; use the "
                         "executor's set_monitor_callback")

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes = self._norm_shapes(data_shapes)
        if label_shapes is not None:
            self._label_shapes = self._norm_shapes(label_shapes)
        shape_kwargs = {d.name: d.shape for d in self._data_shapes}
        for d in (self._label_shapes or []):
            shape_kwargs[d.name] = d.shape
        self._exec = self._exec.reshape(**shape_kwargs)
