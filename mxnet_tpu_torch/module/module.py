"""Module — symbolic training on a bound executor (counterpart of
mxnet_tpu/module/module.py), on one device.

``bind`` simple-binds the symbol on the module's context (the card by
default); ``init_params`` fills the bound arrays through an initializer
(with each variable's attrs) or from given params; ``init_optimizer``
creates the optimizer with the symbol's lr/wd multipliers and
``rescale_grad = 1 / batch``; ``update`` runs the updater once per
parameter. Several contexts, ``group2ctxs`` and a kvstore (ROADMAP queue
1 item 8) raise.
"""
from __future__ import annotations

import logging
import warnings

from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import Uniform, InitDesc
from .. import optimizer as opt_mod
from ..model import (_create_kvstore, _update_params, load_checkpoint)
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
        if len(context) != 1:
            raise MXNetError(f"Module over {len(context)} contexts is not "
                             "ported yet (ROADMAP queue 1 item 8): pass one")
        if group2ctxs:
            raise MXNetError("Module(group2ctxs=) model parallelism is not "
                             "ported yet (ROADMAP queue 1 item 8)")
        if compression_params:
            raise MXNetError("gradient compression needs a kvstore, which is "
                             "not ported yet (ROADMAP queue 1 item 8)")
        context[0].torch_device()       # no card: raise before binding
        self._context = context
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

        self._exec = self._symbol.simple_bind(
            ctx=self._context[0], grad_req=reqs, type_dict=type_kwargs,
            **shape_kwargs)
        self.binded = True

        # already-initialized params (Module.load / rebind) must reach the
        # fresh executor (reference: bind → exec_group.set_params when
        # params_initialized, module.py:390)
        if self.params_initialized and self._arg_params is not None:
            self._exec.copy_params_from(self._arg_params,
                                        self._aux_params or {})

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
        """One updater call per parameter with a gradient (the JAX
        package's ``_update_params`` loop)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        _update_params(
            [[self._exec.arg_dict[n]] for n in self._param_names],
            [[self._exec.grad_dict.get(n)] for n in self._param_names],
            updater=self._updater, num_device=len(self._context),
            kvstore=self._kvstore, param_names=self._param_names)

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
        from ..base import atomic_write
        atomic_write(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
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
