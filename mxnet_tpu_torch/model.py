"""Checkpoints and the updater glue of the Module path (counterpart of
mxnet_tpu/model.py): ``save_checkpoint`` / ``load_checkpoint`` /
``load_params`` (``{prefix}-symbol.json`` + ``{prefix}-{epoch:04d}.params``
with ``arg:`` / ``aux:`` names in the reference's container: the files
the JAX package writes and reads), ``BatchEndParam``, ``_create_kvstore``
and ``_update_params``.

One device has no kvstore: ``_create_kvstore("local", 1, ...)`` returns
``(None, False)`` and the updater runs locally, as the reference does.
Several devices get a ``kvstore.KVStore`` and, by default
(``MXNET_UPDATE_ON_KVSTORE=1``), the updater runs inside it, unless a
parameter has more than 16M elements (the reference's rule for
``local``). The ``dist*`` kinds (ROADMAP queue 1 item 16) are not
ported.

``FeedForward`` is the legacy model API (deprecated upstream, and here
with a ``DeprecationWarning``): numpy in, numpy out, over ``Module``.
"""
from __future__ import annotations

import collections
import logging
import math

from .base import MXNetError
from .ndarray import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam", "FeedForward"]

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save symbol + parameters to ``{prefix}-symbol.json`` and
    ``{prefix}-{epoch:04d}.params``."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_params(prefix, epoch):
    """Parameters only -> (arg_params, aux_params), NDArrays on the host."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    if not isinstance(save_dict, dict):
        raise MXNetError("invalid params file: expected a name->array dict")
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v           # tolerate unprefixed saves
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Symbol + parameters -> (symbol, arg_params, aux_params)."""
    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy model API over ``mod.Module``: numpy ``X`` / ``y`` are
    wrapped into an ``NDArrayIter`` (or a DataIter is taken as it is),
    ``fit`` runs ``Module.fit``, ``predict`` / ``score`` a module bound
    for inference (kept across calls for the same shapes), ``save`` /
    ``load`` the checkpoint files of ``save_checkpoint``. Keyword
    arguments beyond the named ones are the optimizer's."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        import warnings
        warnings.warn(
            "FeedForward is deprecated (as in the reference). "
            "Please use Module instead.", DeprecationWarning, stacklevel=2)
        from .context import Context, current_context
        from .initializer import Uniform
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None
        self._eval_cache = None

    def _init_iter(self, X, y, is_train):
        """numpy (X, y) -> NDArrayIter; a DataIter passes through."""
        import numpy as np
        from . import io as io_mod
        if hasattr(X, "provide_data"):
            return X
        X = np.asarray(X)
        if y is None:
            if is_train:
                raise ValueError("y is required for training")
            y = np.zeros(X.shape[0], dtype=np.float32)
        y = np.asarray(y)
        batch = min(self.numpy_batch_size, X.shape[0])
        return io_mod.NDArrayIter(X, y.astype(np.float32),
                                  batch_size=batch, shuffle=is_train,
                                  label_name="softmax_label")

    def _make_module(self, data_iter):
        from .module.module import Module
        labels = [n for n, _ in (data_iter.provide_label or [])]
        return Module(self.symbol, label_names=labels or None,
                      context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train through ``Module.fit`` over the same data."""
        assert self.num_epoch is not None, "num_epoch must be set"
        train_iter = self._init_iter(X, y, is_train=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._init_iter(eval_data[0], eval_data[1],
                                        is_train=False)
        self._module = self._make_module(train_iter)
        if logger is not None:
            self._module.logger = logger
        self._module.fit(
            train_iter, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer, optimizer_params=dict(self.kwargs),
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params,
            allow_missing=self.arg_params is not None,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
            monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def _bound_for_eval(self, data_iter):
        """A module bound for inference at the iterator's shapes, kept
        across predict / score calls; the current params set each call."""
        key = (tuple(map(tuple, data_iter.provide_data)),
               tuple(map(tuple, data_iter.provide_label or [])))
        if self._eval_cache is not None and self._eval_cache[0] == key:
            mod = self._eval_cache[1]
        else:
            mod = self._make_module(data_iter)
            mod.bind(data_shapes=data_iter.provide_data,
                     label_shapes=data_iter.provide_label,
                     for_training=False)
            self._eval_cache = (key, mod)
        mod.set_params(self.arg_params or {}, self.aux_params or {},
                       allow_missing=False)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Predict -> numpy (and the data and labels with
        ``return_data``)."""
        import numpy as np
        data_iter = self._init_iter(X, None, is_train=False)
        if reset:
            data_iter.reset()
        mod = self._bound_for_eval(data_iter)
        outs = mod.predict(data_iter, num_batch=num_batch, reset=False,
                           always_output_list=True)
        outs_np = [o.asnumpy() for o in outs]
        result = outs_np[0] if len(outs_np) == 1 else outs_np
        if return_data:
            data_iter.reset()
            xs, ys = [], []
            for b in data_iter:
                keep = b.data[0].shape[0] - b.pad
                xs.append(b.data[0].asnumpy()[:keep])
                ys.append(b.label[0].asnumpy()[:keep])
            return result, np.concatenate(xs), np.concatenate(ys)
        return result

    def score(self, X, y=None, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The metric's value over X."""
        data_iter = self._init_iter(X, y, is_train=False)
        if reset:
            data_iter.reset()
        mod = self._bound_for_eval(data_iter)
        res = mod.score(data_iter, eval_metric, num_batch=num_batch,
                        batch_end_callback=batch_end_callback, reset=False)
        return res[0][1]

    def save(self, prefix, epoch=None):
        """``save_checkpoint`` at ``epoch`` (default: num_epoch)."""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from a checkpoint (either package's files)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Construct and fit in one call."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore instance, update_on_kvstore) as the JAX package's
    ``model._create_kvstore``."""
    from . import config
    from . import kvstore as kvs
    update_on_kvstore = bool(config.get("MXNET_UPDATE_ON_KVSTORE"))
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(math.prod(param.shape)
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init each parameter on the kvstore; with the updater there, pull
    the initial values into the devices' arrays."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each gradient, pull the updated weight."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The local updater path: with a kvstore, each gradient is pushed
    and pulled back (summed) first; then one updater call per parameter
    and device, index ``i * num_device + k`` for parameter i on device k,
    device by device."""
    updates = [[] for _ in range(num_device)]
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[i]
            kvstore.push(name, grad_list, priority=-i)
            kvstore.pull(name, grad_list, priority=-i)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updates[k].append((i * num_device + k, g, w))
    for dev_updates in updates:
        for upd in dev_updates:
            updater(*upd)
