"""BaseModule — the training-loop contract (counterpart of
mxnet_tpu/module/base_module.py).

``fit`` drives bind -> init_params -> init_optimizer -> per batch
forward_backward / update / update_metric with callbacks and the epoch
evaluation; ``score``, ``predict`` and the param get/set round out the
interface. The hook order inside ``fit``, the ``BatchEndParam(...,
locals=locals())`` contract, the ``epoch_end_callback(epoch, symbol,
arg_params, aux_params)`` arity and the "Epoch[N] Train-metric=..." /
"Time cost" / "Validation-" log lines are the JAX package's (and the
reference's), which tooling greps out of training logs.
"""
from __future__ import annotations

import itertools
import logging
import time

from ..base import MXNetError
from .. import metric as metric_mod
from ..model import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]


_PARAM_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta")


def _check_input_names(symbol, names, typename, throw):
    """Validate user-declared input names against the symbol's arguments
    (role of the reference helper at base_module.py:44; wording ours)."""
    args = symbol.list_arguments()
    declared = set(args)
    for name in names:
        if name in declared:
            continue
        likely_inputs = [a for a in args
                         if not a.endswith(_PARAM_SUFFIXES)]
        msg = (f"{typename}_names={list(names)!r} declares {name!r}, which "
               f"is not among the symbol's arguments. Arguments that look "
               f"like inputs (non-parameters): {likely_inputs}")
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0

    # -- high-level interface ------------------------------------------------

    def forward_backward(self, data_batch):
        """forward + backward (base_module.py:191)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def _eval_batches(self, eval_data, num_batch, reset):
        """(index, batch, unpadded outputs) triples after an inference
        forward on each batch."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        batches = eval_data if num_batch is None \
            else itertools.islice(eval_data, num_batch)
        for i, batch in enumerate(batches):
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            if batch.pad:
                # iterator tail-padding: drop the replicated rows
                outs = [o[:o.shape[0] - batch.pad] for o in outs]
            yield i, batch, outs

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate on eval_data (base_module.py score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        callbacks = _as_list(batch_end_callback)
        count = 0
        batches = eval_data if num_batch is None \
            else itertools.islice(eval_data, num_batch)
        for nbatch, eval_batch in enumerate(batches):
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for callback in callbacks:
                callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals()))
            count = nbatch + 1
        for callback in _as_list(score_end_callback):
            callback(BatchEndParam(epoch=epoch, nbatch=count,
                                   eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        for i, batch, outs in self._eval_batches(eval_data, num_batch,
                                                 reset):
            yield (outs, i, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Run prediction, collecting (merged) outputs (base_module.py
        predict). Each batch's outputs are fresh tensors of that forward,
        so no defensive copy is needed."""
        per_batch = [outs for (_, _, outs)
                     in self._eval_batches(eval_data, num_batch, reset)]
        if not per_batch or not merge_batches:
            return per_batch
        widths = {len(outs) for outs in per_batch}
        if len(widths) != 1:
            raise ValueError(
                "Cannot merge batches: output count varies across "
                "mini-batches (bucketing?). Call with merge_batches=False.")
        from ..ndarray.ndarray import concatenate
        merged = [concatenate(cols) for cols in zip(*per_batch)]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, steps_per_dispatch=1,
            checkpoint_dir=None, checkpoint_period=None, resume=False):
        """The per-batch training loop (base_module.py:395): bind,
        init_params, init_optimizer, then for each batch forward_backward,
        update, fetch the next batch, update_metric, and the batch-end
        callbacks (after the metric update, seeing the loop through
        ``locals``); at each epoch's end the "Epoch[N] Train-<metric>" and
        "Time cost" log lines, the parameters round-tripped through
        get_params / set_params, the epoch-end callbacks and the
        validation score.

        ``steps_per_dispatch=K`` (K > 1) runs K training steps a dispatch
        through ``_fit_fused`` (Module: a ``parallel.DataParallelTrainer``
        whose ``step_k`` is K replays of one CUDA graph on the card): the
        same updates on the same batches as K = 1, the training metric
        updated and the batch-end callbacks called once a block of K
        batches; a configuration that cannot fuse warns and falls back
        to the per-batch loop, as in the JAX package.

        Options of the JAX package not ported yet raise instead of being
        ignored: ``checkpoint_dir`` / ``resume`` (ROADMAP queue 1 item 14)
        and ``monitor``."""
        assert num_epoch is not None, "please specify number of epochs"
        if checkpoint_dir is not None or resume or checkpoint_period:
            raise MXNetError("fit(checkpoint_dir=, resume=) is not ported "
                             "yet (ROADMAP queue 1 item 14); use "
                             "epoch_end_callback=callback.module_checkpoint")
        if monitor is not None:
            raise MXNetError("fit(monitor=): monitor.Monitor is not ported "
                             "yet; use the executor's set_monitor_callback")
        if steps_per_dispatch and steps_per_dispatch > 1:
            if self._fit_fused(
                    train_data, eval_data=eval_data, eval_metric=eval_metric,
                    epoch_end_callback=epoch_end_callback,
                    batch_end_callback=batch_end_callback, kvstore=kvstore,
                    optimizer=optimizer, optimizer_params=optimizer_params,
                    eval_end_callback=eval_end_callback,
                    eval_batch_end_callback=eval_batch_end_callback,
                    initializer=initializer, arg_params=arg_params,
                    aux_params=aux_params, allow_missing=allow_missing,
                    force_rebind=force_rebind, force_init=force_init,
                    begin_epoch=begin_epoch, num_epoch=num_epoch,
                    validation_metric=validation_metric,
                    steps_per_dispatch=int(steps_per_dispatch)):
                return

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        batch_callbacks = _as_list(batch_end_callback)
        epoch_callbacks = _as_list(epoch_end_callback)

        for epoch in range(begin_epoch, num_epoch):
            epoch_start = time.time()
            eval_metric.reset()
            # a DataBatch is only guaranteed valid until the next next()
            # call, so batch N+1 is fetched after batch N's update
            data_iter = iter(train_data)
            data_batch = next(data_iter, None)
            nbatch = 0
            while data_batch is not None:
                self.forward_backward(data_batch)
                self.update()
                upcoming = next(data_iter, None)
                if upcoming is not None:
                    self.prepare(upcoming, sparse_row_id_fn=sparse_row_id_fn)
                self.update_metric(eval_metric, data_batch.label)
                if batch_callbacks:
                    cb_param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                             eval_metric=eval_metric,
                                             locals=locals())
                    for callback in batch_callbacks:
                        callback(cb_param)
                data_batch = upcoming
                nbatch += 1

            # log-format contract: "Epoch[N] Train-<metric>=<val>"
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - epoch_start)

            # round-trip params through get/set: the host-visible dicts
            # that checkpoints and callbacks read
            snapshot_args, snapshot_aux = self.get_params()
            self.set_params(snapshot_args, snapshot_aux)
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

    def _fit_fused(self, train_data, **kwargs):
        """The steps_per_dispatch > 1 hook: a subclass that can fuse K
        steps into one dispatch (Module) overrides it; False falls back to
        the per-batch loop."""
        logging.warning(
            "%s does not support steps_per_dispatch>1; falling back to "
            "per-batch dispatch", type(self).__name__)
        return False

    # -- symbol/params interface (implemented by subclasses) -----------------

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        from ..ndarray import ndarray as nd
        nd.save(fname, save_dict)

    def load_params(self, fname):
        from ..ndarray import ndarray as nd
        save_dict = nd.load(fname)
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, _, name = k.partition(":")
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError(f"Invalid param file {fname}")
        self.set_params(arg_params, aux_params)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        assert not merge_multi_context
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value

    def install_monitor(self, mon):
        raise NotImplementedError()

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Hook called with the next batch before forward (row_sparse pull
        point in the reference; no-op densely)."""

    # -- computation interface (implemented by subclasses) -------------------

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()
