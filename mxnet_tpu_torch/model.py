"""Checkpoints and the updater glue of the Module path (counterpart of
mxnet_tpu/model.py): ``save_checkpoint`` / ``load_checkpoint`` /
``load_params`` (``{prefix}-symbol.json`` + ``{prefix}-{epoch:04d}.params``
with ``arg:`` / ``aux:`` names in the reference's container: the files
the JAX package writes and reads), ``BatchEndParam``, ``_create_kvstore``
and ``_update_params``.

One device has no kvstore: ``_create_kvstore("local", 1, ...)`` returns
``(None, False)`` and the updater runs locally, as the reference does. A
kvstore across devices or hosts (ROADMAP queue 1 item 8) and the legacy
``FeedForward`` are not ported.
"""
from __future__ import annotations

import collections
import logging

from .base import MXNetError
from .ndarray import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam"]

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


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore): none for one device and a local or
    absent kvstore; anything else is not ported and raises."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str) and num_device == 1 \
            and "dist" not in kvstore:
        return None, False
    raise MXNetError(f"kvstore {kvstore!r} over {num_device} device(s) is "
                     "not ported yet (ROADMAP queue 1 item 8)")


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The local updater path: one updater call per parameter (index i
    of device k is i * num_device + k), in parameter order."""
    if kvstore is not None:
        raise MXNetError("kvstore updates are not ported yet (ROADMAP "
                         "queue 1 item 8)")
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(i * num_device + k, g, w)
