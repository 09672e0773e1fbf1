"""Imperative op invocation (counterpart of mxnet_tpu/imperative.py).

``invoke`` runs a registered op eagerly on its inputs' device: there is
nothing to compile, so the JAX package's jit cache has no counterpart.
An op without array inputs runs on ``ctx`` (else ``out``'s device, else
the current context, which is the card unless a ``with cpu():`` scope or
``ctx=cpu()`` says otherwise). ``is_train`` defaults to
``autograd.is_training()``; torch's grad mode (``autograd.record()``)
decides whether the op is recorded.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import resolve_device
from .ops.registry import OpCtx, OpSchema

__all__ = ["invoke", "write_into"]


def write_into(dst, value):
    """Store ``value`` in the NDArray ``dst``: copied into its tensor when
    shape, dtype and device agree and nothing is being recorded through
    it (so the storage other holders see is updated in place), rebound
    otherwise."""
    t = dst._data
    if t.shape == value.shape and t.dtype == value.dtype \
            and t.device == value.device and not value.requires_grad \
            and not t.requires_grad:
        if t.data_ptr() != value.data_ptr():
            with torch.no_grad():
                t.copy_(value)
    else:
        dst._data = value


def _run_device(datas, ctx, out):
    devs = {d.device for d in datas if isinstance(d, torch.Tensor)}
    if len(devs) > 1:
        raise MXNetError(f"inputs on several devices {sorted(map(str, devs))}"
                         ": copy them to one context first")
    if devs:
        return devs.pop()
    if ctx is not None:
        return resolve_device(ctx)
    if out is not None:
        first = out[0] if isinstance(out, (list, tuple)) else out
        return first._data.device
    return resolve_device(None)


def invoke(schema: OpSchema, inputs, kwargs, out=None, is_train=None,
           ctx=None):
    """Run ``schema`` on NDArrays (or tensors); returns an NDArray, a list
    of them, or ``out``."""
    from . import autograd
    from . import random as _random
    from .ndarray.ndarray import NDArray

    attrs = schema.parse_attrs(kwargs)
    n_in = schema.num_inputs(attrs)
    if len(inputs) != n_in:
        raise MXNetError(f"op {schema.name} expects {n_in} inputs, got "
                         f"{len(inputs)}")
    if is_train is None:
        is_train = autograd.is_training()
    datas = [x._data if isinstance(x, NDArray) else x for x in inputs]
    device = _run_device(datas, ctx, out)
    rng = _random.generator(device) if schema.needs_rng else None
    results = schema.fcompute(attrs, OpCtx(is_train=is_train, rng=rng,
                                           device=device), *datas)
    if not isinstance(results, tuple):
        results = (results,)
    n_out = schema.n_outputs(attrs)

    # auxiliary-state write-back (BatchNorm moving stats, optimizer
    # states): the reference mutates the aux arrays in place
    if schema.mutates_aux and (is_train or schema.aux_always):
        for j, aux_i in enumerate(schema.aux_indices):
            src = inputs[aux_i]
            if isinstance(src, NDArray):
                write_into(src, results[n_out + j].detach())

    outputs = [NDArray(r) for r in results[:n_out]]
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs, outputs):
            write_into(dst, src._data)
        return out
    return outputs[0] if len(outputs) == 1 else outputs
