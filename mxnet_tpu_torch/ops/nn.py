"""Neural-network operators of the training path (subset of
mxnet_tpu/ops/nn.py and ops/tensor.py), as functions on tensors with the
reference semantics. Gluon's ``hybrid_forward(F, ...)`` receives this
module as ``F``.

None of these has a Pallas kernel in the JAX package (XLA fuses them
there), so they are plain PyTorch ops here; the matrix products go to
``torch.matmul`` through ``F.linear`` in full float32 (``allow_tf32``
stays False, PyTorch's default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["FullyConnected", "LayerNorm", "Embedding", "Activation",
           "Dropout", "log_softmax", "pick"]


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """y = x W^T + b with the reference's weight layout (num_hidden, in).
    ``flatten`` folds every axis after the first into the input width."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    return F.linear(x, weight, None if no_bias else bias)


def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5):
    """(x - mean) * rsqrt(var + eps) * gamma + beta over ``axis``, with the
    biased variance."""
    axis = axis % data.ndim
    if axis == data.ndim - 1:
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    bshape = [data.shape[axis] if i == axis else 1 for i in range(data.ndim)]
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


def Embedding(data, weight, input_dim=None):
    """Rows of ``weight`` at ``data``: float ids are cast to int
    (truncation) and clipped to [0, input_dim - 1], where
    ``torch.embedding`` would raise on an id out of range."""
    n = weight.shape[0] if input_dim is None else int(input_dim)
    idx = data.to(torch.int64).clamp(0, n - 1)
    return F.embedding(idx, weight)


def Activation(x, act_type):
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return x / (1 + x.abs())
    raise MXNetError(f"Activation: unknown act_type {act_type}")


def Dropout(x, p=0.5, training=False, generator=None):
    """Inverted dropout: in training mode each element is kept with
    probability 1 - p and scaled by 1 / (1 - p); otherwise x unchanged.
    The mask is drawn from ``generator`` (the port's default generator of
    x's device when None)."""
    if not training or p <= 0:
        return x
    if generator is None:
        from ..random import generator as default_generator
        generator = default_generator(x.device)
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return x * mask / keep


def log_softmax(x, axis=-1, temperature=1.0):
    z = x / temperature if temperature != 1.0 else x
    return torch.log_softmax(z, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """data[..., index, ...] along ``axis``, index clipped into range."""
    idx = index.to(torch.int64)
    axis = axis % data.ndim
    if idx.ndim < data.ndim:
        idx = idx.unsqueeze(axis)
    idx = idx.clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)
