"""Gluon basic layers (subset of mxnet_tpu/gluon/nn/basic_layers.py):
Sequential, HybridSequential, Dense, Activation, Dropout, LayerNorm,
Embedding — same constructor arguments, parameter names and equations."""
from __future__ import annotations

import math

from ... import autograd
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "LayerNorm", "Embedding"]


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_SequentialMixin, Block):
    """Sequentially stacked blocks."""

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_SequentialMixin, HybridBlock):
    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """FullyConnected layer: weight (units, in_units), in_units=0 deferred
    to the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, int(in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def extra_repr(self):
        shape = self.weight.shape
        return (f"{shape[1] if shape[1] else None} -> {shape[0]}, "
                f"{'linear' if self.act is None else self.act._act_type}")


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class Dropout(HybridBlock):
    """Inverted dropout, active only in training mode
    (``autograd.record()`` / ``train_mode()``); masks come from the
    port's default generator of the input's device."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, training=autograd.is_training())

    def extra_repr(self):
        return f"p = {self._rate}, axes={self._axes}"


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = (int(x.shape[self._axis]),)
        self.gamma.shape = c
        self.beta.shape = c

    def hybrid_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}             # for the repr
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, self._kwargs["input_dim"])

    def extra_repr(self):
        return "{input_dim} -> {output_dim}, {dtype}".format(**self._kwargs)
