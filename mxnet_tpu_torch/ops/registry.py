"""Operator registry (counterpart of mxnet_tpu/ops/registry.py, same
schema).

An op is a plain function on tensors plus a typed parameter schema:

  - ``fcompute(attrs, octx, *inputs) -> tuple of tensors`` runs eagerly on
    its inputs' device; torch's autograd differentiates it, except where
    the reference defines a semantically different backward
    (SoftmaxOutput) or the JAX package writes its own vjp (BatchNorm, the
    dead-bias add), which are ``torch.autograd.Function``s;
  - ``infer_shape(attrs, in_shapes) -> (in_shapes, out_shapes)`` fills
    unknown input shapes (None entries), so ``simple_bind`` derives
    weight shapes from the data shape (FInferShape's bidirectional
    contract). Ops without one are run on torch's ``meta`` device
    (forward-only inference, the role of ``jax.eval_shape``).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as _np

from ..base import (MXNetError, dtype_name, parse_bool, parse_float,
                    parse_int, parse_shape)

__all__ = ["Param", "OpSchema", "OpCtx", "register", "register_alias",
           "get_op", "list_ops", "AttrDict"]


def _parse_floats(v):
    """Tuple-of-float attr ((1.0, 2.0), "[1,2]", 0.5 -> tuple of float)."""
    if isinstance(v, (int, float, _np.floating, _np.integer)):
        return (float(v),)
    if isinstance(v, str):
        v = ast.literal_eval(v.strip())
        if not isinstance(v, (tuple, list)):
            return (float(v),)
    return tuple(float(x) for x in v)


_PARSERS = {
    "int": parse_int,
    "float": parse_float,
    "bool": parse_bool,
    "str": lambda v: str(v),
    "shape": parse_shape,
    "floats": _parse_floats,
    "dtype": dtype_name,
    "any": lambda v: v,
}


@dataclasses.dataclass
class Param:
    """Typed op parameter (role of a dmlc::Parameter field)."""
    type: str = "any"
    default: object = None
    required: bool = False

    def parse(self, v):
        if v is None:
            return None
        return _PARSERS[self.type](v)


class AttrDict(dict):
    """Parsed-attr dict with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


@dataclasses.dataclass
class OpCtx:
    """Per-invocation context handed to fcompute (role of OpContext):
    ``is_train`` switches Dropout and BatchNorm; ``rng`` is the
    ``torch.Generator`` a ``needs_rng`` op draws from; ``device`` is where
    an op without array inputs (``_zeros``, ``_arange``) puts its output."""
    is_train: bool = False
    rng: object = None
    device: object = None


@dataclasses.dataclass
class OpSchema:
    name: str
    fcompute: Callable
    params: dict
    # input names in order; auxiliary-state inputs (BN moving stats) are
    # listed too and flagged by aux_indices (MXNet ListAuxiliaryStates)
    input_names: Sequence[str]
    num_outputs: int = 1
    aux_indices: Sequence[int] = ()
    # if True, fcompute returns num_outputs + len(aux_indices) tensors; the
    # trailing ones are the updated aux values the caller writes back
    mutates_aux: bool = False
    # aux write-back normally happens only in training (BN moving stats);
    # optimizer update ops mutate their state inputs unconditionally
    aux_always: bool = False
    needs_rng: bool = False
    # variadic ops (Concat, add_n): attr naming the input count
    key_var_num_args: Optional[str] = None
    infer_shape: Optional[Callable] = None
    infer_type: Optional[Callable] = None
    aliases: Sequence[str] = ()
    # ops that reduce over the batch axis (BatchNorm's statistics, a loss
    # head's normalisation): ``fmesh(attrs, octx, replicas)`` takes each
    # replica's inputs of a data-parallel walk and returns each replica's
    # result tuple, reduced over the whole batch (executor._run_mesh)
    fmesh: Optional[Callable] = None

    def parse_attrs(self, kwargs) -> AttrDict:
        out = AttrDict()
        for k, p in self.params.items():
            if k in kwargs and kwargs[k] is not None:
                out[k] = p.parse(kwargs[k])
            elif p.required:
                raise MXNetError(f"op {self.name}: required param {k!r} "
                                 "missing")
            else:
                out[k] = p.default
        unknown = set(kwargs) - set(self.params)
        unknown -= {"name", "attr", "out", "dtype_hint", "__layout__"}
        if unknown:
            raise MXNetError(f"op {self.name}: unknown params "
                             f"{sorted(unknown)}")
        return out

    def num_inputs(self, attrs) -> int:
        if self.key_var_num_args:
            return int(attrs[self.key_var_num_args])
        return len(self.input_names)

    def list_inputs(self, attrs):
        if self.key_var_num_args:
            n = int(attrs[self.key_var_num_args])
            base = self.input_names[0] if self.input_names else "arg"
            return [f"{base}{i}" for i in range(n)]
        return list(self.input_names)

    def n_outputs(self, attrs) -> int:
        n = self.num_outputs
        return n(attrs) if callable(n) else n


_REGISTRY: dict = {}


def register(name, fcompute, *, params=None, inputs=("data",), num_outputs=1,
             aux=(), mutates_aux=False, aux_always=False, needs_rng=False,
             key_var_num_args=None, infer_shape=None, infer_type=None,
             aliases=(), fmesh=None):
    """Register an operator; ``aux`` names the inputs that are auxiliary
    states. Returns the OpSchema."""
    params = {k: (v if isinstance(v, Param) else Param(*v)
                  if isinstance(v, tuple) else Param(default=v))
              for k, v in (params or {}).items()}
    inputs = list(inputs)
    aux_idx = tuple(inputs.index(a) for a in aux)
    schema = OpSchema(name=name, fcompute=fcompute, params=params,
                      input_names=inputs, num_outputs=num_outputs,
                      aux_indices=aux_idx, mutates_aux=mutates_aux,
                      aux_always=aux_always, needs_rng=needs_rng,
                      key_var_num_args=key_var_num_args,
                      infer_shape=infer_shape, infer_type=infer_type,
                      aliases=tuple(aliases), fmesh=fmesh)
    for n in (name, *aliases):
        if n in _REGISTRY:
            raise MXNetError(f"op {n!r} already registered")
        _REGISTRY[n] = schema
    return schema


def register_alias(alias, name):
    """Expose a registered op under another public name; a clash with a
    different op raises, re-aliasing to the same op is a no-op."""
    schema = get_op(name)
    existing = _REGISTRY.get(alias)
    if existing is not None:
        if existing is schema:
            return schema
        raise MXNetError(f"op {alias!r} already registered to "
                         f"{existing.name!r}")
    _REGISTRY[alias] = schema
    return schema


def get_op(name) -> OpSchema:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} not registered") from None


def list_ops():
    return sorted(set(s.name for s in _REGISTRY.values()))

