"""``mx.nd.random`` (counterpart of mxnet_tpu/ndarray/random.py): the
registered ``_random_*`` / ``_sample_*`` ops (``ops/random_ops.py``) run
imperatively. Scalar parameters draw ``shape`` samples; NDArray
parameters draw ``shape`` samples for each of their elements. Every
draw comes from the port's explicit ``torch.Generator`` of the target
device (``mxnet_tpu_torch.random.generator``), which ``mx.random.seed``
seeds. The numbers differ from the JAX package's for one seed (another
generator); tests hand both packages the same numpy draws instead, or
compare distributions."""
from __future__ import annotations

from .. import imperative as _imp
from ..ops.registry import get_op
from .ndarray import NDArray

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle"]


def _invoke(name, inputs, kwargs):
    out = kwargs.pop("out", None)
    ctx = kwargs.pop("ctx", None)
    if out is not None and kwargs.get("shape") == (1,):
        # a draw into ``out`` fills it whole
        kwargs["shape"] = tuple(out.shape)
    return _imp.invoke(get_op(name), inputs, kwargs, out=out, ctx=ctx)


def _two_form(sampler_name, sample_name, p1, p2):
    def fn(a=0.0, b=1.0, shape=(1,), dtype="float32", ctx=None, out=None,
           **kw):
        if isinstance(a, NDArray) or isinstance(b, NDArray):
            return _invoke(sample_name, [a, b],
                           {"shape": None if shape == (1,) else shape,
                            "dtype": dtype, "out": out})
        return _invoke(sampler_name, [],
                       {p1: a, p2: b, "shape": shape, "dtype": dtype,
                        "out": out, "ctx": ctx})
    fn.__name__ = sampler_name[len("_random_"):]
    return fn


uniform = _two_form("_random_uniform", "_sample_uniform", "low", "high")
normal = _two_form("_random_normal", "_sample_normal", "loc", "scale")
gamma = _two_form("_random_gamma", "_sample_gamma", "alpha", "beta")


def exponential(scale=1.0, shape=(1,), dtype="float32", ctx=None, out=None,
                **kw):
    return _invoke("_random_exponential", [],
                   {"lam": 1.0 / scale, "shape": shape, "dtype": dtype,
                    "out": out, "ctx": ctx})


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None, **kw):
    return _invoke("_random_poisson", [],
                   {"lam": lam, "shape": shape, "dtype": dtype, "out": out,
                    "ctx": ctx})


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", ctx=None,
                      out=None, **kw):
    return _invoke("_random_negative_binomial", [],
                   {"k": k, "p": p, "shape": shape, "dtype": dtype,
                    "out": out, "ctx": ctx})


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                  dtype="float32", ctx=None, out=None, **kw):
    return _invoke("_random_generalized_negative_binomial", [],
                   {"mu": mu, "alpha": alpha, "shape": shape, "dtype": dtype,
                    "out": out, "ctx": ctx})


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None, **kw):
    return _invoke("_random_randint", [],
                   {"low": low, "high": high, "shape": shape, "dtype": dtype,
                    "out": out, "ctx": ctx})


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    return _invoke("_sample_multinomial", [data],
                   {"shape": shape, "get_prob": get_prob, "dtype": dtype})


def shuffle(data, **kw):
    return _invoke("_shuffle", [data], {})
