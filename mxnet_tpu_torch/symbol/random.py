"""``mx.sym.random``: the symbolic twins of ``mx.nd.random``, composing
the registered ``_random_*`` ops (scalar parameters) or ``_sample_*`` ops
(Symbol parameters), which draw from the executor's generator."""
from __future__ import annotations

from .symbol import Symbol

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "shuffle"]


def _op(name):
    from .. import symbol as _sym
    return getattr(_sym, name)


def _two_form(sampler_name, sample_name, p1, p2):
    def fn(a=0.0, b=1.0, shape=(1,), dtype="float32", **kw):
        if isinstance(a, Symbol) or isinstance(b, Symbol):
            return _op(sample_name)(a, b, shape=None if shape == (1,)
                                    else shape, dtype=dtype, **kw)
        return _op(sampler_name)(**{p1: a, p2: b}, shape=shape, dtype=dtype,
                                 **kw)
    fn.__name__ = sampler_name[len("_random_"):]
    return fn


uniform = _two_form("_random_uniform", "_sample_uniform", "low", "high")
normal = _two_form("_random_normal", "_sample_normal", "loc", "scale")
gamma = _two_form("_random_gamma", "_sample_gamma", "alpha", "beta")


def exponential(scale=1.0, shape=(1,), dtype="float32", **kw):
    return _op("_random_exponential")(lam=1.0 / scale, shape=shape,
                                      dtype=dtype, **kw)


def poisson(lam=1.0, shape=(1,), dtype="float32", **kw):
    return _op("_random_poisson")(lam=lam, shape=shape, dtype=dtype, **kw)


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", **kw):
    return _op("_random_negative_binomial")(k=k, p=p, shape=shape,
                                            dtype=dtype, **kw)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                  dtype="float32", **kw):
    return _op("_random_generalized_negative_binomial")(
        mu=mu, alpha=alpha, shape=shape, dtype=dtype, **kw)


def randint(low, high, shape=(1,), dtype="int32", **kw):
    return _op("_random_randint")(low=low, high=high, shape=shape,
                                  dtype=dtype, **kw)


def multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    return _op("_sample_multinomial")(data, shape=shape, get_prob=get_prob,
                                      dtype=dtype, **kw)


def shuffle(data, **kw):
    return _op("_shuffle")(data, **kw)
