"""Random sampling operators (counterpart of mxnet_tpu/ops/random_ops.py):
``_random_*`` draw ``shape`` samples from scalar parameters, ``_sample_*``
``shape`` samples for each element of tensor parameters (the output is
the parameters' shape followed by ``shape``), ``_sample_multinomial``
and ``_shuffle``.

Every draw comes from the ``torch.Generator`` the caller hands in as
``octx.rng``: the imperative layer and the executor give the port's
generator of the op's device (``mxnet_tpu_torch.random.generator``),
which ``mx.random.seed`` seeds. The numbers differ from the JAX
package's for one seed (another generator), so the two packages agree in
shape, dtype and distribution, not draw for draw.

torch samples uniform, normal, exponential, Poisson, integer, multinomial
and permutation draws from a given generator; it has no gamma sampler
that takes one, so the gamma family (gamma, and the negative binomials
as gamma-Poisson mixtures, as in the JAX ops) is Marsaglia and Tsang's
rejection method on the generator's normal and uniform draws.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import Param, register, register_alias

__all__ = []


def _dt(attrs):
    return torch_dtype(attrs.get("dtype") or "float32")


def _float(dtype):
    return dtype if dtype.is_floating_point else torch.float32


def _standard_gamma(alpha, gen):
    """Gamma(alpha, 1) draws, alpha a float tensor (every element one
    draw): Marsaglia-Tsang for alpha >= 1, and for alpha < 1 a draw at
    alpha + 1 times U ** (1 / alpha). Loops until every element accepts
    (~1.05 rounds on average; one host check a round)."""
    small = alpha < 1
    a = torch.where(small, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while True:
        x = torch.empty_like(a).normal_(generator=gen)
        u = torch.empty_like(a).uniform_(generator=gen)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
        if not bool(todo.any()):
            break
    if bool(small.any()):
        u = torch.empty_like(a).uniform_(generator=gen)
        out = torch.where(small, out * u ** (1.0 / alpha), out)
    return out


def _neg_binomial(r, p, gen):
    """Gamma-Poisson mixture: Poisson(Gamma(r) (1 - p) / p)."""
    lam = _standard_gamma(r, gen) * (1 - p) / p
    return torch.poisson(lam, generator=gen)


# ---------------------------------------------------------------------------
# _random_*: scalar parameters, ``shape`` draws
# ---------------------------------------------------------------------------

_SHAPE_PARAMS = {"shape": Param("shape", (1,)),
                 "dtype": Param("dtype", "float32"),
                 "ctx": Param("str", None)}


def _reg_random(name, draw, extra):
    params = dict(_SHAPE_PARAMS)
    params.update(extra)

    def fcompute(attrs, octx, *_):
        dt = _dt(attrs)
        t = torch.empty(attrs["shape"], dtype=_float(dt),
                        device=octx.rng.device)
        return (draw(t, attrs, octx.rng).to(dt),)

    register(name, fcompute, params=params, inputs=(), needs_rng=True)


_reg_random("_random_uniform",
            lambda t, a, g: t.uniform_(a["low"], a["high"], generator=g),
            {"low": Param("float", 0.0), "high": Param("float", 1.0)})
_reg_random("_random_normal",
            lambda t, a, g: t.normal_(a["loc"], a["scale"], generator=g),
            {"loc": Param("float", 0.0), "scale": Param("float", 1.0)})
_reg_random("_random_gamma",
            lambda t, a, g: _standard_gamma(t.fill_(a["alpha"]), g)
            * a["beta"],
            {"alpha": Param("float", 1.0), "beta": Param("float", 1.0)})
_reg_random("_random_exponential",
            lambda t, a, g: t.exponential_(a["lam"], generator=g),
            {"lam": Param("float", 1.0)})
_reg_random("_random_poisson",
            lambda t, a, g: torch.poisson(t.fill_(a["lam"]), generator=g),
            {"lam": Param("float", 1.0)})
_reg_random("_random_negative_binomial",
            lambda t, a, g: _neg_binomial(t.fill_(a["k"]), a["p"], g),
            {"k": Param("int", 1), "p": Param("float", 1.0)})
_reg_random("_random_generalized_negative_binomial",
            lambda t, a, g: _neg_binomial(
                t.fill_(1.0 / a["alpha"]),
                (1.0 / a["alpha"]) / (1.0 / a["alpha"] + a["mu"]), g),
            {"mu": Param("float", 1.0), "alpha": Param("float", 1.0)})


def _random_randint(attrs, octx):
    t = torch.empty(attrs["shape"], dtype=_dt(attrs), device=octx.rng.device)
    return (t.random_(int(attrs["low"]), int(attrs["high"]),
                      generator=octx.rng),)


register("_random_randint", _random_randint,
         params={**_SHAPE_PARAMS,
                 "low": Param("float", 0.0), "high": Param("float", 1.0)},
         inputs=(), needs_rng=True)


# ---------------------------------------------------------------------------
# _sample_*: tensor parameters, ``shape`` draws for each element
# ---------------------------------------------------------------------------

def _reg_sample(name, draw, n_params):
    def fcompute(attrs, octx, *params):
        extra = tuple(attrs["shape"] or ())
        p0 = params[0]
        shape = tuple(p0.shape) + extra
        bc = [p.reshape(tuple(p.shape) + (1,) * len(extra)).expand(shape)
              .to(_float(p0.dtype)) for p in params]
        return (draw(octx.rng, *bc),)

    inputs = ("low", "high") if "uniform" in name else \
        tuple(f"p{i}" for i in range(n_params))
    register(name, fcompute,
             params={"shape": Param("shape", None),
                     "dtype": Param("dtype", "float32")},
             inputs=inputs, needs_rng=True)


_reg_sample("_sample_uniform",
            lambda g, lo, hi: torch.empty_like(lo).uniform_(generator=g)
            * (hi - lo) + lo, 2)
_reg_sample("_sample_normal",
            lambda g, mu, sig: mu + sig
            * torch.empty_like(mu).normal_(generator=g), 2)
_reg_sample("_sample_gamma",
            lambda g, a, b: _standard_gamma(a.contiguous(), g) * b, 2)
_reg_sample("_sample_exponential",
            lambda g, lam: torch.empty_like(lam).exponential_(generator=g)
            / lam, 1)
_reg_sample("_sample_poisson",
            lambda g, lam: torch.poisson(lam.contiguous(), generator=g), 1)
_reg_sample("_sample_negative_binomial",
            lambda g, r, p: _neg_binomial(r.contiguous(), p, g), 2)
_reg_sample("_sample_generalized_negative_binomial",
            lambda g, mu, al: _neg_binomial(
                (1.0 / al).contiguous(), (1.0 / al) / (1.0 / al + mu), g), 2)


def _sample_multinomial(attrs, octx, data):
    """Draws of class indices with probabilities proportional to each
    row of ``data`` (its last axis); ``get_prob`` adds each draw's log
    probability."""
    shape = tuple(attrs["shape"] or ())
    n = 1
    for s in shape:
        n *= s
    probs = torch.clamp_min(data.reshape(-1, data.shape[-1]).to(
        _float(data.dtype)), 1e-30)
    draws = torch.multinomial(probs, n, replacement=True, generator=octx.rng)
    if data.ndim == 1:
        out = draws[0].reshape(shape) if shape else draws[0, 0]
    else:
        out = draws.reshape((data.shape[0],) + shape) if shape \
            else draws[:, 0]
    outs = [out.to(_dt(attrs))]
    if attrs["get_prob"]:
        logp = torch.log_softmax(torch.log(probs), dim=-1)
        lp = torch.gather(logp, 1, out.reshape(probs.shape[0], -1)
                          .to(torch.int64))
        outs.append(lp.reshape(out.shape))
    return tuple(outs)


_mult = register("_sample_multinomial", _sample_multinomial,
                 params={"shape": Param("shape", None),
                         "get_prob": Param("bool", False),
                         "dtype": Param("dtype", "int32")},
                 inputs=("data",), needs_rng=True)
_mult.num_outputs = lambda a: 2 if a["get_prob"] else 1


def _shuffle(attrs, octx, data):
    perm = torch.randperm(data.shape[0], generator=octx.rng,
                          device=octx.rng.device).to(data.device)
    return (data[perm],)


register("_shuffle", _shuffle, needs_rng=True, aliases=("shuffle",))

for _alias, _name in (
        ("uniform", "_random_uniform"),
        ("random_uniform", "_random_uniform"),
        ("normal", "_random_normal"),
        ("random_normal", "_random_normal"),
        ("random_gamma", "_random_gamma"),
        ("random_exponential", "_random_exponential"),
        ("random_poisson", "_random_poisson"),
        ("random_negative_binomial", "_random_negative_binomial"),
        ("random_generalized_negative_binomial",
         "_random_generalized_negative_binomial"),
        ("sample_multinomial", "_sample_multinomial")):
    register_alias(_alias, _name)
