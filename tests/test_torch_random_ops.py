"""The port's random ops (ops/random_ops.py, ``mx.nd.random``,
``mx.sym.random``) on the CPU. They draw from the port's explicit
generator, so they cannot equal the JAX package's draws for one seed:
they are held to the JAX ops' shapes and dtypes (the JAX op run beside
each on the same attrs), to their distributions (the sample mean and
variance of >= 10^5 draws within 5 standard errors of the
distribution's), and to equal draws under one ``mx.random.seed``.
``_shuffle`` returns a permutation of its rows; ``_sample_multinomial``
draws classes at their probabilities and ``get_prob`` their log
probabilities.
"""
import numpy as np
import pytest

import jax
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

N = 100_000
SE = 5.0


def _moments_ok(x, mean, var):
    """Sample mean and variance of ``x`` within SE standard errors of
    the distribution's (the variance's standard error from the sample's
    own fourth central moment)."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    assert abs(x.mean() - mean) <= SE * np.sqrt(var / n), (x.mean(), mean)
    m4 = np.mean((x - x.mean()) ** 4)
    se_var = np.sqrt(max(m4 - x.var() ** 2, 1e-30) / n)
    assert abs(x.var() - var) <= SE * se_var, (x.var(), var)


# (op, attrs, mean, variance)
SCALAR = [
    ("_random_uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    ("_random_normal", dict(loc=0.5, scale=2.0), 0.5, 4.0),
    ("_random_gamma", dict(alpha=2.5, beta=1.5), 2.5 * 1.5, 2.5 * 1.5 ** 2),
    ("_random_gamma", dict(alpha=0.4, beta=2.0), 0.8, 1.6),
    ("_random_exponential", dict(lam=4.0), 0.25, 1 / 16),
    ("_random_poisson", dict(lam=3.5), 3.5, 3.5),
    ("_random_negative_binomial", dict(k=3, p=0.4),
     3 * 0.6 / 0.4, 3 * 0.6 / 0.4 ** 2),
    ("_random_generalized_negative_binomial", dict(mu=2.0, alpha=0.5),
     2.0, 2.0 + 0.5 * 4.0),
    ("_random_randint", dict(low=-3, high=7), 1.5, (10 ** 2 - 1) / 12),
]


def _run(name, attrs, *inputs, seed=0):
    tmx.random.seed(seed)
    with tmx.cpu():
        return tmx.nd.__getattr__(name)(*[tmx.nd.array(x) for x in inputs],
                                        **attrs)


def _jax_out(name, attrs, *inputs):
    schema = jreg.get_op(name)
    octx = jreg.OpCtx(rng=jax.random.PRNGKey(0))
    return [np.asarray(o) for o in schema.fcompute(
        schema.parse_attrs(attrs), octx,
        *[jax.numpy.asarray(x) for x in inputs])]


@pytest.mark.parametrize("name,attrs,mean,var", SCALAR,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SCALAR)])
def test_scalar_parameter_draws(name, attrs, mean, var):
    out = _run(name, dict(attrs, shape=(N // 4, 4)))
    want = _jax_out(name, dict(attrs, shape=(N // 4, 4)))[0]
    got = out.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    _moments_ok(got, mean, var)
    np.testing.assert_array_equal(
        got, _run(name, dict(attrs, shape=(N // 4, 4))).asnumpy())
    assert not np.array_equal(
        got, _run(name, dict(attrs, shape=(N // 4, 4)), seed=1).asnumpy())


# (op, parameter arrays, per-element means, per-element variances)
A = np.array([0.5, 2.0, 4.0], np.float32)
B = np.array([1.0, 0.5, 3.0], np.float32)
P = np.array([0.3, 0.5, 0.8], np.float32)
TENSOR = [
    ("_sample_uniform", (A, A + B), A + B / 2, B ** 2 / 12),
    ("_sample_normal", (A, B), A, B ** 2),
    ("_sample_gamma", (A, B), A * B, A * B ** 2),
    ("_sample_exponential", (B,), 1 / B, 1 / B ** 2),
    ("_sample_poisson", (A,), A, A),
    ("_sample_negative_binomial", (A + 1, P), (A + 1) * (1 - P) / P,
     (A + 1) * (1 - P) / P ** 2),
    ("_sample_generalized_negative_binomial", (A, B), A, A + B * A ** 2),
]


@pytest.mark.parametrize("name,params,mean,var", TENSOR,
                         ids=[c[0] for c in TENSOR])
def test_tensor_parameter_draws(name, params, mean, var):
    k = N // 2
    got = _run(name, dict(shape=(k,)), *params).asnumpy()
    want = _jax_out(name, dict(shape=(k,)), *params)[0]
    assert got.shape == want.shape == (3, k)
    assert got.dtype == want.dtype
    for i in range(3):
        _moments_ok(got[i], mean[i], var[i])
    # shape None: one draw a parameter element
    assert _run(name, {}, *params).shape == (3,)


def test_nd_random_functions_take_the_jax_signatures():
    tmx.random.seed(3)
    with tmx.cpu():
        nd = tmx.nd.random
        assert nd.uniform(0, 1, shape=(2, 3)).shape == (2, 3)
        assert nd.normal(1, 2, shape=(4,)).dtype == np.float32
        assert nd.gamma(2.0, 1.0, shape=(3,)).shape == (3,)
        assert nd.exponential(2.0, shape=(5,)).shape == (5,)
        assert nd.poisson(2.0, shape=(5,)).shape == (5,)
        assert nd.negative_binomial(2, 0.5, shape=(5,)).shape == (5,)
        assert nd.generalized_negative_binomial(1.0, 0.5,
                                                shape=(5,)).shape == (5,)
        r = nd.randint(2, 5, shape=(100,)).asnumpy()
        assert r.dtype == np.int32 and r.min() >= 2 and r.max() < 5
        s = nd.normal(tmx.nd.array([0., 10.]), tmx.nd.array([1., 1.]),
                      shape=(50,)).asnumpy()
        assert s.shape == (2, 50) and abs(s[1].mean() - 10) < 1
        out = tmx.nd.zeros((3, 4))
        nd.uniform(5, 6, out=out)
        got = out.asnumpy()
        assert got.shape == (3, 4) and got.min() >= 5 and got.max() < 6


def test_shuffle_is_a_permutation_of_rows():
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    got = _run("_shuffle", {}, x).asnumpy()
    assert got.shape == x.shape
    assert not np.array_equal(got, x)
    np.testing.assert_array_equal(np.sort(got[:, 0]), x[:, 0])
    np.testing.assert_array_equal(got - got[:, :1], x - x[:, :1])
    np.testing.assert_array_equal(got, _run("_shuffle", {}, x).asnumpy())


def test_multinomial_frequencies_and_log_probabilities():
    p = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    k = N // 2
    draws, logp = _run("_sample_multinomial",
                       dict(shape=(k,), get_prob=True), p)
    d = draws.asnumpy()
    # the JAX op's get_prob takes one row of probabilities (a batch of
    # rows fails its take_along_axis), so its shapes are read so
    (jd,) = _jax_out("_sample_multinomial", dict(shape=(k,)), p)
    assert d.shape == jd.shape == (2, k) and d.dtype == jd.dtype == np.int32
    assert logp.shape == d.shape
    jd1, jlp1 = _jax_out("_sample_multinomial",
                         dict(shape=(5,), get_prob=True), p[0])
    td1, tlp1 = _run("_sample_multinomial", dict(shape=(5,), get_prob=True),
                     p[0])
    assert td1.shape == jd1.shape and tlp1.shape == jlp1.shape
    for row in range(2):
        for c in range(3):
            f = np.mean(d[row] == c)
            q = p[row, c]
            assert abs(f - q) <= SE * np.sqrt(q * (1 - q) / k), (row, c, f)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(p[np.arange(2)[:, None], d]), rtol=1e-6)
    one = _run("_sample_multinomial", {}, p[0]).asnumpy()
    assert one.shape == () and 0 <= int(one) < 3


def test_sym_random_composes_the_ops():
    with tmx.NameManager():
        s = tmx.sym.random.normal(0, 1, shape=(2, 3)) \
            + tmx.sym.random.uniform(tmx.sym.Variable("lo"),
                                     tmx.sym.Variable("hi"))
    assert s.list_arguments() == ["lo", "hi"]
    tmx.random.seed(0)
    ex = s.bind(tmx.cpu(), {"lo": tmx.nd.zeros((2, 3), ctx=tmx.cpu()),
                            "hi": tmx.nd.ones((2, 3), ctx=tmx.cpu())})
    out = ex.forward()[0].asnumpy()
    assert out.shape == (2, 3) and np.isfinite(out).all()
    assert {n for n in treg.list_ops() if n.startswith(("_random_",
                                                        "_sample_"))} \
        == {n for n in jreg.list_ops() if n.startswith(("_random_",
                                                        "_sample_"))}
