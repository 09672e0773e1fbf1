"""mxnet_tpu_torch.ops.conv_fused against the JAX package's conv1x1.

The same seeded numpy inputs go through ``mxnet_tpu.ops.conv_fused.
conv1x1(..., interpret=True)`` (the Pallas kernel under the interpreter,
as tests/test_conv_fused.py runs it) and through the port's ``conv1x1``
on CPU tensors, which runs the plain version. Covered: plain + stats, the
BN + residual + ReLU prologue, ``want_stats=False``, float32 and
bfloat16, bf16 x with f32 w, the statistics helpers, ``eligible`` and the
refusals, and the stage-2 chain that chip_smoke.py's ``conv`` phase
drives, at a tiny width.

Tolerances: float32 1e-5 relative (tests/test_conv_fused.py's), with an
absolute floor of 1e-5 of the output's largest magnitude for elements
near 0 (f32 sums in another order); bf16 outputs within one bf16 ulp of
the JAX result (a sum landing on the other side of a rounding boundary);
statistics 1e-4 relative to their largest magnitude.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import conv_fused as JC
from mxnet_tpu_torch.ops import conv_fused as TC


def _data(n, ci, co, p, seed, prologue=False):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, ci, p)).astype(np.float32)
    w = rng.normal(scale=ci ** -0.5, size=(co, ci)).astype(np.float32)
    extra = {}
    if prologue:
        extra = dict(scale=rng.uniform(0.5, 2.0, ci).astype(np.float32),
                     shift=rng.normal(size=ci).astype(np.float32),
                     res=rng.normal(size=(n, ci, p)).astype(np.float32))
    return x, w, extra


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16"
                                 else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16"
                                  else torch.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_y(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "bf16":
        _, e = np.frexp(np.abs(want))
        assert np.all(np.abs(got - want) <= np.ldexp(1.0, e - 8))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _close_stats(got, want):
    for a, b in zip(got, want):
        a, b = _np(a), _np(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("p", [256, 49], ids=["p256", "p49_full_block"])
def test_plain_and_stats_match_jax(dtype, p):
    x, w, _ = _data(2, 16, 24, p, seed=p)
    jy, js = JC.conv1x1(_jax(x, dtype), _jax(w, dtype), interpret=True)
    n0 = TC.conv1x1.launches
    ty, ts = TC.conv1x1(_torch(x, dtype), _torch(w, dtype))
    assert TC.conv1x1.launches == n0        # a CPU tensor: the plain version
    assert ty.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert ty.shape == (2, 24, p) and ts[0].dtype == torch.float32
    _close_y(ty, jy, dtype)
    _close_stats(ts, js)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
@pytest.mark.parametrize("want_stats", [True, False], ids=["stats", "y"])
def test_bn_prologue_matches_jax(dtype, residual, want_stats):
    x, w, e = _data(2, 24, 16, 128, seed=7, prologue=True)
    jres = _jax(e["res"], dtype) if residual else None
    tres = _torch(e["res"], dtype) if residual else None
    j = JC.conv1x1(_jax(x, dtype), _jax(w, dtype),
                   bn_in=(jnp.asarray(e["scale"]), jnp.asarray(e["shift"])),
                   residual=jres, relu_in=True, want_stats=want_stats,
                   interpret=True)
    t = TC.conv1x1(_torch(x, dtype), _torch(w, dtype),
                   bn_in=(torch.from_numpy(e["scale"]),
                          torch.from_numpy(e["shift"])),
                   residual=tres, relu_in=True, want_stats=want_stats)
    if want_stats:
        _close_y(t[0], j[0], dtype)
        _close_stats(t[1], j[1])
    else:
        assert isinstance(t, torch.Tensor)
        _close_y(t, j, dtype)


def test_bf16_x_with_f32_w_keeps_w_unrounded_as_jax_does():
    # JAX promotes (bf16 x, f32 w) to f32 in its dot: w is not rounded,
    # y comes back in bf16. Rounding w to bf16 first would miss by many
    # ulps; keeping it matches to the ulp.
    x, w, _ = _data(2, 64, 32, 128, seed=1)
    jy, js = JC.conv1x1(_jax(x, "bf16"), jnp.asarray(w), interpret=True)
    assert jy.dtype == jnp.bfloat16
    ty, ts = TC.conv1x1(_torch(x, "bf16"), torch.from_numpy(w))
    assert ty.dtype == torch.bfloat16
    _close_y(ty, jy, "bf16")
    _close_stats(ts, js)
    rounded = TC.conv1x1(_torch(x, "bf16"), _torch(w, "bf16"),
                         want_stats=False)
    with pytest.raises(AssertionError):
        _close_y(rounded, jy, "bf16")


def test_finalize_stats_and_bn_fold_match_jax():
    rng = np.random.RandomState(3)
    s1 = rng.normal(size=32).astype(np.float32) * 100
    s2 = np.abs(rng.normal(size=32)).astype(np.float32) * 1000
    s2[0] = 0.0                     # var clamps at 0, as in JAX
    gamma = rng.uniform(0.5, 2, 32).astype(np.float32)
    beta = rng.normal(size=32).astype(np.float32)
    j = JC.finalize_stats(jnp.asarray(s1), jnp.asarray(s2), 640, 1e-5)
    t = TC.finalize_stats(torch.from_numpy(s1), torch.from_numpy(s2), 640,
                          1e-5)
    assert float(t[1][0]) == 0.0
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    jf = JC.bn_fold(jnp.asarray(gamma), jnp.asarray(beta), j[0], j[2])
    tf = TC.bn_fold(torch.from_numpy(gamma), torch.from_numpy(beta), t[0],
                    t[2])
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


RESNET_1X1 = [(256, 64, 56 * 56), (64, 256, 56 * 56), (128, 512, 28 * 28),
              (1024, 256, 14 * 14), (512, 2048, 7 * 7), (512, 128, 28 * 28)]
REFUSED = [(63, 64, 1000), (64, 60, 3136), (512, 512, 4000),
           (1024, 1024, 3000)]


@pytest.mark.parametrize("ci,co,p", RESNET_1X1 + REFUSED)
@pytest.mark.parametrize("res", [False, True], ids=["nores", "res"])
def test_eligible_matches_jax(ci, co, p, res):
    assert TC.eligible(ci, co, p, res) == JC.eligible(ci, co, p, res)
    if (ci, co, p) in RESNET_1X1:
        assert TC.eligible(ci, co, p, res)


def test_both_refuse_the_same_spatial_dims():
    x = np.zeros((1, 512, 4000), np.float32)
    w = np.zeros((512, 512), np.float32)
    with pytest.raises(ValueError, match="not blockable"):
        JC.conv1x1(jnp.asarray(x), jnp.asarray(w), interpret=True)
    with pytest.raises(ValueError, match="not blockable"):
        TC.conv1x1(torch.from_numpy(x), torch.from_numpy(w))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage2_chain_matches_jax(dtype):
    # chip_smoke.py's conv phase at a tiny width: expand 8 -> 32 with
    # stats, fold BN, then the next block's reduce 32 -> 8 with the
    # BN + residual + ReLU prologue and stats
    n, c, p = 2, 8, 49
    rng = np.random.RandomState(11)
    x0 = rng.normal(size=(n, c, p)).astype(np.float32)
    w1 = rng.normal(scale=c ** -0.5, size=(4 * c, c)).astype(np.float32)
    w2 = rng.normal(scale=(4 * c) ** -0.5, size=(c, 4 * c)) \
        .astype(np.float32)
    r = rng.normal(size=(n, 4 * c, p)).astype(np.float32)
    gamma = rng.uniform(0.5, 2, 4 * c).astype(np.float32)
    beta = rng.normal(size=4 * c).astype(np.float32)

    def chain(mod, conv, cast, f32):
        y, (s1, s2) = conv(cast(x0), cast(w1))
        mean, _, rstd = mod.finalize_stats(s1, s2, n * p, 1e-5)
        fold = mod.bn_fold(f32(gamma), f32(beta), mean, rstd)
        z, (t1, t2) = conv(y, cast(w2), bn_in=fold, residual=cast(r),
                           relu_in=True)
        return y, z, mod.finalize_stats(t1, t2, n * p, 1e-5)

    jy, jz, jst = chain(JC, functools.partial(JC.conv1x1, interpret=True),
                        lambda a: _jax(a, dtype), jnp.asarray)
    ty, tz, tst = chain(TC, TC.conv1x1, lambda a: _torch(a, dtype),
                        torch.from_numpy)
    _close_y(ty, jy, dtype)
    if dtype == "f32":
        _close_y(tz, jz, dtype)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
    else:
        # a one-ulp flip of y moves the fold and the next conv's rounded
        # input: the second output is held to 2^-6 of its largest value
        assert np.abs(_np(tz) - _np(jz)).max() <= 2 ** -6 * np.abs(
            _np(jz)).max()
