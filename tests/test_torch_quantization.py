"""mxnet_tpu_torch weight-only quantization against the JAX package.

Quantization is held byte-for-byte (int8 and fp8 e4m3fn); the fused
matmul against the JAX Pallas kernel under the interpreter
(``force="interpret"``) at tolerance 1e-5: float32 dot products of
<= 40 terms of O(1) values, summed in another order.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.contrib import quantization as JCQ
from mxnet_tpu.ops import quantization as JQ
from mxnet_tpu_torch.contrib import quantization as TCQ
from mxnet_tpu_torch.convert import to_tensor
from mxnet_tpu_torch.ops import quantization as TQ

TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(k=24, n=12, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 3] = 0.0                        # an all-zero channel: scale 1.0
    w[:4, 5] = [1e-4, -2e-3, 0.5, 1.0]   # tiny values: fp8 subnormals
    w[:, 7] *= 1e-3
    return w


def _bytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_rows_byte_equal_to_jax(dtype):
    w = _weights(seed=1)
    jq, js = JQ.quantize_rows(w, dtype)
    tq, ts = TQ.quantize_rows(w, dtype)
    assert tq.dtype == (torch.int8 if dtype == "int8"
                        else torch.float8_e4m3fn)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequantize_rows(tq, ts).numpy(),
        np.asarray(JQ.dequantize_rows(jq, js)))


def test_int8_rounds_half_to_even_like_rint():
    # channel amax 127 gives scale 1.0, so w/scale keeps its .5 ties
    w = np.array([[0.5, 1.5], [2.5, -0.5], [127.0, 127.0]], np.float32)
    jq, _ = JQ.quantize_rows(w, "int8")
    tq, _ = TQ.quantize_rows(w, "int8")
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[:2].tolist() == [[0, 2], [2, 0]]


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(5, 24, 12), (3, 40, 13)],
                         ids=["even", "ragged_n"])
def test_quantized_matmul_matches_jax_interpret(dtype, shape):
    m, k, n = shape
    rng = np.random.RandomState(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq, js = JQ.quantize_rows(_weights(k, n, seed=k), dtype)
    j = JQ.quantized_matmul(x, jq, js, force="interpret")
    before = TQ.quantized_matmul.launches
    t = TQ.quantized_matmul(torch.from_numpy(x), to_tensor(jq),
                            torch.from_numpy(np.asarray(js)))
    assert TQ.quantized_matmul.launches == before
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # and against dequantize-then-matmul, the oracle of both packages
    ref = x @ np.asarray(JQ.dequantize_rows(jq, js))
    np.testing.assert_allclose(t.numpy(), ref, **TOL)


def test_quantized_matmul_keeps_leading_dims():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    q, s = TQ.quantize_rows(_weights(16, 8), "int8")
    out = TQ.quantized_matmul(torch.from_numpy(x), q, s)
    assert out.shape == (2, 3, 8)
    flat = TQ.quantized_matmul(torch.from_numpy(x.reshape(6, 16)), q, s)
    np.testing.assert_array_equal(out.reshape(6, 8).numpy(), flat.numpy())


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_calibrate_weights_matches_jax(dtype):
    rng = np.random.RandomState(5)
    params = {"embed": rng.standard_normal((10, 8)).astype(np.float32),
              "l0.w1": rng.standard_normal((8, 16)).astype(np.float32),
              "l0.ln1": np.ones(8, np.float32),
              "head": rng.standard_normal((8, 10)).astype(np.float32)}
    jp, jstats = JCQ.calibrate_weights(params, dtype)
    tp, tstats = TCQ.calibrate_weights(params, dtype)
    assert sorted(tp) == sorted(jp)
    assert sorted(tstats) == sorted(jstats) == ["head", "l0.w1"]
    for name, j in jp.items():
        t = tp[name]
        got = t.view(torch.uint8) if t.element_size() == 1 else t
        np.testing.assert_array_equal(got.numpy(), _bytes(j))
    for name in jstats:
        np.testing.assert_allclose(tstats[name]["rms_rel_err"],
                                   jstats[name]["rms_rel_err"], rtol=1e-4)


def test_calibrate_weights_rejects_nothing_to_quantize():
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(MXNetError):
        TCQ.calibrate_weights({"embed": np.ones((4, 4), np.float32)})


def _bf16_ulps(got, ref):
    """|got - ref| in bf16 ulps of ref (ref's exponent; 2^-133 floor)."""
    ref = np.asarray(ref, np.float32)
    _, e = np.frexp(ref)
    ulp = np.ldexp(np.float32(1.0), np.maximum(e - 8, -133))
    return np.abs(np.asarray(got, np.float32) - ref) / ulp


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(5, 24, 12), (3, 40, 13)],
                         ids=["even", "ragged_n"])
def test_quantized_matmul_bf16_x_matches_jax_interpret(dtype, shape):
    """bfloat16 activations: both packages accumulate in f32 and round to
    bf16 once, so they differ only where the sums' order moves a result
    across a rounding boundary: at most 1 bf16 ulp."""
    import jax.numpy as jnp
    m, k, n = shape
    rng = np.random.RandomState(m + 1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq, js = JQ.quantize_rows(_weights(k, n, seed=k + 1), dtype)
    j = JQ.quantized_matmul(jnp.asarray(x, jnp.bfloat16), jq, js,
                            force="interpret")
    assert j.dtype == jnp.bfloat16
    tx = torch.from_numpy(x).bfloat16()
    t = TQ.quantized_matmul(tx, to_tensor(jq), torch.from_numpy(np.asarray(js)))
    assert t.dtype == torch.bfloat16
    assert _bf16_ulps(t.float().numpy(), np.asarray(j, np.float32)).max() <= 1


def _pieces(x):
    """The kernels' split of float32 x into bf16 values."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    lo = (x - hi - mid).bfloat16().float()
    return hi, mid, lo


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_tensor_core_pieces_are_exact(dtype):
    """The premise of both quantized-matmul kernels
    (csrc/quantized_matmul.cu), emulated on the CPU: an f32 x is the exact sum of three bf16
    pieces, every weight is a bf16 value, so sum over pieces of
    piece @ bf16(q), times scale, agrees with reference_quantized_matmul
    within f32 rounding of sums that span x from 1e-20 to 1e20: 4 * K
    units of 2^-24 of sum |x| |q| * scale."""
    rng = np.random.RandomState(7)
    m, k, n = 6, 64, 20
    mag = 10.0 ** rng.uniform(-20, 20, (m, k))
    x = torch.from_numpy((np.sign(rng.standard_normal((m, k))) * mag)
                         .astype(np.float32))
    q, s = TQ.quantize_rows(_weights(k, n, seed=3), dtype)
    hi, mid, lo = _pieces(x)
    assert torch.equal(hi + mid + lo, x)
    for p in (hi, mid, lo):
        assert torch.equal(p.bfloat16().float(), p)
    qb = q.bfloat16().float()
    assert torch.equal(qb, q.float())          # every weight is a bf16
    emu = sum(torch.matmul(p.double(), qb.double()).float()
              for p in (hi, mid, lo)) * s
    # f32 accumulation of the pieces' products, as the tensor cores do
    emu32 = sum(torch.matmul(p, qb) for p in (hi, mid, lo)) * s
    ref = TQ.reference_quantized_matmul(x, q, s)
    bound = 4 * k * 2.0 ** -24 * (torch.matmul(x.abs().double(),
                                                qb.abs().double())
                                  * s.double()).float()
    assert bool(((emu32 - ref).abs() <= bound).all())
    assert bool(((emu - ref).abs() <= bound).all())


def test_quantized_matmul_route_by_shape():
    """The wrapper's shape route: the decode kernel (qmm_small) up to 16
    rows and on shapes the prefill kernel (qmm_tc) does not take."""
    q = torch.zeros(1024, 4096, dtype=torch.int8)
    for m, x_dtype, k, n, route in ((8, torch.float32, 1024, 4096, 0),
                                    (16, torch.float32, 1024, 4096, 0),
                                    (17, torch.float32, 1024, 4096, 1),
                                    (1000, torch.bfloat16, 1024, 4096, 1),
                                    (1000, torch.float32, 1024, 129, 0),
                                    (1000, torch.float32, 100, 4096, 1),
                                    (1000, torch.bfloat16, 100, 4096, 0)):
        x = torch.zeros(m, k, dtype=x_dtype)
        w = q[:k, :n].contiguous() if (k, n) != (1024, 4096) else q
        out = torch.empty(m, n, dtype=x_dtype)
        assert TQ._qmm_route(x, w, out) == route, (m, x_dtype, k, n)
