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
