"""float16 through the quantized matmul and the fused 1x1 convolution,
against the JAX package.

* ``quantized_matmul`` with float16 x, int8 and fp8 weights, M 8 (a
  decode step's slots) and 64 (a prefill block), K and N multiples of 128:
  the JAX Pallas kernel under the interpreter (``force="interpret"``) and
  its XLA spelling (``force="xla"``) each return float16, and so does the
  port (its plain version on CPU tensors; on the card both kernels take
  f16 x: tests/test_torch_kernels_cuda.py). Both accumulate in f32 and
  round once to f16, so they differ only where the sums' order moves a
  result across a rounding boundary: at most 1 f16 ulp of the JAX result.
* ``conv1x1`` with each (x, w) pair that holds a float16 and that the JAX
  function takes: (f16, f16), (f16, f32), (f16, bf16), (bf16, f16) —
  plain, with the BN + ReLU prologue, and with it and a float16 residual —
  against ``conv1x1(..., interpret=True)``. y keeps x's dtype and the
  statistics stay f32: y within 1 ulp of its type of the JAX result,
  the statistics within 1e-4 of their largest magnitude (f32 sums of
  a few hundred terms in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import conv_fused as JC
from mxnet_tpu.ops import quantization as JQ
from mxnet_tpu_torch.convert import to_tensor
from mxnet_tpu_torch.ops import conv_fused as TC
from mxnet_tpu_torch.ops import quantization as TQ

_JT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
_TT = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _ulps(got, ref, dtype):
    """|got - ref| in ulps of ref in ``dtype`` (bf16 or f16; subnormal
    ulps below the type's smallest normal)."""
    ref = np.asarray(ref, np.float32)
    fi = torch.finfo(_TT[dtype])
    _, e = np.frexp(ref)
    min_e = int(np.log2(fi.tiny)) + 1
    ulp = np.ldexp(np.float32(fi.eps), np.maximum(e, min_e) - 1)
    return np.abs(np.asarray(got, np.float32) - ref) / ulp


@pytest.mark.parametrize("force", ["interpret", "xla"])
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("k,n", [(128, 256), (256, 128)])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_matmul_f16_x_matches_jax(dtype, k, n, m, force):
    rng = np.random.RandomState(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jq, js = JQ.quantize_rows(w, dtype)
    j = JQ.quantized_matmul(jnp.asarray(x, jnp.float16), jq, js, force=force)
    assert j.dtype == jnp.float16
    n0 = TQ.quantized_matmul.launches
    t = TQ.quantized_matmul(torch.from_numpy(x).half(), to_tensor(jq),
                            torch.from_numpy(np.asarray(js)))
    assert TQ.quantized_matmul.launches == n0     # CPU: the plain version
    assert t.dtype == torch.float16 and t.shape == (m, n)
    assert _ulps(t.float().numpy(), np.asarray(j, np.float32),
                 "f16").max() <= 1


def _conv_inputs(xdt, wdt, mode, seed):
    n, ci, co, p = 2, 32, 24, 128
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, ci, p)).astype(np.float32)
    w = rng.normal(scale=ci ** -0.5, size=(co, ci)).astype(np.float32)
    kw = {}
    if mode != "plain":
        kw = dict(bn_in=(rng.uniform(0.5, 2.0, ci).astype(np.float32),
                         rng.normal(size=ci).astype(np.float32)),
                  relu_in=True)
    if mode == "prologue_res":
        kw["residual"] = rng.normal(size=(n, ci, p)).astype(np.float32)
    return x, w, kw


@pytest.mark.parametrize("mode", ["plain", "prologue", "prologue_res"])
@pytest.mark.parametrize("xdt,wdt", [("f16", "f16"), ("f16", "f32"),
                                     ("f16", "bf16"), ("bf16", "f16")])
def test_conv1x1_half_pairs_match_jax_interpret(xdt, wdt, mode):
    x, w, kw = _conv_inputs(xdt, wdt, mode, seed=len(xdt + wdt + mode))
    jkw, tkw = {}, {}
    if "bn_in" in kw:
        jkw = dict(bn_in=tuple(jnp.asarray(a) for a in kw["bn_in"]),
                   relu_in=True)
        tkw = dict(bn_in=tuple(torch.from_numpy(a) for a in kw["bn_in"]),
                   relu_in=True)
    if "residual" in kw:        # the residual in f16
        jkw["residual"] = jnp.asarray(kw["residual"], jnp.float16)
        tkw["residual"] = torch.from_numpy(kw["residual"]).half()
    jy, js = JC.conv1x1(jnp.asarray(x, _JT[xdt]), jnp.asarray(w, _JT[wdt]),
                        interpret=True, **jkw)
    n0 = TC.conv1x1.launches
    ty, ts = TC.conv1x1(torch.from_numpy(x).to(_TT[xdt]),
                        torch.from_numpy(w).to(_TT[wdt]), **tkw)
    assert TC.conv1x1.launches == n0              # CPU: the plain version
    assert jy.dtype == _JT[xdt] and ty.dtype == _TT[xdt]
    assert ts[0].dtype == torch.float32 and ts[1].dtype == torch.float32
    assert _ulps(ty.float().numpy(), np.asarray(jy, np.float32),
                 xdt).max() <= 1
    for a, b in zip(ts, js):
        b = np.asarray(b, np.float32)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()
