"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card they build the
kernels from mxnet_tpu_torch/csrc and run them:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerance 1e-4 absolute plus 1e-4 of the reference's largest magnitude:
float32 sums taken in another order (chip_smoke.py states the same). The
flash backward kernels are also checked to give bit-identical gradients
on a second run (they use no atomics). The bf16 conv1x1 output is held
within one bf16 ulp of the reference plus 1e-4 of its largest magnitude
(the f32 sums differ in order before rounding), its statistics within
1e-3 of their largest magnitude, and bit-identical on a second run.
The rtc cases mirror tests/test_rtc.py with CUDA source through NVRTC.
The quantized matmul runs both of its kernels (qmm_small at M <= 16 or
on shapes qmm_tc does not take); with bfloat16 x it is held within one
bf16 ulp plus 1e-4 of the largest magnitude, and every case gives
bit-identical results on a second call. With float32 x over 40 decades
both are held against float64 within the bound that exact products keep
(and that x without its third bf16 piece breaks), and every weight byte
is widened bit for bit.

The attention kernels also take bfloat16 and float16: out, dq, dk, dv
and the decode output are held element by element within 2 units of
(one ulp of the reference there + one ulp of the root-sum-square of the
terms it sums), in their type (``mxnet_tpu_torch.test_utils``; the
forward and dQ kernels round P and dS to the input type before their
second product, as the TPU kernels do, which moves an element by a
fraction of its terms; the plain versions round once at the end); the
same attention with one tile of keys left out must fail that check; lse
is held to the float32 tolerance, and every second call is
bit-identical. The f32 flash forward
and dQ (three TF32 tensor-core products each) are held against float64
within 4x the plain f32 version's own error, which one TF32 pass
(emulated in torch) exceeds. Cross-attention takes the dense route.
"""
import functools
import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref):
    tol = 1e-4 + 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("s,h_kv,causal,d", [
    (64, 4, True, 64), (100, 4, True, 64), (100, 2, False, 64),
    (7, 1, True, 64), (100, 2, True, 128), (70, 4, False, 128),
    (33, 4, True, 16), (33, 4, True, 32), (70, 2, True, 256),
    (33, 4, False, 256), (70, 2, True, 384), (33, 4, False, 512),
    (40, 1, True, 512)])
def test_flash_kernel_matches_plain(dev, s, h_kv, causal, d):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(2, 4, s, d, generator=g, device=dev)
    k = torch.randn(2, h_kv, s, d, generator=g, device=dev)
    v = torch.randn(2, h_kv, s, d, generator=g, device=dev)
    n0 = A.flash_attention_fwd.launches
    out, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    assert A.flash_attention_fwd.launches == n0 + 1
    ref, rlse = A.reference_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(out, ref)
    _close(lse, rlse)


@pytest.mark.parametrize("h_kv,d", [(8, 64), (2, 64), (8, 256), (1, 256),
                                    (8, 384), (1, 512), (2, 512)])
def test_decode_kernel_matches_plain(dev, h_kv, d):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(h_kv)
    q = torch.randn(4, 8, d, generator=g, device=dev)
    k = torch.randn(4, h_kv, 80, d, generator=g, device=dev)
    v = torch.randn(4, h_kv, 80, d, generator=g, device=dev)
    lengths = torch.tensor([0, 1, 33, 80], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, lengths)
    _close(out, A.reference_decode_attention(q, k, v, lengths))
    assert not out[0].any()


# GQA groups that are not 1, 2, 4 or 8: 3; 7 (Qwen2-7B: 28 q heads over 4);
# 16 (Falcon-40B: 128 over 8); through the D <= 256 and the wide kernels
@pytest.mark.parametrize("h,h_kv,d", [(6, 2, 64), (28, 4, 128), (128, 8, 64),
                                      (21, 3, 256), (14, 2, 384),
                                      (48, 3, 512), (12, 1, 32)])
def test_decode_kernel_takes_any_group(dev, h, h_kv, d):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(h + d)
    q = torch.randn(3, h, d, generator=g, device=dev)
    k = torch.randn(3, h_kv, 90, d, generator=g, device=dev)
    v = torch.randn(3, h_kv, 90, d, generator=g, device=dev)
    lengths = torch.tensor([0, 37, 90], dtype=torch.int32, device=dev)
    n, dense = A.decode_attention.launches, A.dense_attention.calls
    out = A.decode_attention(q, k, v, lengths)
    assert A.decode_attention.launches == n + 1
    assert A.dense_attention.calls == dense
    _close(out, A.reference_decode_attention(q, k, v, lengths))
    assert not out[0].any()


@pytest.mark.parametrize("glse", [False, True], ids=["no_glse", "glse"])
@pytest.mark.parametrize("s,h_kv,causal,d", [
    (64, 4, True, 64), (100, 4, True, 64), (100, 2, False, 64),
    (7, 1, True, 64), (100, 2, True, 128), (70, 2, True, 256),
    (33, 1, False, 256), (33, 4, True, 16), (33, 4, False, 32),
    (70, 2, True, 384), (33, 1, False, 512), (20, 4, True, 512),
    (257, 2, True, 64), (150, 1, False, 128), (90, 2, True, 256),
    (130, 4, True, 32), (70, 4, False, 16)])
def test_flash_backward_kernels_match_plain(dev, s, h_kv, causal, d, glse):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(s + d)
    q = torch.randn(2, 4, s, d, generator=g, device=dev)
    k = torch.randn(2, h_kv, s, d, generator=g, device=dev)
    v = torch.randn(2, h_kv, s, d, generator=g, device=dev)
    do = torch.randn(2, 4, s, d, generator=g, device=dev)
    gl = torch.randn(2, 4, s, generator=g, device=dev) if glse else None
    out, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    n = (A.flash_attention_bwd_dq.launches, A.flash_attention_bwd_dkv.launches)
    got = A.flash_attention_bwd(q, k, v, out, lse, do, gl, causal=causal)
    assert (A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    ref = A.reference_flash_attention_bwd(q, k, v, out, lse, do, gl,
                                          causal=causal)
    again = A.flash_attention_bwd(q, k, v, out, lse, do, gl, causal=causal)
    torch.cuda.synchronize()
    for a, r, b in zip(got, ref, again):
        _close(a, r)
        assert torch.equal(a, b)              # no atomics: bit-identical


def test_trainable_flash_attention_matches_torch_autograd(dev):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(2, 4, 90, 64, generator=g, device=dev)
               .requires_grad_() for _ in range(3))
    do = torch.randn(2, 4, 90, 64, generator=g, device=dev)
    A.flash_attention(q, k, v, causal=True).backward(do)
    got = [t.grad for t in (q, k, v)]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    A.reference_attention(q2, k2, v2, causal=True).backward(do)
    for a, t in zip(got, (q2, k2, v2)):
        _close(a, t.grad)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 256, 512), (3, 100, 50257 // 16),
                                   (37, 300, 129)])
def test_quantized_matmul_kernel_matches_plain(dev, dtype, m, k, n):
    from mxnet_tpu_torch.ops import quantization as Q
    g = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn(m, k, generator=g, device=dev)
    q, s = Q.quantize_rows(torch.randn(k, n, generator=g, device=dev)
                           / math.sqrt(k), dtype)
    _close(Q.quantized_matmul(x, q, s), Q.reference_quantized_matmul(x, q, s))


@functools.lru_cache(maxsize=4)
def _qweights(k, n, dtype):
    from mxnet_tpu_torch.ops import quantization as Q
    g = torch.Generator(device="cuda").manual_seed(k + n)
    w = torch.randn(k, n, generator=g, device="cuda") / math.sqrt(k)
    return Q.quantize_rows(w, dtype)


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("k", [100, 1024, 4096])
@pytest.mark.parametrize("n", [129, 1024, 4096, 50257])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 1000])
def test_quantized_matmul_kernels_over_shapes(dev, m, n, k, dtype, xdt):
    """Both kernels over decode and prefill shapes (odd N is the vocab
    head's): a launch each, the plain version's answer, and the same bits
    on a second call."""
    from mxnet_tpu_torch.ops import quantization as Q
    q, s = _qweights(k, n, dtype)
    g = torch.Generator(device=dev).manual_seed(m * 7 + k)
    x = torch.randn(m, k, generator=g, device=dev)
    if xdt == "bf16":
        x = x.bfloat16()
    n0 = Q.quantized_matmul.launches
    out = Q.quantized_matmul(x, q, s)
    assert Q.quantized_matmul.launches == n0 + 1
    assert out.dtype == x.dtype and out.shape == (m, n)
    again = Q.quantized_matmul(x, q, s)
    ref = Q.reference_quantized_matmul(x, q, s)
    torch.cuda.synchronize()
    if xdt == "bf16":
        _bf16_close(out, ref)
    else:
        _close(out, ref)
    assert torch.equal(out, again)


def _pieces(x):
    """x as the sum of three bf16 values, as the kernels split it."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _f64(x, q, s):
    return (x.double() @ q.double()) * s.double()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 1, 1024), (8, 8, 50257), (16, 8, 1024),
                                   (64, 8, 128), (1000, 8, 4096),
                                   (8, 1024, 4096), (1000, 1024, 4096)])
def test_quantized_matmul_forms_exact_products(dev, dtype, m, k, n):
    """Both kernels against float64, with float32 x spanning 1e-20 to 1e20
    so that one term rules each short sum: within 4 K units of 2^-24 of
    sum |x| |q| * scale, what float32 sums of exact products stay inside
    in any order. The bound has teeth at K <= 8: x without its third bf16
    piece, x as one bf16 value and x rounded to TF32 (each emulated here)
    fall outside it."""
    from mxnet_tpu_torch.ops import quantization as Q
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    mag = 10.0 ** (torch.rand(m, k, generator=g, device=dev) * 40 - 20)
    x = (torch.randn(m, k, generator=g, device=dev).sign() * mag).float()
    q, s = Q.quantize_rows(torch.randn(k, n, generator=g, device=dev), dtype)
    out = Q.quantized_matmul(x, q, s)
    ref = _f64(x, q, s)
    bound = 4 * k * 2.0 ** -24 * _f64(x.abs(), q.float().abs(), s)
    assert bool(((out.double() - ref).abs() <= bound).all())
    if k <= 8:
        hi, mid, _ = _pieces(x)
        tf32 = ((x.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)
        for wrong in (hi + mid, hi, tf32):
            assert bool(((_f64(wrong, q, s) - ref).abs() > bound).any())


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("dtype,nan", [("int8", False), ("fp8", False),
                                       ("fp8", True)],
                         ids=["int8", "fp8", "fp8_nan_codes"])
@pytest.mark.parametrize("m,n", [(8, 256), (8, 257), (64, 256)])
def test_quantized_matmul_widens_every_code(dev, m, n, dtype, nan, xdt):
    """Every weight byte once in each of 16 rows, x one-hot rows: each
    output is one code's value times its scale, bit for bit the plain
    version's (e4m3fn's NaN codes, where kept, make their columns NaN in
    both)."""
    from mxnet_tpu_torch.ops import quantization as Q
    codes = (torch.arange(n, device=dev)[None, :]
             + 16 * torch.arange(16, device=dev)[:, None]) % 256
    if dtype == "fp8" and not nan:
        codes[(codes & 0x7f) == 0x7f] = 0
    q = codes.to(torch.uint8).view(
        torch.int8 if dtype == "int8" else torch.float8_e4m3fn)
    g = torch.Generator(device=dev).manual_seed(n)
    s = torch.rand(n, generator=g, device=dev) + 0.5
    x = torch.nn.functional.one_hot(torch.arange(m, device=dev) % 16,
                                    16).float()
    if xdt == "bf16":
        x = x.bfloat16()
    out = Q.quantized_matmul(x, q, s)
    torch.testing.assert_close(out, Q.reference_quantized_matmul(x, q, s),
                               rtol=0, atol=0, equal_nan=True)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as A, quantization as Q
    q = torch.randn(1, 2, 8, 64, device=dev)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        A.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(MXNetError, match="share one dtype"):
        A.flash_attention_fwd(q, q.half(), q.half())
    with pytest.raises(MXNetError, match="dense_attention"):
        x = torch.randn(1, 2, 16, 64, device=dev)
        A.flash_attention_fwd(q, x, x)
    with pytest.raises(MXNetError, match="head dim"):
        x = torch.randn(1, 2, 8, 48, device=dev)
        A.flash_attention_fwd(x, x, x)
    with pytest.raises(MXNetError, match="above 512"):
        x = torch.randn(1, 1, 8, 640, device=dev)
        A.flash_attention_fwd(x, x, x)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        Q.quantized_matmul(torch.randn(2, 4, device=dev).half(),
                           torch.zeros(4, 4, dtype=torch.int8, device=dev),
                           torch.ones(4, device=dev))


def test_head_dim_96_takes_the_dense_route(dev):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(96)
    q, k, v = (torch.randn(2, 4, 50, 96, generator=g, device=dev)
               .requires_grad_() for _ in range(3))
    do = torch.randn(2, 4, 50, 96, generator=g, device=dev)
    kernels = (A.flash_attention_fwd.launches, A.flash_attention_bwd_dq.launches,
               A.flash_attention_bwd_dkv.launches, A.decode_attention.launches)
    dense = A.dense_attention.calls
    A.flash_attention(q, k, v, causal=True).backward(do)
    lengths = torch.tensor([3, 50], dtype=torch.int32, device=dev)
    out = A.decode_attention(q[:, :, 0].detach(), k.detach(), v.detach(),
                             lengths)
    assert A.dense_attention.calls == dense + 2
    assert (A.flash_attention_fwd.launches, A.flash_attention_bwd_dq.launches,
            A.flash_attention_bwd_dkv.launches,
            A.decode_attention.launches) == kernels
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    A.reference_attention(q2, k2, v2, causal=True).backward(do)
    for a, t in zip((q, k, v), (q2, k2, v2)):
        _close(a.grad, t.grad)
    _close(out, A.reference_decode_attention(q[:, :, 0].detach(), k.detach(),
                                             v.detach(), lengths))


def test_head_dim_above_512_takes_the_dense_route(dev):
    """D = 640, a multiple of 128 above the kernels' 512: the entry points
    take the dense route, decided by shape before any launch."""
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(640)
    q, k, v = (torch.randn(1, 2, 40, 640, generator=g, device=dev)
               .requires_grad_() for _ in range(3))
    do = torch.randn(1, 2, 40, 640, generator=g, device=dev)
    kernels = {n: f.launches for n, f in (
        ("fwd", A.flash_attention_fwd), ("dq", A.flash_attention_bwd_dq),
        ("dkv", A.flash_attention_bwd_dkv), ("dec", A.decode_attention))}
    dense = A.dense_attention.calls
    A.flash_attention(q, k, v, causal=True).backward(do)
    lengths = torch.tensor([40], dtype=torch.int32, device=dev)
    out = A.decode_attention(q[:, :, 0].detach(), k.detach(), v.detach(),
                             lengths)
    assert A.dense_attention.calls == dense + 2
    assert kernels == {n: f.launches for n, f in (
        ("fwd", A.flash_attention_fwd), ("dq", A.flash_attention_bwd_dq),
        ("dkv", A.flash_attention_bwd_dkv), ("dec", A.decode_attention))}
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    A.reference_attention(q2, k2, v2, causal=True).backward(do)
    for a, t in zip((q, k, v), (q2, k2, v2)):
        _close(a.grad, t.grad)
    _close(out, A.reference_decode_attention(q[:, :, 0].detach(), k.detach(),
                                             v.detach(), lengths))


def _bf16_close(got, ref):
    """Within one bf16 ulp of the reference plus 1e-4 of its largest
    magnitude (f32 sums in another order before the rounding)."""
    r = ref.float()
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.ones_like(r), e - 8)
    assert bool(((got.float() - r).abs()
                 <= ulp + 1e-4 * float(r.abs().max())).all())


def _stats_close(got, ref):
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("dt,wdt,n,ci,co,p,prologue,residual", [
    ("bf16", "bf16", 4, 64, 256, 196, True, False),
    ("bf16", "bf16", 2, 256, 64, 3136, True, True),
    ("bf16", "bf16", 3, 512, 2048, 49, False, False),
    ("bf16", "f32", 2, 40, 72, 100, True, True),
    ("f32", "f32", 2, 64, 256, 784, True, True),
    ("f32", "bf16", 2, 24, 8, 64, False, False)])
def test_conv1x1_kernel_matches_plain(dev, dt, wdt, n, ci, co, p, prologue,
                                      residual):
    from mxnet_tpu_torch.ops import conv_fused as C
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device=dev).manual_seed(ci + co + p)
    x = torch.randn(n, ci, p, generator=g, device=dev).to(types[dt])
    w = (torch.randn(co, ci, generator=g, device=dev) / ci ** 0.5) \
        .to(types[wdt])
    kw = {}
    if prologue:
        kw = dict(bn_in=(torch.rand(ci, generator=g, device=dev) + 0.5,
                         torch.randn(ci, generator=g, device=dev)),
                  relu_in=True)
        if residual:
            kw["residual"] = torch.randn(n, ci, p, generator=g,
                                         device=dev).to(types[dt])
    n0 = C.conv1x1.launches
    y, stats = C.conv1x1(x, w, **kw)
    assert C.conv1x1.launches == n0 + 1
    assert y.dtype == x.dtype and y.shape == (n, co, p)
    ry, rstats = C.reference_conv1x1(x, w, **kw)
    y2, stats2 = C.conv1x1(x, w, **kw)
    torch.cuda.synchronize()
    if dt == "bf16":
        _bf16_close(y, ry)
    else:
        _close(y, ry)
    _stats_close(stats, rstats)
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(stats, stats2))
    assert torch.equal(C.conv1x1(x, w, want_stats=False, **kw), y)


def test_conv1x1_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import conv_fused as C
    x = torch.randn(2, 16, 64, device=dev)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        C.conv1x1(x.half(), torch.randn(8, 16, device=dev).half())
    with pytest.raises(MXNetError, match="contiguous"):
        C.conv1x1(x.transpose(1, 2).contiguous().transpose(1, 2),
                  torch.randn(8, 16, device=dev))
    with pytest.raises(ValueError, match="not blockable"):
        C.conv1x1(torch.randn(1, 512, 4000, device=dev),
                  torch.randn(512, 512, device=dev))


_RTC_SRC = r"""
extern "C" __global__ void scale_add(const float* x, const float* y,
                                     float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f + y[i];
}
extern "C" __global__ void negate(const float* x, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = -x[i];
}
template <typename T>
__global__ void twice(T* x, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = x[i] * T(2);
}
extern "C" __global__ void row_sum(const float* x, float* out, int cols) {
  extern __shared__ float part[];
  const float* row = x + (size_t)blockIdx.x * cols;
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) s += row[c];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}
"""


def test_rtc_cuda_module_roundtrip(dev):
    from mxnet_tpu_torch import gpu, rtc
    mod = rtc.CudaModule(_RTC_SRC, exports=("twice<float>",))
    a = torch.arange(8, dtype=torch.float32, device=dev).reshape(2, 4)
    b = torch.ones(2, 4, device=dev)
    out = torch.empty_like(a)
    k = mod.get_kernel("scale_add", "const float *x, const float *y, "
                       "float *out, int n")
    k.launch([a, b, out, 8], gpu(0), (1, 1, 1), (32, 1, 1))
    neg = mod.get_kernel("negate", "const float *x, float *out, int n")
    nout = torch.empty_like(a)
    neg.launch([a, nout, a.numel()], gpu(0), (1,), (8,))
    tw = mod.get_kernel("twice<float>", "float *x, int n")
    c = a.clone()
    tw.launch([c, 8], dev, (1,), (8,))
    x = torch.randn(100, 3000, device=dev)
    sums = torch.empty(100, device=dev)
    rs = mod.get_kernel("row_sum", "const float *x, float *out, int cols")
    rs.launch([x, sums, 3000], dev, (100,), (128,), shared_mem=128 * 4)
    torch.cuda.synchronize()
    assert torch.equal(out, a * 2 + 1)
    assert torch.equal(nout, -a)
    assert torch.equal(c, a * 2)
    _close(sums, x.sum(1))


def test_rtc_cuda_module_errors(dev):
    from mxnet_tpu_torch import MXNetError, gpu, rtc
    with pytest.raises(MXNetError, match="failed to compile") as e:
        rtc.CudaModule('extern "C" __global__ void broken( {}')
    assert "error" in str(e.value)
    mod = rtc.CudaModule(_RTC_SRC)
    with pytest.raises(MXNetError, match="no kernel"):
        mod.get_kernel("nope", "int n")
    with pytest.raises(MXNetError, match="exports"):
        rtc.CudaModule(_RTC_SRC, exports=("missing",))
    k = mod.get_kernel("negate", "const float *x, float *out, int n")
    x = torch.ones(2, device=dev)
    with pytest.raises(MXNetError, match="expects"):
        k.launch([x, x], gpu(0), (1,), (2,))
    with pytest.raises(MXNetError, match="takes torch.float32"):
        k.launch([x.int(), x, 2], gpu(0), (1,), (2,))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("s,h_kv,causal,d,glse", [
    (64, 4, True, 64, False), (100, 2, True, 64, True),
    (70, 4, False, 128, False), (130, 1, True, 128, True),
    (90, 2, True, 256, False), (33, 4, False, 256, True),
    (70, 2, True, 384, True), (40, 1, False, 512, False),
    (33, 4, True, 16, False), (50, 2, False, 32, True)])
def test_half_attention_kernels_match_plain(dev, dt, s, h_kv, causal, d,
                                            glse):
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(s + d + h_kv)
    q = torch.randn(2, 4, s, d, generator=g, device=dev).to(dt)
    k = torch.randn(2, h_kv, s, d, generator=g, device=dev).to(dt)
    v = torch.randn(2, h_kv, s, d, generator=g, device=dev).to(dt)
    do = torch.randn(2, 4, s, d, generator=g, device=dev).to(dt)
    gl = torch.randn(2, 4, s, generator=g, device=dev) if glse else None
    counts = [f.launches for f in (A.flash_attention_fwd,
                                   A.flash_attention_bwd_dq,
                                   A.flash_attention_bwd_dkv,
                                   A.decode_attention)]
    dense = A.dense_attention.calls
    out, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    grads = A.flash_attention_bwd(q, k, v, out, lse, do, gl, causal=causal)
    lengths = torch.tensor([s // 3, s], dtype=torch.int32, device=dev)
    dec = A.decode_attention(q[:, :, -1].contiguous(), k, v, lengths)
    assert [f.launches for f in (A.flash_attention_fwd,
                                 A.flash_attention_bwd_dq,
                                 A.flash_attention_bwd_dkv,
                                 A.decode_attention)] == [
        c + 1 for c in counts]
    assert A.dense_attention.calls == dense
    assert out.dtype == dt and lse.dtype == torch.float32
    assert [t.dtype for t in grads] == [dt] * 3 and dec.dtype == dt
    ref, rlse = A.reference_attention_with_lse(q, k, v, causal=causal)
    rgrads = A.reference_flash_attention_bwd(q, k, v, out, lse, do, gl,
                                             causal=causal)
    rdec = A.reference_decode_attention(q[:, :, -1], k, v, lengths)
    terms = U.attention_term_scales(q, k, v, causal, o=out, do=do, glse=gl)
    torch.cuda.synchronize()
    assert U.half_units(out, ref, terms[0]) <= 2
    _close(lse, rlse)
    for a, r, t in zip(grads, rgrads, terms[1:]):
        assert U.half_units(a, r, t) <= 2
    assert U.half_units(dec, rdec, U.decode_term_scales(
        q[:, :, -1], k, v, lengths)) <= 2
    # the check has teeth: one tile of 16 keys left out fails it
    ctrl = U.attention_without_keys(q, k, v, s // 2, s // 2 + 16, causal,
                                    do=do, glse=gl)
    for c, r, t in zip(ctrl, (ref, *rgrads), terms):
        assert U.half_units(c, r, t) > 2
    again = (A.flash_attention_fwd(q, k, v, causal=causal),
             A.flash_attention_bwd(q, k, v, out, lse, do, gl, causal=causal))
    assert torch.equal(again[0][0], out) and torch.equal(again[0][1], lse)
    for a, b in zip(grads, again[1]):
        assert torch.equal(a, b)


def _tf32(x):
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_flash_kernels_hold_float64_accuracy(dev, d):
    """The f32 forward and dQ (three TF32 tensor-core products each)
    against float64: within 4x the plain f32 version's own error; one TF32
    pass (the same formulas on tf32-rounded q, k, v, P and dS, in float64)
    breaks it."""
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v, do = (torch.randn(2, 4, 200, d, generator=g, device=dev)
                   for _ in range(4))
    out, lse = A.flash_attention_fwd(q, k, v, causal=True)
    dq = A.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=True)
    p_out, p_lse = A.reference_attention_with_lse(q, k, v, causal=True)
    p_dq = A.reference_flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=True)[0]

    def f64(q, k, v, rnd):
        mask = torch.ones(200, 200, dtype=torch.bool, device=dev).tril()
        s = rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(d)
        s = s.masked_fill(~mask, float("-inf"))
        lse = torch.logsumexp(s, -1)
        p = torch.exp(s - lse[..., None])
        o = rnd(p) @ rnd(v)
        dp = rnd(do.double()) @ rnd(v).transpose(-1, -2)
        ds = p * (dp - (do.double() * o).sum(-1, keepdim=True)) / math.sqrt(d)
        return o, rnd(ds) @ rnd(k)

    def exact(x):
        return x.double()

    def one_tf32(x):
        return _tf32(x.float()).double()

    o64, dq64 = f64(q, k, v, exact)
    c_out, c_dq = f64(q, k, v, one_tf32)
    for got, plain, ctrl, ref in ((out, p_out, c_out, o64),
                                  (dq, p_dq, c_dq, dq64)):
        bound = 4 * float((plain.double() - ref).abs().max())
        assert float((got.double() - ref).abs().max()) <= bound
        assert float((ctrl - ref).abs().max()) > bound


@pytest.mark.parametrize("s_q,s_k", [(128, 512), (96, 32)])
def test_cross_attention_takes_the_dense_route(dev, s_q, s_k):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(s_q + s_k)
    q = torch.randn(2, 4, s_q, 64, generator=g, device=dev).requires_grad_()
    k, v = (torch.randn(2, 2, s_k, 64, generator=g, device=dev)
            .requires_grad_() for _ in range(2))
    do = torch.randn(2, 4, s_q, 64, generator=g, device=dev)
    kernels = [f.launches for f in (A.flash_attention_fwd,
                                    A.flash_attention_bwd_dq,
                                    A.flash_attention_bwd_dkv)]
    dense = A.dense_attention.calls
    A.flash_attention(q, k, v, causal=True).backward(do)
    assert A.dense_attention.calls == dense + 1
    assert [f.launches for f in (A.flash_attention_fwd,
                                 A.flash_attention_bwd_dq,
                                 A.flash_attention_bwd_dkv)] == kernels
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    A.reference_attention(q2, k2, v2, causal=True).backward(do)
    for a, t in zip((q, k, v), (q2, k2, v2)):
        assert torch.isfinite(a.grad).all()
        _close(a.grad, t.grad)


def test_dq_f32_d128_over_many_blocks_matches_plain(dev):
    """f32 dQ at D = 128 takes tiles of 16 keys when its grid spans more
    than two waves of the card's SMs (B4 H8 S640: 320 blocks), 32 below:
    both against the plain twin, and bit-identical on a second call."""
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(640)
    for b, s in ((4, 640), (1, 100)):
        q = torch.randn(b, 8, s, 128, generator=g, device=dev)
        k, v = (torch.randn(b, 2, s, 128, generator=g, device=dev)
                for _ in range(2))
        do = torch.randn(b, 8, s, 128, generator=g, device=dev)
        out, lse = A.flash_attention_fwd(q, k, v, causal=True)
        dq = A.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=True)
        ref = A.reference_flash_attention_bwd(q, k, v, out, lse, do,
                                              causal=True)[0]
        again = A.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=True)
        torch.cuda.synchronize()
        _close(dq, ref)
        assert torch.equal(dq, again)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.0])
def test_flash_kernels_take_any_scale(dev, dt, scale):
    """A caller's scale of either sign (or 0) through the forward and
    both backward kernels, against the plain versions."""
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn(2, 4, 100, 64, generator=g, device=dev).to(dt)
                   for _ in range(4))
    out, lse = A.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    grads = A.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                  scale=scale)
    ref, rlse = A.reference_attention_with_lse(q, k, v, causal=True,
                                               scale=scale)
    rgrads = A.reference_flash_attention_bwd(q, k, v, out, lse, do,
                                             causal=True, scale=scale)
    terms = U.attention_term_scales(q, k, v, True, scale, o=out, do=do)
    torch.cuda.synchronize()
    for a, r, t in zip((out, *grads), (ref, *rgrads), terms):
        if dt == torch.float32:
            _close(a, r)
        else:
            assert U.half_units(a, r, t) <= 2
    _close(lse, rlse)
