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
"""
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


@pytest.mark.parametrize("glse", [False, True], ids=["no_glse", "glse"])
@pytest.mark.parametrize("s,h_kv,causal,d", [
    (64, 4, True, 64), (100, 4, True, 64), (100, 2, False, 64),
    (7, 1, True, 64), (100, 2, True, 128), (70, 2, True, 256),
    (33, 1, False, 256), (33, 4, True, 16), (33, 4, False, 32),
    (70, 2, True, 384), (33, 1, False, 512), (20, 4, True, 512)])
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


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as A, quantization as Q
    q = torch.randn(1, 2, 8, 64, device=dev)
    with pytest.raises(MXNetError, match="float32"):
        A.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(MXNetError, match="head dim"):
        x = torch.randn(1, 2, 8, 48, device=dev)
        A.flash_attention_fwd(x, x, x)
    with pytest.raises(MXNetError, match="above 512"):
        x = torch.randn(1, 1, 8, 640, device=dev)
        A.flash_attention_fwd(x, x, x)
    with pytest.raises(MXNetError, match="float32"):
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
