"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card they build the
kernels from mxnet_tpu_torch/csrc and run them:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerance 1e-4 absolute plus 1e-4 of the reference's largest magnitude:
float32 sums taken in another order (chip_smoke.py states the same). The
flash backward kernels are also checked to give bit-identical gradients
on a second run (they use no atomics). The bf16/f16 conv1x1 output (every
pair of x and w types) is held within one ulp of its type of the
reference plus 1e-4 of its largest magnitude (the f32 sums differ in
order before rounding), its statistics within 1e-3 of their largest
magnitude, and bit-identical on a second run.
The rtc cases mirror tests/test_rtc.py with CUDA source through NVRTC.
The quantized matmul runs both of its kernels (qmm_small at M <= 16 or
on shapes qmm_tc does not take); with bfloat16 or float16 x it is held
within one ulp of x's type plus 1e-4 of the largest magnitude, and every
case gives
bit-identical results on a second call. With float32 x over 40 decades
both are held against float64 within the bound that exact products keep
(and that x without its third bf16 piece breaks), and every weight byte
is widened bit for bit.

Decode attention is split over the pool (one split and many, chunks
wholly past a slot's length, lengths 0 and > S), each second call
bit-identical, and its arrival counters back at 0 after every call; its
f32 kernel (FMA products) is held against float64 as the flash kernels
are.
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
import contextlib
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


_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}


# one split (a pool of <= 128 positions) and many (the plan cuts the pool
# into 128-key multiples): chunks wholly past a slot's length, a slot with
# length 0 and one with length > S, GQA groups 1/2/3/7/16, D 16..512
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,group,s", [
    (64, 3, 100), (64, 16, 2000), (128, 7, 100), (128, 7, 2000),
    (256, 3, 2000), (512, 7, 600), (16, 1, 300), (32, 16, 1000),
    (384, 2, 500)])
def test_decode_split_kernel_matches_plain(dev, dt, d, group, s):
    from mxnet_tpu_torch import _build, test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(d + group + s)
    b, h_kv = 4, 2
    h = group * h_kv
    q = torch.randn(b, h, d, generator=g, device=dev).to(_TYPES[dt])
    k = torch.randn(b, h_kv, s, d, generator=g, device=dev).to(_TYPES[dt])
    v = torch.randn(b, h_kv, s, d, generator=g, device=dev).to(_TYPES[dt])
    lengths = torch.tensor([0, s + 50, max(1, s // 3), 1], dtype=torch.int32,
                           device=dev)
    _, splits, chunk = A.decode_plan(b, h, h_kv, s, torch.cuda.
                                     get_device_properties(dev).
                                     multi_processor_count)
    assert (splits == 1) == (s <= 128) and splits * chunk >= s
    n = A.decode_attention.launches
    kernels = _build.launches("decode_attention")
    out = A.decode_attention(q, k, v, lengths)
    again = A.decode_attention(q, k, v, lengths)
    assert A.decode_attention.launches == n + 2
    assert _build.launches("decode_attention") == kernels + 2   # one a call
    ref = A.reference_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and torch.equal(out, again)
    assert not out[0].any()
    if dt == "f32":
        _close(out, ref)
    else:
        assert U.half_units(out, ref, U.decode_term_scales(
            q, k, v, lengths)) <= 2


def test_decode_arrival_counters_return_to_zero(dev):
    """Calls of several shapes share one stream's arrival counters: the
    block that merges a (slot, kv head, tile) sets its counter back to 0,
    so every call finds them zeroed and is right."""
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(3)
    for b, h, h_kv, s, d in ((8, 16, 16, 1024, 64), (3, 28, 4, 700, 128),
                             (2, 8, 2, 4000, 32), (8, 16, 16, 1024, 64)):
        q = torch.randn(b, h, d, generator=g, device=dev)
        k = torch.randn(b, h_kv, s, d, generator=g, device=dev)
        v = torch.randn(b, h_kv, s, d, generator=g, device=dev)
        lengths = torch.randint(0, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        out = A.decode_attention(q, k, v, lengths)
        _close(out, A.reference_decode_attention(q, k, v, lengths))
        torch.cuda.synchronize()
        assert A._ARRIVALS and all(not t.any()
                                   for t in A._ARRIVALS.values())


@pytest.mark.parametrize("h,h_kv,d", [(16, 16, 64), (28, 4, 128),
                                      (8, 8, 512)])
def test_f32_decode_kernel_holds_float64_accuracy(dev, h, h_kv, d):
    """f32 decode (FMA products, split over the pool) against float64:
    within 4x the plain f32 version's own error; one TF32 pass (q, k, P
    and v rounded to TF32, in float64) breaks it."""
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(h + d)
    b, s = 4, 1000
    q = torch.randn(b, h, d, generator=g, device=dev)
    k = torch.randn(b, h_kv, s, d, generator=g, device=dev)
    v = torch.randn(b, h_kv, s, d, generator=g, device=dev)
    lengths = torch.tensor([1, 130, 777, 1000], dtype=torch.int32,
                           device=dev)
    got = A.decode_attention(q, k, v, lengths)
    plain = A.reference_decode_attention(q, k, v, lengths)
    kk, vv = (t.repeat_interleave(h // h_kv, dim=1) for t in (k, v))
    valid = torch.arange(s, device=dev)[None, None, :] \
        < lengths[:, None, None]

    def f64(rnd):
        sc = torch.einsum("bhd,bhsd->bhs", rnd(q), rnd(kk)) / math.sqrt(d)
        p = torch.softmax(sc.masked_fill(~valid, float("-inf")), -1)
        return torch.einsum("bhs,bhsd->bhd", rnd(p), rnd(vv))

    ref = f64(lambda x: x.double())
    bound = 4 * float((plain.double() - ref).abs().max())
    assert float((got.double() - ref).abs().max()) <= bound
    ctrl = f64(lambda x: _tf32(x.float()).double())
    assert float((ctrl - ref).abs().max()) > bound


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


@pytest.mark.parametrize("xdt", ["f32", "bf16", "f16"])
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
    x = torch.randn(m, k, generator=g, device=dev).to(_TYPES[xdt])
    n0 = Q.quantized_matmul.launches
    out = Q.quantized_matmul(x, q, s)
    assert Q.quantized_matmul.launches == n0 + 1
    assert out.dtype == x.dtype and out.shape == (m, n)
    again = Q.quantized_matmul(x, q, s)
    ref = Q.reference_quantized_matmul(x, q, s)
    torch.cuda.synchronize()
    if xdt == "f32":
        _close(out, ref)
    else:
        _half_close(out, ref)
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


@pytest.mark.parametrize("xdt", ["f32", "bf16", "f16"])
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
                                    16).to(_TYPES[xdt])
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
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16 x"):
        Q.quantized_matmul(torch.randn(2, 4, device=dev).double(),
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


def _half_close(got, ref):
    """Within one ulp of the reference in got's type (bfloat16 or float16)
    plus 1e-4 of its largest magnitude (f32 sums in another order before
    the rounding)."""
    r = ref.float()
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.full_like(r, torch.finfo(got.dtype).eps), e - 1)
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
    ("f32", "bf16", 2, 24, 8, 64, False, False),
    # float16 and every mixed pair, ragged P (3136, 196, 49), Co and Ci
    # edges (72, 40, 200), the residual in x's type
    ("f16", "f16", 2, 64, 256, 3136, True, True),
    ("f16", "f16", 3, 512, 2048, 49, False, False),
    ("f16", "bf16", 2, 64, 256, 196, True, False),
    ("bf16", "f16", 2, 256, 64, 3136, True, True),
    ("f16", "f32", 2, 40, 72, 100, True, True),
    ("f32", "f16", 2, 40, 200, 196, True, True),
    ("f32", "bf16", 2, 64, 256, 3136, True, True),
    ("bf16", "f32", 2, 128, 512, 784, True, False),
    ("f16", "f16", 2, 1024, 256, 196, True, False),
    ("bf16", "bf16", 2, 40, 72, 49, True, True)])
def test_conv1x1_kernel_matches_plain(dev, dt, wdt, n, ci, co, p, prologue,
                                      residual):
    from mxnet_tpu_torch.ops import conv_fused as C
    types = _TYPES
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
    if dt == "f32":
        _close(y, ry)
    else:
        _half_close(y, ry)
    _stats_close(stats, rstats)
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(stats, stats2))
    assert torch.equal(C.conv1x1(x, w, want_stats=False, **kw), y)


def test_conv1x1_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import conv_fused as C
    x = torch.randn(2, 16, 64, device=dev)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        C.conv1x1(x.double(), torch.randn(8, 16, device=dev).double())
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


# -- the decode engine's CUDA graphs ------------------------------------------

# head dim 64; 8 slots over 2 kv heads make 16 decode blocks, so decode
# attention splits the pool (partials, arrival counters) inside the graph
GRAPH_CFG = dict(vocab=512, layers=2, d_model=256, heads=4, kv_heads=2,
                 d_ff=512, max_len=256)


def _graph_engine(dev, quant, name, slots=8):
    from mxnet_tpu_torch.contrib.quantization import calibrate_weights
    from mxnet_tpu_torch.serving.decode import DecodeEngine, DecodeModel
    model = DecodeModel(**GRAPH_CFG)
    params = model.init_params(seed=0)
    if quant:
        params, _ = calibrate_weights(params, quant)
    return DecodeEngine(model, params, num_slots=slots, name=name,
                        device=dev)


def _fill_pool(eng, seed):
    g = torch.Generator(device=eng.device).manual_seed(seed)
    for t in eng._k + eng._v:
        t.normal_(generator=g)
    torch.cuda.synchronize()


def _step_state(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, GRAPH_CFG["vocab"], (n,), generator=g,
                         device=dev, dtype=torch.int32)
    lens = torch.randint(0, GRAPH_CFG["max_len"], (n,), generator=g,
                         device=dev, dtype=torch.int32)
    act = (torch.arange(n, device=dev) % 3 != 2).to(torch.int32)
    return toks, lens, act


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_step_graph_replay_is_bitwise_the_eager_step(dev, quant):
    from mxnet_tpu_torch.ops import attention as A
    with _graph_engine(dev, quant, f"cg-step-{quant}") as eng:
        plan = eng._step_plan
        assert plan.graph is not None and eng.step_compiles == 1
        _fill_pool(eng, 1)
        toks, lens, act = _step_state(dev, eng.num_slots, 2)
        kc = [t.clone() for t in eng._k]
        vc = [t.clone() for t in eng._v]
        _, _, nxt, new_len, logits = eng.model.step(kc, vc, toks, lens,
                                                    act.bool())
        torch.cuda.synchronize()
        plan.host_in.copy_(torch.stack([toks, lens, act]).cpu())
        rows = list(range(eng.num_slots))
        for _ in range(2):          # a second replay gives the same bits
            with torch.cuda.stream(eng._stream):
                plan.run(rows)
            eng._stream.synchronize()
            assert torch.equal(plan.host_out, torch.stack([nxt, new_len])
                               .cpu())
            assert torch.equal(plan.logits, logits)
            assert torch.equal(plan.host_logits, logits.cpu())
            for a, b in zip(eng._k + eng._v, kc + vc):
                assert torch.equal(a, b)
            assert all(not t.any() for t in A._ARRIVALS.values())


def test_prefill_graph_replays_for_two_slots_and_two_lengths(dev):
    with _graph_engine(dev, None, "cg-prefill", slots=4) as eng:
        _fill_pool(eng, 3)
        plan = eng._prefill_plan(32, slot=2)
        assert plan.graph is not None and eng.plan_compiles == 3
        g = torch.Generator().manual_seed(4)
        for slot, n in ((1, 17), (3, 32)):
            toks = torch.zeros(32, dtype=torch.int32)
            toks[:n] = torch.randint(0, GRAPH_CFG["vocab"], (n,), generator=g,
                                     dtype=torch.int32)
            kc = [t.clone() for t in eng._k]
            vc = [t.clone() for t in eng._v]
            _, _, tok0, logits = eng.model.prefill(
                kc, vc, toks.view(1, 32).to(dev), n, slot)
            torch.cuda.synchronize()
            plan.host_in.copy_(torch.cat([toks, torch.tensor(
                [n, slot], dtype=torch.int32)]))
            with torch.cuda.stream(eng._stream):
                plan.run((0,))
            eng._stream.synchronize()
            assert int(plan.host_out[0]) == int(tok0)
            assert torch.equal(plan.host_logits[0], logits.cpu())
            for a, b in zip(eng._k + eng._v, kc + vc):
                assert torch.equal(a, b)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_graph_launches_are_the_eager_launches_on_every_replay(dev, quant):
    from mxnet_tpu_torch.serving.decode import _launch_counts
    with _graph_engine(dev, quant, f"cg-count-{quant}") as eng:
        plan = eng._step_plan
        toks, lens, act = _step_state(dev, eng.num_slots, 5)
        c0 = _launch_counts()
        eng.model.step([t.clone() for t in eng._k],
                       [t.clone() for t in eng._v], toks, lens, act.bool())
        torch.cuda.synchronize()
        c1 = _launch_counts()
        eager = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        assert plan.launches == eager
        assert eager["decode_attention"] == GRAPH_CFG["layers"]
        assert eager["lib:decode_attention"] == GRAPH_CFG["layers"]
        assert eager.get("quantized_matmul", 0) == \
            (6 * GRAPH_CFG["layers"] + 1 if quant else 0)
        plan.host_in.copy_(torch.stack([toks, lens, act]).cpu())
        before = eng.graph_launches()["replayed"]
        with torch.cuda.stream(eng._stream):
            for _ in range(5):
                plan.run()
        eng._stream.synchronize()
        c2 = _launch_counts()
        assert {k: c2[k] - c1[k] for k in c2 if c2[k] != c1[k]} == \
            {k: 5 * n for k, n in eager.items()}
        after = eng.graph_launches()["replayed"]
        assert {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)} == \
            {k: 5 * n for k, n in eager.items()}


def test_engine_serves_through_graphs(dev):
    from mxnet_tpu_torch.ops import attention as A
    with _graph_engine(dev, "int8", "cg-serve", slots=4) as eng:
        dense = A.dense_attention.calls
        sessions = [eng.submit(list(range(1, n + 1)), max_new_tokens=6)
                    for n in (3, 20, 40, 9, 100)]
        outs = [s.result(timeout=300) for s in sessions]
        assert all(len(o) == 6 for o in outs)
        assert eng.step_compiles == 1
        # the step, and buckets 8, 32, 64, 16, 128
        assert eng.plan_compiles == 1 + 5
        assert all(p["graph"] for p in eng.plans())
        assert eng.plan_resident_bytes == eng._pool_bytes() > 0
        assert eng.resident_bytes() == (eng.cache_bytes + eng.params_bytes
                                        + eng.plan_resident_bytes)
        rep = eng.graph_launches()["replayed"]
        for k in ("flash_attention_fwd", "decode_attention",
                  "quantized_matmul"):
            assert rep[k] > 0, k
        assert A.dense_attention.calls == dense
        assert all(not t.any() for t in A._ARRIVALS.values())


def _lenet_symbol(mx):
    with mx.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.Convolution(data, kernel=(5, 5), num_filter=20,
                                 name="c1")
        net = mx.sym.Activation(net, act_type="tanh")
        net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                             stride=(2, 2))
        net = mx.sym.Convolution(net, kernel=(5, 5), num_filter=50,
                                 name="c2")
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                             stride=(2, 2))
        net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=500,
                                    name="f1")
        net = mx.sym.Activation(net, act_type="tanh")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="f2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def test_executor_on_the_card_matches_the_cpu(dev):
    """LeNet (with a BatchNorm + ReLU pair) bound on the card and on the
    CPU from the same parameters. A training step in float64 (data and
    arguments): output and every gradient within 1e-9 of each tensor's
    largest magnitude, the (float32) moving statistics within 1e-6. A
    training step in float32 on the card against the CPU's float64 step:
    output and every gradient within F32_STEP_RTOL of the tensor's
    largest magnitude, and the same step with TF32 allowed everywhere
    (the port's per-call guard off) must break that bound. The float32
    inference output within 1e-5 of the CPU's.

    Readings on these inputs, each against the CPU's float64 step (card:
    H100 80GB HBM3, 700 W). The CPU's float32 step, at one thread and at
    four: c1_weight's gradient below 1.7e-6, c1_bias 3.5e-5 / 4.0e-5
    (the largest); one thread against four differs by 1.2e-6 on
    c1_weight. So no ReLU flips between summation orders here. The
    card's float32 step: 1.56e-3 on c1_weight, every other tensor at
    most 2.3e-5; with cuDNN disabled every tensor at most 2.9e-5; with
    TF32 allowed 3.1e-2 on c1_weight and 8.6e-2 on c2_weight. So the
    1.56e-3 came from the weight-gradient algorithm cuDNN picks for c1
    (1 input channel, 5 x 5, batch 8), not from TF32. The port now takes
    the weight gradient of float32 5 x 5 stride-1 convolutions as one
    float32 GEMM (``ops.nn._wgrad_route``), so F32_STEP_RTOL is
    2e-4: five times the CPU's own largest float32 error here (c1_bias,
    4.0e-5), which the TF32 control still breaks."""
    import numpy as np
    import mxnet_tpu_torch as mx
    sym = _lenet_symbol(mx)
    rng = np.random.RandomState(0)
    shape = (8, 1, 28, 28)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    args["softmax_label"] = rng.randint(0, 10, shape[0]).astype(np.float32)
    aux = {n: np.ones(s, np.float32) for n, s in
           zip(sym.list_auxiliary_states(), aux_shapes)}

    def bound(ctx, dt):
        ex = sym.simple_bind(ctx=ctx, data=shape, type_dict={
            n: dt for n in sym.list_arguments()})
        ex.copy_params_from(args, aux)
        return ex

    def close(a, b, tol, what):
        a, b = a.asnumpy().astype(np.float64), b.asnumpy().astype(np.float64)
        scale = max(1e-30, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= tol * scale, what

    exs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        ex = bound(ctx, "float64")
        ex.forward(is_train=True,
                   data=mx.nd.array(args["data"], ctx=mx.cpu()),
                   softmax_label=mx.nd.array(args["softmax_label"],
                                             ctx=mx.cpu()))
        ex.backward()
        exs.append(ex)
    card, host = exs
    assert card.arg_dict["c1_weight"]._data.device.type == "cuda"
    close(card.outputs[0], host.outputs[0], 1e-9, "out")
    for n in host.grad_dict:
        close(card.grad_dict[n], host.grad_dict[n], 1e-9, n)
    for n in host.aux_dict:
        close(card.aux_dict[n], host.aux_dict[n], 1e-6, n)
    F32_STEP_RTOL = 2e-4

    def f32_step_errors(tf32):
        from mxnet_tpu_torch.ops import nn as nnops
        cd, mm = torch.backends.cudnn, torch.backends.cuda.matmul
        old = (cd.allow_tf32, mm.allow_tf32, nnops.cudnn_f32)
        if tf32:
            nnops.cudnn_f32 = contextlib.nullcontext
            cd.allow_tf32 = mm.allow_tf32 = True
        try:
            ex = bound(mx.gpu(0), "float32")
            ex.forward(is_train=True,
                       data=mx.nd.array(args["data"], ctx=mx.cpu()),
                       softmax_label=mx.nd.array(args["softmax_label"],
                                                 ctx=mx.cpu()))
            ex.backward()
            torch.cuda.synchronize()
        finally:
            cd.allow_tf32, mm.allow_tf32, nnops.cudnn_f32 = old
        pairs = [("out", ex.outputs[0], host.outputs[0])]
        pairs += [(n, ex.grad_dict[n], host.grad_dict[n])
                  for n in host.grad_dict]
        errs = {}
        for n, a, b in pairs:
            a, b = a.asnumpy().astype(np.float64), b.asnumpy()
            errs[n] = float(np.abs(a - b).max()) / max(
                1e-30, float(np.abs(b).max()))
        return errs

    errs = f32_step_errors(tf32=False)
    assert max(errs.values()) <= F32_STEP_RTOL, errs
    control = f32_step_errors(tf32=True)
    assert max(control.values()) > F32_STEP_RTOL, control
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        ex = bound(ctx, "float32")
        outs.append(ex.forward(data=mx.nd.array(args["data"],
                                                ctx=mx.cpu()))[0])
    assert not torch.backends.cuda.matmul.allow_tf32
    close(outs[0], outs[1], 1e-5, "float32 inference output")


def _dp_trainer(mx, n_batch, **kw):
    """A conv + BatchNorm + FC net under a one-card DataParallelTrainer
    and its inputs: (trainer, state, inputs), from seed 0."""
    import numpy as np
    from mxnet_tpu_torch.parallel import DataParallelTrainer, \
        data_parallel_mesh
    with mx.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                                 pad=(1, 1), name="c1")
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                             pool_type="max")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc")
        sym = mx.sym.SoftmaxOutput(net, name="softmax")
    tr = DataParallelTrainer(sym, data_parallel_mesh(1), learning_rate=0.05,
                             rescale_grad=1.0 / n_batch, **kw)
    rng = np.random.RandomState(0)
    x = rng.standard_normal((4, n_batch, 3, 12, 12)).astype(np.float32)
    y = rng.randint(0, 10, (4, n_batch)).astype(np.float32)
    state = tr.init_state({"data": x.shape[1:], "softmax_label": (n_batch,)})
    return tr, state, tr.shard_inputs([x, y], stacked=True)


@pytest.mark.parametrize("kw", [dict(momentum=0.9, wd=1e-4),
                                dict(optimizer="adam"),
                                dict(momentum=0.9, dtype="bfloat16")],
                         ids=["sgd", "adam", "bf16"])
def test_dp_graph_step_is_bitwise_the_eager_step(dev, kw):
    """The trainer's step as a CUDA graph replay against the same body
    run eagerly on the card, from the same state: losses, parameters,
    momenta and aux bit for bit over 3 steps and a step_k of 4."""
    import mxnet_tpu_torch as mx
    with _cudnn_deterministic():
        g, e = [_dp_run(mx, kw, graphed) for graphed in (True, False)]
    assert g[0].captures == 1 and e[0].captures == 0
    assert g[0].graph_stats()["pool_bytes"] > 0
    for u, v in zip(g[1:5], e[1:5]):
        for a, b in zip(u, v):
            assert torch.equal(a, b)
    assert torch.equal(g[5], e[5])


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms (some others sum with atomics), so
    two runs can be compared bit for bit."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _dp_run(mx, kw, graphed):
    """3 steps and a step_k of 4: (trainer, params, states, aux, losses,
    the step_k outputs)."""
    tr, state, (x, y) = _dp_trainer(mx, 8, **kw)
    if not graphed:
        tr._graphed = lambda: False
    p, s, a = state
    losses = []
    for i in range(3):
        p, s, a, loss, outs = tr.step(p, s, a, (x[i], y[i]))
        losses.append(loss.clone())
    p, s, a, lk, ok = tr.step_k(p, s, a, (x, y), outputs_mode="all")
    torch.cuda.synchronize()
    return (tr, [t.clone() for t in p], [t.clone() for st in s
                                         for t in st],
            [t.clone() for t in a], losses + [lk], ok[0].clone())


def test_dp_set_learning_rate_never_recaptures(dev):
    """lr lives in a device tensor: a schedule changes what the replays
    compute (the same as eager steps at those rates) with one capture."""
    import mxnet_tpu_torch as mx
    finals = []
    for graphed in (True, False):
        tr, (p, s, a), (x, y) = _dp_trainer(mx, 8, momentum=0.9)
        if not graphed:
            tr._graphed = lambda: False
        with _cudnn_deterministic():
            for i, lr in enumerate((0.05, 0.01, 0.2, 0.02)):
                tr.set_learning_rate(lr)
                p, s, a, _, _ = tr.step(p, s, a, (x[i], y[i]))
            tr.set_learning_rate(0.1)
            p, s, a, _, _ = tr.step_k(p, s, a, (x, y))
            torch.cuda.synchronize()
        finals.append((tr.captures, [t.clone() for t in p]))
    assert finals[0][0] == 1 and finals[1][0] == 0
    for u, v in zip(finals[0][1], finals[1][1]):
        assert torch.equal(u, v)



def test_dp_mesh_over_four_cards_matches_one_card(dev):
    """A mesh over 4 cards (the replicated walk, eager: BatchNorm's
    statistics and the gradients summed across the cards through
    ``Tensor.to``) against the one-card graph step, and Module over
    gpu(0..3) against Module over gpu(0), from the same state: within
    the JAX package's own data-parallel tolerance (rtol 2e-4, atol
    1e-5; 4 partial sums in another order)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import DataParallelTrainer, \
        data_parallel_mesh
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    tr1, state, (x, y) = _dp_trainer(mx, 16, momentum=0.9)
    sym = tr1._symbol
    tr4 = DataParallelTrainer(sym, data_parallel_mesh(4), learning_rate=0.05,
                              momentum=0.9, rescale_grad=1.0 / 16)
    finals = []
    with _cudnn_deterministic():
        for tr in (tr1, tr4):
            p, s, a = (tuple(t.clone() for t in state[0]),
                       tuple(tuple(u.clone() for u in st)
                             for st in state[1]),
                       tuple(t.clone() for t in state[2]))
            for i in range(3):
                p, s, a, _, outs = tr.step(p, s, a, (x[i], y[i]))
            torch.cuda.synchronize()
            finals.append([t.cpu().numpy() for t in p + a] +
                          [outs[0].float().cpu().numpy()])
    assert tr1.captures == 1 and tr4.captures == 0
    for u, v in zip(*finals):
        np.testing.assert_allclose(u, v, rtol=2e-4, atol=1e-5)
    # Module over four cards: one executor over their mesh
    rng = np.random.RandomState(1)
    data = rng.standard_normal((64, 3, 12, 12)).astype(np.float32)
    label = rng.randint(0, 10, 64).astype(np.float32)
    params = None
    got = []
    for ctxs in ([mx.gpu(0)], [mx.gpu(i) for i in range(4)]):
        it = mx.io.NDArrayIter(data, label, 16, label_name="softmax_label")
        mod = mx.mod.Module(sym, context=ctxs)
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        if params is None:
            mod.init_params(mx.init.Xavier())
            params = mod.get_params()
        with _cudnn_deterministic():
            mod.fit(it, num_epoch=2, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.05,
                                      "momentum": 0.9},
                    arg_params=params[0], aux_params=params[1],
                    force_init=True)
        args, auxs = mod.get_params()
        got.append({k: v.asnumpy() for k, v in {**args, **auxs}.items()})
    for k in got[0]:
        np.testing.assert_allclose(got[1][k], got[0][k], rtol=2e-4,
                                   atol=1e-5, err_msg=k)
