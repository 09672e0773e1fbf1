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
Gluon's ``fused_fit`` on the card (captured steps, a DataLoader on the
card) is held against the port's CPU run, and a Trainer over two cards
against one card (skips with fewer). The fused RNN op (plain PyTorch
ops on the card, as the JAX op is a scan of XLA ops) is held against
float64 within 4x the CPU float32's own error. The detection ops (plain
PyTorch ops too) at SSD300's 8,732 anchors equal the CPU's (masks,
classes, kept rows; floats within 1e-5), anchors shifted by one row must
change the targets, and MultiBoxTarget replays from a CUDA graph; the
trainer's graph step is bitwise its eager step for all eight fused
optimizers. The random ops draw on the card (means within 5 standard
errors over 2^20 draws, one seed one draw), and the python-side
optimizers' updates on the card equal the CPU's within 1e-5. The
runtime planes: the device feed's staged batches equal their sources
with the copy event waited on, the profiler's kernel lane names the
flash forward once a counted launch, and a traced step_k runs under
sync-debug "error".
Parallel breadth over a mesh listing the card 4 times: ring attention
(16 launches of each flash kernel, the backward with a non-zero lse
cotangent) and Ulysses (4 of each) against one flash call over the whole
sequence (norm-wise 1e-5 in float32), ZeRO-1 and ZeRO-2 bit-identical
to dp on the card, and the fp8 wire cast equal to the CPU's.
The image pipeline: nvJPEG's decode of the committed JPEG fixture
(tests/data/jpeg_fixture.npz, the JAX package's OpenCV decode beside
each JPEG) within a mean of 1.5 and a largest difference of 16 units
(another IDCT and chroma upsampling than libjpeg's), which another
entry's pixels must fail; an nvJPEG encode round trip; the assembly
kernel bit-identical to its plain version (uint8, crop, mirror, resize)
and float32 with mean/std equal; and ImageRecordIter's card route
drawing the crops and flips of its ``ctx=cpu()`` twin, its batch the
plain assembly of the card's decode at those draws.
"""
import contextlib
import functools
import math
import os

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


@pytest.mark.parametrize("route", ["nd", "sym"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_registry_flash_attention_op_matches_plain(dev, dt, route):
    """``_contrib_flash_attention`` (what Gluon's MultiHeadAttention calls,
    eager through ``mx.nd`` and hybridized through the executor) on the
    card: one launch of each flash kernel a forward and backward, and
    out / dq / dk / dv against the plain versions on the same inputs (q,
    k, v handed over as transposed views, as the block makes them), with
    the tolerances above: f32 ``_close``, bf16 within 2 half units."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(11)
    b, s, h, d = 2, 96, 4, 64
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
                   .to(dt).transpose(1, 2) for _ in range(4))
    arrs = [mx.nd.NDArray(t) for t in (q, k, v)]
    for a in arrs:
        a.attach_grad()
    counts = [f.launches for f in (A.flash_attention_fwd,
                                   A.flash_attention_bwd_dq,
                                   A.flash_attention_bwd_dkv)]
    with mx.autograd.record():
        if route == "nd":
            out = mx.nd._contrib_flash_attention(*arrs, causal=True)
        else:
            names = [mx.sym.var(n) for n in ("q", "k", "v")]
            block = mx.gluon.SymbolBlock(
                mx.sym._contrib_flash_attention(*names, causal=True), names)
            block.hybridize()
            out = block(*arrs)
    out.backward(mx.nd.NDArray(do.contiguous()))
    torch.cuda.synchronize()
    assert [f.launches for f in (A.flash_attention_fwd,
                                 A.flash_attention_bwd_dq,
                                 A.flash_attention_bwd_dkv)] == [
        c + 1 for c in counts]
    got = [out._data] + [a.grad._data for a in arrs]
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    ref, lse = A.reference_attention_with_lse(qc, kc, vc, causal=True)
    rgrads = A.reference_flash_attention_bwd(qc, kc, vc, got[0], lse, doc,
                                             causal=True)
    if dt == torch.float32:
        for a, r in zip(got, [ref, *rgrads]):
            _close(a, r)
    else:
        terms = U.attention_term_scales(qc, kc, vc, True, o=got[0], do=doc)
        for a, r, t in zip(got, [ref, *rgrads], terms):
            assert U.half_units(a, r, t) <= 2


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


@pytest.mark.parametrize("kw", [
    dict(momentum=0.9, wd=1e-4), dict(optimizer="adam"),
    dict(momentum=0.9, dtype="bfloat16"),
    dict(optimizer="rmsprop", gamma1=0.9, wd=1e-4),
    dict(optimizer="rmspropalex", gamma1=0.9, gamma2=0.8),
    dict(optimizer="ftrl", lamda1=1e-6), dict(optimizer="signsgd"),
    dict(optimizer="signum", momentum=0.9, wd_lh=1e-4),
    dict(optimizer="ftml", beta2=0.99)],
    ids=["sgd", "adam", "bf16", "rmsprop", "rmspropalex", "ftrl", "signsgd",
         "signum", "ftml"])
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


def _gluon_convnet(mx, ctx, values=None):
    """A conv + BatchNorm + Dense Gluon net on ``ctx`` (a context or a
    list), its deferred shapes finished on a (16, 3, 8, 8) batch, set
    from ``values`` or a seeded draw; returns (net, values)."""
    import numpy as np
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, kernel_size=3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Dense(10))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    first = ctx[0] if isinstance(ctx, list) else ctx
    net(mx.nd.array(np.zeros((16, 3, 8, 8), np.float32), ctx=first))
    rng = np.random.RandomState(2)
    params = list(net.collect_params().values())
    if values is None:
        values = [rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
                  if p.name.endswith(("gamma", "var")) else
                  rng.normal(0, 0.2, p.shape).astype(np.float32)
                  for p in params]
    for p, v in zip(params, values):
        p.set_data(mx.nd.array(v, ctx=first))
    return net, values


def _gluon_batches(n):
    import numpy as np
    rng = np.random.RandomState(3)
    return [(rng.standard_normal((16, 3, 8, 8)).astype(np.float32),
             rng.randint(0, 10, 16).astype(np.float32)) for _ in range(n)]


def test_gluon_fused_fit_on_the_card_matches_the_cpu(dev, monkeypatch):
    """fused_fit on the card (K = 4 replays of one captured step a block,
    a tail block of 2, batches from a DataLoader on the card) against the
    port's CPU run from the same parameters: epoch losses and parameters
    within 1e-4 of the tensor's largest magnitude (float32 sums in
    another order; cuDNN deterministic)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dp
    trainers = []
    real_init = dp.DataParallelTrainer.__init__

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        trainers.append(self)
    monkeypatch.setattr(dp.DataParallelTrainer, "__init__", recording_init)
    batches = _gluon_batches(6)
    xs = np.stack([b[0] for b in batches]).reshape(-1, 3, 8, 8)
    ys = np.concatenate([b[1] for b in batches])
    got = []
    values = None
    with _cudnn_deterministic():
        for ctx in (mx.cpu(), mx.gpu(0)):
            net, values = _gluon_convnet(mx, ctx, values)
            with ctx:
                loader = mx.gluon.data.DataLoader(
                    mx.gluon.data.ArrayDataset(xs, ys), batch_size=16)
                losses = mx.gluon.trainer.fused_fit(
                    net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), loader, 2,
                    optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                    steps_per_dispatch=4)
            got.append((losses, [p.data().asnumpy() for p in
                                 net.collect_params().values()]))
    # one capture: the tail block replays the same per-step graph
    assert trainers[0].captures == 0 and trainers[1].captures == 1
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-4)
    for a, b in zip(got[1][1], got[0][1]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


def test_gluon_trainer_over_two_cards_matches_one(dev):
    """A hybridized net over gpu(0) and gpu(1) (split_and_load batches
    through the mesh walk, the kvstore updating) against one card, 3
    steps: the JAX package's data-parallel tolerance (rtol 2e-4, atol
    1e-5)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    batches = _gluon_batches(3)
    finals, values = [], None
    with _cudnn_deterministic():
        for ctxs in ([mx.gpu(0)], [mx.gpu(0), mx.gpu(1)]):
            net, values = _gluon_convnet(mx, ctxs, values)
            net.hybridize()
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            for x, y in batches:
                xb = mx.gluon.utils.split_and_load(x, ctxs)[0]
                yb = mx.gluon.utils.split_and_load(y, ctxs)[0]
                with mx.autograd.record():
                    loss = loss_fn(net(xb), yb)
                loss.backward()
                tr.step(16)
            finals.append([p.data(ctxs[0]).asnumpy()
                           for p in net.collect_params().values()])
    assert tr._kvstore is not None
    for a, b in zip(*finals):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)


def test_rnn_op_on_the_card_against_float64(dev):
    """The fused RNN op (lstm, 2 layers, bidirectional) in float32 on the
    card and on the CPU, each against the CPU's float64: the outputs and
    the gradients of random cotangents for data, parameters and both
    states within 4x the CPU float32's own error (norm-wise, the largest
    over the tensors, plus 1e-7)."""
    import numpy as np
    from mxnet_tpu_torch.ops.registry import OpCtx, get_op
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size
    T, N, I, H, L = 12, 4, 8, 16, 2
    rng = np.random.RandomState(0)
    ins = [rng.uniform(-1, 1, (T, N, I)),
           rng.uniform(-0.3, 0.3, rnn_param_size(L, I, H, True, "lstm")),
           rng.uniform(-0.5, 0.5, (2 * L, N, H)),
           rng.uniform(-0.5, 0.5, (2 * L, N, H))]
    cts = [rng.standard_normal((T, N, 2 * H)),
           rng.standard_normal((2 * L, N, H)),
           rng.standard_normal((2 * L, N, H))]
    schema = get_op("RNN")
    attrs = schema.parse_attrs(dict(state_size=H, num_layers=L,
                                    bidirectional=True, mode="lstm"))

    def run(device, dtype):
        xs = [torch.tensor(a, dtype=dtype, device=device,
                           requires_grad=True) for a in ins]
        outs = schema.fcompute(attrs, OpCtx(is_train=True), *xs)
        grads = torch.autograd.grad(outs, xs, [
            torch.tensor(c, dtype=dtype, device=device) for c in cts])
        return [t.detach().to("cpu", torch.float64).numpy()
                for t in list(outs) + list(grads)]
    ref = run("cpu", torch.float64)

    def worst(got):
        return max(np.linalg.norm(g - r) / np.linalg.norm(r)
                   for g, r in zip(got, ref))
    card, cpu = worst(run(dev, torch.float32)), \
        worst(run("cpu", torch.float32))
    assert card <= 4 * cpu + 1e-7, (card, cpu)


# -- the detection ops (plain PyTorch ops, SSD300's shapes) -------------------

def _ssd_inputs(batch=4, seed=0):
    """SSD300's 8,732 anchors (chip_smoke.py's symbol at 1/16 width, its
    MultiBoxPrior outputs), seeded class and box predictions, and
    chip_smoke.synthetic_detection's labels with the last image's
    ground truth removed."""
    import os
    import sys
    import numpy as np
    import mxnet_tpu_torch as mx
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    with mx.NameManager():
        sym = chip_smoke.ssd300_vgg16_symbol(mx.sym, width_div=16)
    anc = sym.get_internals()["multibox_anchors_output"]
    ex = anc.simple_bind(ctx=mx.cpu(), data=(1, 3, 300, 300),
                         grad_req="null")
    ex.forward(is_train=False,
               data=mx.nd.zeros((1, 3, 300, 300), ctx=mx.cpu()))
    anchors = ex.outputs[0]._data.clone()
    _, y = chip_smoke.synthetic_detection(batch, seed=seed)
    y[-1] = -1.0
    rng = np.random.RandomState(seed + 1)
    na = anchors.shape[1]
    cls_pred = torch.tensor(rng.standard_normal((batch, 21, na)) * 2,
                            dtype=torch.float32)
    loc_pred = torch.tensor(rng.standard_normal((batch, na * 4)) * 0.5,
                            dtype=torch.float32)
    return anchors, torch.tensor(y), cls_pred, loc_pred


def _op(name, attrs, *xs):
    from mxnet_tpu_torch.ops import registry
    s = registry.get_op(name)
    return s.fcompute(s.parse_attrs(attrs), registry.OpCtx(
        device=xs[0].device), *xs)


@pytest.mark.parametrize("mining", [-1.0, 3.0])
def test_multibox_target_on_the_card_is_the_cpu(dev, mining):
    """Masks and classes equal, loc targets within 1e-5 of their largest
    magnitude; anchors shifted by one row must break the equality."""
    anchors, label, cls_pred, _ = _ssd_inputs()
    attrs = dict(negative_mining_ratio=mining, negative_mining_thresh=0.5)
    want = _op("_contrib_MultiBoxTarget", attrs, anchors, label, cls_pred)
    got = [t.cpu() for t in _op("_contrib_MultiBoxTarget", attrs,
                                anchors.to(dev), label.to(dev),
                                cls_pred.to(dev))]
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert float((got[0] - want[0]).abs().max()) \
        <= 1e-5 * float(want[0].abs().max())
    assert (want[2][-1] == -1).all() and (want[2] > 0).any()
    shifted = _op("_contrib_MultiBoxTarget", attrs,
                  torch.roll(anchors, 1, dims=1).to(dev), label.to(dev),
                  cls_pred.to(dev))
    assert not torch.equal(shifted[2].cpu(), want[2])


@pytest.mark.parametrize("topk", [-1, 400])
def test_multibox_detection_on_the_card_is_the_cpu(dev, topk):
    """The kept rows (ids) equal, scores and boxes within 1e-5 of their
    largest magnitude, at nms_topk -1 and 400."""
    anchors, _, cls_pred, loc_pred = _ssd_inputs()
    prob = torch.softmax(cls_pred, dim=1)
    attrs = dict(nms_threshold=0.45, nms_topk=topk)
    want = _op("_contrib_MultiBoxDetection", attrs, prob, loc_pred,
               anchors)[0]
    got = _op("_contrib_MultiBoxDetection", attrs, prob.to(dev),
              loc_pred.to(dev), anchors.to(dev))[0].cpu()
    assert torch.equal(got[..., 0], want[..., 0])
    assert float((got - want).abs().max()) <= 1e-5
    assert (want[..., 0] >= 0).sum() > 0


def test_box_nms_and_iou_and_matching_on_the_card_are_the_cpu(dev):
    import numpy as np
    rng = np.random.RandomState(3)
    xy = rng.rand(3, 500, 2) * 0.6
    rows = torch.tensor(np.concatenate([
        rng.randint(0, 4, (3, 500, 1)), rng.rand(3, 500, 1), xy,
        xy + rng.rand(3, 500, 2) * 0.4 + 0.02], -1), dtype=torch.float32)
    for attrs in (dict(), dict(topk=100, id_index=0, overlap_thresh=0.3),
                  dict(force_suppress=True, valid_thresh=0.2)):
        want = _op("_contrib_box_nms", attrs, rows)[0]
        got = _op("_contrib_box_nms", attrs, rows.to(dev))[0].cpu()
        assert torch.equal(got, want), attrs
    iou = _op("_contrib_box_iou", {}, rows[0, :, 2:6], rows[1, :, 2:6])[0]
    got = _op("_contrib_box_iou", {}, rows[0, :, 2:6].to(dev),
              rows[1, :, 2:6].to(dev))[0].cpu()
    assert torch.equal(got, iou)
    score = torch.rand(2, 30, 20, generator=torch.Generator().manual_seed(0))
    want = _op("_contrib_bipartite_matching", dict(threshold=0.1), score)
    got = _op("_contrib_bipartite_matching", dict(threshold=0.1),
              score.to(dev))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_multibox_target_is_captured_in_a_cuda_graph(dev):
    """MultiBoxTarget has no host sync: it captures into a CUDA graph,
    and the replay gives the eager result (a training step that holds it
    can be a graph)."""
    anchors, label, cls_pred, _ = _ssd_inputs()
    args = [t.to(dev) for t in (anchors, label, cls_pred)]
    attrs = dict(negative_mining_ratio=3.0)
    want = _op("_contrib_MultiBoxTarget", attrs, *args)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        _op("_contrib_MultiBoxTarget", attrs, *args)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = _op("_contrib_MultiBoxTarget", attrs, *args)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(out, want))



# -- the random ops and the python-side optimizers on the card ----------------

@pytest.mark.parametrize("name,attrs,mean,var", [
    ("_random_uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    ("_random_normal", dict(loc=0.5, scale=2.0), 0.5, 4.0),
    ("_random_gamma", dict(alpha=0.4, beta=2.0), 0.8, 1.6),
    ("_random_gamma", dict(alpha=2.5, beta=1.5), 3.75, 5.625),
    ("_random_exponential", dict(lam=4.0), 0.25, 1 / 16),
    ("_random_poisson", dict(lam=3.5), 3.5, 3.5),
    ("_random_negative_binomial", dict(k=3, p=0.4), 4.5, 11.25),
    ("_random_randint", dict(low=-3, high=7), 1.5, 99 / 12)])
def test_random_ops_draw_on_the_card(dev, name, attrs, mean, var):
    """Each scalar-parameter random op draws on the card from the port's
    generator of the card: the sample mean within 5 standard errors of
    the distribution's over 10^6 draws, the same draws under one seed."""
    import mxnet_tpu_torch as mx
    n = 1 << 20

    def draw():
        mx.random.seed(7)
        out = mx.nd.__getattr__(name)(shape=(n,), ctx=mx.gpu(0), **attrs)
        return out._data
    a, b = draw(), draw()
    assert a.is_cuda and torch.equal(a, b)
    x = a.double()
    assert abs(float(x.mean()) - mean) <= 5 * math.sqrt(var / n)


def test_multinomial_and_shuffle_on_the_card(dev):
    import mxnet_tpu_torch as mx
    mx.random.seed(3)
    p = mx.nd.array([[0.1, 0.2, 0.7]], ctx=mx.gpu(0))
    d, lp = mx.nd.random.multinomial(p, shape=(200000,), get_prob=True)
    d = d._data
    assert d.is_cuda
    for c, q in enumerate((0.1, 0.2, 0.7)):
        f = float((d == c).double().mean())
        assert abs(f - q) <= 5 * math.sqrt(q * (1 - q) / d.numel())
    assert torch.allclose(lp._data, torch.log(
        torch.tensor([0.1, 0.2, 0.7], device=d.device))[d.long()])
    rows = mx.nd.array([[float(i)] for i in range(1000)], ctx=mx.gpu(0))
    got = mx.nd.random.shuffle(rows)._data
    assert got.is_cuda and torch.equal(got.sort(0).values, rows._data)


@pytest.mark.parametrize("name", ["signum", "ftml", "dcasgd", "nag", "sgld",
                                  "adagrad", "rmsprop", "adadelta", "ftrl",
                                  "adamax", "nadam", "lbsgd", "test"])
def test_optimizer_on_the_card_is_the_cpu(dev, name):
    """3 updates of the optimizer on the card against the same updates on
    the CPU (SGLD's noise taken out): within 1e-5 of the weight's largest
    magnitude."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as O
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-1, 1, (64, 33)).astype(np.float32)
    grads = [rng.standard_normal(w0.shape).astype(np.float32)
             for _ in range(3)]
    noise = O._sgld_noise
    O._sgld_noise = lambda w, lr: torch.zeros_like(w)
    try:
        out = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            opt = O.create(name, learning_rate=0.05, wd=0.01,
                           rescale_grad=0.5, clip_gradient=1.0)
            upd = O.get_updater(opt)
            w = mx.nd.array(w0, ctx=ctx)
            for g in grads:
                upd(0, mx.nd.array(g, ctx=ctx), w)
            out.append(w.asnumpy())
    finally:
        O._sgld_noise = noise
    assert np.abs(out[1] - out[0]).max() <= 1e-5 * np.abs(out[0]).max()
    assert np.abs(out[0] - w0).max() > 0


# -- the runtime planes on the card ------------------------------------------

def test_device_feed_stages_equal_tensors_and_honours_the_copy_event(dev):
    """pipeline.DeviceFeed on the card (tests/test_torch_pipeline.py::
    test_feed_order_values_and_shutdown pins the order and values on the
    host): each batch staged by the feeder thread through pinned memory
    on the feed's copy stream equals its source, in order; the copy is
    queued behind a ~20 ms sleep on that stream, so a consumer that did
    not wait on the copy event would read the copy's memory early."""
    from mxnet_tpu_torch import pipeline
    copy_stream = torch.cuda.Stream(dev)
    gen = torch.Generator().manual_seed(0)
    src = [torch.randn(1 << 22, generator=gen) for _ in range(4)]

    def stage(t):
        with torch.cuda.stream(copy_stream):
            torch.cuda._sleep(40_000_000)
        (out,), event = pipeline.stage_tensors([t], dev, copy_stream)
        return pipeline.Staged(out, (out,), event)

    with pipeline.DeviceFeed(iter(src), stage=stage) as feed:
        got = [(t.device, t.sum(), t.clone()) for t in feed]
    assert not feed._thread.is_alive()
    for (device, s, t), ref in zip(got, src):
        assert device.type == "cuda"
        assert torch.equal(t.cpu(), ref)
        assert float(s) == float(t.sum())


def test_profiler_kernel_lane_lists_the_flash_kernel(dev, tmp_path):
    """profiler.set_config(xplane_dir=...) on the card: the chrome trace
    of torch.profiler names flash_fwd_tc once a launch the counter saw
    (tests/test_torch_profiler.py::test_kernel_lane_writes_a_torch_trace
    pins the lane on the host)."""
    import json
    import re
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import attention as A
    q, k, v = (torch.randn(2, 4, 128, 64, device=dev) for _ in range(3))
    A.flash_attention_fwd(q, k, v, causal=True)     # built, warmed
    torch.cuda.synchronize()
    saved = dict(profiler._config)
    before = A.flash_attention_fwd.launches
    try:
        profiler.set_config(xplane_dir=str(tmp_path))
        profiler.set_state("run")
        for _ in range(3):
            A.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        profiler.set_state("stop")
    finally:
        profiler.set_state("stop")
        profiler._config.clear()
        profiler._config.update(saved)
    with open(profiler.kernel_profile()[1]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    seen = sum(1 for n in names if re.search(r"\bflash_fwd_tc\b", n))
    assert seen == A.flash_attention_fwd.launches - before == 3


def test_traced_step_k_runs_under_sync_debug_error(dev, monkeypatch):
    """One step_k of a one-card DataParallelTrainer (replays of its
    captured step) inside a tracing span, with the step log's record, runs
    under torch.cuda.set_sync_debug_mode("error"): neither the spans nor
    the StepLogger wait for the card (tests/test_torch_tracing.py::
    test_span_traced_event_and_set_step pins the span semantics)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.telemetry import StepLogger, tracing
    monkeypatch.setenv("MXNET_TRACE", "1")
    monkeypatch.delenv("MXNET_TELEMETRY_LOG", raising=False)
    tr, (params, states, aux), inputs = _dp_trainer(mx, 8)
    tr.step_k(params, states, aux, inputs)          # captured here
    torch.cuda.synchronize()
    slog = StepLogger("sync_debug_test")
    torch.cuda.set_sync_debug_mode("error")
    try:
        with tracing.span("step.fused_dispatch", phase="compute", k=4):
            out = tr.step_k(params, states, aux, inputs)
        slog.step(samples=32, steps=4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    slog.close()
    assert tr.captures == 1
    assert torch.isfinite(out[3]).all()


def _nerr(got, ref):
    got, ref = got.detach().double(), ref.detach().double()
    return float((got - ref).norm() / ref.norm())


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_attention_on_the_card(dev, kind):
    """ring_attention (auto impl: flash on a CUDA mesh) and
    ulysses_attention over build_mesh({"sp": 4}, [cuda:0] * 4): output and
    gradients against one flash call over the whole sequence, norm-wise
    1e-5 in float32 (tests/test_torch_sp.py holds the bodies against the
    JAX package on the host); the kernels' launches a step."""
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.parallel import build_mesh, ring_attention, \
        ulysses_attention
    mesh = build_mesh({"sp": 4}, [dev] * 4)
    fn = ring_attention if kind == "ring" else ulysses_attention
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(1, 8, 1024, 64, generator=g, device=dev)
               .requires_grad_(True) for _ in range(3))
    fwd, dq = A.flash_attention_fwd.launches, \
        A.flash_attention_bwd_dq.launches
    out = fn(q, k, v, mesh, causal=True)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    torch.cuda.synchronize()
    want = 16 if kind == "ring" else 4
    assert A.flash_attention_fwd.launches - fwd == want
    assert A.flash_attention_bwd_dq.launches - dq == want
    ref = A.flash_attention(q, k, v, causal=True)
    rgrads = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    assert _nerr(out, ref) <= 1e-5
    for a, b in zip(grads, rgrads):
        assert _nerr(a, b) <= 1e-5


def test_zero_equals_dp_on_the_card(dev):
    """ZeRO-1 and ZeRO-2 over 4 replicas of the card equal dp over the
    same mesh bit for bit in float32 (the sums in autograd's order; an
    MLP: cuBLAS's products are the same a replica in both)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import DataParallelTrainer, build_mesh
    mesh = build_mesh({"data": 4}, [dev] * 4)
    with mx.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                    num_hidden=64, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc")
        sym = mx.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    host = []
    for stage in (0, 1, 2):
        tr = DataParallelTrainer(sym, mesh, optimizer="adam",
                                 learning_rate=0.01, rescale_grad=1 / 16,
                                 zero_stage=stage, zero_bucket_mb=0.002)
        state = tr.init_state({"data": x.shape, "softmax_label": y.shape})
        inputs = tr.shard_inputs([x, y])
        for _ in range(3):
            state = tr.step(*state, inputs)[:3]
        host.append(tr.host_params(state[0]))
    for h in host[1:]:
        for n in host[0]:
            assert np.array_equal(h[n], host[0][n]), n


def test_fp8_wire_cast_on_the_card_is_the_cpus(dev):
    from mxnet_tpu_torch.parallel.mesh import cast_wire
    v = torch.tensor([447, 448, 449, 464, 464.5, 500, -465, 17, 19, 1.0625,
                      float("inf"), float("-inf"), 2.0 ** -10, 3e-3])
    got = cast_wire(v.to(dev), torch.float8_e4m3fn).float().cpu()
    want = cast_wire(v, torch.float8_e4m3fn).float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~got.isnan()], want[~want.isnan()])


def test_tensor_parallel_walk_on_the_card(dev):
    """dp2.tp2 and dp2.tp2+zero2 over 4 replicas of the card against dp
    over the same mesh (3 SGD steps with momentum of an MLP): within
    1e-5 of each tensor's largest element (cuBLAS sums a split product
    in another order); the tensor-parallel step is a CUDA graph (one
    capture) whose replays add the wire the planner priced."""
    import numpy as np
    from mxnet_tpu_torch.parallel import mesh as pmesh, planner
    model = planner._small_model()[0]
    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.randint(0, 8, 16).astype(np.float32)
    host = {}
    for plan in ("dp", "dp2.tp2", "dp2.tp2+zero2"):
        tr = planner.make_trainer(model.symbol, model.shape_kwargs,
                                  plan=plan, devices=[dev] * 4,
                                  apply_knobs=False, optimizer="sgd",
                                  **model.trainer_kwargs)
        state = tr.init_state(model.shape_kwargs)
        inputs = tr.shard_inputs([x, y])
        state = tr.step(*state, inputs)[:3]
        pmesh.reset_wire()
        for _ in range(2):
            state = tr.step(*state, inputs)[:3]
        torch.cuda.synchronize()
        priced = planner.score_plan(model, tr._sharding_plan)["wire_bytes"]
        assert abs(pmesh.wire_bytes() - 2 * priced) < 2.0, plan
        if plan == "dp2.tp2":
            assert tr.captures == 1
        host[plan] = tr.host_params(state[0])
    for plan in ("dp2.tp2", "dp2.tp2+zero2"):
        for n, ref in host["dp"].items():
            err = np.abs(host[plan][n] - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, (plan, n, err)


def test_segmented_walk_on_the_card(dev):
    """group2ctx with a head group on the host: every node's output on
    its group's device, outputs and gradients equal the all-card walk's
    within 1e-4, copies at the stage boundaries; the head on the card
    makes none."""
    import numpy as np
    import mxnet_tpu_torch as mx

    def build():
        with mx.NameManager():
            x = mx.sym.Variable("data")
            with mx.AttrScope(ctx_group="body"):
                h = mx.sym.FullyConnected(x, num_hidden=32, name="fc0")
                h = mx.sym.Activation(h, act_type="tanh")
            with mx.AttrScope(ctx_group="head"):
                h = mx.sym.FullyConnected(h, num_hidden=4, name="fc1")
                return mx.sym.SoftmaxOutput(h, name="softmax")
    rng = np.random.RandomState(0)
    xs = rng.normal(size=(8, 16)).astype(np.float32)
    ys = rng.randint(0, 4, 8).astype(np.float32)
    gpu = mx.gpu(dev.index or 0)
    got = {}
    for head in (mx.cpu(), gpu):
        ex = build().simple_bind(gpu, data=(8, 16), softmax_label=(8,),
                                 group2ctx={"body": gpu, "head": head})
        r = np.random.RandomState(1)
        for k in ("fc0_weight", "fc0_bias", "fc1_weight", "fc1_bias"):
            ex.arg_dict[k][:] = r.normal(0, 0.3, ex.arg_dict[k].shape) \
                .astype(np.float32)
        seen = {}
        ex.set_monitor_callback(lambda n, t: seen.setdefault(
            n.rsplit("_output", 1)[0], t._data.device))
        out = ex.forward(is_train=True, data=mx.nd.array(xs, ctx=gpu),
                         softmax_label=mx.nd.array(ys, ctx=gpu))[0]
        ex.backward()
        for n, c in ex.placement.items():
            assert seen[n] == c.torch_device(), n
        got[head.device_type] = (out.asnumpy(), {
            k: g.asnumpy() for k, g in ex.grad_dict.items()}, ex.copies)
    (o1, g1, c1), (o2, g2, c2) = got["cpu"], got["gpu"]
    assert c1 > 0 and c2 == 0
    np.testing.assert_allclose(o1, o2, rtol=1e-4, atol=1e-6)
    for k in g2:
        np.testing.assert_allclose(g1[k], g2[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


JPEG_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "jpeg_fixture.npz")


def _jpeg_fixture():
    """[(JPEG bytes, the JAX package's decoded BGR pixels)]."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.test_utils import jpeg_fixture
    return [(recordio.unpack(r)[1], pix)
            for r, pix in jpeg_fixture(JPEG_FIXTURE)]


def test_nvjpeg_decodes_the_fixture_as_the_jax_package(dev):
    import numpy as np
    from mxnet_tpu_torch.image import codec
    entries = _jpeg_fixture()
    for buf, pix in entries:
        got = codec.decode(buf, dev, to_rgb=False).cpu().numpy()
        d = np.abs(got.astype(np.int64) - pix)
        assert d.mean() <= 1.5 and d.max() <= 16, (d.mean(), d.max())
    # the control: entry 0's decode against entry 1's pixels
    got = codec.decode(entries[0][0], dev, to_rgb=False).cpu().numpy()
    assert np.abs(got.astype(np.int64) - entries[1][1]).mean() > 1.5
    # RGB is BGR reversed; an encode round trip at quality 95
    rgb = codec.decode(entries[2][0], dev).cpu().numpy()
    bgr = torch.from_numpy(rgb[:, :, ::-1].copy()).to(dev)
    back = codec.decode(codec.encode(bgr, 95, bgr=True), dev,
                        to_rgb=False).float()
    mse = float(((back - bgr.float()) ** 2).mean())
    assert 10 * math.log10(255 ** 2 / max(mse, 1e-12)) > 30


def _assembly_case(dev, n, resize, out=32):
    import numpy as np
    from mxnet_tpu_torch.image import assemble, codec
    rng = np.random.RandomState(0)
    plans, offs, pos = [], [], 0
    for i in range(n):
        h, w = rng.randint(out + 2, out + 40, 2)
        rec = assemble._IR.pack(0, float(i), i, 0) + b"\xff\xd8"
        plans.append(assemble.plan_record(
            rec, lambda p, h=h, w=w: (int(h), int(w)), 3, 1, i,
            (3, out, out), resize, True, True, 1))
        offs.append(pos)
        pos += int(h) * int(w) * 3
    raw = torch.randint(0, 256, (pos,), dtype=torch.uint8, device=dev)
    return raw, plans, offs, codec


@pytest.mark.parametrize("resize", [0, 40])
def test_image_assemble_kernel_matches_plain(dev, resize):
    from mxnet_tpu_torch.image import assemble
    raw, plans, offs, _ = _assembly_case(dev, 9, resize)
    n0 = assemble.assemble.launches
    got = assemble.assemble(raw, plans, offs, (32, 32))
    ref = assemble.assemble_plain(raw, plans, offs, (32, 32))
    assert assemble.assemble.launches == n0 + 1
    assert torch.equal(got, ref)
    kw = dict(mean=[123.68, 116.28, 103.53], std=[58.395, 57.12, 57.375])
    got = assemble.assemble(raw, plans, offs, (32, 32), "float32", **kw)
    ref = assemble.assemble_plain(raw, plans, offs, (32, 32), "float32",
                                  **kw)
    assert torch.equal(got, ref)
    # the host's plain version on the same bytes: the same batch
    host = assemble.assemble_plain(raw.cpu(), plans, offs, (32, 32),
                                   "float32", **kw)
    assert torch.equal(got.cpu(), host)


def test_image_record_iter_card_draws_equal_the_cpu_twin(dev, tmp_path):
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.image import assemble, codec
    rng = np.random.RandomState(1)
    rec = str(tmp_path / "c.rec")
    w = mx.recordio.MXRecordIO(rec, "w")
    for i in range(12):
        img = torch.from_numpy(rng.randint(0, 256, (rng.randint(36, 60),
                                                    rng.randint(36, 60), 3))
                               .astype(np.uint8))
        w.write(mx.recordio.pack_img(mx.recordio.IRHeader(0, float(i), i, 0),
                                     img, quality=90, ctx=mx.gpu()))
    w.close()
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=5,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=40,
              output_dtype="uint8", seed=4)
    card = mx.image.ImageRecordIter(ctx=mx.gpu(), **kw)
    host = mx.image.ImageRecordIter(ctx=mx.cpu(), **kw)
    n0 = assemble.assemble.launches
    for k in range(3):
        b = card.next()
        plans, _ = card.plans(k)
        host.next()
        assert card.last_draws == host.last_draws
        assert b.data[0].context == mx.gpu()
        raw = torch.cat([codec.decode(p.payload, dev).reshape(-1)
                         for p in plans])
        offs = np.concatenate([[0], np.cumsum(
            [p.sh * p.sw * 3 for p in plans])])[:-1]
        ref = assemble.assemble_plain(raw, plans, list(offs), (32, 32))
        assert torch.equal(b.data[0]._data, ref)
    assert assemble.assemble.launches == n0 + 3
    card.close()
    host.close()


def test_image_record_iter_card_draws_hold_while_training(dev, tmp_path):
    """Batches the card route delivers while a one-card trainer steps on
    the current stream equal the plain assembly of a fresh decode of their
    own plans, and the producer's buffers never take a block that work
    still queued on that stream reads: after each step a tensor of 7s the
    size of a batch's decoded images is freed while a sum over it waits
    behind a sleep on the card, and every sum must still see only 7s."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.image import assemble, codec
    from mxnet_tpu_torch.parallel import DataParallelTrainer, \
        data_parallel_mesh
    rng = np.random.RandomState(2)
    rec = str(tmp_path / "t.rec")
    w = mx.recordio.MXRecordIO(rec, "w")
    for i in range(48):
        img = torch.from_numpy(rng.randint(0, 256, (48, 52, 3))
                               .astype(np.uint8))
        w.write(mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(i % 10), i, 0), img, quality=90,
            ctx=mx.gpu()))
    w.close()
    it = mx.image.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, 32, 32), batch_size=8, shuffle=True,
        rand_crop=True, rand_mirror=True, resize=40, output_dtype="uint8",
        preprocess_threads=4, prefetch_buffer=3, seed=5, ctx=mx.gpu())
    with mx.NameManager():
        net = mx.sym.Convolution(mx.sym.Variable("data"), kernel=(3, 3),
                                 num_filter=16, pad=(1, 1), name="c1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc")
        sym = mx.sym.SoftmaxOutput(net, name="softmax")
    tr = DataParallelTrainer(
        sym, data_parallel_mesh(1), learning_rate=0.01, rescale_grad=1 / 8,
        input_preproc=lambda name, v: (v.float() - 128.0) / 64.0
        if name == "data" else v)
    state = tr.init_state({"data": (8, 3, 32, 32), "softmax_label": (8,)})
    held, sums = [], []
    n = 8 * 48 * 52 * 3                       # a batch's decoded bytes
    for _ in range(18):                       # three epochs of six
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        held.append((b.data[0]._data, it.last_plans))
        p, st, a, _, _ = tr.step(*state, tr.shard_inputs(
            [b.data[0], b.label[0]._data]))
        state = (p, st, a)
        sevens = torch.full((n,), 7, dtype=torch.uint8, device=dev)
        torch.cuda._sleep(20_000_000)         # ~10 ms on the card
        sums.append(sevens.sum(dtype=torch.int64))
        del sevens                            # free while its sum waits
    torch.cuda.synchronize()
    it.close()
    assert [int(v) for v in sums] == [7 * n] * len(sums)
    for data, plans in held:
        raw = torch.cat([codec.decode(p.payload, dev).reshape(-1)
                         for p in plans])
        offs = np.concatenate([[0], np.cumsum(
            [p.sh * p.sw * 3 for p in plans])])[:-1]
        ref = assemble.assemble_plain(raw, plans, list(offs), (32, 32))
        assert torch.equal(data, ref)


def _roi_case(dev, dtype, n, c, h, w, r, seed, ties=None):
    """Data of ``dtype`` (``ties``: "plateau" clips at 0 after a shift, so
    whole bins tie; "all" makes every value equal) and r rois over an
    image of 16 h x 16 w (some past its edges)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    data = torch.randn(n, c, h, w, generator=g, dtype=torch.float64)
    if ties == "plateau":
        data = torch.clamp_min(data - 0.5, 0.0)
    elif ties == "all":
        data = torch.full_like(data, 0.25)
    xy = torch.rand(r, 4, generator=g, dtype=torch.float64) \
        * torch.tensor([w, h, w, h], dtype=torch.float64) * 18 - 16
    x1, x2 = torch.minimum(xy[:, 0], xy[:, 2]), torch.maximum(xy[:, 0],
                                                              xy[:, 2])
    y1, y2 = torch.minimum(xy[:, 1], xy[:, 3]), torch.maximum(xy[:, 1],
                                                              xy[:, 3])
    b = torch.randint(0, n, (r,), generator=g).to(torch.float64)
    rois = torch.stack([b, x1, y1, x2, y2], dim=1)
    rdt = torch.float64 if dtype == torch.float64 else torch.float32
    return data.to(dtype).to(dev), rois.to(rdt).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape,ties", [
    ((2, 8, 20, 31, 24), None), ((1, 16, 37, 62, 64), "plateau"),
    ((1, 4, 9, 11, 12), "all")])
def test_roi_pooling_kernel_matches_plain(dev, dtype, shape, ties):
    """Forward equal to the plain version (a max is one of the data's
    values); the data gradient by the JAX op's tie rule within 1e-5 of
    its largest magnitude (float32 atomics in another order) of the
    plain version's, which for the half types runs in float32 on the
    same values (the kernel accumulates in float32 and rounds once: one
    unit of the type, 1e-2 of the largest magnitude); the rois'
    gradient None, one launch each way."""
    from mxnet_tpu_torch.ops import rcnn
    n, c, h, w, r = shape
    data, rois = _roi_case(dev, dtype, n, c, h, w, r, seed=r, ties=ties)
    half = dtype in (torch.float16, torch.bfloat16)
    x = data.clone().requires_grad_(True)
    xp = (data.float() if half else data).clone().requires_grad_(True)
    n0 = rcnn.roi_pooling.launches
    out = rcnn.roi_pooling(x, rois, (7, 7), 1.0 / 16)
    ref = rcnn.roi_pooling_plain(xp, rois, (7, 7), 1.0 / 16)
    assert rcnn.roi_pooling.launches == n0 + 1
    assert torch.equal(out, ref.to(dtype))
    assert torch.equal(out, rcnn.roi_pooling_plain(data, rois, (7, 7),
                                                   1.0 / 16))
    g = torch.randn(out.shape, generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev).to(dtype)
    (gx,) = torch.autograd.grad(out, x, g)
    (gp,) = torch.autograd.grad(ref, xp, g.to(ref.dtype))
    assert rcnn.roi_pooling.launches == n0 + 2
    tol = (1e-2 if half else 1e-5) * float(gp.abs().max()) + 1e-12
    assert float((gx.double() - gp.double()).abs().max()) <= tol
    # the host's plain version on the same data: the same forward
    host = rcnn.roi_pooling_plain(data.cpu(), rois.cpu(), (7, 7), 1.0 / 16)
    assert torch.equal(out.cpu(), host)


def _nms_boxes(dev, dtype, b, n, seed, thresh=None):
    """Score-sorted boxes in a 600 x 1000 image; with ``thresh``, box 1
    is box 0 widened so their IoU is exactly ``thresh`` in the type."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ctr = torch.rand(b, n, 2, generator=g, dtype=torch.float64) \
        * torch.tensor([1000.0, 600.0], dtype=torch.float64)
    wh = torch.rand(b, n, 2, generator=g, dtype=torch.float64) * 200 + 16
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=2).to(dtype)
    if thresh is not None:
        # a 10 x 10 box and a 10 x 10 / thresh one around the same corner:
        # IoU 100 / (100 / thresh) -- chosen so it rounds to thresh
        boxes[:, 0] = torch.tensor([100.0, 100.0, 110.0, 110.0],
                                   dtype=dtype)
        boxes[:, 1] = torch.tensor([100.0, 100.0, 110.0, 100.0 + 10.0
                                    / thresh], dtype=dtype)
    return boxes.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,n", [(1, 12000), (3, 1000), (2, 130)])
def test_proposal_nms_kernel_matches_plain(dev, dtype, b, n):
    """The keep mask equals the plain version's (and the host's), one
    call."""
    from mxnet_tpu_torch.ops import rcnn
    boxes = _nms_boxes(dev, dtype, b, n, seed=n)
    n0 = rcnn.proposal_nms.launches
    keep = rcnn.proposal_nms(boxes, 0.7)
    assert rcnn.proposal_nms.launches == n0 + 1
    assert torch.equal(keep, rcnn.proposal_nms_plain(boxes, 0.7))
    if n <= 1000:
        assert torch.equal(keep.cpu(),
                           rcnn.proposal_nms_plain(boxes.cpu(), 0.7))
    assert 0 < int(keep.sum()) < b * n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_proposal_nms_suppresses_at_exactly_the_threshold(dev, dtype):
    """Two boxes whose IoU is the threshold to the last bit: ``>=``
    suppresses the second, on the card and on the host; a threshold one
    step above keeps it."""
    from mxnet_tpu_torch.ops import contrib, rcnn
    thresh = 0.5
    boxes = _nms_boxes(dev, dtype, 1, 64, seed=3, thresh=thresh)
    iou = contrib._pair_iou(boxes[0, :1], boxes[0, 1:2])[0, 0]
    assert float(iou) == thresh
    keep = rcnn.proposal_nms(boxes, thresh)
    assert bool(keep[0, 0]) and not bool(keep[0, 1])
    assert torch.equal(keep, rcnn.proposal_nms_plain(boxes, thresh))
    above = float(torch.nextafter(iou, iou.new_full((), 1.0)))
    keep2 = rcnn.proposal_nms(boxes, above)
    assert bool(keep2[0, 1])
    assert torch.equal(keep2, rcnn.proposal_nms_plain(boxes, above))


def test_empty_inputs_launch_nothing_and_count_nothing(dev):
    """0 rois (forward and backward) and 0 boxes: empty results of the
    right shapes, and neither launch count moves."""
    from mxnet_tpu_torch.ops import rcnn
    data, rois = _roi_case(dev, torch.float32, 1, 8, 20, 30, 4, seed=0)
    x = data.clone().requires_grad_(True)
    r0, p0 = rcnn.roi_pooling.launches, rcnn.proposal_nms.launches
    out = rcnn.roi_pooling(x, rois[:0], (7, 7), 1.0 / 16)
    assert out.shape == (0, 8, 7, 7)
    (gx,) = torch.autograd.grad(out.sum(), x, allow_unused=True)
    assert gx is None or not bool(gx.any())
    for b, n in [(0, 100), (2, 0)]:
        boxes = _nms_boxes(dev, torch.float32, max(b, 1), 100, seed=1)
        keep = rcnn.proposal_nms(boxes[:b, :n], 0.7)
        assert keep.shape == (b, n)
    assert rcnn.roi_pooling.launches == r0
    assert rcnn.proposal_nms.launches == p0


def test_proposal_op_on_the_card_equals_the_host(dev):
    """_contrib_Proposal at Faster R-CNN's widths (37 x 62 x 9 anchors,
    12,000 before NMS, 2,000 after) in float64: the card's rois and
    scores are the host's, and its gradients too (within 1e-12)."""
    from mxnet_tpu_torch.ops import registry
    schema = registry.get_op("_contrib_Proposal")
    attrs = schema.parse_attrs(dict(
        scales=(8, 16, 32), ratios=(0.5, 1, 2), rpn_pre_nms_top_n=12000,
        rpn_post_nms_top_n=2000, threshold=0.7, rpn_min_size=16))
    g = torch.Generator(device="cpu").manual_seed(5)
    z = torch.randn(1, 2, 9, 37, 62, generator=g, dtype=torch.float64)
    prob = torch.softmax(z, dim=1).reshape(1, 18, 37, 62)
    delta = torch.randn(1, 36, 37, 62, generator=g,
                        dtype=torch.float64) * 0.2
    info = torch.tensor([[600.0, 1000.0, 1.0]], dtype=torch.float64)
    res = {}
    for d in (dev, torch.device("cpu")):
        p = prob.to(d).requires_grad_(True)
        dl = delta.to(d).requires_grad_(True)
        rois, scores = schema.fcompute(attrs, registry.OpCtx(device=d), p,
                                       dl, info.to(d))
        gp, gd = torch.autograd.grad((rois[:, 1:].sum() + scores.sum()),
                                     (p, dl))
        res[d.type] = [t.detach().cpu() for t in (rois, scores, gp, gd)]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
