#!/usr/bin/env python3
"""Chip smoke test of mxnet_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port's paths end to end with random weights and data from a
seed: at GPT-2 medium's published widths (OpenAI GPT-2 "355M": n_embd
1024, n_head 16, n_layer 24, n_positions 1024, vocab 50257, MLP 4096),
Gluon training of a causal transformer LM (the repo's TransformerEncoder
equations: LayerNorm, ReLU FFN, an untied Dense head with bias) and
decode serving (DecodeModel: RMSNorm, no biases, an untied head); at
ResNet-50's widths (batch 128, bf16), the fused 1x1 convolution of a
stage-2 bottleneck boundary; and runtime compilation of CUDA C++ through
NVRTC (rtc.CudaModule). Phases, one JSON line each:

  device   card name, power limit (nvidia-smi), torch/CUDA versions
  build    nvcc builds every kernel of mxnet_tpu_torch/csrc, timed; fails
           if ptxas reports a spill in any instance
  kernels  each kernel against its plain PyTorch version at the main
           paths' shapes (max error vs a stated tolerance), and timed
           (device time) beside its plain version and one library call;
           head dims 384 and 512 through the wide kernels, 96 and 640
           and cross-attention (S_q 128, S_k 512) through the dense
           route; the attention kernels in bfloat16 and float16 beside
           SDPA in the same type (each element against its row's
           magnitude; a control with one tile of keys dropped must fail
           that check); the f32 flash forward and dQ against
           float64 (exact_flash_*: within 4x the plain f32 version's own
           error, which one TF32 pass, emulated, must break); decode at
           GQA groups 7 and 16; the
           quantized matmul's decode and prefill kernels with float32 and
           bfloat16 x;
           conv1x1 at ResNet-50's five 1x1 shapes; the rtc kernels over
           2^26 floats with NVRTC's compile time
  train    TransformerEncoder + Dense head trained through the port's
           Gluon (initialize, autograd.record, loss.backward,
           Trainer("adam").step) on 8 x 1024 tokens: every parameter's
           gradient held against the plain attention path on a
           2-sequence slice, then 2 warm-up and 5 timed steps (loss per
           step, step time, tokens/s, peak memory, launches per step)
  train_profile
           one training step under torch.profiler: device time by kernel
  engine_f32 / engine_int8
           DecodeEngine serving 8 staggered sessions with float and
           int8 weights; one session's per-token logits held against a
           full-context recompute through the plain path; tokens/s,
           per-token latency, and each kernel's launch count
  profile  one decode step under torch.profiler: device time by kernel
  conv     ResNet-50 stage 2 at batch 128, bf16, through ops.conv_fused:
           expand 64 -> 256 with statistics, finalize_stats, bn_fold, then
           the next block's reduce 256 -> 64 with the BN + residual + ReLU
           prologue and statistics; held against the same chain through
           reference_conv1x1; time per application, peak memory, launches
  rtc      a user's runtime-compiled kernels through rtc.CudaModule:
           compile, get_kernel, launch (grid, block, dynamic shared
           memory) over 2^26 floats, checked against torch

then a ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero (and prints no result)
without CUDA, or when any phase fails. Details go to
chiprun_out/chip_smoke.json.
"""
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth, the
# FP32 rate outside the tensor cores (the f32 kernels' type), and the bf16
# tensor-core rate (the bf16 conv1x1's type)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# the flash forward and dQ kernels form each f32 product as 3 TF32
# tensor-core products (bf16/f16 inputs: 1 product at the bf16 rate)
TF32_PIECES = 3
# f32 flash forward and dQ against float64: within F64_FACTOR times the
# plain f32 version's own float64 error
F64_FACTOR = 4
# bf16/f16 attention outputs vs their plain versions, element by element:
# |got - ref| within HALF_ULPS units of (one ulp of |ref| there + one ulp
# of the root-sum-square of the terms it sums), ulps of the output type
# (mxnet_tpu_torch.test_utils.half_units). The kernels round P and dS to
# the input type before their second product, as the TPU kernels do,
# which moves an element by a fraction of its terms; the plain versions
# round once at the end. Causal rows and keys differ in magnitude by 30x
# and more, so no tensor-wide scale is used. Each bf16/f16 flash case also
# holds a control, its plain version with DROP_KEYS keys from S/2 on left
# out of every row (a skipped K/V tile), which must fail the check.
HALF_ULPS = 2
DROP_KEYS = 64
DTYPES = {}             # "f32" / "bf16" / "f16" -> torch dtype, at run time
# the quantized matmul's kernels form each f32 x as 3 exact bf16 pieces on
# the bf16 tensor cores (bf16 x: 1 piece)
QMM_PIECES = {"f32": 3, "bf16": 1}
# ... so with f32 x they agree with float64 within QMM_F64_ULPS * K units of
# 2^-24 of sum |x| |q| * scale: f32 sums of exact products in any order
QMM_F64_ULPS = 4

# GPT-2 medium widths
CFG = dict(vocab=50257, layers=24, d_model=1024, heads=16, kv_heads=16,
           d_ff=4096, max_len=1024)
SLOTS = 8
PROMPT_LENS = (17, 60, 100, 200, 300, 500, 700, 900)
NEW_TOKENS = 32
SEED = 0

# the training model: GPT-2 medium widths in TransformerEncoder + Dense
TRAIN = dict(vocab_size=50257, units=1024, hidden_size=4096, num_heads=16,
             num_layers=24, max_length=1024)
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
GRAD_SLICE = 2          # sequences of the first batch in the gradient check

# tolerances, stated before the run. Kernels vs their plain versions:
# float32 sums taken in another order, |values| ~ 1, so 1e-4 absolute
# plus 1e-4 relative to the reference's largest magnitude (the flash
# backward's sums run over up to S = 4096 terms and stay inside it).
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 1e-4
# training gradients on 2 sequences, per parameter tensor, in two checks:
# * backward only: kernels vs the forward kernel with the backward's plain
#   twin swapped in. The forward is bit-identical, so only the dQ and
#   dK/dV kernels differ: every tensor within BWD_GRAD_RTOL both
#   norm-wise (||g - g_ref|| / ||g_ref||) and element by element (of the
#   tensor's max |g_ref|): float32 sums in another order through 24
#   layers. Earlier runs on the H100 measured 4.2e-6 to 4.7e-6 here;
#   1e-4 leaves 20x room above that and still catches a dQ or dK/dV sum
#   off by a few 1e-4.
# * whole path: kernels vs the plain attention forward and backward (the
#   blocks' flash_attention swapped for reference_attention), every
#   tensor within PATH_GRAD_RTOL norm-wise. Looser, because ReLU's
#   derivative jumps at 0: an FFN pre-activation within rounding distance
#   of 0 lands on the other side in the other forward, which moves the
#   FFN's backward at that token by its whole contribution (up to ~1.3% of
#   a tensor's max |grad| at 2 x 1024 tokens) in ffn1 and the LayerNorm
#   before it, and attenuated upstream. Earlier runs on the H100 found all
#   25,316 elements beyond 1e-3 of their tensor's max (of 406 M) in ffn1
#   weights, and norm-wise errors up to 1.29e-3 (ffn1 weight) and 1.26e-3
#   (that LayerNorm's gamma). Their losses agree within LOSS_RTOL.
# The attention key biases are exempt from both: their true gradient is
# exactly 0 (softmax ignores the per-row shift q . b), so both paths hold
# rounding noise there; they are held below ZERO_GRAD_RTOL of the largest
# gradient of the model instead.
BWD_GRAD_RTOL = 1e-4
PATH_GRAD_RTOL = 1e-2
PATH_ELEM_RTOL = 1e-3   # only counts the elements beyond it, as a report
LOSS_RTOL = 1e-3
ZERO_GRAD_RTOL = 1e-4
# conv1x1 (bf16) vs reference_conv1x1 on the same inputs: y within one
# bf16 ulp of the reference plus CONV_ATOL_REL of its largest magnitude
# (the f32 sums run in another order before the rounding, so a sum near a
# rounding boundary lands on the other side); the statistics within
# CONV_STATS_RTOL of their largest magnitude (f32 sums of ~400 k terms in
# another order); float32 cases use the kernels' tolerance above. The
# stage-2 chain's second output takes its input through the first one's
# statistics, so it is held to one ulp plus CHAIN_ATOL_REL.
CONV_ATOL_REL = 1e-4
CONV_STATS_RTOL = 1e-3
CHAIN_ATOL_REL = 1e-3
# ResNet-50 (He et al. 2016, torchvision resnet50) stage 2 at batch 128
CONV_BATCH = 128
# the rtc kernels run over 2^26 float32 elements
RTC_N = 1 << 26
# engine logits vs full-context recompute through the plain path: 24
# layers of float32 rounding in another order (and, for int8, the same
# dequantized weights multiplied in another order), relative to the
# largest logit
LOGIT_RTOL = 1e-3

# cycles a second of torch.cuda._sleep's spin: above the H100's boost clock
# (1.98 GHz), so the spin outlasts the enqueue it covers
SPIN_HZ = 2e9

RECORD = {}
DEV = "cuda"


def _sync():
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = "nvidia-smi unavailable: %s" % e
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def bench_ms(fn, argsets, iters):
    """Mean device ms per call by CUDA events, cycling through ``argsets``
    so consecutive calls read different buffers (beyond the 50 MB L2 where
    the main path finds its inputs cold). A spin kernel (``_sleep``) ahead
    of the timed calls holds the card while the host enqueues them, so a
    call whose host side takes longer than its kernel is timed by its
    kernel, not by the host's launch rate."""
    import torch
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*argsets[0])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0        # an upper bound of one enqueue
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9, (1.5 * host_s * iters + 2e-4) * SPIN_HZ)))
    st.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    en.record()
    en.synchronize()
    return st.elapsed_time(en) / iters


def copies(nbytes, *ts):
    """Enough clones of ``ts`` to pass 120 MB in all (at least one)."""
    n = max(1, math.ceil(120e6 / max(nbytes, 1)))
    return [ts] + [tuple(t.clone() for t in ts) for _ in range(n - 1)]


def bound_ms(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak_flops * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def err_of(got, ref):
    import torch
    diff = (got.float() - ref.float()).abs()
    fin = torch.isfinite(ref)
    if not bool(torch.equal(torch.isfinite(got), fin)):
        return float("inf"), float("inf")
    e = float(diff[fin].max()) if bool(fin.any()) else 0.0
    scale = float(ref.float()[fin].abs().max()) if bool(fin.any()) else 0.0
    return e, KERNEL_ATOL + KERNEL_RTOL * scale


# -- phases -------------------------------------------------------------------

def phase_device():
    import torch
    smi = nvidia_smi()
    print(smi, flush=True)
    RECORD["nvidia_smi"] = smi
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library("flash_attention")
    secs = time.perf_counter() - t0
    info = dict(_build.last_build)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        for stem, log in info.get("logs", {}).items():
            f.write("== %s\n%s\n" % (stem, log))
    spills, regs = [], {}
    for stem, log in info.get("logs", {}).items():
        fn = "?"
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append("%s %s: %s" % (stem, fn, ln.strip()))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                regs[stem] = max(regs.get(stem, 0), int(m.group(1)))
    res = {"build_seconds": secs, "built": info.get("built"),
           "max_registers": regs, "spills": spills}
    if spills:
        raise AssertionError("ptxas spilled: %s" % spills[:8])
    return res


def _max_rule_ulps(got, ref):
    """The tensor-wide rule the element check replaced: max |got - ref| in
    ulps of max |ref|. Kept for the controls' record only."""
    import torch
    r = ref.float()
    m = float(r.abs().max())
    return float((got.float() - r).abs().max()) / (
        2.0 ** math.floor(math.log2(m)) * torch.finfo(got.dtype).eps)


def _held(got, ref, terms=None):
    """(error, its tolerance, ok): float32 outputs by err_of, bf16/f16 by
    half_units (``terms``: the root-sum-squares of their terms) against
    HALF_ULPS."""
    import torch
    from mxnet_tpu_torch import test_utils as U
    if got.dtype == torch.float32:
        e, tol = err_of(got, ref)
        return e, tol, e <= tol
    u = U.half_units(got, ref, terms)
    return u, "%d units of ulp(|ref|) + ulp(rss of its terms)" \
        % HALF_ULPS, u <= HALF_ULPS


def _control(ctrl, ref, terms):
    """A control's record: its error by the check (it must fail) and by
    the tensor-wide rule that the check replaced."""
    from mxnet_tpu_torch import test_utils as U
    return {"units": U.half_units(ctrl, ref, terms),
            "max_rule_ulps": _max_rule_ulps(ctrl, ref)}


def _tc_bound(io_bytes, flops, dt):
    """A flash kernel's bound at the tensor cores' peak for its inputs (3
    TF32 products for f32, the forward's and dQ's design; one bf16/f16
    product), and the FP32 pipes' bound."""
    if dt == "f32":
        design = bound_ms(io_bytes, TF32_PIECES * flops, PEAK_TF32_FLOPS)
    else:
        design = bound_ms(io_bytes, flops, PEAK_BF16_FLOPS)
    return design, bound_ms(io_bytes, flops)[0]


def _flash_case(name, b, h, hkv, s, d, causal, gen, dt="f32"):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    tdt = DTYPES[dt]
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(tdt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    n0, dense0 = A.flash_attention_fwd.launches, A.dense_attention.calls
    out, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    launched = (A.flash_attention_fwd.launches - n0,
                A.dense_attention.calls - dense0)
    again = A.flash_attention_fwd(q, k, v, causal=causal)
    rout, rlse = A.reference_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(out, again[0]) and
                         torch.equal(lse, again[1]))
    control = terms = None
    if dt != "f32":
        terms = U.attention_term_scales(q, k, v, causal)[0]
        ctrl = U.attention_without_keys(q, k, v, s // 2, s // 2 + DROP_KEYS,
                                        causal)[0]
        control = _control(ctrl, rout, terms)
        del ctrl
    e_o, tol_o, ok_o = _held(out, rout, terms)
    e_l, tol_l = err_of(lse, rlse)
    del terms
    ok_o = ok_o and (control is None or control["units"] > HALF_ULPS)
    esz = q.element_size()
    io_bytes = esz * (2 * q.numel() + k.numel() + v.numel()) \
        + 4 * lse.numel()
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * d * pairs
    sets = copies(io_bytes, q, k, v)
    iters = 20
    ms = bench_ms(lambda q, k, v: A.flash_attention_fwd(q, k, v, causal),
                  sets, iters)
    plain = bench_ms(lambda q, k, v: A.reference_attention_with_lse(
        q, k, v, causal), sets, iters)
    gqa = {"enable_gqa": True} if hkv != h else {}
    lib = bench_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, **gqa), sets, iters)
    (bnd, by), b_f32 = _tc_bound(io_bytes, flops, dt)
    return {"kernel": "flash_attention_fwd", "case": name, "dtype": dt,
            "held_in_ulps": dt != "f32",
            "shape": [b, h, hkv, s, d], "causal": causal,
            "max_abs_err": max(float((out.float() - rout.float()).abs()
                                     .max()), e_l),
            "err_out": e_o, "err_lse": e_l,
            "tol_out": tol_o, "tol_lse": tol_l,
            "control_dropped_keys": control,
            "launches_and_dense_calls": launched,
            "deterministic": deterministic,
            "ok": ok_o and e_l <= tol_l and launched == (1, 0)
            and deterministic,
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "library_note": "SDPA in %s" % dt,
            "bound_ms": bnd, "bound_by": by, "bound_f32_pipes_ms": b_f32,
            "bytes": io_bytes, "flops": flops}


def _flash_bwd_case(name, b, h, hkv, s, d, causal, gen, glse=False,
                    plain_batch=None, iters=10, dt="f32"):
    """dQ and dK/dV kernels against the plain twin (on the first
    ``plain_batch`` sequences when the dense (S, S) matrices would not
    fit), timed beside the twin and SDPA's backward through autograd."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    tdt = DTYPES[dt]
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(tdt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    do = torch.randn(b, h, s, d, generator=gen, device=dev).to(tdt)
    gl = torch.randn(b, h, s, generator=gen, device=dev) if glse else None
    o, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    dq = A.flash_attention_bwd_dq(q, k, v, o, lse, do, gl, causal)
    dkp, dvp = A.flash_attention_bwd_dkv(q, k, v, o, lse, do, gl, causal)
    again = A.flash_attention_bwd(q, k, v, o, lse, do, gl, causal)
    torch.cuda.synchronize()
    if hkv != h:
        dkp = dkp.reshape(b, hkv, h // hkv, s, d).sum(2)
        dvp = dvp.reshape(b, hkv, h // hkv, s, d).sum(2)
    dk, dv = dkp.to(tdt), dvp.to(tdt)
    deterministic = bool(torch.equal(dq, again[0]) and
                         torch.equal(dk, again[1]) and
                         torch.equal(dv, again[2]))
    pb = plain_batch or b
    sl = slice(0, pb)
    ref = A.reference_flash_attention_bwd(
        q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl],
        None if gl is None else gl[sl], causal)
    torch.cuda.synchronize()
    abs_err = max(float((got[sl].float() - r.float()).abs().max())
                  for got, r in zip((dq, dk, dv), ref))
    control, terms = None, (None,) * 3
    if dt != "f32":
        gsl = None if gl is None else gl[sl]
        terms = U.attention_term_scales(q[sl], k[sl], v[sl], causal,
                                        o=o[sl], do=do[sl], glse=gsl)[1:]
        ctrl = U.attention_without_keys(q[sl], k[sl], v[sl], s // 2,
                                        s // 2 + DROP_KEYS, causal,
                                        do=do[sl], glse=gsl)[1:]
        control = [_control(c, r, t) for c, r, t in zip(ctrl, ref, terms)]
        del ctrl
    held = [_held(got[sl], r, t) for got, r, t in zip((dq, dk, dv), ref,
                                                       terms)]
    del ref, terms
    pairs = s * (s + 1) // 2 if causal else s * s
    esz = q.element_size()
    n_in = esz * (3 * q.numel() + k.numel() + v.numel()) + 4 * (
        lse.numel() + (gl.numel() if gl is not None else 0))
    dq_bytes = n_in + esz * q.numel()
    dkv_bytes = n_in + 4 * 2 * q.numel()          # f32 per-q-head partials
    dq_flops = 6 * d * pairs * b * h
    dkv_flops = 8 * d * pairs * b * h
    sets = copies(n_in, q, k, v, o, lse, do)
    if len(sets) > 3:
        sets = sets[:3]
    dq_ms = bench_ms(lambda q, k, v, o, l, g: A.flash_attention_bwd_dq(
        q, k, v, o, l, g, gl, causal), sets, iters)
    dkv_ms = bench_ms(lambda q, k, v, o, l, g: A.flash_attention_bwd_dkv(
        q, k, v, o, l, g, gl, causal), sets, iters)
    psets = [tuple(t[sl] for t in a) for a in sets[:1]]
    plain = bench_ms(lambda q, k, v, o, l, g: A.reference_flash_attention_bwd(
        q, k, v, o, l, g, None if gl is None else gl[sl], causal), psets,
        max(2, iters // 4)) * b / pb
    # library: the backward of SDPA (recorded once, replayed with
    # retain_graph), the same dq/dk/dv of the same inputs without glse
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    gqa = {"enable_gqa": True} if hkv != h else {}
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, **gqa)
    lib = bench_ms(lambda g: torch.autograd.grad(
        lo, (ql, kl, vl), g, retain_graph=True), [(do,)], iters)
    del lo, ql, kl, vl
    (b_dq, by_dq), b_dq_f32 = _tc_bound(dq_bytes, dq_flops, dt)
    # dK/dV does its math on the FP32 pipes, but the card could do the
    # same work at the forward's and dQ's rates: its bound is theirs
    (b_dkv, by_dkv), b_dkv_f32 = _tc_bound(dkv_bytes, dkv_flops, dt)
    ok = all(h_[2] for h_ in held) and deterministic and (
        control is None or all(c["units"] > HALF_ULPS for c in control))
    return {"kernel": "flash_attention_bwd", "case": name, "dtype": dt,
            "held_in_ulps": dt != "f32",
            "shape": [b, h, hkv, s, d], "causal": causal, "glse": glse,
            "plain_batch": pb, "err_dq": held[0][0], "err_dk": held[1][0],
            "err_dv": held[2][0], "tols": [t for _, t, _ in held],
            "control_dropped_keys": control,
            "max_abs_err": abs_err,
            "deterministic": deterministic, "ok": ok,
            "dq_ms": dq_ms, "dkv_ms": dkv_ms, "kernel_ms": dq_ms + dkv_ms,
            "plain_ms": plain, "plain_note": "the plain twin computes dq, "
            "dk and dv together" + (
                "; timed on %d of %d sequences, scaled" % (pb, b)
                if pb != b else ""),
            "library_ms": lib, "library_note": "SDPA backward in %s "
            "through autograd (dq, dk, dv together)" % dt,
            "dq_bound_ms": b_dq, "dq_bound_by": by_dq,
            "dq_bound_f32_pipes_ms": b_dq_f32,
            "dkv_bound_ms": b_dkv, "dkv_bound_by": by_dkv,
            "dkv_bound_f32_pipes_ms": b_dkv_f32,
            "bound_ms": b_dq + b_dkv,
            "bound_by": by_dq if by_dq == by_dkv else "mixed",
            "dq_bytes": dq_bytes, "dkv_bytes": dkv_bytes,
            "dq_flops": dq_flops, "dkv_flops": dkv_flops}


def _decode_case(name, b, h, hkv, s, d, lengths, gen, dt="f32"):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import test_utils as U
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    tdt = DTYPES[dt]
    q = torch.randn(b, h, d, generator=gen, device=dev).to(tdt)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(tdt)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n0, dense0 = A.decode_attention.launches, A.dense_attention.calls
    out = A.decode_attention(q, k, v, ln)
    launched = (A.decode_attention.launches - n0,
                A.dense_attention.calls - dense0)
    ref = A.reference_decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    e, tol, ok = _held(out, ref, None if dt == "f32" else
                       U.decode_term_scales(q, k, v, ln))
    tot = int(sum(lengths))
    esz = q.element_size()
    io_bytes = esz * (2 * q.numel() + 2 * hkv * d * tot) + 4 * b
    flops = 4 * h * d * tot
    pool_bytes = esz * (k.numel() + v.numel())
    sets = copies(pool_bytes, q, k, v)
    mask = (torch.arange(s, device=dev)[None, :] < ln[:, None])
    mask = mask[:, None, None, :]
    gqa = {"enable_gqa": True} if hkv != h else {}

    def lib_fn(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, **gqa)

    iters = 50
    ms = bench_ms(lambda q, k, v: A.decode_attention(q, k, v, ln), sets,
                  iters)
    plain = bench_ms(lambda q, k, v: A.reference_decode_attention(
        q, k, v, ln), sets, iters)
    lib = bench_ms(lib_fn, sets, iters)
    bnd, by = bound_ms(io_bytes, flops)
    return {"kernel": "decode_attention", "case": name, "dtype": dt,
            "held_in_ulps": dt != "f32",
            "shape": [b, h, hkv, s, d], "lengths": list(lengths),
            "group": h // hkv, "launches_and_dense_calls": launched,
            "max_abs_err": float((out.float() - ref.float()).abs().max()),
            "err": e, "tol": tol,
            "ok": ok and launched == (1, 0),
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bnd, "bound_by": by, "bytes": io_bytes,
            "flops": flops}


def _qmm_case(name, m, kdim, n, dtype, gen, xdt="f32"):
    """The quantized matmul against its plain version (float32 x: the
    kernels' tolerance; bfloat16 x: one bf16 ulp plus 1e-4 of the largest
    magnitude), the same bits on a second call, timed beside the plain
    version and torch.matmul on the wide weight. float32 x is also held
    against float64 (_qmm_f64_ratio). Both kernels run QMM_PIECES bf16
    tensor-core products, which set the bound's operations (the FP32
    pipes' bound is kept beside)."""
    import torch
    from mxnet_tpu_torch.ops import quantization as Q
    dev = "cuda"
    x = torch.randn(m, kdim, generator=gen, device=dev)
    if xdt == "bf16":
        x = x.bfloat16()
    w = torch.randn(kdim, n, generator=gen, device=dev) / math.sqrt(kdim)
    q, sc = Q.quantize_rows(w, dtype)
    del w
    out = Q.quantized_matmul(x, q, sc)
    again = Q.quantized_matmul(x, q, sc)
    ref = Q.reference_quantized_matmul(x, q, sc)
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(out, again))
    route = "qmm_tc" if Q._qmm_route(x, q, out) == 1 else "qmm_small"
    e, tol = err_of(out, ref)
    f64 = None
    if xdt == "bf16":
        ulps = _bf16_ulp_err(out, ref, KERNEL_RTOL)
        ok, tol_s = ulps <= 1.0, "one bf16 ulp + %g of max |ref|" % KERNEL_RTOL
    else:
        # and against float64 within the exact-products bound
        f64 = _qmm_f64_ratio(out, x, q, sc)
        ulps, ok, tol_s = None, e <= tol and f64 <= 1.0, tol
    io_bytes = x.element_size() * (m * kdim + m * n) \
        + q.numel() * q.element_size() + 4 * n
    flops = 2 * m * n * kdim
    sets = copies(q.numel() * q.element_size(), x, q, sc)
    wide = [(a[0], Q.dequantize_rows(a[1], a[2]).to(x.dtype))
            for a in sets[:2]]
    iters = 20
    ms = bench_ms(Q.quantized_matmul, sets, iters)
    plain = bench_ms(Q.reference_quantized_matmul, sets, iters)
    lib = bench_ms(torch.matmul, wide, iters)
    b_f32, _ = bound_ms(io_bytes, flops)
    bnd, by = bound_ms(io_bytes, QMM_PIECES[xdt] * flops, PEAK_BF16_FLOPS)
    return {"kernel": "quantized_matmul", "case": name, "dtype": dtype,
            "x_dtype": xdt, "route": route,
            "shape": [m, kdim, n], "max_abs_err": e, "tol": tol_s,
            "err_bf16_ulps": ulps, "f64_err_over_bound": f64,
            "deterministic": deterministic,
            "ok": ok and deterministic, "kernel_ms": ms, "plain_ms": plain,
            "library_ms": lib, "library_note": "torch.matmul on the "
            "pre-dequantized weight in x's dtype (2 copies rotated)",
            "bound_ms": bnd, "bound_by": by, "bound_f32_pipes_ms": b_f32,
            "bytes": io_bytes, "flops": flops}


def _qmm_f64_ratio(out, x, q, sc):
    """The largest |out - x @ q * scale| in float64 over the bound that
    float32 sums of exact products keep in any order: 4 K units of 2^-24
    of sum |x| |q| * scale (QMM_F64_ULPS)."""
    def f64(a, b):
        return (a.double() @ b.double()) * sc.double()
    bound = QMM_F64_ULPS * x.shape[1] * 2.0 ** -24 * f64(x.abs(),
                                                          q.float().abs())
    return float(((out.double() - f64(x, q)).abs() / bound).nan_to_num(
        0.0, posinf=float("inf")).max())


def _qmm_pieces_case(name, m, kdim, n, dtype, gen):
    """Both quantized-matmul kernels form exact products: float32 x spans
    1e-20 to 1e20, so one term rules each short sum, and the result stays
    within the float64 bound of _qmm_f64_ratio, which x without its third
    bf16 piece, x as one bf16 value and x rounded to TF32 (emulated in
    torch on the same inputs) all break."""
    import torch
    from mxnet_tpu_torch.ops import quantization as Q
    dev = "cuda"
    mag = 10.0 ** (torch.rand(m, kdim, generator=gen, device=dev) * 40 - 20)
    x = (torch.randn(m, kdim, generator=gen, device=dev).sign() * mag).float()
    q, sc = Q.quantize_rows(torch.randn(kdim, n, generator=gen, device=dev),
                            dtype)
    out = Q.quantized_matmul(x, q, sc)
    route = Q._qmm_route(x, q, out)
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    tf32 = ((x.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)
    controls = {}
    for cname, xw in (("two_pieces", hi + mid), ("one_piece", hi),
                      ("tf32", tf32)):
        ref = ((xw.double() @ q.double()) * sc.double()).float()
        controls[cname] = _qmm_f64_ratio(ref, x, q, sc)
    ratio = _qmm_f64_ratio(out, x, q, sc)
    return {"kernel": "quantized_matmul_exact", "case": name,
            "dtype": dtype, "shape": [m, kdim, n],
            "route": "qmm_tc" if route == 1 else "qmm_small",
            "err_over_bound": ratio, "controls_err_over_bound": controls,
            "ok": ratio <= 1.0 and all(v > 1.0 for v in controls.values())}


def _dense_case(name, d, gen, s_q=512):
    """A head dim no kernel takes (96), or one above the kernels' 512
    (640), through flash_attention with its backward and through
    decode_attention; or cross-attention (``s_q`` query rows against 512
    keys, causal from the bottom right) through flash_attention alone:
    the dense route's answer, and no kernel launch."""
    import torch
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    q = torch.randn(2, 8, s_q, d, generator=gen, device=dev).requires_grad_()
    k, v = (torch.randn(2, 8, 512, d, generator=gen, device=dev)
            .requires_grad_() for _ in range(2))
    do = torch.randn(2, 8, s_q, d, generator=gen, device=dev)
    ln = torch.tensor([1, 512], dtype=torch.int32, device=dev)
    decode = not A.kernel_head_dim(d) or d > A.MAX_HEAD_DIM
    kernels = {n: f.launches for n, f in _wrappers().items()}
    calls = A.dense_attention.calls
    out = A.flash_attention(q, k, v, causal=True)
    out.backward(do)
    if decode:
        dec = A.decode_attention(q[:, :, -1].detach(), k.detach(),
                                 v.detach(), ln)
    torch.cuda.synchronize()
    after = {n: f.launches for n, f in _wrappers().items()}
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = A.reference_attention(q2, k2, v2, causal=True)
    ref.backward(do)
    pairs = [(out, ref), (q.grad, q2.grad), (k.grad, k2.grad),
             (v.grad, v2.grad)]
    if decode:
        pairs.append((dec, A.reference_decode_attention(
            q2[:, :, -1].detach(), k2.detach(), v2.detach(), ln)))
    errs = [err_of(a.detach(), b.detach()) for a, b in pairs]
    finite = all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    dense = A.dense_attention.calls - calls
    return {"kernel": "dense_attention", "case": name,
            "shape": [2, 8, 8, s_q, 512, d], "dense_calls": dense,
            "kernel_launches": {n: after[n] - kernels[n] for n in after},
            "max_abs_err": max(e for e, _ in errs), "finite_grads": finite,
            "ok": dense == 1 + decode and after == kernels and finite
            and all(e <= t for e, t in errs)}


def _flash_exact_case(name, b, h, s, d, gen):
    """The f32 flash forward (``exact_flash_fwd_f32``) or dQ
    (``exact_flash_dq_f32``) against float64: its largest error within
    F64_FACTOR times the plain f32 version's own, while one TF32 pass (the
    same formulas on tf32-rounded q, k, v, P and dS, in float64; the
    control) must exceed that bound."""
    import torch
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   for _ in range(4))
    out, lse = A.flash_attention_fwd(q, k, v, causal=True)
    mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()

    def f64(rnd):
        sc = rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(d)
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.exp(sc - torch.logsumexp(sc, -1, keepdim=True))
        o = rnd(p) @ rnd(v)
        if name.startswith("exact_flash_fwd"):
            return o
        dp = rnd(do) @ rnd(v).transpose(-1, -2)
        ds = p * (dp - (do.double() * o).sum(-1, keepdim=True)) \
            / math.sqrt(d)
        return rnd(ds) @ rnd(k)

    def exact(x):
        return x.double()

    def one_tf32(x):
        x = x.float()
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(
            torch.float32).double()

    if name.startswith("exact_flash_fwd"):
        got = out
        plain = A.reference_attention_with_lse(q, k, v, causal=True)[0]
    else:
        got = A.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=True)
        plain = A.reference_flash_attention_bwd(q, k, v, out, lse, do,
                                                causal=True)[0]
    ref = f64(exact)
    bound = F64_FACTOR * float((plain.double() - ref).abs().max())
    ratio = float((got.double() - ref).abs().max()) / bound
    control = float((f64(one_tf32) - ref).abs().max()) / bound
    return {"kernel": "flash_attention_exact", "case": name,
            "shape": [b, h, h, s, d], "err_over_bound": ratio,
            "control_one_tf32_err_over_bound": control,
            "bound": "%d x the plain f32 version's float64 error (%g)"
                     % (F64_FACTOR, bound),
            "ok": ratio <= 1.0 and control > 1.0}


def _bf16_ulp_err(got, ref, atol_rel):
    """Largest |got - ref| in units of (one bf16 ulp of ref + atol_rel of
    max |ref|): <= 1 passes."""
    import torch
    r = ref.float()
    _, e = torch.frexp(r)
    tol = torch.ldexp(torch.ones_like(r), e - 8) \
        + atol_rel * float(r.abs().max())
    return float(((got.float() - r).abs() / tol).max())


def _stats_err(got, ref):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


def _conv_case(name, n, ci, co, p, dtype, gen, residual=False):
    """conv1x1 with the relu(bn(x)) prologue (and a residual) plus
    statistics against reference_conv1x1 on the card; timed beside the
    plain twin and a library chain (the prologue in torch ops,
    torch.matmul, two reductions); statistics checked bit-identical on a
    second run."""
    import torch
    from mxnet_tpu_torch.ops import conv_fused as C
    dev = "cuda"
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.randn(n, ci, p, generator=gen, device=dev).to(dt)
    w = (torch.randn(co, ci, generator=gen, device=dev) / ci ** 0.5).to(dt)
    scale = torch.rand(ci, generator=gen, device=dev) + 0.5
    shift = torch.randn(ci, generator=gen, device=dev) * 0.5
    res = torch.randn(n, ci, p, generator=gen, device=dev).to(dt) \
        if residual else None
    kw = dict(bn_in=(scale, shift), residual=res, relu_in=True)
    y, st = C.conv1x1(x, w, **kw)
    y2, st2 = C.conv1x1(x, w, **kw)
    ry, rst = C.reference_conv1x1(x, w, **kw)
    torch.cuda.synchronize()
    abs_err = float((y.float() - ry.float()).abs().max())
    if dtype == "bf16":
        y_err = _bf16_ulp_err(y, ry, CONV_ATOL_REL)
        y_ok = y_err <= 1.0
    else:
        e, tol = err_of(y, ry)
        y_err, y_ok = e / tol, e <= tol
    s_err = _stats_err(st, rst)
    deterministic = bool(torch.equal(y, y2) and torch.equal(st[0], st2[0])
                         and torch.equal(st[1], st2[1]))
    del y2, st2, ry, rst
    esz = x.element_size()
    io_bytes = esz * (x.numel() + co * p * n) + w.numel() * w.element_size() \
        + 8 * ci + 8 * co + (res.numel() * esz if residual else 0)
    flops = 2 * n * p * ci * co
    iters = 10
    sets = [(x, w, res)]
    ms = bench_ms(lambda x, w, r: C.conv1x1(
        x, w, bn_in=(scale, shift), residual=r, relu_in=True), sets, iters)
    plain = bench_ms(lambda x, w, r: C.reference_conv1x1(
        x, w, bn_in=(scale, shift), residual=r, relu_in=True), sets,
        max(2, iters // 2))
    sc3, sh3 = scale.reshape(1, ci, 1), shift.reshape(1, ci, 1)

    def library(x, w, r):
        xp = x * sc3 + sh3
        if r is not None:
            xp = xp + r
        yl = torch.matmul(w, torch.relu(xp).to(dt))
        yf = yl.float()
        return yl, yf.sum(dim=(0, 2)), (yf * yf).sum(dim=(0, 2))

    lib = bench_ms(library, sets, iters)
    bnd, by = bound_ms(io_bytes, flops,
                       PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS)
    return {"kernel": "conv1x1", "case": name, "dtype": dtype,
            "shape": [n, ci, co, p], "residual": residual,
            "max_abs_err": abs_err, "err_over_tol": y_err,
            "tol": "one bf16 ulp + %g of max |ref|" % CONV_ATOL_REL
            if dtype == "bf16" else "%g + %g of max |ref|" % (
                KERNEL_ATOL, KERNEL_RTOL), "stats_rel_err": s_err,
            "stats_rtol": CONV_STATS_RTOL, "deterministic": deterministic,
            "ok": y_ok and s_err <= CONV_STATS_RTOL and deterministic,
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "library_note": "torch prologue + torch.matmul (cuBLAS) + two "
            "reductions", "bound_ms": bnd, "bound_by": by, "bytes": io_bytes,
            "flops": flops}


RTC_SOURCE = r"""
extern "C" __global__ void scale_add(const float* x, const float* y,
                                     float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f + y[i];
}
extern "C" __global__ void negate(const float* x, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = -x[i];
}
// one block per row, a block-wide tree sum in dynamic shared memory
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
RTC_SIGS = {"scale_add": "const float *x, const float *y, float *out, int n",
            "negate": "const float *x, float *out, int n",
            "row_sum": "const float *x, float *out, int cols"}
RTC_ROWS = 4096          # row_sum: (4096, 2^26 / 4096)
RTC_BLOCK = 256


def _rtc_launch(kernels, name, x, y, out):
    """The launch of each rtc kernel over RTC_N floats, as a user writes
    it (the grid covers the data; row_sum one block per row)."""
    from mxnet_tpu_torch import gpu
    k = kernels[name]
    if name == "scale_add":
        k.launch([x, y, out, RTC_N], gpu(0),
                 ((RTC_N + RTC_BLOCK - 1) // RTC_BLOCK,), (RTC_BLOCK,))
    elif name == "negate":
        k.launch([x, out, RTC_N], gpu(0),
                 ((RTC_N + RTC_BLOCK - 1) // RTC_BLOCK,), (RTC_BLOCK,))
    else:
        k.launch([x, out, RTC_N // RTC_ROWS], gpu(0), (RTC_ROWS,),
                 (RTC_BLOCK,), shared_mem=RTC_BLOCK * 4)


def _rtc_cases(gen):
    """NVRTC's compile time; each rtc kernel over 2^26 floats against its
    torch expression (plain) and one torch call (library), timed beside
    its bytes bound."""
    import torch
    from mxnet_tpu_torch import rtc
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_SOURCE)
    compile_s = time.perf_counter() - t0
    kernels = {n: mod.get_kernel(n, sig) for n, sig in RTC_SIGS.items()}
    x = torch.randn(RTC_N, generator=gen, device="cuda")
    y = torch.randn(RTC_N, generator=gen, device="cuda")
    out = torch.empty_like(x)
    sums = torch.empty(RTC_ROWS, device="cuda")
    x2 = x.view(RTC_ROWS, -1)
    exprs = {  # (plain torch expression, one torch call, output, bytes)
        "scale_add": (lambda: x * 2.0 + y, lambda: torch.add(y, x, alpha=2),
                      out, 3 * 4 * RTC_N),
        "negate": (lambda: -x, lambda: torch.neg(x), out, 2 * 4 * RTC_N),
        "row_sum": (lambda: x2.sum(1), lambda: torch.sum(x2, 1), sums,
                    4 * RTC_N + 4 * RTC_ROWS)}
    cases = []
    for name, (plain_fn, lib_fn, dst, nbytes) in exprs.items():
        _rtc_launch(kernels, name, x, y, dst)
        ref = plain_fn()
        torch.cuda.synchronize()
        e, tol = err_of(dst, ref)
        ms = bench_ms(lambda: _rtc_launch(kernels, name, x, y, dst), [()], 20)
        plain = bench_ms(plain_fn, [()], 20)
        lib = bench_ms(lib_fn, [()], 20)
        bnd, by = bound_ms(nbytes, 0)
        cases.append({"kernel": "rtc", "case": name, "n": RTC_N,
                      "compile_s": compile_s, "max_abs_err": e, "tol": tol,
                      "ok": e <= tol, "kernel_ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                      "bytes": nbytes})
    return cases


def phase_kernels():
    import torch
    DTYPES.update(f32=torch.float32, bf16=torch.bfloat16, f16=torch.float16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [
        _flash_case("train_b8_s1024", TRAIN_BATCH, 16, 16, 1024, 64, True,
                    gen),
        _flash_case("prefill_s128", 1, 16, 16, 128, 64, True, gen),
        _flash_case("prefill_s1024", 1, 16, 16, 1024, 64, True, gen),
        _flash_case("gqa_s512", 1, 16, 4, 512, 64, True, gen),
        _flash_case("ragged_s1000", 1, 16, 16, 1000, 64, True, gen),
        _flash_case("noncausal_s300", 1, 16, 16, 300, 64, False, gen),
        _flash_case("hd128_s1000", 1, 8, 8, 1000, 128, True, gen),
        _flash_case("hd256_s1000", 1, 8, 8, 1000, 256, True, gen),
        _flash_case("hd384_s1000", 1, 8, 8, 1000, 384, True, gen),
        _flash_case("hd512_s1000", 1, 8, 8, 1000, 512, True, gen),
        _flash_case("train_b8_s1024_bf16", TRAIN_BATCH, 16, 16, 1024, 64,
                    True, gen, "bf16"),
        _flash_case("hd128_s1000_bf16", 1, 8, 8, 1000, 128, True, gen,
                    "bf16"),
        _flash_case("train_b8_s1024_f16", TRAIN_BATCH, 16, 16, 1024, 64,
                    True, gen, "f16"),
        _flash_exact_case("exact_flash_fwd_f32", 2, 16, 1024, 64, gen),
        _flash_exact_case("exact_flash_fwd_f32_hd128", 1, 8, 1000, 128, gen),
    ]
    cases += [
        _flash_bwd_case("train_b8_s1024", TRAIN_BATCH, 16, 16, 1024, 64,
                        True, gen, plain_batch=2),
        _flash_bwd_case("longctx_b8_s4096_d128", 8, 8, 8, 4096, 128, True,
                        gen, plain_batch=1, iters=3),
        _flash_bwd_case("gqa_h8_kv2_s1024", 2, 8, 2, 1024, 64, True, gen),
        _flash_bwd_case("ragged_s1000", 2, 16, 16, 1000, 64, True, gen),
        _flash_bwd_case("noncausal_s512", 2, 16, 16, 512, 64, False, gen),
        _flash_bwd_case("glse_s1024", 2, 16, 16, 1024, 64, True, gen,
                        glse=True),
        # f32 D = 128 dQ on both sides of its tile choice: one wave of
        # blocks here (32-key tiles), many at S 4096 above (16-key tiles)
        _flash_bwd_case("hd128_s1000", 1, 8, 8, 1000, 128, True, gen),
        _flash_bwd_case("hd256_s1000", 1, 8, 8, 1000, 256, True, gen),
        _flash_bwd_case("hd384_s1000", 1, 8, 8, 1000, 384, True, gen),
        _flash_bwd_case("hd512_s1000", 1, 8, 8, 1000, 512, True, gen),
        _flash_bwd_case("train_b8_s1024_bf16", TRAIN_BATCH, 16, 16, 1024, 64,
                        True, gen, plain_batch=2, dt="bf16"),
        _flash_bwd_case("hd128_s1000_bf16", 1, 8, 8, 1000, 128, True, gen,
                        dt="bf16"),
        _flash_bwd_case("gqa_h8_kv2_s1024_f16", 2, 8, 2, 1024, 64, True, gen,
                        glse=True, dt="f16"),
        _flash_exact_case("exact_flash_dq_f32", 2, 16, 1024, 64, gen),
        _flash_exact_case("exact_flash_dq_f32_hd128", 1, 8, 1000, 128, gen),
    ]
    lengths = (0, 1, 17, 100, 511, 700, 1000, 1024)
    cases += [
        _decode_case("step_mha", SLOTS, 16, 16, 1024, 64, lengths, gen),
        _decode_case("step_gqa", SLOTS, 16, 4, 1024, 64, lengths, gen),
        _decode_case("step_hd128", SLOTS, 8, 8, 1024, 128, lengths, gen),
        _decode_case("step_hd256", SLOTS, 8, 8, 1024, 256, lengths, gen),
        _decode_case("step_hd384", SLOTS, 8, 8, 1024, 384, lengths, gen),
        _decode_case("step_hd512", SLOTS, 8, 8, 1024, 512, lengths, gen),
        _decode_case("step_hd512_gqa8", SLOTS, 8, 1, 1024, 512, lengths,
                     gen),
        # GQA groups of 7 (Qwen2-7B: 28 q heads over 4 kv heads, D 128) and
        # 16 (Falcon-40B: 128 over 8, D 64)
        _decode_case("step_gqa7_hd128", SLOTS, 28, 4, 1024, 128, lengths,
                     gen),
        _decode_case("step_gqa16_hd64", SLOTS, 128, 8, 1024, 64, lengths,
                     gen),
        _decode_case("step_mha_bf16", SLOTS, 16, 16, 1024, 64, lengths, gen,
                     "bf16"),
        _decode_case("step_hd128_bf16", SLOTS, 8, 8, 1024, 128, lengths,
                     gen, "bf16"),
        _decode_case("step_gqa_f16", SLOTS, 16, 4, 1024, 64, lengths, gen,
                     "f16"),
        _dense_case("hd96", 96, gen),
        _dense_case("hd640", 640, gen),
        _dense_case("cross_sq128_sk512", 64, gen, s_q=128),
    ]
    # the decode step's six per-layer matmuls (wq, wk, wv, wo at (1024,
    # 1024); w1; w2) and the head at 8 slots, then prefill at the longest
    # bucket's 1000 rows
    cases.append(_qmm_case("step_wq_int8", 8, 1024, 1024, "int8", gen))
    for dt in ("int8", "fp8"):
        cases += [
            _qmm_case("step_w1_" + dt, 8, 1024, 4096, dt, gen),
            _qmm_case("step_w2_" + dt, 8, 4096, 1024, dt, gen),
            _qmm_case("step_head_" + dt, 8, 1024, 50257, dt, gen),
        ]
    cases += [
        _qmm_case("step_w2_int8_m1", 1, 4096, 1024, "int8", gen),
        _qmm_case("step_w2_int8_m16", 16, 4096, 1024, "int8", gen),
        _qmm_case("step_w1_int8_bf16x", 8, 1024, 4096, "int8", gen, "bf16"),
        _qmm_case("prefill_w1_int8", 1000, 1024, 4096, "int8", gen),
        _qmm_case("prefill_w1_fp8", 1000, 1024, 4096, "fp8", gen),
        _qmm_case("prefill_w2_int8", 1000, 4096, 1024, "int8", gen),
        _qmm_case("prefill_w1_int8_bf16x", 1000, 1024, 4096, "int8", gen,
                  "bf16"),
    ]
    # exact products, with teeth: K = 8, x over 40 decades
    cases += [_qmm_pieces_case("exact_%s_%s" % (kind, dt), m, 8, n, dt, gen)
              for kind, m, n in (("step_head", 8, 50257),
                                 ("prefill", 1000, 4096))
              for dt in ("int8", "fp8")]
    # ResNet-50's 1x1 shapes (docs/megakernel_r04.md section 3), each as
    # that doc's unit: relu(bn(x)) prologue plus statistics
    for ci, co, hw in ((256, 64, 56), (64, 256, 56), (128, 512, 28),
                       (1024, 256, 14), (512, 2048, 7)):
        cases.append(_conv_case("r50_%dto%d_%d" % (ci, co, hw), CONV_BATCH,
                                ci, co, hw * hw, "bf16", gen))
    cases.append(_conv_case("r50_256to64_56_residual", CONV_BATCH, 256, 64,
                            56 * 56, "bf16", gen, residual=True))
    cases.append(_conv_case("r50_64to256_56_f32", CONV_BATCH, 64, 256,
                            56 * 56, "f32", gen))
    cases += _rtc_cases(gen)
    RECORD["kernel_cases"] = cases
    for c in cases:
        emit(dict(phase="kernel_case", **c))
    bad = [c["kernel"] + ":" + c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError("kernel disagrees with its plain version: %s"
                             % bad)
    return {"cases": len(cases)}


def _wrappers():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import attention as A, conv_fused as C, \
        quantization as Q
    return {"flash_attention_fwd": A.flash_attention_fwd,
            "flash_attention_bwd_dq": A.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": A.flash_attention_bwd_dkv,
            "decode_attention": A.decode_attention,
            "quantized_matmul": Q.quantized_matmul,
            "conv1x1": C.conv1x1, "rtc": rtc.CudaKernel}


def _reset_counts():
    from mxnet_tpu_torch.ops import attention as A
    for fn in _wrappers().values():
        fn.launches = 0
    A.dense_attention.calls = 0


def _read_counts():
    """Kernel launches by wrapper, and the dense attention route's calls
    (GPT-2 medium's head dim 64 has a kernel: they stay 0)."""
    from mxnet_tpu_torch.ops import attention as A
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    counts["dense_attention"] = A.dense_attention.calls
    return counts


def _lm_batch():
    """Next token = (token + 3) % vocab (examples/transformer_lm.py),
    8 x 1024 tokens from the seed, as float ids (Gluon's convention)."""
    import numpy as np
    import torch
    v, s = TRAIN["vocab_size"], TRAIN["max_length"]
    rng = np.random.RandomState(SEED)
    start = rng.randint(0, v, (TRAIN_BATCH, 1))
    tokens = (start + np.arange(s + 1) * 3) % v
    x = torch.tensor(tokens[:, :-1], dtype=torch.float32, device=DEV)
    y = torch.tensor(tokens[:, 1:], dtype=torch.float32, device=DEV)
    return x, y


def _lm_step_loss(net, head, loss_fn, x, y):
    logits = head(net(x))
    return loss_fn(logits.reshape(-1, TRAIN["vocab_size"]),
                   y.reshape(-1)).mean()


def _grad_stats(g_a, g_b, gmax, elem_rtol):
    """Per-tensor differences of two gradient dicts (g_b the reference);
    counts the elements beyond ``elem_rtol`` of their tensor's max."""
    st = {"norm": (0.0, None), "elem": (0.0, None), "key_bias": 0.0, "outliers": {},
          "n_out": 0, "n_el": 0, "finite": True}
    for n in g_b:
        st["finite"] = st["finite"] and bool(g_a[n].isfinite().all())
        if n.endswith("_key_bias"):
            st["key_bias"] = max(st["key_bias"],
                                 float(g_a[n].abs().max()) / gmax,
                                 float(g_b[n].abs().max()) / gmax)
            continue
        diff = (g_a[n] - g_b[n]).abs()
        rel = float(diff.norm()) / max(float(g_b[n].norm()), 1e-30)
        scale = max(float(g_b[n].abs().max()), 1e-30)
        out = int((diff > elem_rtol * scale).sum())
        st["n_el"] += diff.numel()
        if out:
            st["n_out"] += out
            st["outliers"][n] = out
        if rel > st["norm"][0]:
            st["norm"] = (rel, n)
        if float(diff.max()) / scale > st["elem"][0]:
            st["elem"] = (float(diff.max()) / scale, n)
    st["outliers"] = dict(sorted(st["outliers"].items(),
                                 key=lambda kv: -kv[1])[:12])
    return st


def _grad_check(net, head, params, loss_fn, x, y):
    """Loss and every parameter's gradient on the first GRAD_SLICE
    sequences three ways: through the kernels; through the plain
    attention (the blocks' ``flash_attention`` swapped for
    ``reference_attention``, differentiated by torch); and through the
    forward kernel with the backward's plain twin swapped in, which keeps
    the forward (and every ReLU mask) bit-identical and so isolates the
    dQ and dK/dV kernels. Both swaps hold for this check only."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.nn import transformer as T
    from mxnet_tpu_torch.ops import attention as A
    xs, ys = x[:GRAD_SLICE], y[:GRAD_SLICE]
    kernel_fwd, kernel_bwd = T.flash_attention, A.flash_attention_bwd
    runs = {}
    for mode in ("kernels", "plain", "plain_bwd"):
        if mode == "plain":
            T.flash_attention = A.reference_attention
        if mode == "plain_bwd":
            A.flash_attention_bwd = A.reference_flash_attention_bwd
        try:
            with autograd.record():
                loss = _lm_step_loss(net, head, loss_fn, xs, ys)
            loss.backward()
        finally:
            T.flash_attention = kernel_fwd
            A.flash_attention_bwd = kernel_bwd
        runs[mode] = (float(loss.detach()),
                      {n: p.grad().detach().clone()
                       for n, p in params.items()})
    l_k, g_k = runs["kernels"]
    l_p, g_p = runs["plain"]
    gmax = max(float(g.abs().max()) for g in g_p.values())
    full = _grad_stats(g_k, g_p, gmax, PATH_ELEM_RTOL)
    bwd = _grad_stats(g_k, runs["plain_bwd"][1], gmax, BWD_GRAD_RTOL)
    del runs, g_k, g_p
    res = {"sequences": GRAD_SLICE, "tensors": len(params),
           "loss_kernels": l_k, "loss_plain": l_p,
           "loss_rel_err": abs(l_k - l_p) / abs(l_p),
           "loss_rtol": LOSS_RTOL,
           "bwd_only_norm_rel_err": bwd["norm"][0],
           "bwd_only_elem_rel_err_max": bwd["elem"][0],
           "bwd_only_worst_tensor": bwd["elem"][1],
           "bwd_only_elems_beyond_rtol_of_max": bwd["n_out"],
           "bwd_only_rtol": BWD_GRAD_RTOL,
           "path_norm_rel_err": full["norm"][0],
           "path_worst_tensor": full["norm"][1],
           "path_rtol": PATH_GRAD_RTOL,
           "path_elem_rel_err_max": full["elem"][0],
           "path_worst_elem_tensor": full["elem"][1],
           "path_elem_count_rtol": PATH_ELEM_RTOL,
           "path_elems_beyond_rtol_of_max": full["n_out"],
           "elems": full["n_el"],
           "path_tensors_with_such_elems": full["outliers"],
           "key_bias_max_rel": max(full["key_bias"], bwd["key_bias"]),
           "key_bias_rtol": ZERO_GRAD_RTOL,
           "all_finite": full["finite"] and bwd["finite"]}
    res["ok"] = bool(
        res["all_finite"] and res["loss_rel_err"] <= LOSS_RTOL and
        bwd["norm"][0] <= BWD_GRAD_RTOL and
        bwd["elem"][0] <= BWD_GRAD_RTOL and
        full["norm"][0] <= PATH_GRAD_RTOL and
        res["key_bias_max_rel"] <= ZERO_GRAD_RTOL)
    return res


def phase_train():
    """The Gluon training path at full width: build, gradient check,
    warm-up, timed steps (launch counts read around the timed steps)."""
    import math as _m
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, cpu, gluon, gpu
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    ctx = gpu(0) if DEV == "cuda" else cpu()
    net = gluon.nn.TransformerEncoder(**TRAIN, prefix="lm_")
    head = gluon.nn.Dense(TRAIN["vocab_size"], flatten=False,
                          prefix="head_")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    head.initialize(mx.init.Xavier(), ctx=ctx)
    params = {**net.collect_params(), **head.collect_params()}
    trainer = gluon.Trainer(params, "adam", {"learning_rate": TRAIN_LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _lm_batch()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    check = _grad_check(net, head, params, loss_fn, x, y)
    if DEV == "cuda":
        check["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    build_s = time.perf_counter() - t0
    n_params = int(sum(p.data().numel() for p in params.values()))
    emit(dict(phase="train_grad_check", **check))

    def step():
        with autograd.record():
            loss = _lm_step_loss(net, head, loss_fn, x, y)
        loss.backward()
        trainer.step(1)             # the loss is a mean already, as in
        return loss.detach()        # examples/transformer_lm.py

    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(step())
    _sync()
    if DEV == "cuda":               # the timed steps' peak alone
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        losses.append(step())
        _sync()
        step_s.append(time.perf_counter() - t1)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    losses = [float(v) for v in losses]
    tokens = TRAIN_BATCH * TRAIN["max_length"]
    mean_s = sum(step_s) / len(step_s)
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = TRAIN["num_layers"]
    res = {"model": dict(TRAIN, head="Dense(vocab, flatten=False)"),
           "batch": TRAIN_BATCH, "tokens_per_step": tokens,
           "n_params": n_params, "setup_and_check_s": build_s,
           "grad_check": check, "losses": losses,
           "step_s": step_s, "step_s_mean": mean_s,
           "step_s_min": min(step_s), "tokens_per_s": tokens / mean_s,
           "peak_mem_gb": peak / 1e9, "launches": counts,
           "launches_per_step": per_step,
           "all_finite": all(_m.isfinite(v) for v in losses),
           "loss_falls": losses[-1] < losses[0]}
    res["ok"] = bool(check["ok"] and res["all_finite"] and res["loss_falls"]
                     and counts["dense_attention"] == 0
                     and all(counts[k] == want * TRAIN_STEPS for k in (
                         "flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")))
    RECORD["train"] = res
    RECORD["_train"] = (net, head, trainer, loss_fn, x, y, mean_s)
    if not res["ok"]:
        raise AssertionError("train failed: %s" % json.dumps(res)[:3000])
    return res


def _device_rows(prof, n_steps):
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and "CUDA" in str(getattr(ev, "device_type", "")):
            rows.append((ev.key, t / (1e3 * n_steps), ev.count / n_steps))
    if DEV == "cuda" and not rows:
        raise AssertionError("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    return rows


# device kernels grouped by name (matched lower-case, first group wins)
_GROUPS = (("flash_fwd", ("flash_fwd",)), ("flash_bwd_dq", ("flash_bwd_dq",)),
           ("flash_bwd_dkv", ("flash_bwd_dkv",)),
           ("gemm", ("gemm", "cutlass", "kernel2")),
           ("layer_norm", ("layer_norm", "gammabeta")),
           ("log_softmax", ("softmax",)),
           ("embedding", ("embedding", "index", "scatter", "gather")))


def phase_train_profile():
    """One training step under torch.profiler: device time by kernel
    against the host wall per step (the timed steps' mean)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import autograd
    net, head, trainer, loss_fn, x, y, host_s = RECORD.pop("_train")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with autograd.record():
            loss = _lm_step_loss(net, head, loss_fn, x, y)
        loss.backward()
        trainer.step(1)
        _sync()
    rows = _device_rows(prof, 1)
    dev_ms = sum(r[1] for r in rows)
    groups = {}
    for k, t, c in rows:
        g = next((name for name, keys in _GROUPS
                  if any(key in k.lower() for key in keys)),
                 "other (elementwise: Adam, residuals, ReLU, ...)")
        groups[g] = groups.get(g, 0.0) + t
    res = {"step_host_ms": host_s * 1e3, "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms / (host_s * 1e3),
           "groups_ms": groups,
           "top": [{"kernel": k[:100], "ms_per_step": t, "calls": c}
                   for k, t, c in rows[:15]]}
    del net, head, trainer, loss, x, y
    import gc
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return res


def _pct(xs, p):
    xs = sorted(xs)
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))]


def _recompute_logits(model, toks):
    """Logits after ``toks`` by one prefill of the whole context into a
    fresh one-slot cache."""
    import torch
    from mxnet_tpu_torch.serving.decode import prompt_buckets
    bucket = next(b for b in prompt_buckets(CFG["max_len"])
                  if b >= len(toks))
    kc, vc = model.init_cache(1)
    padded = torch.zeros(1, bucket, dtype=torch.int64, device=DEV)
    padded[0, :len(toks)] = torch.tensor(toks, device=DEV)
    _, _, _, ref = model.prefill(kc, vc, padded, len(toks), 0)
    return ref.float().cpu().numpy()


def _serve(tag, model, params, need):
    """Serve the staggered sessions; check logits; return the phase."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.serving.decode import DecodeEngine, prompt_buckets
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, CFG["vocab"], size=n).tolist()
               for n in PROMPT_LENS]
    t0 = time.perf_counter()
    eng = DecodeEngine(model, params, num_slots=SLOTS, name=tag, device=DEV)
    setup_s = time.perf_counter() - t0
    try:
        # warm the allocator and every prompt bucket off the clock
        ladder = prompt_buckets(CFG["max_len"])
        for b in sorted({next(b for b in ladder if b >= n)
                         for n in PROMPT_LENS}):
            eng.generate([1] * min(b, CFG["max_len"] - 1), max_new_tokens=2)
        _sync()
        _reset_counts()
        steps0 = eng.step_executions
        t_sub, sessions = [], []
        t_start = time.perf_counter()
        for i, p in enumerate(prompts):
            t_sub.append(time.perf_counter())
            sessions.append(eng.submit(
                p, max_new_tokens=NEW_TOKENS,
                keep_logits=i in (0, len(prompts) - 1)))
            time.sleep(0.005)
        outs = [s.result(timeout=600) for s in sessions]
        wall = time.perf_counter() - t_start
        counts = _read_counts()
        steps = eng.step_executions - steps0
    finally:
        eng.close()
    n_tok = sum(len(o) for o in outs)
    itl = [(b - a) * 1e3 for s in sessions
           for a, b in zip(s.t_emit, s.t_emit[1:])]
    ttft = [(s.t_emit[0] - t) * 1e3 for s, t in zip(sessions, t_sub)]
    # served logits vs a full-context recompute through the plain path:
    # every step of the shortest prompt (bucket 32), and the first and last
    # step of the longest (bucket 1024, decode lengths past 900)
    checks = [(0, range(NEW_TOKENS)), (len(prompts) - 1, (0, NEW_TOKENS - 1))]
    worst, n_checked, finite = {}, 0, True
    # the plain versions for this recompute only: serving.decode's names
    # of the three kernel wrappers patched to their reference twins
    from mxnet_tpu_torch.ops import attention as A, quantization as Q
    from mxnet_tpu_torch.serving import decode as SD
    kernels = (SD.flash_attention, SD.decode_attention, SD.quantized_matmul)
    SD.flash_attention = A.reference_attention
    SD.decode_attention = A.reference_decode_attention
    SD.quantized_matmul = Q.reference_quantized_matmul
    try:
        for i, steps_i in checks:
            sess = sessions[i]
            worst[PROMPT_LENS[i]] = 0.0
            for t in steps_i:
                got = sess.logits[t]
                finite = finite and bool(np.isfinite(got).all())
                ref = _recompute_logits(model, prompts[i] + sess.tokens[:t])
                rel = float(np.abs(got - ref).max()
                            / max(1e-30, np.abs(ref).max()))
                worst[PROMPT_LENS[i]] = max(worst[PROMPT_LENS[i]], rel)
                n_checked += 1
    finally:
        (SD.flash_attention, SD.decode_attention,
         SD.quantized_matmul) = kernels
    ok_counts = all(counts[k] > 0 for k in need) \
        and counts["dense_attention"] == 0
    res = {"setup_s": setup_s, "sessions": len(outs),
           "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "steps": steps, "step_ms_mean": wall / max(steps, 1) * 1e3,
           "itl_p50_ms": _pct(itl, 50), "itl_p99_ms": _pct(itl, 99),
           "ttft_p50_ms": _pct(ttft, 50), "ttft_max_ms": max(ttft),
           "launches": counts, "logits_checked": n_checked,
           "logits_max_rel_err": max(worst.values()),
           "logits_max_rel_err_by_prompt": worst,
           "logits_tol_rel": LOGIT_RTOL, "all_finite": finite,
           "lens_ok": all(len(o) == NEW_TOKENS for o in outs)}
    res["ok"] = bool(ok_counts and res["logits_max_rel_err"] <= LOGIT_RTOL
                     and finite and res["lens_ok"])
    if not res["ok"]:
        raise AssertionError("%s failed: %s" % (tag, json.dumps(res)))
    return res


def phase_engines():
    import numpy as np  # noqa: F401
    import torch
    from mxnet_tpu_torch.contrib.quantization import calibrate_weights
    from mxnet_tpu_torch.convert import to_torch_params
    from mxnet_tpu_torch.serving.decode import DecodeModel
    t0 = time.perf_counter()
    model = DecodeModel(**CFG)
    params = model.init_params(seed=SEED)
    init_s = time.perf_counter() - t0
    n_params = int(sum(v.size for v in params.values()))
    out = {}
    r = _serve("gpt2m-f32", model, params,
               ("flash_attention_fwd", "decode_attention"))
    r.update(init_params_s=init_s, n_params=n_params)
    out["engine_f32"] = r
    emit(dict(phase="engine_f32", **r))
    dev_params = to_torch_params(params, DEV)
    del params
    qparams, stats = calibrate_weights(dev_params, "int8")
    del dev_params
    model_q = DecodeModel(**CFG)
    r = _serve("gpt2m-int8", model_q, qparams,
               ("flash_attention_fwd", "decode_attention",
                "quantized_matmul"))
    r["int8_weight_bytes"] = int(sum(
        v.numel() for k, v in qparams.items()
        if v.dtype == torch.int8))
    r["calib_rms_rel_err_max"] = max(s["rms_rel_err"]
                                     for s in stats.values())
    out["engine_int8"] = r
    emit(dict(phase="engine_int8", **r))
    RECORD["engines"] = out
    RECORD["_models"] = {"f32": model, "int8": model_q}
    return {"done": list(out)}


def phase_profile():
    """A full-occupancy decode step of each served model (float, int8),
    timed by host clock and under torch.profiler (device time by
    kernel)."""
    models = RECORD.pop("_models")
    return {tag: _profile_step(m) for tag, m in models.items()}


def _profile_step(model):
    import torch
    from torch.profiler import ProfilerActivity, profile
    kc, vc = model.init_cache(SLOTS)
    dev = DEV
    toks = torch.arange(SLOTS, dtype=torch.int32, device=dev)
    lens = torch.tensor([CFG["max_len"] // 2] * SLOTS, dtype=torch.int32,
                        device=dev)
    act = torch.ones(SLOTS, dtype=torch.bool, device=dev)
    for _ in range(3):
        model.step(kc, vc, toks, lens, act)
    _sync()
    t0 = time.perf_counter()
    n = 10
    for _ in range(n):
        model.step(kc, vc, toks, lens, act)
    _sync()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    res = {"step_host_ms": host_ms, "slots": SLOTS,
           "length": CFG["max_len"] // 2}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.step(kc, vc, toks, lens, act)
        _sync()
    rows = _device_rows(prof, 3)
    dev_total = sum(r[1] for r in rows)
    res.update(device_ms_per_step=dev_total,
               device_busy_share=dev_total / host_ms if host_ms else None,
               top=[{"kernel": k[:80], "ms_per_step": t, "calls": c}
                    for k, t, c in rows[:12]])
    del kc, vc
    return res


def _stage2_chain(conv, x0, w1, w2, r, gamma, beta):
    """ResNet-50 stage 2's bottleneck boundary through ops.conv_fused:
    expand with statistics, fold BN, the next block's reduce with the
    BN + residual + ReLU prologue and statistics, and its BN."""
    from mxnet_tpu_torch.ops import conv_fused as C
    count = x0.shape[0] * x0.shape[2]
    y, (s1, s2) = conv(x0, w1)
    mean, _, rstd = C.finalize_stats(s1, s2, count, 1e-5)
    fold = C.bn_fold(gamma, beta, mean, rstd)
    z, (t1, t2) = conv(y, w2, bn_in=fold, residual=r, relu_in=True)
    return y, z, C.finalize_stats(t1, t2, count, 1e-5)


def phase_conv():
    """The conv path at ResNet-50's stage-2 widths, batch 128, bf16:
    x0 (128, 64, 56*56) -> 256 channels -> 64, through conv1x1,
    finalize_stats and bn_fold. Launch counts are read around the timed
    applications; the check runs the same chain through
    reference_conv1x1."""
    import torch
    from mxnet_tpu_torch.ops import conv_fused as C
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    n, c, p = CONV_BATCH, 64, 56 * 56
    bf = torch.bfloat16
    x0 = torch.randn(n, c, p, generator=gen, device=DEV).to(bf)
    w1 = (torch.randn(4 * c, c, generator=gen, device=DEV) / c ** 0.5).to(bf)
    w2 = (torch.randn(c, 4 * c, generator=gen, device=DEV)
          / (4 * c) ** 0.5).to(bf)
    r = torch.randn(n, 4 * c, p, generator=gen, device=DEV).to(bf)
    gamma = torch.rand(4 * c, generator=gen, device=DEV) + 0.5
    beta = torch.randn(4 * c, generator=gen, device=DEV) * 0.1
    args = (x0, w1, w2, r, gamma, beta)
    _stage2_chain(C.conv1x1, *args)                  # warm-up
    _sync()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    iters = 10
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(iters):
        y, z, (mean, var, rstd) = _stage2_chain(C.conv1x1, *args)
    en.record()
    en.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = st.elapsed_time(en) / iters
    ry, rz, (rmean, rvar, _) = _stage2_chain(C.reference_conv1x1, *args)
    torch.cuda.synchronize()
    y_err = _bf16_ulp_err(y, ry, CONV_ATOL_REL)
    z_err = _bf16_ulp_err(z, rz, CHAIN_ATOL_REL)
    stats_err = _stats_err((mean, var), (rmean, rvar))
    res = {"model": "ResNet-50 stage 2 bottleneck boundary (torchvision "
           "resnet50: 64 -> 256 expand, 256 -> 64 reduce)",
           "shape": [n, c, 4 * c, p], "dtype": "bf16",
           "ms_per_application": ms, "applications": iters,
           "launches": counts,
           "launches_per_application": counts["conv1x1"] / iters,
           "peak_mem_gb": peak / 1e9, "y_err_ulps": y_err,
           "z_err_ulps": z_err, "bn_stats_rel_err": stats_err,
           "all_finite": bool(torch.isfinite(z.float()).all()),
           "bytes_per_application": 2 * (x0.numel() + 2 * y.numel()
                                         + r.numel() + z.numel())}
    res["ok"] = bool(counts["conv1x1"] == 2 * iters and y_err <= 1.0
                     and z_err <= 1.0 and stats_err <= CONV_STATS_RTOL
                     and res["all_finite"])
    RECORD["conv"] = res
    if not res["ok"]:
        raise AssertionError("conv failed: %s" % json.dumps(res))
    return res


def phase_rtc():
    """A user's runtime-compiled kernels: rtc.CudaModule compiles the
    source through NVRTC, get_kernel parses each signature, launch runs
    each over 2^26 floats (row_sum with a grid of rows, a block and
    dynamic shared memory); launch counts read around the launches."""
    import torch
    from mxnet_tpu_torch import rtc
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 3)
    _reset_counts()
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_SOURCE)
    kernels = {n: mod.get_kernel(n, sig) for n, sig in RTC_SIGS.items()}
    x = torch.randn(RTC_N, generator=gen, device=DEV)
    y = torch.randn(RTC_N, generator=gen, device=DEV)
    outs = {"scale_add": torch.empty_like(x), "negate": torch.empty_like(x),
            "row_sum": torch.empty(RTC_ROWS, device=DEV)}
    for name, dst in outs.items():
        _rtc_launch(kernels, name, x, y, dst)
    _sync()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    refs = {"scale_add": x * 2.0 + y, "negate": -x,
            "row_sum": x.view(RTC_ROWS, -1).sum(1)}
    errs = {n: err_of(outs[n], refs[n]) for n in outs}
    res = {"kernels": list(outs), "n": RTC_N, "compile_and_run_s": wall,
           "launches": counts,
           "max_abs_err": {n: e for n, (e, _) in errs.items()},
           "tol": {n: t for n, (_, t) in errs.items()}}
    res["ok"] = bool(counts["rtc"] == len(outs)
                     and all(e <= t for e, t in errs.values()))
    RECORD["rtc"] = res
    if not res["ok"]:
        raise AssertionError("rtc failed: %s" % json.dumps(res))
    return res


PHASES = (("device", phase_device), ("build", phase_build),
          ("kernels", phase_kernels), ("train", phase_train),
          ("train_profile", phase_train_profile),
          ("engines", phase_engines), ("profile", phase_profile),
          ("conv", phase_conv), ("rtc", phase_rtc))

# (name, source, TPU kernel, case kind, case, its time / bound keys, errors)
KERNEL_ROWS = (
    ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/attention.py:80", "flash_attention_fwd",
     "train_b8_s1024", "kernel_ms", "bound_ms", "bound_by",
     ("max_abs_err",)),
    ("flash_attention_bwd_dq", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
     "mxnet_tpu/ops/attention.py:144", "flash_attention_bwd",
     "train_b8_s1024", "dq_ms", "dq_bound_ms", "dq_bound_by", ("err_dq",)),
    ("flash_attention_bwd_dkv",
     "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
     "mxnet_tpu/ops/attention.py:197", "flash_attention_bwd",
     "train_b8_s1024", "dkv_ms", "dkv_bound_ms", "dkv_bound_by",
     ("err_dk", "err_dv")),
    ("decode_attention", "mxnet_tpu_torch/csrc/decode_attention.cu",
     "mxnet_tpu/ops/attention.py:612", "decode_attention", "step_mha",
     "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",)),
    ("quantized_matmul", "mxnet_tpu_torch/csrc/quantized_matmul.cu",
     "mxnet_tpu/ops/quantization.py:407", "quantized_matmul",
     "step_head_int8", "kernel_ms", "bound_ms", "bound_by",
     ("max_abs_err",)),
    ("conv1x1", "mxnet_tpu_torch/csrc/conv1x1.cu",
     "mxnet_tpu/ops/conv_fused.py:69", "conv1x1", "r50_64to256_56",
     "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",)),
    ("rtc", "mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:71", "rtc",
     "scale_add", "kernel_ms", "bound_ms", "bound_by", ("max_abs_err",)),
)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import mxnet_tpu_torch  # noqa: F401
        from mxnet_tpu_torch import _build
        if not any(_build.CSRC.glob("*.cu")):
            raise ImportError("no kernel sources under %s" % _build.CSRC)
    except ImportError as e:
        print("chip_smoke: mxnet_tpu_torch not importable from %s: %s"
              % (HERE, e), file=sys.stderr)
        return 2
    failed = []
    for name, fn in PHASES:
        t0 = time.perf_counter()
        try:
            res = fn()
            emit(dict(res, phase=name, ok=True,
                      seconds=time.perf_counter() - t0))
        except Exception as e:      # a phase failing must not hide the rest
            failed.append(name)
            emit({"phase": name, "ok": False, "error": repr(e)[:2000],
                  "seconds": time.perf_counter() - t0})
            traceback.print_exc()
            if name in ("device", "build"):
                break
    cases = RECORD.get("kernel_cases", [])
    paths = list(RECORD.get("engines", {}).values())
    paths += [RECORD[k] for k in ("train", "conv", "rtc") if k in RECORD]
    rows = []
    for (name, src, replaces, kind, case, ms_key, bound_key, by_key,
         err_keys) in KERNEL_ROWS:
        c = next((c for c in cases
                  if c["kernel"] == kind and c["case"] == case), None)
        # absolute errors, but of the attention cases in bf16/f16: those
        # are held in ulps and kept in chip_smoke.json
        errs = [c[k] for c in cases if c["kernel"] == kind
                and not c.get("held_in_ulps") for k in err_keys]
        launches = sum(p["launches"].get(name, 0) for p in paths)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": max(errs) if errs else None,
                     "case": case,
                     "ms": c and c[ms_key],
                     "plain_ms": c and c["plain_ms"],
                     "bound_ms": c and c[bound_key],
                     "bound_by": c and c[by_key],
                     "library_ms": c and c["library_ms"]})
    RECORD["kernels"] = rows
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1, default=str)
    unlaunched = [r["name"] for r in rows if not r["launches"]]
    if unlaunched and not failed:
        failed.append("no launch on a path: %s" % unlaunched)
    if failed:
        print("chip_smoke: failed phases: %s" % failed, file=sys.stderr)
        return 1
    print(RECORD["nvidia_smi"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
