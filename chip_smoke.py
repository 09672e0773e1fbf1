#!/usr/bin/env python3
"""Chip smoke test of mxnet_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port's decode-serving path end to end at GPT-2 medium's
published widths (OpenAI GPT-2 "355M": n_embd 1024, n_head 16, n_layer 24,
n_positions 1024, vocab 50257, MLP 4096) with random weights from a seed.
The DecodeModel's own equations differ from GPT-2's: RMSNorm instead of
LayerNorm, no biases, an untied head. Phases, one JSON line each:

  device   card name, power limit (nvidia-smi), torch/CUDA versions
  build    nvcc builds every kernel of mxnet_tpu_torch/csrc, timed
  kernels  each kernel against its plain PyTorch version at the main
           path's shapes (max error vs a stated tolerance), and timed
           beside its plain version and one library call
  engine_f32 / engine_int8
           DecodeEngine serving 8 staggered sessions with float and
           int8 weights; one session's per-token logits held against a
           full-context recompute through the plain path; tokens/s,
           per-token latency, and each kernel's launch count
  profile  one decode step under torch.profiler: device time by kernel

then a ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero (and prints no result)
without CUDA, or when any phase fails. Details go to
chiprun_out/chip_smoke.json.
"""
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# the FP32 rate outside the tensor cores (every kernel here is f32 FMA)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# GPT-2 medium widths
CFG = dict(vocab=50257, layers=24, d_model=1024, heads=16, kv_heads=16,
           d_ff=4096, max_len=1024)
SLOTS = 8
PROMPT_LENS = (17, 60, 100, 200, 300, 500, 700, 900)
NEW_TOKENS = 32
SEED = 0

# tolerances, stated before the run. Kernels vs their plain versions:
# float32 sums taken in another order, |values| ~ 1, so 1e-4 absolute
# plus 1e-4 relative to the reference's largest magnitude.
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 1e-4
# engine logits vs full-context recompute through the plain path: 24
# layers of float32 rounding in another order (and, for int8, the same
# dequantized weights multiplied in another order), relative to the
# largest logit
LOGIT_RTOL = 1e-3

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
    """Mean ms per call by CUDA events, cycling through ``argsets`` so
    consecutive calls read different buffers (beyond the 50 MB L2 where
    the main path finds its inputs cold)."""
    import torch
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
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


def bound_ms(nbytes, flops):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_F32_FLOPS * 1e3
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
    ptxas = [ln.strip() for log in info.get("logs", {}).values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln
             and "0 bytes spill" not in ln]
    return {"build_seconds": secs, "built": info.get("built"),
            "ptxas": ptxas[:40]}


def _flash_case(name, b, h, hkv, s, d, causal, gen):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    q = torch.randn(b, h, s, d, generator=gen, device=dev)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    out, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    rout, rlse = A.reference_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    e_o, tol_o = err_of(out, rout)
    e_l, tol_l = err_of(lse, rlse)
    io_bytes = 4 * (2 * q.numel() + k.numel() + v.numel() + lse.numel())
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
    bnd, by = bound_ms(io_bytes, flops)
    return {"kernel": "flash_attention_fwd", "case": name,
            "shape": [b, h, hkv, s, d], "causal": causal,
            "max_abs_err": max(e_o, e_l), "err_out": e_o, "err_lse": e_l,
            "tol_out": tol_o, "tol_lse": tol_l,
            "ok": e_o <= tol_o and e_l <= tol_l,
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bnd, "bound_by": by, "bytes": io_bytes,
            "flops": flops}


def _decode_case(name, b, h, hkv, s, d, lengths, gen):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as A
    dev = "cuda"
    q = torch.randn(b, h, d, generator=gen, device=dev)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, ln)
    ref = A.reference_decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    e, tol = err_of(out, ref)
    tot = int(sum(lengths))
    io_bytes = 4 * (2 * q.numel() + 2 * hkv * d * tot) + 4 * b
    flops = 4 * h * d * tot
    pool_bytes = 4 * (k.numel() + v.numel())
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
    return {"kernel": "decode_attention", "case": name,
            "shape": [b, h, hkv, s, d], "lengths": list(lengths),
            "max_abs_err": e, "tol": tol, "ok": e <= tol,
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bnd, "bound_by": by, "bytes": io_bytes,
            "flops": flops}


def _qmm_case(name, m, kdim, n, dtype, gen):
    import torch
    from mxnet_tpu_torch.ops import quantization as Q
    dev = "cuda"
    x = torch.randn(m, kdim, generator=gen, device=dev)
    w = torch.randn(kdim, n, generator=gen, device=dev) / math.sqrt(kdim)
    q, sc = Q.quantize_rows(w, dtype)
    del w
    out = Q.quantized_matmul(x, q, sc)
    ref = Q.reference_quantized_matmul(x, q, sc)
    torch.cuda.synchronize()
    e, tol = err_of(out, ref)
    io_bytes = 4 * m * kdim + q.numel() * q.element_size() + 4 * n \
        + 4 * m * n
    flops = 2 * m * n * kdim
    sets = copies(q.numel() * q.element_size(), x, q, sc)
    wide = [(a[0], Q.dequantize_rows(a[1], a[2])) for a in sets[:2]]
    iters = 20
    ms = bench_ms(Q.quantized_matmul, sets, iters)
    plain = bench_ms(Q.reference_quantized_matmul, sets, iters)
    lib = bench_ms(torch.matmul, wide, iters)
    bnd, by = bound_ms(io_bytes, flops)
    return {"kernel": "quantized_matmul", "case": name, "dtype": dtype,
            "shape": [m, kdim, n], "max_abs_err": e, "tol": tol,
            "ok": e <= tol, "kernel_ms": ms, "plain_ms": plain,
            "library_ms": lib, "library_note": "torch.matmul on the "
            "pre-dequantized f32 weight (2 copies rotated)",
            "bound_ms": bnd, "bound_by": by, "bytes": io_bytes,
            "flops": flops}


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [
        _flash_case("prefill_s128", 1, 16, 16, 128, 64, True, gen),
        _flash_case("prefill_s1024", 1, 16, 16, 1024, 64, True, gen),
        _flash_case("gqa_s512", 1, 16, 4, 512, 64, True, gen),
        _flash_case("ragged_s1000", 1, 16, 16, 1000, 64, True, gen),
        _flash_case("noncausal_s300", 1, 16, 16, 300, 64, False, gen),
        _flash_case("hd128_s1000", 1, 8, 8, 1000, 128, True, gen),
    ]
    lengths = (0, 1, 17, 100, 511, 700, 1000, 1024)
    cases += [
        _decode_case("step_mha", SLOTS, 16, 16, 1024, 64, lengths, gen),
        _decode_case("step_gqa", SLOTS, 16, 4, 1024, 64, lengths, gen),
        _decode_case("step_hd128", SLOTS, 8, 8, 1024, 128, lengths, gen),
    ]
    for dt in ("int8", "fp8"):
        cases += [
            _qmm_case("step_w1_" + dt, 8, 1024, 4096, dt, gen),
            _qmm_case("step_w2_" + dt, 8, 4096, 1024, dt, gen),
            _qmm_case("step_head_" + dt, 8, 1024, 50257, dt, gen),
        ]
    cases.append(_qmm_case("prefill_w1_int8", 1000, 1024, 4096, "int8",
                           gen))
    RECORD["kernel_cases"] = cases
    for c in cases:
        emit(dict(phase="kernel_case", **c))
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError("kernel disagrees with its plain version: %s"
                             % bad)
    return {"cases": len(cases)}


def _reset_counts():
    from mxnet_tpu_torch.ops import attention as A, quantization as Q
    A.flash_attention_fwd.launches = 0
    A.decode_attention.launches = 0
    Q.quantized_matmul.launches = 0


def _read_counts():
    from mxnet_tpu_torch.ops import attention as A, quantization as Q
    return {"flash_attention_fwd": A.flash_attention_fwd.launches,
            "decode_attention": A.decode_attention.launches,
            "quantized_matmul": Q.quantized_matmul.launches}


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
    model.plain = True
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
        model.plain = False
    ok_counts = all(counts[k] > 0 for k in need)
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
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and "CUDA" in str(getattr(ev, "device_type", "")):
            rows.append((ev.key, t / 3e3, ev.count / 3))
    if DEV == "cuda" and not rows:
        raise AssertionError("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    dev_total = sum(r[1] for r in rows)
    res.update(device_ms_per_step=dev_total,
               device_busy_share=dev_total / host_ms if host_ms else None,
               top=[{"kernel": k[:80], "ms_per_step": t, "calls": c}
                    for k, t, c in rows[:12]])
    del kc, vc
    return res


PHASES = (("device", phase_device), ("build", phase_build),
          ("kernels", phase_kernels), ("engines", phase_engines),
          ("profile", phase_profile))

KERNEL_ROWS = (
    ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention.cu",
     "mxnet_tpu/ops/attention.py:80", "prefill_s1024"),
    ("decode_attention", "mxnet_tpu_torch/csrc/decode_attention.cu",
     "mxnet_tpu/ops/attention.py:612", "step_mha"),
    ("quantized_matmul", "mxnet_tpu_torch/csrc/quantized_matmul.cu",
     "mxnet_tpu/ops/quantization.py:407", "step_head_int8"),
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
    total = {}
    for c in RECORD.get("kernel_cases", []):
        total[c["kernel"]] = max(total.get(c["kernel"], 0.0),
                                 c["max_abs_err"])
    eng = RECORD.get("engines", {})
    rows = []
    for name, src, replaces, case in KERNEL_ROWS:
        c = next((c for c in RECORD.get("kernel_cases", [])
                  if c["case"] == case), None)
        launches = sum(e["launches"].get(name, 0) for e in eng.values())
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": total.get(name),
                     "case": case,
                     "ms": c and c["kernel_ms"],
                     "plain_ms": c and c["plain_ms"],
                     "bound_ms": c and c["bound_ms"],
                     "bound_by": c and c["bound_by"],
                     "library_ms": c and c["library_ms"]})
    RECORD["kernels"] = rows
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1, default=str)
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
