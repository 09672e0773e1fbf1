"""Device-efficiency accounting: cost extraction, MFU and roofline
attainment, device-memory preflight, plan accounting and the recompile
sentinel (counterpart of mxnet_tpu/telemetry/devstats.py).

* **Preflight**: a KV pool plus weights, or a plan, that cannot fit the
  card fails with a sized error (:class:`HBMPreflightError`) instead of
  running out of memory mid-request.
* **Plan accounting** (:func:`record_program`, :func:`program_stats`,
  :func:`counters`): each compiled plan (the decode engine's CUDA graphs)
  records its name, kind, peak bytes (the caching allocator's peak across
  its capture) and resident bytes (what its capture added to the graphs'
  memory pool).
* **Recompile sentinel** (:func:`note_compile`): compiles per plan, and a
  warning once one plan passes ``MXNET_DEVSTATS_RECOMPILE_LIMIT``.

* **Costs** (:func:`extract`, :func:`on_dispatch`): the JAX package reads
  each program's FLOPs and bytes from XLA's cost analysis. A CUDA graph
  carries none, so the trainers hand a program description counted by
  ``telemetry.costs`` from the Symbol's shapes; :func:`extract` turns it
  into the JAX function's keys. :func:`on_dispatch` is synchronous and
  memoized per shape signature (nothing compiles in the background
  here).
* **MFU** (:func:`peaks`, :func:`mfu`, :func:`roofline_frac`,
  :func:`step_sample`, :func:`fit_summary`): the active step program's
  FLOPs and bytes a step over the card's peak for the compute type
  (``_PEAKS``: the H100 SXM's data-sheet rates; the CPU row is the JAX
  package's), which the step log turns into ``mfu`` / ``roofline_frac``
  fields.

``python -m mxnet_tpu_torch.telemetry.devstats --selftest [--ctx cpu]``
holds fused fits with devstats on and off bit-identical, with the
overhead under 2%.
"""
from __future__ import annotations

import functools
import logging
import os
import threading

from .. import config
from .registry import counter as _counter

__all__ = ["HBMPreflightError", "enabled", "hbm_budget", "preflight",
           "pool_bytes", "record_program", "program_stats", "note_compile",
           "counters", "recompile_limit", "extract", "on_dispatch",
           "peaks", "mfu", "roofline_frac", "set_step_costs", "step_costs",
           "step_sample", "fit_summary", "reset"]

log = logging.getLogger("mxnet_tpu_torch.devstats")

_LOCK = threading.RLock()
_PROGRAMS = {}       # name -> stats dict (peak/resident bytes + "kind")
_COMPILES = {}       # name -> compiles observed (sentinel input)
_STORMED = set()     # programs whose storm already fired
_STORMS = [0]
_SIGS = {}           # name -> the shape signature its costs were taken at
_STEP = {"name": None, "flops": 0.0, "bytes": 0.0, "dtype": "float32"}

# Peak (FLOP/s, bytes/s) by card and compute type. The H100 SXM rows are
# NVIDIA's data-sheet dense rates (FP32 outside the tensor cores, TF32
# and BF16/FP16 tensor cores, HBM3); the cpu row is the JAX package's
# deliberately low one, a sanity signal and no hardware claim. Override
# with MXNET_DEVSTATS_PEAK_TFLOPS / MXNET_DEVSTATS_PEAK_GBPS.
_PEAKS = {
    ("H100", "float32"): (67.0e12, 3.35e12),
    ("H100", "tf32"): (495.0e12, 3.35e12),
    ("H100", "bfloat16"): (989.0e12, 3.35e12),
    ("H100", "float16"): (989.0e12, 3.35e12),
    ("cpu", None): (2.0e11, 5.0e10),
}


class HBMPreflightError(RuntimeError):
    """An estimated device-memory footprint exceeds the budget. Raised
    before anything is allocated, with sizes in the message."""


def enabled():
    """Live MXNET_DEVSTATS flag (default on; ``0`` is fully inert)."""
    return bool(config.get("MXNET_DEVSTATS"))


def recompile_limit():
    """Sentinel threshold: compiles of one plan past this warn
    (``MXNET_DEVSTATS_RECOMPILE_LIMIT``, <= 0 disables)."""
    return int(config.get("MXNET_DEVSTATS_RECOMPILE_LIMIT"))


def hbm_budget(device=None):
    """Device memory budget in bytes: ``MXNET_DEVSTATS_HBM_BYTES`` if set,
    else the card's total memory (``torch.cuda.mem_get_info``); None on
    the CPU (preflight inert)."""
    raw = os.environ.get("MXNET_DEVSTATS_HBM_BYTES")
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            pass
    import torch
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(torch.device(device))[1])


def _mib(n):
    n = float(n)
    for unit, width in (("GiB", 1024.0 ** 3), ("MiB", 1024.0 ** 2),
                        ("KiB", 1024.0)):
        if abs(n) >= width:
            return "%.1f %s" % (n / width, unit)
    return "%d B" % int(n)


def preflight(name, need_bytes, resident_bytes=0, budget=None, what="plan",
              device=None):
    """Check an estimated footprint (``need_bytes`` on top of
    ``resident_bytes`` already held) against the budget (``budget``, else
    that of ``device``). Returns headroom bytes (None when no budget is
    known); raises :class:`HBMPreflightError` when it does not fit."""
    if budget is None:
        budget = hbm_budget(device)
    if budget is None:
        return None
    total = int(need_bytes) + int(resident_bytes)
    if total > budget:
        raise HBMPreflightError(
            "HBM preflight: %s %r needs %s (estimated peak %s + %s "
            "already resident) but the device memory budget is %s — "
            "over by %s. Shrink the batch/bucket, evict cached plans, "
            "or raise MXNET_DEVSTATS_HBM_BYTES if the budget is wrong."
            % (what, name, _mib(total), _mib(need_bytes),
               _mib(resident_bytes), _mib(budget), _mib(total - budget)))
    return budget - total


# -- plan accounting ----------------------------------------------------------

def pool_bytes(pool, device):
    """Bytes of the segments a CUDA graph memory pool holds on
    ``device`` (``torch.cuda.memory_snapshot``)."""
    import torch
    pid = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg["segment_pool_id"]) == pid)


def capture_mark(pool, device):
    """(bytes allocated on ``device``, bytes of ``pool``'s segments) now.
    Taken before a CUDA graph capture into ``pool`` and passed to
    ``capture_peak`` after it: the capture's peak without resetting the
    process's peak counters (a caller's own measurement)."""
    import torch
    return torch.cuda.memory_allocated(device), pool_bytes(pool, device)


def capture_peak(pool, device, mark):
    """The peak bytes of a capture into ``pool`` since ``mark``
    (``capture_mark``): the bytes allocated before it plus the segments it
    added to the pool, which hold every block it allocated (the caching
    allocator's rounding makes this an upper bound)."""
    allocated, held = mark
    return allocated + pool_bytes(pool, device) - held


def record_program(name, stats, kind="program"):
    """Record one plan's stats (``peak_bytes``, ``resident_bytes``, the
    :func:`extract` figures) under ``name``, merged into what it already
    holds (a later write of a figure wins); returns them."""
    with _LOCK:
        _PROGRAMS[name] = dict(_PROGRAMS.get(name, {}), **stats, kind=kind)
    return stats


def program_stats(name=None):
    """Snapshot of recorded plan stats (one dict, or all)."""
    with _LOCK:
        if name is not None:
            s = _PROGRAMS.get(name)
            return dict(s) if s else None
        return {k: dict(v) for k, v in _PROGRAMS.items()}


def _rec_counter():
    return _counter("mxnet_recompiles_total",
                    "plan compiles (graph captures) noted by devstats")


def note_compile(name, n=1):
    """Count ``n`` compiles of plan ``name``; warn once when the plan's
    total crosses :func:`recompile_limit`."""
    if n <= 0:
        return
    _rec_counter().inc(n)
    limit = recompile_limit()
    storm = False
    with _LOCK:
        c = _COMPILES.get(name, 0) + n
        _COMPILES[name] = c
        if 0 < limit < c and name not in _STORMED:
            _STORMED.add(name)
            _STORMS[0] += 1
            storm = True
    if storm:
        log.warning(
            "devstats: recompile storm — plan %r compiled %d times "
            "(limit %d). Shape churn is defeating the plan cache; pad or "
            "bucket inputs. (MXNET_DEVSTATS_RECOMPILE_LIMIT)",
            name, c, limit)


# -- costs ---------------------------------------------------------------------

def extract(program):
    """Cost and memory figures of a program description as a plain dict
    with the JAX function's keys. ``program`` is what a trainer hands
    (``telemetry.costs.step_costs`` of its step, times the steps of the
    dispatch): ``flops``, ``bytes``, ``param_bytes``, ``state_bytes``,
    ``input_bytes``, ``output_bytes``, ``act_bytes`` (missing keys count
    0). The parameters and states are updated in place (the donated
    arguments: ``alias_bytes``); ``temp_bytes`` are the activations the
    backward keeps; ``peak_bytes`` is arguments + outputs + temporaries
    net of the aliasing, as the JAX function's footprint."""
    g = lambda k: float(program.get(k, 0) or 0)
    args = int(g("param_bytes") + g("state_bytes") + g("input_bytes"))
    alias = int(g("param_bytes") + g("state_bytes"))
    out = {"flops": g("flops"), "bytes_accessed": g("bytes"),
           "argument_bytes": args,
           "output_bytes": int(g("output_bytes")) + alias,
           "temp_bytes": int(g("act_bytes")),
           "generated_code_bytes": 0, "alias_bytes": alias}
    out["peak_bytes"] = max(0, out["argument_bytes"] + out["output_bytes"]
                            + out["temp_bytes"] - alias)
    return out


def on_dispatch(name, costs_fn, signature, steps=None, kind="fit",
                dtype="float32"):
    """Trainer hook, called once a dispatch before it runs: the first
    dispatch of a program at a shape ``signature`` (or after the shapes
    change) counts its costs (``costs_fn()`` -> a program description,
    see :func:`extract`), records them, publishes the per-step FLOPs and
    bytes (``steps`` steps a dispatch) and, when ``MXNET_DEVSTATS_HBM_BYTES``
    sets a budget, preflights the peak (``HBMPreflightError`` before
    anything runs). Later dispatches cost one dict compare. Never raises
    anything else."""
    try:
        if not enabled():
            return
        with _LOCK:
            fresh = _SIGS.get(name) != signature
        if fresh:
            stats = record_program(name, extract(costs_fn()), kind=kind)
            with _LOCK:
                _SIGS[name] = signature
            if steps:
                set_step_costs(name, stats["flops"] / steps,
                               stats["bytes_accessed"] / steps, dtype=dtype)
            if os.environ.get("MXNET_DEVSTATS_HBM_BYTES"):
                preflight(name, stats["peak_bytes"],
                          what="fused %s plan" % kind)
        elif steps:
            with _LOCK:
                same = _STEP["name"] == name
            if not same:
                st = program_stats(name)
                set_step_costs(name, st["flops"] / steps,
                               st["bytes_accessed"] / steps, dtype=dtype)
    except HBMPreflightError:
        raise
    except Exception:
        log.debug("devstats.on_dispatch failed for %r", name, exc_info=True)


# -- peaks and MFU -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _card_name():
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:
        pass
    return None


def peaks(dtype=None):
    """(peak FLOP/s, peak bytes/s, source) for the card and the compute
    type (``dtype``, default the active step program's, else float32).
    ``MXNET_DEVSTATS_PEAK_TFLOPS`` / ``_GBPS`` override; otherwise the
    ``_PEAKS`` table (source ``table:<card>:<dtype>``), the cpu row
    (``table:cpu``) where no known card is present."""
    if dtype is None:
        with _LOCK:
            dtype = _STEP.get("dtype") or "float32"
    card = _card_name()
    row = None
    if card is not None:
        for (key, dt), v in _PEAKS.items():
            if dt is not None and key in card and dt == str(dtype):
                row, src = v, "table:%s:%s" % (key, dt)
                break
    if row is None:
        row, src = _PEAKS[("cpu", None)], "table:cpu"
    pf, pb = row
    tf = os.environ.get("MXNET_DEVSTATS_PEAK_TFLOPS")
    gb = os.environ.get("MXNET_DEVSTATS_PEAK_GBPS")
    try:
        if tf:
            pf = float(tf) * 1e12
            src = "env"
        if gb:
            pb = float(gb) * 1e9
            src = "env"
    except ValueError:
        pass
    return pf, pb, src


def mfu(flops_per_s):
    """Model FLOPs utilization: achieved FLOP/s over the peak."""
    pf, _, _ = peaks()
    return flops_per_s / pf if pf > 0 else 0.0


def roofline_frac(flops_per_s, flops_per_step, bytes_per_step):
    """Attainment against the roofline ceiling for this program's
    arithmetic intensity: min(peak_flops, intensity * peak_bw)."""
    pf, pb, _ = peaks()
    ceiling = pf
    if bytes_per_step > 0 and flops_per_step > 0:
        ceiling = min(pf, (flops_per_step / bytes_per_step) * pb)
    return flops_per_s / ceiling if ceiling > 0 else 0.0


def set_step_costs(name, flops_per_step, bytes_per_step, dtype="float32"):
    """Publish the active training step's FLOPs and bytes a step (what
    the step log turns into MFU each step)."""
    with _LOCK:
        _STEP.update(name=name, flops=float(flops_per_step),
                     bytes=float(bytes_per_step), dtype=str(dtype))


def step_costs():
    with _LOCK:
        return {k: _STEP[k] for k in ("name", "flops", "bytes")}


def fit_summary():
    """Run-end digest for the fused fits: the step program, its costs a
    step and the peak table in force, splatted into
    ``StepLogger.close(**fit_summary())``; {} when devstats is off or no
    step program was counted."""
    if not enabled():
        return {}
    costs = step_costs()
    if not costs.get("name") or costs.get("flops", 0.0) <= 0:
        return {}
    pf, pb, src = peaks()
    return {"devstats_program": costs["name"],
            "devstats_flops_per_step": costs["flops"],
            "devstats_bytes_per_step": costs["bytes"],
            "devstats_peak_flops_per_s": pf,
            "devstats_peak_bytes_per_s": pb,
            "devstats_peak_source": src}


def step_sample(wall_s, steps):
    """Per-step MFU / roofline fields for the step log, or None when off
    or no step program was counted. Host floats only; also sets the
    ``mxnet_devstats_mfu`` / ``_roofline_frac`` gauges."""
    if not enabled():
        return None
    with _LOCK:
        f, b = _STEP["flops"], _STEP["bytes"]
    if f <= 0 or wall_s <= 0 or steps <= 0:
        return None
    fps = f * steps / wall_s
    m = mfu(fps)
    rf = roofline_frac(fps, f, b)
    from .registry import gauge as _gauge
    _gauge("mxnet_devstats_mfu",
           "achieved FLOP/s over the peak").set(m)
    _gauge("mxnet_devstats_roofline_frac",
           "achieved FLOP/s over the roofline ceiling").set(rf)
    _gauge("mxnet_devstats_model_flops_per_s",
           "achieved model FLOP/s").set(fps)
    return {"mfu": round(m, 6), "roofline_frac": round(rf, 6),
            "model_flops_per_s": fps}


def reset():
    """Test support: forget programs, compiles and step costs (the
    registry's counters are monotonic and stay)."""
    with _LOCK:
        _PROGRAMS.clear()
        _COMPILES.clear()
        _STORMED.clear()
        _STORMS[0] = 0
        _SIGS.clear()
        _STEP.update(name=None, flops=0.0, bytes=0.0, dtype="float32")


def counters():
    """Plan accounting as one dict: plan count, storms, the budget, the
    peaks in force, compiles by plan, and each recorded figure
    (``flops``, ``bytes_accessed``, ``peak_bytes``, ``resident_bytes``,
    ...) by plan."""
    pf, pb, _ = peaks()
    with _LOCK:
        progs = {k: dict(v) for k, v in _PROGRAMS.items()}
        compiles = dict(_COMPILES)
        storms = _STORMS[0]
    out = {"programs": len(progs), "recompile_storms": storms,
           "hbm_budget_bytes": hbm_budget() or 0,
           "peak_flops_per_s": pf, "peak_bytes_per_s": pb,
           "recompiles": compiles}
    for stat in ("flops", "bytes_accessed", "peak_bytes", "resident_bytes",
                 "argument_bytes", "output_bytes", "temp_bytes",
                 "generated_code_bytes"):
        series = {n: s[stat] for n, s in progs.items() if stat in s}
        if series:
            out[stat] = series
    return out


def _ensure_hook():
    from .. import profiler
    profiler.register_counter_export("devstats", counters)


_ensure_hook()


# -- selftest -------------------------------------------------------------------

def _fit_arm(ctx, params0, data):
    """One fused fit from ``params0``; the final parameters (host)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.trainer import fused_fit
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(64, activation="relu", in_units=32))
    net.add(gluon.nn.Dense(8, in_units=64))
    net.initialize(mx.init.Zero(), ctx=ctx)
    for (n, p), v in zip(net.collect_params().items(), params0):
        p.set_data(mx.nd.array(v, ctx=ctx))
    fused_fit(net, gluon.loss.SoftmaxCrossEntropyLoss(), data,
              num_epoch=1, optimizer="adam",
              optimizer_params={"learning_rate": 1e-3},
              steps_per_dispatch=4, contexts=[ctx])
    return [np.asarray(p.data().asnumpy()).copy()
            for p in net.collect_params().values()]


def _selftest(ctx_name="gpu", max_overhead_pct=2.0):
    """Fused fits with devstats on and off: bit-identical parameters,
    the on arm's per-step costs published, and the overhead (min of 4
    fits an arm, 3 attempts) under ``max_overhead_pct``. One
    ``devstats_selftest`` JSON line."""
    import json
    import time
    import numpy as np
    import mxnet_tpu_torch as mx
    ctx = mx.cpu() if ctx_name == "cpu" else mx.gpu(0)
    rng = np.random.RandomState(7)
    shapes = [(64, 32), (64,), (8, 64), (8,)]
    params0 = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    x = rng.normal(size=(512, 32)).astype(np.float32)
    y = rng.randint(0, 8, size=(512,)).astype(np.float32)
    data = [(mx.nd.array(x[i:i + 32], ctx=mx.cpu()),
             mx.nd.array(y[i:i + 32], ctx=mx.cpu()))
            for i in range(0, 512, 32)]
    res = {"metric": "devstats_selftest", "ctx": ctx_name}
    reset()
    on = _fit_arm(ctx, params0, data)
    costs = step_costs()
    res["step_flops"] = costs["flops"]
    res["costs_published"] = bool(costs["flops"] > 0)
    overhead = None
    for _ in range(3):
        t_on, t_off = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            on = _fit_arm(ctx, params0, data)
            t_on.append(time.perf_counter() - t0)
            os.environ["MXNET_DEVSTATS"] = "0"
            try:
                t0 = time.perf_counter()
                off = _fit_arm(ctx, params0, data)
                t_off.append(time.perf_counter() - t0)
            finally:
                os.environ.pop("MXNET_DEVSTATS", None)
        overhead = 100.0 * (min(t_on) - min(t_off)) / min(t_off)
        if overhead <= max_overhead_pct:
            break
    res["overhead_pct"] = overhead
    res["overhead_ok"] = bool(overhead <= max_overhead_pct)
    res["bit_identical"] = bool(all(np.array_equal(a, b)
                                    for a, b in zip(on, off)))
    res["ok"] = bool(res["costs_published"] and res["overhead_ok"]
                     and res["bit_identical"])
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.telemetry.devstats")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--max-overhead-pct", type=float, default=2.0)
    ns = ap.parse_args(argv)
    if not ns.selftest:
        ap.print_help()
        return 0
    from mxnet_tpu_torch.telemetry import devstats as canonical
    return canonical._selftest(ns.ctx, ns.max_overhead_pct)


if __name__ == "__main__":
    raise SystemExit(main())
