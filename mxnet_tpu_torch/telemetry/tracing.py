"""Span tracing: where does a step's wall-clock time go (counterpart of
mxnet_tpu/telemetry/tracing.py)?

Host-side spans (context manager / decorator) threaded through the step
phases the framework owns: DeviceFeed staging (``pipeline.py``), fused
and per-batch dispatch (``module/``, ``gluon/trainer.py``), checkpoint
stage / commit / seal, and the serving request lifecycle (queue ->
compute). Three sinks a span close:

  - the shared profiler chrome-event ring (``profiler.EventRing``) as a
    complete ("X") event with cat ``trace:<phase>``, pid = rank, tid =
    thread, so ``trace-rank-K.json`` shards load in perfetto as they are;
  - per-phase registry histograms (``mxnet_trace_<phase>_seconds``) and
    the phase totals StepLogger samples for its per-step feed / compute
    / comm / ckpt breakdown and overlap fractions;
  - the flight recorder ring (``flightrec.py``).

Discipline: monotonic clocks only (``time.perf_counter``), per-thread
span stacks, and ``MXNET_TRACE=0`` (the default, with
``MXNET_FLIGHTREC=0``) returns the shared no-op before any clock is
read. A span never calls into CUDA (no synchronize, no ``.item()``, no
host copy): it times what the host does, and the card runs on behind it.
Never open a span inside a CUDA-graph capture: host code there runs once,
at capture, not at each replay.

Clocks: each process's ``perf_counter`` has its own epoch, so a shard
records its wall <-> perf offset; ``merge()`` (also ``python -m
mxnet_tpu_torch.telemetry.tracing --merge``) aligns shards into rank 0's
timebase, re-pids events by rank, and emits one merged chrome trace plus
a critical-path summary (slowest rank per phase per step, the rank that
went quiet first). The port trains in one process, so
``exchange_clock`` measures nothing: the skew is 0.
"""
from __future__ import annotations

import functools
import json
import os
import re
import threading
import time

from . import flightrec
from .. import profiler

__all__ = ["enabled", "active", "span", "traced", "event", "set_step",
           "current_stack", "phase_totals", "reset_phase_totals",
           "dump", "shard_path", "merge", "format_summary",
           "arm_autodump", "disarm_autodump", "exchange_clock",
           "clock_info", "synth_shards", "main"]

# _step_ctx / _clock / _autodump are written with GIL-atomic dict stores
# from one control thread; span readers tolerate one stale value.
# _phase_us / _phase_n are held to _phase_lock; _tls is per thread.
_tls = threading.local()

_phase_lock = threading.Lock()
_phase_us = {}                 # phase -> accumulated span µs
_phase_n = {}                  # phase -> span count
_histograms = {}               # phase -> registry Histogram (get-or-create)

_step_ctx = {"trace_id": None, "step": None}
_clock = {"skew_us": 0.0, "exchanged": False}
_autodump = {"armed": False, "path": None, "stop": None}

# span durations: µs-scale queue hops through multi-second ckpt commits
SPAN_BUCKETS = (0.00001, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
                0.1, 0.5, 1.0, 5.0, 30.0)


def enabled():
    """MXNET_TRACE master gate (default OFF). One env-dict lookup so the
    off-path cost at every span site is nanoseconds."""
    return os.environ.get("MXNET_TRACE", "0") not in ("0", "", "false")


def active():
    """Spans are timed when either sink wants them: the trace stream
    (MXNET_TRACE) or the always-on flight recorder (MXNET_FLIGHTREC)."""
    return enabled() or flightrec.enabled()


def _rank():
    try:
        return int(os.environ.get("DMLC_WORKER_ID", "0") or 0)
    except ValueError:
        return 0


def _phase_hist(phase):
    h = _histograms.get(phase)
    if h is None:
        from .registry import histogram
        # double-checked under _phase_lock: spans close on arbitrary
        # threads, and two racing creators would register twice
        with _phase_lock:
            h = _histograms.get(phase)
            if h is None:
                h = histogram(
                    f"mxnet_trace_{phase}_seconds",
                    help=f"traced span durations in the {phase} phase",
                    buckets=SPAN_BUCKETS)
                _histograms[phase] = h
    return h


def _emit(name, phase, t0_perf, dur_us, args, error=None):
    """Common span-close path for _Span.__exit__ and event()."""
    if enabled():
        ev_args = dict(args) if args else {}
        if _step_ctx["trace_id"] is not None:
            ev_args.setdefault("trace_id", _step_ctx["trace_id"])
            ev_args.setdefault("step", _step_ctx["step"])
        if error is not None:
            ev_args["error"] = error
        profiler._record_event(name, f"trace:{phase or 'span'}",
                               t0_perf * 1e6, dur_us, pid=_rank(),
                               args=ev_args or None)
        if phase:
            with _phase_lock:
                _phase_us[phase] = _phase_us.get(phase, 0.0) + dur_us
                _phase_n[phase] = _phase_n.get(phase, 0) + 1
            try:
                _phase_hist(phase).observe(dur_us / 1e6)
            except Exception:            # pragma: no cover
                pass
    if flightrec.enabled():
        flightrec.record("span", name, dur_us=dur_us,
                         **({"err": error} if error else {}),
                         **(args or {}))


class _Span:
    __slots__ = ("name", "phase", "args", "_t0")

    def __init__(self, name, phase, args):
        self.name = name
        self.phase = phase
        self.args = args

    def __enter__(self):
        st = getattr(_tls, "stack", None)
        if st is None:
            st = _tls.stack = []
        st.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur_us = (time.perf_counter() - self._t0) * 1e6
        _tls.stack.pop()
        _emit(self.name, self.phase, self._t0, dur_us, self.args,
              error=exc_type.__name__ if exc_type is not None else None)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name, phase=None, **args):
    """`with span("feed.wait", phase="feed", feed=name): ...` — times the
    block on this thread's span stack. Phases ("feed", "compute", "comm",
    "ckpt", "serve", ...) drive the per-phase histograms and StepLogger's
    step breakdown; omit for one-off spans."""
    if not active():
        return _NULL
    return _Span(name, phase, args or None)


def traced(name=None, phase=None):
    """Decorator form of span()."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(label, phase=phase):
                return fn(*a, **kw)
        return wrapper
    return deco


def event(name, t0_perf, t1_perf=None, phase=None, **args):
    """Record a retrospective span from timestamps the caller already
    holds (serving's queue time: t_submit was captured at submit, the
    span is known only at dequeue)."""
    if not active():
        return
    t1 = t1_perf if t1_perf is not None else time.perf_counter()
    _emit(name, phase, t0_perf, max(0.0, (t1 - t0_perf) * 1e6), args or None)


def current_stack():
    """This thread's open span names, outermost first (tests)."""
    return tuple(getattr(_tls, "stack", ()) or ())


def set_step(trace_id, step):
    """StepLogger publishes its run trace id + step counter here; spans
    closing afterwards carry {trace_id, step} args, correlating JSONL
    step rows with timeline spans."""
    _step_ctx["trace_id"] = trace_id
    _step_ctx["step"] = step


def phase_totals():
    """Accumulated span µs per phase since process start (StepLogger
    diffs consecutive snapshots for its per-step breakdown)."""
    with _phase_lock:
        return dict(_phase_us)


def phase_counts():
    with _phase_lock:
        return dict(_phase_n)


def reset_phase_totals():
    with _phase_lock:
        _phase_us.clear()
        _phase_n.clear()


# -- cross-rank clock exchange ----------------------------------------------

def exchange_clock(client=None, timeout_ms=5000):
    """The cross-rank wall-clock skew against rank 0. The port runs one
    process: rank 0's skew is 0, and exchanging with other processes
    needs the process group of ``dist.py``, not ported (ROADMAP queue 1
    item 16), so a client raises."""
    if client is not None or _rank() != 0 or \
            int(os.environ.get("DMLC_NUM_WORKER", "1") or 1) > 1:
        raise NotImplementedError(
            "exchange_clock across processes needs dist.py's process "
            "group, not ported yet (ROADMAP queue 1 item 16)")
    _clock["exchanged"] = True
    _clock["skew_us"] = 0.0
    return 0.0


def clock_info():
    return {"skew_us": _clock["skew_us"],
            "exchanged": _clock["exchanged"],
            "offset_us": (time.time() - time.perf_counter()) * 1e6}


# -- per-rank shard dump ----------------------------------------------------

def shard_path(directory=None):
    from .. import config
    d = directory or config.get("MXNET_TRACE_DIR") or "."
    return os.path.join(str(d), f"trace-rank-{_rank()}.json")


def dump(path=None, clear=False):
    """Write this rank's trace shard: the buffered chrome events plus
    the clock metadata merge() needs. Atomic tmp+rename so the periodic
    flusher never leaves a torn file. Returns the path (None when
    tracing is off)."""
    if not enabled():
        return None
    path = path or shard_path()
    r = _rank()
    meta = {"version": 1, "rank": r, "pid": os.getpid(),
            "wall_time": time.time(),
            "clock_offset_us": (time.time() - time.perf_counter()) * 1e6,
            "clock_skew_us": _clock["skew_us"],
            "clock_exchanged": _clock["exchanged"],
            "dropped_events": profiler.dropped_events(),
            "phase_totals_us": phase_totals()}
    trace = {"traceEvents":
             [{"name": "process_name", "ph": "M", "pid": r,
               "args": {"name": f"rank {r}"}},
              {"name": "process_sort_index", "ph": "M", "pid": r,
               "args": {"sort_index": r}}] + profiler.events_snapshot(),
             "displayTimeUnit": "ms", "metadata": meta}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    if clear:
        profiler.clear_events()
    return path


def _atexit_dump():
    if _autodump["armed"]:
        try:
            dump(path=_autodump["path"])
        except Exception:                # pragma: no cover
            pass


def arm_autodump(directory=None, flush_s=None):
    """Arm the shard writer: an atexit dump, plus a flusher daemon when
    MXNET_TRACE_FLUSH_S > 0 so a SIGKILL'd rank still leaves a shard at
    most one interval stale. config._apply_startup arms this whenever
    MXNET_TRACE is on. Idempotent."""
    if not enabled() or _autodump["armed"]:
        return _autodump["armed"]
    import atexit
    _autodump["path"] = shard_path(directory)
    _autodump["armed"] = True
    atexit.register(_atexit_dump)
    if flush_s is None:
        from .. import config
        try:
            flush_s = float(config.get("MXNET_TRACE_FLUSH_S", "0") or 0)
        except (TypeError, ValueError):
            flush_s = 0.0
    if flush_s and flush_s > 0:
        stop = threading.Event()
        _autodump["stop"] = stop

        def _loop():
            # first dump immediately: a rank killed inside its first
            # flush interval must still leave a shard on disk
            while True:
                try:
                    dump(path=_autodump["path"])
                except Exception:        # pragma: no cover
                    pass
                if stop.wait(flush_s):
                    return

        threading.Thread(target=_loop, name="trace-flusher",
                         daemon=True).start()
    return True


def disarm_autodump():
    _autodump["armed"] = False
    if _autodump["stop"] is not None:
        _autodump["stop"].set()
        _autodump["stop"] = None
    _autodump["path"] = None


# -- shard merge ------------------------------------------------------------

def _shard_paths(shards):
    import glob
    if isinstance(shards, (str, os.PathLike)):
        s = str(shards)
        if os.path.isdir(s):
            return sorted(glob.glob(os.path.join(s, "trace-rank-*.json")))
        return [s]
    return [str(p) for p in shards]


def _rank_from_path(path):
    """Best-effort rank recovery for a shard whose JSON is unreadable —
    the trace-rank-K.json naming convention is the only intact bit."""
    m = re.search(r"trace-rank-(\d+)\.json$", os.path.basename(str(path)))
    return int(m.group(1)) if m else None


def merge(shards, out_path=None):
    """Align per-rank shards into one perfetto-loadable timeline.

    `shards` is a directory (globbed for trace-rank-*.json) or a list of
    paths. Every event timestamp is mapped into rank 0's wall timebase
    (ts + clock_offset_us - clock_skew_us), then normalized so the
    earliest event is t=0; every event is re-pid'd to its rank. Returns
    (out_path, summary) where summary carries the critical path: the
    slowest rank per (step, phase), per-phase totals per rank, and the
    rank that went quiet first.

    Degrades gracefully when a gang died mid-run: a shard that is
    missing from the set, unreadable, or torn (truncated JSON from a
    killed rank) is skipped, the survivors are merged, and the summary
    records the damage — `torn_shards` (per-path parse errors, rank
    recovered from the filename) and `missing_ranks` (gaps in the
    0..max contiguous rank range). Raises FileNotFoundError only when
    not a single shard is readable."""
    paths = _shard_paths(shards)
    if not paths:
        raise FileNotFoundError(f"no trace shards found in {shards!r}")
    merged, per_rank, torn = [], {}, []
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as f:
                shard = json.load(f)
        except (OSError, ValueError) as e:
            torn.append({"path": p, "rank": _rank_from_path(p),
                         "error": f"{type(e).__name__}: {e}"})
            continue
        meta = shard.get("metadata", {})
        r = int(meta.get("rank", 0))
        adj = float(meta.get("clock_offset_us", 0.0)) \
            - float(meta.get("clock_skew_us", 0.0))
        last_ts, n = None, 0
        for ev in shard.get("traceEvents", []):
            if ev.get("ph") == "M":
                continue                 # metadata lanes re-added below
            ev = dict(ev)
            ev["pid"] = r
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + adj
                end = ev["ts"] + float(ev.get("dur", 0.0))
                last_ts = end if last_ts is None else max(last_ts, end)
            merged.append(ev)
            n += 1
        per_rank[r] = {"path": p, "events": n, "last_ts_us": last_ts,
                       "dropped_events": int(meta.get("dropped_events", 0)),
                       "clock_skew_us": float(meta.get("clock_skew_us", 0.0)),
                       "clock_exchanged":
                           bool(meta.get("clock_exchanged", False)),
                       "phase_totals_us": meta.get("phase_totals_us", {})}
    if not per_rank:
        raise FileNotFoundError(
            f"no readable trace shards in {shards!r} "
            f"({len(torn)} unreadable/torn)")
    t0 = min((ev["ts"] for ev in merged if "ts" in ev), default=0.0)
    for ev in merged:
        if "ts" in ev:
            ev["ts"] -= t0
    merged.sort(key=lambda e: e.get("ts", 0.0))
    header = []
    for r in sorted(per_rank):
        header.append({"name": "process_name", "ph": "M", "pid": r,
                       "args": {"name": f"rank {r}"}})
        header.append({"name": "process_sort_index", "ph": "M", "pid": r,
                       "args": {"sort_index": r}})
    summary = _summarize(merged, per_rank, t0)
    # damage report: ranks whose shard was torn, plus gaps in the
    # contiguous 0..max rank range with no shard at all
    known = set(per_rank) | {t["rank"] for t in torn
                             if t["rank"] is not None}
    missing = sorted(r for r in range(max(known) + 1 if known else 0)
                     if r not in per_rank
                     and all(t["rank"] != r for t in torn))
    summary["torn_shards"] = torn
    summary["missing_ranks"] = missing
    out = {"traceEvents": header + merged, "displayTimeUnit": "ms",
           "metadata": {"merged_from": len(per_rank), "t0_wall_us": t0,
                        "ranks": sorted(per_rank)},
           "summary": summary}
    if out_path is None:
        base = paths[0]
        out_path = os.path.join(os.path.dirname(base) or ".",
                                "trace-merged.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f)
    return out_path, summary


def _summarize(merged, per_rank, t0):
    # slowest rank per (step, phase) over trace spans
    worst = {}                           # (step, phase) -> event
    for ev in merged:
        cat = ev.get("cat", "")
        if ev.get("ph") != "X" or not cat.startswith("trace:"):
            continue
        phase = cat[len("trace:"):]
        step = (ev.get("args") or {}).get("step")
        key = (step, phase)
        cur = worst.get(key)
        if cur is None or ev.get("dur", 0.0) > cur.get("dur", 0.0):
            worst[key] = ev
    critical = sorted(
        ({"step": k[0], "phase": k[1], "rank": ev["pid"],
          "name": ev["name"], "dur_us": round(float(ev.get("dur", 0.0)), 1)}
         for k, ev in worst.items()),
        key=lambda w: -w["dur_us"])[:20]
    slowest_per_phase = {}
    for r, info in per_rank.items():
        for phase, us in (info.get("phase_totals_us") or {}).items():
            cur = slowest_per_phase.get(phase)
            if cur is None or us > cur["total_us"]:
                slowest_per_phase[phase] = \
                    {"rank": r, "total_us": round(float(us), 1)}
    quiet = None
    lasts = {r: i["last_ts_us"] for r, i in per_rank.items()
             if i["last_ts_us"] is not None}
    if len(lasts) > 1:
        qr = min(lasts, key=lambda r: lasts[r])
        newest = max(lasts.values())
        quiet = {"rank": qr,
                 "last_event_us": round(lasts[qr] - t0, 1),
                 "quiet_for_us": round(newest - lasts[qr], 1)}
    return {"ranks": sorted(per_rank),
            "events": sum(i["events"] for i in per_rank.values()),
            "dropped_events":
                sum(i["dropped_events"] for i in per_rank.values()),
            "critical_path": critical,
            "slowest_rank_per_phase": slowest_per_phase,
            "quiet_first": quiet}


def format_summary(summary):
    lines = [f"merged {summary['events']} events from ranks "
             f"{summary['ranks']} "
             f"({summary['dropped_events']} dropped at source)"]
    missing = summary.get("missing_ranks")
    if missing:
        lines.append(f"MISSING: no shard for ranks {missing} — merged "
                     f"the survivors")
    for t in summary.get("torn_shards") or []:
        who = f"rank {t['rank']}" if t.get("rank") is not None \
            else os.path.basename(t["path"])
        lines.append(f"TORN: {who} shard unreadable ({t['error']}) — "
                     f"skipped")
    q = summary.get("quiet_first")
    if q:
        lines.append(f"quiet first: rank {q['rank']} — last event at "
                     f"t+{q['last_event_us'] / 1e6:.3f}s, silent for "
                     f"{q['quiet_for_us'] / 1e6:.3f}s before the newest "
                     f"event")
    for phase, w in sorted(summary["slowest_rank_per_phase"].items()):
        lines.append(f"slowest in {phase:>8}: rank {w['rank']} "
                     f"({w['total_us'] / 1e3:.1f}ms total)")
    for w in summary["critical_path"][:8]:
        step = f"step {w['step']}" if w["step"] is not None else "no-step"
        lines.append(f"critical: {step:>10} {w['phase']:>8} rank "
                     f"{w['rank']} {w['name']} {w['dur_us'] / 1e3:.2f}ms")
    return "\n".join(lines)


def synth_shards(directory, ranks=8, steps=5, base_wall=None,
                 quiet_rank=None, quiet_after_step=None, slow_rank=None):
    """Generate a synthetic shard set with per-rank clock offsets/skews
    (selftest + bench's merge-latency probe). Ground truth: rank
    `slow_rank` has 3x compute spans; rank `quiet_rank` stops emitting
    after `quiet_after_step`."""
    os.makedirs(directory, exist_ok=True)
    base = base_wall if base_wall is not None else time.time()
    paths = []
    for r in range(ranks):
        off_us = 1e6 * (100.0 + 17.0 * r)      # distinct perf epochs
        skew_us = 1000.0 * r                   # 1ms/rank wall skew
        evs, totals = [], {}
        for s in range(steps):
            if quiet_rank == r and quiet_after_step is not None \
                    and s > quiet_after_step:
                break
            t_step = (base + 0.050 * s) * 1e6  # true wall µs
            for phase, off, dur in (("feed", 0.0, 2000.0),
                                    ("compute", 2000.0,
                                     30000.0 if slow_rank == r
                                     else 10000.0),
                                    ("comm", 12000.0, 5000.0)):
                evs.append({"name": f"{phase}.step", "cat": f"trace:{phase}",
                            "ph": "X",
                            "ts": t_step + off - off_us + skew_us,
                            "dur": dur, "pid": r, "tid": 1,
                            "args": {"step": s, "trace_id": "synth"}})
                totals[phase] = totals.get(phase, 0.0) + dur
        shard = {"traceEvents": evs, "displayTimeUnit": "ms",
                 "metadata": {"version": 1, "rank": r, "pid": 1000 + r,
                              "wall_time": base,
                              "clock_offset_us": off_us,
                              "clock_skew_us": skew_us,
                              "clock_exchanged": True,
                              "dropped_events": 0,
                              "phase_totals_us": totals}}
        p = os.path.join(directory, f"trace-rank-{r}.json")
        with open(p, "w", encoding="utf-8") as f:
            json.dump(shard, f)
        paths.append(p)
    return paths


# -- selftest / CLI ---------------------------------------------------------

def _check(ok, what, failures):
    print(f"{'ok' if ok else 'FAIL'}: {what}")
    if not ok:
        failures.append(what)
    return ok


def _selftest():
    """Proof of the tracing + flight-recorder plumbing on the host. Exercises: ring bound + drop accounting, span nesting
    and thread separation, off -> zero events, shard dump/merge clock
    alignment + victim naming, flight-recorder dump + tail."""
    import tempfile
    failures = []
    saved = {k: os.environ.get(k) for k in
             ("MXNET_TRACE", "MXNET_FLIGHTREC", "MXNET_TRACE_DIR")}
    t_start = time.perf_counter()
    try:
        os.environ["MXNET_TRACE"] = "1"
        os.environ["MXNET_FLIGHTREC"] = "1"
        profiler.clear_events()
        flightrec.reset()
        reset_phase_totals()

        # 1. nesting + per-thread stacks
        seen = {}

        def worker():
            with span("outer.t2", phase="compute"):
                seen["t2_stack"] = current_stack()

        with span("outer", phase="compute", k=1):
            with span("inner", phase="feed"):
                seen["stack"] = current_stack()
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        evs = [e for e in profiler.events_snapshot()
               if e.get("cat", "").startswith("trace:")]
        byname = {e["name"]: e for e in evs}
        _check(seen.get("stack") == ("outer", "inner"),
               "span stack tracks nesting", failures)
        _check(seen.get("t2_stack") == ("outer.t2",),
               "span stacks are per-thread", failures)
        _check(set(byname) == {"outer", "inner", "outer.t2"},
               "all spans recorded", failures)
        inner, outer = byname.get("inner"), byname.get("outer")
        _check(inner and outer
               and outer["ts"] <= inner["ts"]
               and inner["ts"] + inner["dur"]
               <= outer["ts"] + outer["dur"] + 1.0,
               "child span nested within parent interval", failures)
        _check(byname["outer.t2"]["tid"] != outer["tid"],
               "threads get distinct tids", failures)
        totals = phase_totals()
        _check(totals.get("compute", 0) > 0 and totals.get("feed", 0) > 0,
               "phase totals accumulate", failures)

        # 2. off -> zero trace events
        os.environ["MXNET_TRACE"] = "0"
        profiler.clear_events()
        with span("ghost", phase="compute"):
            pass
        n_after = len([e for e in profiler.events_snapshot()
                       if e.get("cat", "").startswith("trace:")])
        _check(n_after == 0, "MXNET_TRACE=0 records zero trace events",
               failures)
        os.environ["MXNET_TRACE"] = "1"

        # 3. ring bound + drop accounting
        profiler.set_max_events(32)
        profiler.clear_events()
        for i in range(100):
            with span(f"burst{i}", phase="compute"):
                pass
        snap = profiler.events_snapshot()
        _check(len(snap) == 32, "ring bounded at capacity", failures)
        _check(profiler.dropped_events() == 68,
               "dropped-events counter exact", failures)
        profiler.set_max_events(200000)
        profiler.clear_events()

        # 4. shard dump + 8-rank synthetic merge
        with tempfile.TemporaryDirectory() as td:
            with span("real.step", phase="compute"):
                time.sleep(0.001)
            p = dump(path=os.path.join(td, "trace-rank-0.json"))
            with open(p) as f:
                shard = json.load(f)
            _check(isinstance(shard["traceEvents"], list)
                   and "clock_offset_us" in shard["metadata"],
                   "shard dump carries events + clock metadata", failures)
            synth = os.path.join(td, "synth")
            synth_shards(synth, ranks=8, steps=5, quiet_rank=3,
                         quiet_after_step=1, slow_rank=5)
            out, summary = merge(synth)
            with open(out) as f:
                m = json.load(f)
            _check(isinstance(m["traceEvents"], list)
                   and all("ts" not in e or e["ts"] >= 0
                           for e in m["traceEvents"]),
                   "merged trace is valid chrome JSON, ts normalized",
                   failures)
            _check(sorted({e["pid"] for e in m["traceEvents"]})
                   == list(range(8)), "merged trace re-pids by rank",
                   failures)
            xs = [e for e in m["traceEvents"] if e.get("ph") == "X"]
            step0 = [e for e in xs if (e.get("args") or {}).get("step") == 0
                     and e["cat"] == "trace:feed"]
            spread = max(e["ts"] for e in step0) - min(e["ts"]
                                                      for e in step0)
            _check(spread < 1.0,
                   "clock offsets+skew aligned (same-step spread < 1µs)",
                   failures)
            _check(summary["quiet_first"]
                   and summary["quiet_first"]["rank"] == 3,
                   "merge names the quiet rank", failures)
            _check(summary["slowest_rank_per_phase"]
                   .get("compute", {}).get("rank") == 5,
                   "merge names the slowest rank per phase", failures)
            _check(any(w["rank"] == 5 and w["phase"] == "compute"
                       for w in summary["critical_path"]),
                   "critical path attributes slow steps", failures)

            # 5. flight recorder: record, dump, tail
            flightrec.reset()
            for i in range(10):
                flightrec.record("event", f"beat{i}", step=i)
            fp = flightrec.dump(path=os.path.join(td, "fr.json"),
                                reason="selftest")
            with open(fp) as f:
                box = json.load(f)
            _check(box["reason"] == "selftest" and len(box["events"]) == 10
                   and "last_event_t" in box,
                   "flight recorder dump valid", failures)
            _check("beat9" in flightrec.tail_text(),
                   "flight tail names recent events", failures)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        profiler.clear_events()
        flightrec.reset()
        reset_phase_totals()
    elapsed = time.perf_counter() - t_start
    print(json.dumps({"selftest": "tracing", "checks_failed": len(failures),
                      "elapsed_s": round(elapsed, 3)}))
    if failures:
        print("TRACING-SELFTEST-FAIL")
        return 1
    print("TRACING-SELFTEST-OK")
    return 0


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.telemetry.tracing",
        description="merge per-rank trace shards / run the tracing "
                    "selftest")
    p.add_argument("--merge", nargs="*", metavar="DIR_OR_SHARD",
                   default=None,
                   help="directory holding trace-rank-*.json (or an "
                        "explicit shard list); default: current dir")
    p.add_argument("--out", default=None,
                   help="merged timeline output path "
                        "(default: <dir>/trace-merged.json)")
    p.add_argument("--selftest", action="store_true")
    args = p.parse_args(argv)
    if args.selftest:
        return _selftest()
    if args.merge is not None:
        target = args.merge if len(args.merge) > 1 else \
            (args.merge[0] if args.merge else ".")
        out, summary = merge(target, out_path=args.out)
        print(format_summary(summary))
        print(f"merged timeline -> {out}")
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":              # pragma: no cover
    import sys
    sys.exit(main())
