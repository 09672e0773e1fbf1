"""Profiler: chrome://tracing JSON emitter + aggregate op stats
(counterpart of mxnet_tpu/profiler.py; the reference's
python/mxnet/profiler.py ``set_config`` / ``set_state`` / ``dump`` /
``dumps`` / pause / resume / Domain / Task / Counter / Marker).

Two lanes:

  - The host-side op timeline here: while profiling runs, each imperative
    op (``imperative.invoke``) and each executor forward / backward is
    timed by ``profile_op``, which waits for the op's outputs on the card
    (a CUDA event recorded after the op, then synchronized) and emits a
    chrome-trace complete event. Like the reference's profiling runs,
    this serializes the ops it times.
  - The kernel lane: ``set_config(xplane_dir=<dir>)`` (the JAX package's
    name for its XPlane directory) starts a ``torch.profiler`` session on
    ``set_state('run')`` recording CPU and CUDA activities, and writes
    its chrome trace to ``<dir>/torch-trace-<pid>.json`` on
    ``set_state('stop')``. Every kernel that ran in between, the
    hand-written ones included, appears by name on the device timeline;
    ``kernel_profile()`` hands back the finished session
    (``key_averages()``, ``events()``).

Counter exports: subsystems register ``fn() -> dict`` with
``register_counter_export``; ``export_counters()`` merges them, ``dump()``
embeds them in the trace file, and the telemetry registry renders them
on ``/metrics``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = ["set_config", "set_state", "pause", "resume", "dump", "dumps",
           "profiler_set_config", "profiler_set_state", "Domain", "Task",
           "Counter", "Marker", "Frame", "register_counter_export",
           "unregister_counter_export", "export_counters",
           "export_counter", "EventRing", "events_snapshot", "clear_events",
           "dropped_events", "set_max_events", "kernel_profile"]

_lock = threading.Lock()
_state = "stop"
_paused = False


class EventRing:
    """Bounded chrome-event buffer with drop accounting, shared by the op
    lane and ``telemetry.tracing``'s spans: it keeps the newest
    ``capacity`` events and counts what it evicted. Callers hold the
    module ``_lock``."""

    def __init__(self, capacity):
        self._cap = max(1, int(capacity))
        self._dq = deque(maxlen=self._cap)
        self.dropped = 0          # evicted since last clear()
        self.total = 0            # appended since last clear()

    @property
    def capacity(self):
        return self._cap

    def append(self, ev):
        if len(self._dq) >= self._cap:
            self.dropped += 1
        self.total += 1
        self._dq.append(ev)

    def __len__(self):
        return len(self._dq)

    def snapshot(self):
        return list(self._dq)

    def clear(self):
        self._dq.clear()
        self.dropped = 0
        self.total = 0

    def set_capacity(self, capacity):
        self._cap = max(1, int(capacity))
        self._dq = deque(self._dq, maxlen=self._cap)


def _ring_capacity():
    try:
        return int(os.environ.get("MXNET_TRACE_MAX_EVENTS", "200000"))
    except ValueError:
        return 200000


_events = EventRing(_ring_capacity())
_agg = {}               # name -> [count, total_us, min_us, max_us]
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": False,
    "continuous_dump": False,
    "xplane_dir": None,
}
_kernel = {"session": None, "done": None, "path": None}


def set_config(**kwargs):
    """mx.profiler.set_config (python/mxnet/profiler.py:28)."""
    unknown = [k for k in kwargs if k not in _config]
    if unknown:
        raise ValueError(f"profiler.set_config: unknown options {unknown}")
    _config.update(kwargs)


profiler_set_config = set_config


def is_running():
    return _state == "run" and not _paused


def imperative_enabled():
    """Gate of the per-imperative-op lane (profile_imperative)."""
    return is_running() and (_config["profile_all"] or
                             _config["profile_imperative"])


def symbolic_enabled():
    """Gate of the executor Forward / Backward spans (profile_symbolic)."""
    return is_running() and (_config["profile_all"] or
                             _config["profile_symbolic"])


def _start_kernel_lane(directory):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    session = torch.profiler.profile(activities=acts)
    session.__enter__()
    _kernel.update(session=session, done=None,
                   path=os.path.join(str(directory),
                                     f"torch-trace-{os.getpid()}.json"))


def _stop_kernel_lane():
    session, _kernel["session"] = _kernel["session"], None
    session.__exit__(None, None, None)
    os.makedirs(os.path.dirname(_kernel["path"]), exist_ok=True)
    session.export_chrome_trace(_kernel["path"])
    _kernel["done"] = session


def kernel_profile():
    """The last finished ``torch.profiler`` session of the kernel lane
    (None before one stopped) and the chrome trace it wrote:
    ``(session, path)``."""
    return _kernel["done"], _kernel["path"]


def set_state(state="stop", profile_process="worker"):
    """mx.profiler.set_state: 'run' | 'stop' (profiler.py:105)."""
    global _state
    if state not in ("run", "stop"):
        raise ValueError("profiler state must be 'run' or 'stop'")
    prev = _state
    _state = state
    if state == "run" and prev != "run" and _config["xplane_dir"]:
        _start_kernel_lane(_config["xplane_dir"])
    if state == "stop" and _kernel["session"] is not None:
        _stop_kernel_lane()
    if state == "stop" and prev == "run" and _config["continuous_dump"]:
        dump()


profiler_set_state = set_state


def pause(profile_process="worker"):
    global _paused
    _paused = True


def resume(profile_process="worker"):
    global _paused
    _paused = False


def _record_event(name, cat, ts_us, dur_us, pid=0, tid=None, args=None):
    ev = {"name": name, "cat": cat, "ph": "X", "ts": ts_us, "dur": dur_us,
          "pid": pid, "tid": tid if tid is not None else
          threading.get_ident() % 10000}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)
        st = _agg.get(name)
        if st is None:
            _agg[name] = [1, dur_us, dur_us, dur_us]
        else:
            st[0] += 1
            st[1] += dur_us
            st[2] = min(st[2], dur_us)
            st[3] = max(st[3], dur_us)


def _device_bytes():
    """Bytes the caching allocator holds for live tensors on the current
    card (0 without one: nothing lives on a device)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


def _record_memory_counter():
    live = _device_bytes()
    with _lock:
        _events.append({"name": "live_device_bytes", "ph": "C",
                        "ts": time.perf_counter() * 1e6, "pid": 0,
                        "args": {"bytes": live}})


def _cuda_devices(out, found):
    import torch
    if isinstance(out, (list, tuple)):
        for o in out:
            _cuda_devices(o, found)
        return found
    t = getattr(out, "_data", out)
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        found.add(t.device)
    return found


def _sync_result(out):
    """Wait until the work queued for ``out`` on its cards is done: a
    CUDA event recorded on each card's current stream, synchronized."""
    import torch
    for dev in _cuda_devices(out, set()):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def profile_op(name, run):
    """Time ``run()`` (a thunk returning tensors or NDArrays) until its
    outputs are ready on the card: the engine-profiling role."""
    t0 = time.perf_counter()
    out = run()
    _sync_result(out)
    dur = (time.perf_counter() - t0) * 1e6
    _record_event(name, "operator", t0 * 1e6, dur)
    if _config["profile_memory"]:
        _record_memory_counter()
    return out


# -- counter export hooks ---------------------------------------------------
_counter_exports = {}


def register_counter_export(name, fn):
    """Register ``fn() -> dict`` under ``name``; re-registering a name
    replaces the previous hook."""
    if not callable(fn):
        raise ValueError("register_counter_export: fn must be callable")
    with _lock:
        _counter_exports[name] = fn


def unregister_counter_export(name):
    with _lock:
        _counter_exports.pop(name, None)


def export_counter(name):
    """Snapshot one registered hook (None when absent)."""
    with _lock:
        fn = _counter_exports.get(name)
    if fn is None:
        return None
    try:
        return fn()
    except Exception as e:                           # pragma: no cover
        return {"error": f"{type(e).__name__}: {e}"}


def export_counters(format="dict"):
    """Snapshot every registered hook: {name: fn()}. A hook that raises
    is reported as {"error": ...}."""
    with _lock:
        hooks = list(_counter_exports.items())
    out = {}
    for name, fn in hooks:
        try:
            out[name] = fn()
        except Exception as e:                       # pragma: no cover
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    if format == "json":
        return json.dumps(out)
    return out


def events_snapshot():
    """Copy of the buffered chrome events (the ring is not drained)."""
    with _lock:
        return _events.snapshot()


def clear_events():
    with _lock:
        _events.clear()


def dropped_events():
    with _lock:
        return _events.dropped


def set_max_events(capacity):
    """Resize the shared event ring (MXNET_TRACE_MAX_EVENTS)."""
    with _lock:
        _events.set_capacity(capacity)


def dump(finished=True, profile_process="worker"):
    """Write the chrome-trace JSON to the configured filename (a
    temporary file, then ``os.replace``)."""
    with _lock:
        trace = {"traceEvents": _events.snapshot(), "displayTimeUnit": "ms",
                 "metadata": {"dropped_events": _events.dropped,
                              "total_events": _events.total}}
    counters = export_counters()
    if counters:
        trace["counters"] = counters
    path = _config["filename"]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    if finished:
        with _lock:
            _events.clear()
    return path


def dumps(reset=False, format="table"):
    """Aggregate per-op stats (profiler.h aggregate_stats role)."""
    with _lock:
        rows = [(name, st[0], st[1], st[1] / st[0], st[2], st[3])
                for name, st in sorted(_agg.items(),
                                       key=lambda kv: -kv[1][1])]
        if reset:
            _agg.clear()
    if format == "json":
        return json.dumps([{"name": r[0], "count": r[1], "total_us": r[2],
                            "avg_us": r[3], "min_us": r[4], "max_us": r[5]}
                           for r in rows])
    lines = [f"{'Name':<40}{'Count':>8}{'Total(us)':>14}{'Avg(us)':>12}"
             f"{'Min(us)':>12}{'Max(us)':>12}"]
    for r in rows:
        lines.append(f"{r[0]:<40}{r[1]:>8}{r[2]:>14.1f}{r[3]:>12.1f}"
                     f"{r[4]:>12.1f}{r[5]:>12.1f}")
    return "\n".join(lines)


# -- user-facing profiling objects --------------------------------------------

class Domain:
    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class Task:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            dur = (time.perf_counter() - self._t0) * 1e6
            _record_event(self.name, f"task:{self.domain.name}",
                          self._t0 * 1e6, dur)
            self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


Frame = Task       # same mechanics in the reference


class Counter:
    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self.value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        with _lock:
            self.value = value
            self._record(value)

    def _record(self, value):
        # caller holds _lock; recorded only while profiling runs, so a
        # counter ticked per request does not fill the ring
        if not is_running():
            return
        _events.append({"name": self.name, "ph": "C",
                        "ts": time.perf_counter() * 1e6, "pid": 0,
                        "args": {self.name: value}})

    def increment(self, delta=1):
        with _lock:
            self.value = self.value + delta
            self._record(self.value)

    def decrement(self, delta=1):
        self.increment(-delta)


class Marker:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        if not is_running():
            return
        with _lock:
            _events.append({"name": self.name, "ph": "i",
                            "ts": time.perf_counter() * 1e6, "pid": 0,
                            "s": "p" if scope == "process" else "t"})
