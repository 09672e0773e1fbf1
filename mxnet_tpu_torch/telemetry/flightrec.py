"""Crash flight recorder: the always-on black box (counterpart of
mxnet_tpu/telemetry/flightrec.py).

A bounded ring of the most recent spans and events (``record()`` is a
dict build and a deque append: no I/O, nothing on the card) that is
dumped to a postmortem JSON file when something dies:

  - a watchdog stall or deadline dump (``watchdog.dump_now`` appends
    ``tail_text()`` under the faulthandler stacks),
  - an uncaught exception (``install()`` chains ``sys.excepthook``),
  - SIGTERM (``install()`` chains the handler, dumps, then re-delivers
    the prior disposition).

SIGKILL cannot be caught, so when ``MXNET_FLIGHTREC_DIR`` is set a
flusher daemon snapshots the ring to disk every
``MXNET_FLIGHTREC_FLUSH_S`` seconds. Every dump is written to a
temporary file of its own (pid and thread in its name) and moved into
place with ``os.replace``, one dump at a time: a reader never sees a
half-written box, and the flusher never writes over a crash dump that
already holds every recorded event.

``MXNET_FLIGHTREC=0`` turns recording off. The ring is host-side only
and never touches the card, so it cannot change what is computed.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque

__all__ = ["enabled", "record", "snapshot", "dump", "tail_lines",
           "tail_text", "install", "uninstall", "default_path", "rank",
           "stats", "reset"]

_lock = threading.Lock()
_dump_lock = threading.RLock()    # one dump at a time (a signal handler
                                  # may dump on a thread inside one)
_ring = None          # deque, created lazily at first record
_total = 0            # appended since reset
_dumped = {}          # path -> _total its last dump held
_installed = {
    "excepthook": None,     # prev sys.excepthook when chained
    "sigterm": None,        # prev SIGTERM handler when chained
    "flusher": None,        # (thread, stop_event)
    "dir": None,            # where auto-dumps land
}


def enabled():
    """MXNET_FLIGHTREC master gate (default ON — the recorder is the
    always-on black box; the env dict lookup keeps the off-path cheap)."""
    return os.environ.get("MXNET_FLIGHTREC", "1") not in ("0", "false", "")


def _capacity():
    from .. import config
    try:
        return max(16, int(config.get("MXNET_FLIGHTREC_EVENTS", 4096)))
    except (TypeError, ValueError):
        return 4096


def rank():
    try:
        return int(os.environ.get("DMLC_WORKER_ID", "0") or 0)
    except ValueError:
        return 0


def record(kind, name, dur_us=None, **fields):
    """Append one event to the ring. kind is a short class ("span",
    "event", "error"); extra fields must be JSON-serializable scalars."""
    if not enabled():
        return
    ev = {"t": time.time(), "thr": threading.current_thread().name,
          "kind": kind, "name": name}
    if dur_us is not None:
        ev["dur_us"] = int(dur_us)
    if fields:
        ev.update(fields)
    global _ring, _total
    with _lock:
        if _ring is None:
            _ring = deque(maxlen=_capacity())
        _ring.append(ev)
        _total += 1


def snapshot(last_s=None):
    """Copy of the buffered events, optionally only the last `last_s`
    seconds (relative to the newest event, not the wall clock — a long
    stall should not empty the tail)."""
    with _lock:
        evs = list(_ring) if _ring is not None else []
    if last_s is not None and evs:
        cutoff = evs[-1]["t"] - float(last_s)
        evs = [e for e in evs if e["t"] >= cutoff]
    return evs


def stats():
    with _lock:
        n = len(_ring) if _ring is not None else 0
        cap = _ring.maxlen if _ring is not None else _capacity()
        return {"events": n, "total": _total,
                "dropped": max(0, _total - n), "capacity": cap}


def reset():
    """Drop all buffered events (tests)."""
    global _ring, _total
    with _lock:
        _ring = None
        _total = 0
        _dumped.clear()


def default_path(directory=None):
    from .. import config
    d = directory or _installed["dir"] or \
        config.get("MXNET_FLIGHTREC_DIR") or "."
    return os.path.join(str(d), f"flightrec-rank-{rank()}.json")


def dump(path=None, reason="on-demand", last_s=None, _periodic=False):
    """Write the black box (a temporary file, then ``os.replace``).
    Returns the path, or None when recording is disabled or nothing was
    written. Never raises: this runs on crash paths where a second
    failure must not mask the first."""
    if not enabled():
        return None
    try:
        path = path or default_path()
        with _dump_lock:
            with _lock:
                total = _total
            if _periodic and _dumped.get(path) == total:
                return None          # the box on disk is already current
            st = stats()
            box = {"version": 1, "rank": rank(), "pid": os.getpid(),
                   "reason": str(reason), "wall_time": time.time(),
                   "events": snapshot(last_s=last_s),
                   "dropped": st["dropped"], "total": st["total"]}
            if box["events"]:
                box["last_event_t"] = box["events"][-1]["t"]
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(box, f)
            os.replace(tmp, path)
            _dumped[path] = st["total"]
        return path
    except Exception:                    # pragma: no cover
        return None


def tail_lines(n=50, last_s=None):
    """The last events formatted one per line — what watchdog.dump_now
    appends under the faulthandler stacks so a hang dump shows what the
    threads were DOING, not just where they are."""
    evs = snapshot(last_s=last_s)[-int(n):]
    out = []
    for e in evs:
        extra = {k: v for k, v in e.items()
                 if k not in ("t", "thr", "kind", "name", "dur_us")}
        dur = f" {e['dur_us'] / 1000.0:.3f}ms" if "dur_us" in e else ""
        out.append(f"  [{time.strftime('%H:%M:%S', time.localtime(e['t']))}"
                   f".{int((e['t'] % 1) * 1000):03d} {e['thr']}] "
                   f"{e['kind']} {e['name']}{dur}"
                   f"{' ' + json.dumps(extra) if extra else ''}")
    return out


def tail_text(n=50, last_s=None):
    lines = tail_lines(n=n, last_s=last_s)
    st = stats()
    head = (f"flight recorder tail ({len(lines)} of {st['events']} "
            f"buffered, {st['dropped']} dropped):")
    return "\n".join([head] + lines) if lines else \
        "flight recorder: no events buffered"


# -- crash triggers ----------------------------------------------------------

def _excepthook(exc_type, exc, tb):
    record("error", f"uncaught:{exc_type.__name__}", msg=str(exc)[:200])
    dump(reason=f"uncaught exception: {exc_type.__name__}: "
                f"{str(exc)[:200]}")
    prev = _installed["excepthook"]
    (prev or sys.__excepthook__)(exc_type, exc, tb)


def _sigterm(signum, frame):
    record("event", "SIGTERM")
    dump(reason="SIGTERM")
    prev = _installed["sigterm"]
    if callable(prev):
        prev(signum, frame)      # e.g. checkpoint's preemption hook
    elif prev == signal.SIG_DFL:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _flush_interval():
    from .. import config
    try:
        return float(config.get("MXNET_FLIGHTREC_FLUSH_S", "0.5") or 0)
    except (TypeError, ValueError):
        return 0.5


def _flusher(stop, directory):
    # first dump immediately (not one interval in): a process SIGKILLed
    # inside its first flush interval still leaves a black box
    path = default_path(directory)
    while True:
        dump(path=path, reason="periodic-flush", _periodic=True)
        if stop.wait(_flush_interval() or 0.5):
            return


def install(directory=None):
    """Arm the auto-dump triggers: excepthook + SIGTERM chains, and,
    when a dump directory is configured, the periodic flusher that keeps
    an on-disk snapshot fresh for SIGKILL / OOM deaths. Idempotent;
    ``config._apply_startup`` calls it when ``MXNET_FLIGHTREC_DIR`` is
    set."""
    if not enabled():
        return False
    from .. import config
    directory = directory or config.get("MXNET_FLIGHTREC_DIR") or None
    if directory and _installed["flusher"] is None:
        # baseline event: a process killed before its first span still
        # leaves a box with a last_event_t
        record("event", "flightrec.armed", pid=os.getpid())
    with _lock:
        if _installed["dir"] is None:
            _installed["dir"] = directory
        if _installed["excepthook"] is None and \
                sys.excepthook is not _excepthook:
            _installed["excepthook"] = sys.excepthook
            sys.excepthook = _excepthook
        if _installed["sigterm"] is None:
            try:
                prev = signal.getsignal(signal.SIGTERM)
                if prev is not _sigterm:
                    _installed["sigterm"] = prev
                    signal.signal(signal.SIGTERM, _sigterm)
            except (ValueError, OSError):    # non-main thread / platform
                pass
        if directory and _installed["flusher"] is None and \
                _flush_interval() > 0:
            stop = threading.Event()
            t = threading.Thread(target=_flusher, args=(stop, directory),
                                 name="flightrec-flusher", daemon=True)
            t.start()
            _installed["flusher"] = (t, stop)
    return True


def uninstall():
    """Restore chained hooks and stop the flusher (tests)."""
    with _lock:
        if _installed["excepthook"] is not None:
            if sys.excepthook is _excepthook:
                sys.excepthook = _installed["excepthook"]
            _installed["excepthook"] = None
        if _installed["sigterm"] is not None:
            try:
                if signal.getsignal(signal.SIGTERM) is _sigterm:
                    signal.signal(signal.SIGTERM, _installed["sigterm"])
            except (ValueError, OSError):
                pass
            _installed["sigterm"] = None
        flusher, _installed["flusher"] = _installed["flusher"], None
        _installed["dir"] = None
    if flusher is not None:
        t, stop = flusher
        stop.set()
        t.join(timeout=2.0)
