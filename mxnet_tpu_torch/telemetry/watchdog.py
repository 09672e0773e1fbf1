"""Hang/crash diagnostics (counterpart of mxnet_tpu/telemetry/watchdog.py):
the tool for runs killed by a time limit with nothing printed.

Three mechanisms, all built on `faulthandler` (C-level stack dumping that
works even when the GIL holder is stuck in native code):

  - **Stall watchdog**: `install(stall_s)` arms a daemon monitor thread;
    training loops (StepLogger, or anyone) call `beat()` every step. If
    no beat lands for `stall_s` seconds, the watchdog dumps ALL thread
    stacks (stderr + optional file) with a header naming the last-live
    label and the silence duration, ticks the
    `mxnet_watchdog_stall_dumps_total` counter, then re-arms only after
    the next beat (one dump per stall, not one per poll).
  - **SIGUSR1 on-demand dump**: `kill -USR1 <pid>` dumps all stacks any
    time — no restart, no config (`install_sigusr1`, armed by default
    alongside the watchdog).
  - **Deadline dump**: `dump_after(seconds)` schedules one dump at an
    absolute deadline regardless of beats (armed just under a harness's
    time budget, a kill at the time limit leaves the stacks on record). `cancel_deadline()` on clean exit.

Env wiring (config.py): MXNET_TELEMETRY_STALL_S=<seconds> installs the
watchdog at import; MXNET_TELEMETRY_STALL_PATH appends dumps to a file
as well as stderr.
"""
from __future__ import annotations

import faulthandler
import os
import signal
import sys
import threading
import time

__all__ = ["install", "uninstall", "beat", "last_beat_age", "install_sigusr1",
           "dump_after", "cancel_deadline", "dump_now"]

# beat() and _monitor write _state without the lock: the hot path is two
# GIL-atomic dict stores a training step, and the monitor tolerates a torn
# label/beat pair; install/uninstall serialize structural changes on _lock
_state = {
    "thread": None,          # monitor thread
    "stop": None,            # threading.Event
    "stall_s": 0.0,
    "path": None,            # extra dump file path (stderr always)
    "last_beat": None,       # monotonic of last beat; None = not yet armed
    "label": "",             # who beat last (e.g. "module_fit step")
    "dumped": False,         # one dump per stall
    "sigusr1": False,
}
_lock = threading.Lock()


def beat(label=None):
    """Liveness tick. Lock-free hot path: two attribute stores under the
    GIL (the monitor tolerates torn label/beat pairs)."""
    _state["last_beat"] = time.monotonic()
    if label is not None:
        _state["label"] = label
    _state["dumped"] = False


def last_beat_age():
    """Seconds since the last beat, or None before the first."""
    t = _state["last_beat"]
    return None if t is None else time.monotonic() - t


def _counter():
    from .registry import counter
    return counter("mxnet_watchdog_stall_dumps_total",
                   help="all-thread stack dumps triggered by step stalls")


def dump_now(reason="on-demand", file=None):
    """Dump every thread's stack immediately (stderr + the configured
    dump file). Returns the header line written."""
    age = last_beat_age()
    header = (f"\n==== mxnet_tpu_torch.telemetry watchdog: {reason} | "
              f"pid {os.getpid()} | last beat "
              f"{f'{age:.1f}s ago' if age is not None else 'never'}"
              f"{' (' + _state['label'] + ')' if _state['label'] else ''}"
              f" ====\n")
    targets = []
    if file is not None:
        targets.append((file, False))
    else:
        targets.append((sys.stderr, False))
        if _state["path"]:
            try:
                targets.append((open(_state["path"], "a"), True))
            except OSError:
                pass
    # the flight-recorder tail shows what the threads were DOING in the
    # last seconds, complementing the faulthandler stacks that show
    # where they ARE now
    try:
        from . import flightrec
        tail = "\n" + flightrec.tail_text(n=40, last_s=30.0) + "\n"
    except Exception:                   # pragma: no cover
        tail = ""
    for f, close in targets:
        try:
            f.write(header)
            f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)
            if tail:
                f.write(tail)
            f.flush()
        except Exception:               # pragma: no cover
            pass
        finally:
            if close:
                f.close()
    return header


def _monitor(stop):
    while not stop.wait(min(max(_state["stall_s"] / 4.0, 0.05), 1.0)):
        stall = _state["stall_s"]
        t = _state["last_beat"]
        if not stall or t is None or _state["dumped"]:
            continue
        age = time.monotonic() - t
        if age > stall:
            _state["dumped"] = True     # re-arm on next beat
            dump_now(reason=f"step stalled {age:.1f}s "
                            f"(limit {stall:.1f}s)")
            # tick AFTER the dump file is written: the counter is the
            # "dump complete" signal observers poll on
            _counter().inc()


def install(stall_s=None, path=None, sigusr1=True):
    """Arm the stall watchdog. `stall_s=None` reads
    MXNET_TELEMETRY_STALL_S (no-op when unset/0). Idempotent; a second
    call retunes stall_s/path on the running monitor."""
    if stall_s is None:
        from .. import config
        raw = config.get("MXNET_TELEMETRY_STALL_S")
        stall_s = float(raw) if raw not in (None, "", 0) else 0.0
    if path is None:
        path = os.environ.get("MXNET_TELEMETRY_STALL_PATH") or None
    stall_s = float(stall_s)
    if stall_s <= 0:
        return None
    with _lock:
        _state["stall_s"] = stall_s
        _state["path"] = path
        if sigusr1:
            install_sigusr1()
        if _state["thread"] is None or not _state["thread"].is_alive():
            _state["stop"] = threading.Event()
            _state["thread"] = threading.Thread(
                target=_monitor, args=(_state["stop"],),
                name="telemetry-watchdog", daemon=True)
            _state["thread"].start()
    return _state["thread"]


def uninstall():
    with _lock:
        _state["stall_s"] = 0.0
        if _state["stop"] is not None:
            _state["stop"].set()
        t, _state["thread"] = _state["thread"], None
        _state["last_beat"] = None
        _state["label"] = ""
        _state["dumped"] = False
    if t is not None and t.is_alive() and t is not threading.current_thread():
        t.join(timeout=2.0)


def install_sigusr1():
    """`kill -USR1 <pid>` -> all-thread stack dump on stderr. C-level
    (faulthandler.register), so it fires even mid-native-call. No-op on
    platforms without SIGUSR1 (windows)."""
    if _state["sigusr1"]:
        return True
    try:
        # chain only to a REAL prior handler: chaining to SIG_DFL re-runs
        # the default disposition, and SIGUSR1's default is terminate —
        # the dump would land and then kill the process being diagnosed
        prev = signal.getsignal(signal.SIGUSR1)
        faulthandler.register(signal.SIGUSR1, file=sys.stderr,
                              all_threads=True, chain=callable(prev))
        _state["sigusr1"] = True
        return True
    except (AttributeError, ValueError, OSError):
        return False


def dump_after(seconds, file=None, repeat=False):
    """One scheduled all-thread dump `seconds` from now unless
    `cancel_deadline()` runs first (faulthandler.dump_traceback_later —
    fires from a C watchdog thread, immune to a stuck GIL)."""
    faulthandler.dump_traceback_later(
        max(float(seconds), 1.0), repeat=repeat, exit=False,
        file=file if file is not None else sys.stderr)


def cancel_deadline():
    faulthandler.cancel_dump_traceback_later()
