"""Device feed: hide host-side input cost behind compute (counterpart of
mxnet_tpu/pipeline.py).

``DeviceFeed`` runs a feeder thread that pulls item N+1 from the source
and *stages* it while the consumer's step N runs on the card: the stage
function stacks the batch on the host, copies it into pinned memory and
starts a non-blocking copy to the card on a copy stream of the feed's
own, then records a CUDA event after the copy. The consumer gets the
staged tensors with that event; before it uses them it makes its current
stream wait on the event and calls ``record_stream``, so the caching
allocator keeps the copy's memory until the consumer's work is done.
Nothing is synchronized with the host.

Mechanics, as in the JAX package:
  - a bounded queue (depth 2 by default, ``MXNET_DEVICE_FEED_DEPTH``):
    the feeder stays at most ``depth`` items ahead;
  - the stage function runs on the feeder thread and copies out of the
    source item (``torch.stack`` and the pinned copy both do), so a
    source that reuses its buffers is safe;
  - an exception in the source or the stage function is raised again in
    the consumer at its next ``__next__``; ``close()`` drains the queue
    and joins the thread (idempotent);
  - counters (``feed_wait_us``, ``feed_stage_us``, ``overlap_frac``, ...)
    go out through ``profiler.register_counter_export("device_feed")``.

CUDA's current stream is per thread, so the stage sets its device
(``torch.cuda.device``) and stream on the feeder thread. The loops
threaded through the feed: ``BaseModule.fit`` / ``score`` / ``predict``,
``Module._fit_fused``, Gluon ``fused_fit`` and ``ServingEngine``'s
warm-up. ``MXNET_DEVICE_FEED=0`` maps the same stage function inline on
the consumer's thread: the same copies, so the same results.

Selftest: ``python -m mxnet_tpu_torch.pipeline --selftest``.
"""
from __future__ import annotations

import queue
import threading
import time

from .telemetry import tracing as _tracing

__all__ = ["DeviceFeed", "module_stage", "enabled", "default_depth",
           "stats", "reset_stats", "feed_or_inline", "close_feed",
           "Staged", "stage_tensors", "stack_to_device"]

_STATS_LOCK = threading.Lock()
_TOTALS = {"feed_wait_us": 0, "feed_stage_us": 0, "feed_batches": 0,
           "feeds_opened": 0, "feeds_closed": 0}


def _bump(key, val):
    with _STATS_LOCK:
        _TOTALS[key] += val


def stats():
    """Snapshot of the aggregate device-feed counters. ``overlap_frac`` is
    the fraction of staging time hidden behind compute: 1 when consumers
    never blocked on the feed, 0 when every staged microsecond was
    waited for."""
    with _STATS_LOCK:
        out = dict(_TOTALS)
    stage = out["feed_stage_us"]
    out["overlap_frac"] = round(
        max(0.0, 1.0 - out["feed_wait_us"] / stage), 4) if stage else 0.0
    out["feeds_active"] = out["feeds_opened"] - out["feeds_closed"]
    return out


def reset_stats():
    with _STATS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0


def _register_export():
    from . import profiler
    profiler.register_counter_export("device_feed", stats)


_register_export()


def enabled():
    """MXNET_DEVICE_FEED gate (default on)."""
    from . import config
    return bool(config.get("MXNET_DEVICE_FEED", 1))


def default_depth():
    from . import config
    return max(1, int(config.get("MXNET_DEVICE_FEED_DEPTH", 2)))


# -- staging on the card ------------------------------------------------------

class Staged:
    """A staged item, the tensors a copy stream wrote for it and the CUDA
    event recorded after the copy (None: nothing to wait for)."""

    __slots__ = ("item", "tensors", "event")

    def __init__(self, item, tensors=(), event=None):
        self.item = item
        self.tensors = tuple(tensors)
        self.event = event

    def ready(self):
        """The item, once the consumer thread's current stream waits for
        the copy; ``record_stream`` keeps the copy's memory for that
        stream's work."""
        if self.event is not None:
            import torch
            cur = torch.cuda.current_stream(self.tensors[0].device)
            cur.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(cur)
        return self.item


def _ready(item):
    return item.ready() if isinstance(item, Staged) else item


def stage_tensors(tensors, device, copy_stream=None):
    """``tensors`` on ``device``: ``(staged list, event or None)``.

    Host tensors bound for a card go through pinned memory, copied
    without blocking on ``copy_stream`` (made current on this thread with
    its device); the event is recorded after the copies. Tensors already
    on the card are cloned there, on ``copy_stream`` after the card's
    current stream (which made them). On the host the tensors are cloned
    (the caller may reuse its buffers)."""
    import torch
    if device.type != "cuda" or not tensors:
        return [t.to(device) if t.device != device else t.clone()
                for t in tensors], None
    if copy_stream is None:
        raise ValueError("stage_tensors: a card needs a copy stream")
    with torch.cuda.device(device), torch.cuda.stream(copy_stream):
        if any(t.device == device for t in tensors):
            copy_stream.wait_stream(torch.cuda.current_stream(device))
        out = []
        for t in tensors:
            if t.device == device:
                out.append(t.clone())
            else:
                host = t if t.device.type == "cpu" else t.cpu()
                out.append(host.pin_memory().to(device, non_blocking=True))
        return out, copy_stream.record_event()


def stack_to_device(columns, device, copy_stream=None):
    """Each column (a list of same-shape tensors) stacked on axis 0 onto
    ``device``: ``(stacks, event or None)``. Columns already on the card
    are stacked there on ``copy_stream`` after the current stream (of
    the card, which made them); others are stacked on the host and go
    through ``stage_tensors``."""
    import torch
    if all(t.device == device for col in columns for t in col):
        if copy_stream is None:
            return [torch.stack(c) for c in columns], None
        with torch.cuda.device(device):
            producer = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_stream(producer)
                stacks = [torch.stack(c) for c in columns]
                return stacks, copy_stream.record_event()
    host = [torch.stack([t.cpu() for t in c]) for c in columns]
    return stage_tensors(host, device, copy_stream)


_END = "end"
_ITEM = "item"
_ERR = "err"


class DeviceFeed:
    """Iterate ``source`` with staging ahead on a feeder thread.

    ``stage(item)`` runs on the feeder thread and returns the staged form
    of ``item`` (a ``Staged`` when it copied to a card); omitted, the feed
    prefetches the raw items. Yields staged items in source order;
    StopIteration at exhaustion; an exception of the source or the stage
    function is raised here, in the consumer thread. Use as a context
    manager or call ``close()``.
    """

    def __init__(self, source, stage=None, depth=None, name="device_feed"):
        self._source = iter(source)
        self._stage = stage if stage is not None else (lambda item: item)
        self._depth = depth if depth is not None else default_depth()
        self._q = queue.Queue(maxsize=max(1, int(self._depth)))
        self._stop = threading.Event()
        self._done = False
        self.name = name
        # per-feed counters: stage_us is written by the feeder thread
        # only, wait_us / batches by the consumer only
        self.wait_us = 0
        self.stage_us = 0
        self.batches = 0
        _bump("feeds_opened", 1)
        self._thread = threading.Thread(
            target=self._feeder, name=f"{name}-feeder", daemon=True)
        self._thread.start()

    # -- feeder side --------------------------------------------------------
    def _put(self, msg):
        """Bounded put that gives up when the consumer closed the feed."""
        while not self._stop.is_set():
            try:
                self._q.put(msg, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _feeder(self):
        # feed_stage_us is the feeder's whole cost an item (source pull
        # plus staging): the host work the feed hides
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                # "feed_stage", not "feed": StepLogger's feed_us counts
                # only the time the consumer was blocked
                with _tracing.span("feed.stage", phase="feed_stage",
                                   feed=self.name):
                    try:
                        item = next(self._source)
                    except StopIteration:
                        break
                    staged = self._stage(item)
                dt_us = int((time.perf_counter() - t0) * 1e6)
                self.stage_us += dt_us
                _bump("feed_stage_us", dt_us)
                if not self._put((_ITEM, staged)):
                    return
            self._put((_END, None))
        except BaseException as exc:   # noqa: BLE001 — raised consumer-side
            self._put((_ERR, exc))

    # -- consumer side ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        with _tracing.span("feed.wait", phase="feed", feed=self.name):
            kind, val = self._q.get()
        dt_us = int((time.perf_counter() - t0) * 1e6)
        self.wait_us += dt_us
        _bump("feed_wait_us", dt_us)
        if kind == _ITEM:
            self.batches += 1
            _bump("feed_batches", 1)
            return _ready(val)
        self._done = True
        self.close()
        if kind == _ERR:
            raise val
        raise StopIteration

    def overlap_frac(self):
        """Fraction of this feed's staging time hidden behind compute."""
        if not self.stage_us:
            return 0.0
        return max(0.0, 1.0 - self.wait_us / self.stage_us)

    def close(self):
        """Stop the feeder, drain the queue, join the thread. Idempotent."""
        if self._stop.is_set() and not self._thread.is_alive():
            return
        self._stop.set()
        # drain so a feeder blocked in put() wakes and sees the stop flag
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
        self._done = True
        _bump("feeds_closed", 1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- stage functions -------------------------------------------------------

def _copy_stream(device):
    import torch
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def module_stage(module):
    """Stage function for DataBatch streams feeding a bound module: each
    data / label array is copied to the device of the module's executor
    (resolved per batch: a reshape swaps the executor), on a copy stream
    of the stage's own. A batch whose axis 0 does not divide a mesh
    passes unstaged, so forward raises its divisibility error; a module
    without a bound executor gets host-side prefetch of the raw batches."""
    import torch
    from .io import DataBatch
    from .ndarray.ndarray import NDArray
    streams = {}

    def _arrays(ex, names, arrays):
        out = []
        for name, arr in zip(names, arrays):
            data = arr._data if isinstance(arr, NDArray) else arr
            # sparse arrays keep their parts: they pass unstaged
            staged = name in ex.arg_dict and isinstance(data, torch.Tensor) \
                and getattr(arr, "stype", "default") == "default"
            n = len(ex._replicas)
            if staged and name in ex._sharded_args and n > 1 and \
                    data.ndim and data.shape[0] % n != 0:
                staged = False      # forward owns the divisibility error
            out.append((arr, data if staged else None))
        return out

    def stage(batch):
        ex = getattr(module, "_exec", None)
        if ex is None or getattr(ex, "arg_dict", None) is None:
            return batch
        dev = ex._device
        if dev not in streams:
            streams[dev] = _copy_stream(dev)
        lnames = list(getattr(module, "label_names", None) or [])
        cols = _arrays(ex, module.data_names, batch.data or []) + \
            _arrays(ex, lnames, batch.label or [])
        copies, event = stage_tensors([t for _, t in cols if t is not None],
                                      dev, streams[dev])
        it = iter(copies)
        arrays = [NDArray(next(it)) if t is not None else a
                  for a, t in cols]
        nd = len(batch.data or [])
        out = DataBatch(data=arrays[:nd],
                        label=arrays[nd:] if batch.label else batch.label,
                        pad=batch.pad, index=batch.index,
                        bucket_key=batch.bucket_key,
                        provide_data=batch.provide_data,
                        provide_label=batch.provide_label)
        return Staged(out, copies, event)

    return stage


def feed_or_inline(source, stage, name="device_feed"):
    """A DeviceFeed when MXNET_DEVICE_FEED is on, else a lazy map of the
    same stage function on the consumer's thread: one code path whose
    copies are the same either way (only the thread differs)."""
    if enabled():
        return DeviceFeed(source, stage=stage, name=name)
    return (_ready(stage(item)) for item in source)


def close_feed(feed):
    """close() for a DeviceFeed; the inline map has nothing to close."""
    if isinstance(feed, DeviceFeed):
        feed.close()


# -- selftest ------------------------------------------------------------------

def _selftest(device):
    """Overlap smoke: a source with real per-item host cost feeding a
    consumer with per-item compute; order and values survive the feed,
    the feeder thread exits, and staging overlapped."""
    import torch
    n, host_ms = 24, 4.0
    dev = torch.device(device)
    copy_stream = _copy_stream(dev)

    def source():
        for i in range(n):
            time.sleep(host_ms / 1e3)        # decode/read stand-in
            yield i, torch.full((64,), float(i))

    def stage(item):
        i, t = item
        (staged,), event = stage_tensors([t], dev, copy_stream)
        return Staged((i, staged), (staged,), event)

    t0 = time.perf_counter()
    seen = []
    with DeviceFeed(source(), stage=stage, name="selftest") as feed:
        for i, arr in feed:
            time.sleep(host_ms / 1e3)        # device-step stand-in
            assert float(arr[0]) == float(i)
            seen.append(i)
        thread = feed._thread
    wall = time.perf_counter() - t0
    assert seen == list(range(n)), "order not preserved"
    assert not thread.is_alive(), "feeder thread leaked"
    sync_est = 2 * n * host_ms / 1e3
    print(f"device-feed selftest on {dev}: {n} items, wall {wall:.2f}s vs "
          f"~{sync_est:.2f}s synchronous, overlap_frac "
          f"{stats()['overlap_frac']}")
    if wall >= sync_est * 0.85:
        raise SystemExit("selftest FAILED: no overlap measured")
    print("PIPELINE-SELFTEST-OK")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="device-feed pipeline")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--ctx", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.selftest:
        _selftest(args.ctx)
        return 0
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
