"""Engine facade (counterpart of mxnet_tpu/engine.py; the reference's
include/mxnet/engine.h and mx.engine).

CUDA streams are the port's engine: ops are queued on the current stream
and run asynchronously, and their order follows the queue. The public
knobs stay: ``bulk`` / ``set_bulk_size`` are recorded and schedule
nothing, and ``MXNET_ENGINE_TYPE=NaiveEngine`` (``config._apply_startup``)
makes every imperative op wait for the card before it returns, the
reference's synchronous debugging engine.
"""
from __future__ import annotations

import contextlib

__all__ = ["set_engine_type", "set_bulk_size", "bulk", "wait_for_all",
           "waitall"]

_bulk_size = 0
_sync_mode = False


def set_engine_type(name):
    """'NaiveEngine' -> synchronous; 'ThreadedEngine' /
    'ThreadedEnginePerDevice' -> asynchronous (the default)."""
    global _sync_mode
    _sync_mode = (name == "NaiveEngine")


def set_bulk_size(size: int) -> int:
    """Engine bulk-exec hook (engine.h:287-294): recorded, no scheduling
    effect. Returns the previous size."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, size
    return prev


@contextlib.contextmanager
def bulk(size: int):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def sync_device(device):
    """Wait for ``device``'s queued work (NaiveEngine's per-op wait); a
    host device has nothing queued."""
    if device is not None and device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def wait_for_all():
    """Engine::WaitForAll: wait for the work queued on every card."""
    from .ndarray.ndarray import waitall as _waitall
    _waitall()


waitall = wait_for_all
