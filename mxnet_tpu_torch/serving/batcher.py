"""Completion handle shared by the serving engines (subset of
mxnet_tpu/serving/batcher.py: the dynamic batcher itself waits for a later
slice)."""
from __future__ import annotations

import threading
import time

__all__ = ["Future", "RequestTimeout"]


class RequestTimeout(TimeoutError):
    """The request's deadline expired before its result was ready."""


class Future:
    """Minimal completion handle (threading.Event based)."""

    __slots__ = ("_ev", "_value", "_exc", "_deadline")

    def __init__(self, deadline):
        self._ev = threading.Event()
        self._value = None
        self._exc = None
        self._deadline = deadline

    def _set(self, value):
        self._value = value
        self._ev.set()

    def _set_exception(self, exc):
        self._exc = exc
        self._ev.set()

    def done(self):
        return self._ev.is_set()

    def result(self, timeout=None):
        if timeout is None and self._deadline is not None:
            # backstop: never block past the request's own deadline
            timeout = max(self._deadline - time.monotonic(), 0.0) + 1.0
        if not self._ev.wait(timeout):
            raise RequestTimeout("result() timed out")
        if self._exc is not None:
            raise self._exc
        return self._value
