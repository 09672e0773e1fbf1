"""Errors and naming shared by the PyTorch port (counterpart of
mxnet_tpu/base.py)."""
from __future__ import annotations

import threading

__all__ = ["MXNetError", "NameManager"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


class NameManager:
    """Automatic unique names for blocks (python/mxnet/name.py): the
    first block of a kind without a prefix is ``dense0_``, then
    ``dense1_``, ... Counters are per thread and per manager; ``with
    NameManager():`` starts a fresh count."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name is not None:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, *exc):
        NameManager._current.value = self._old

    @classmethod
    def current(cls) -> "NameManager":
        v = getattr(cls._current, "value", None)
        if v is None:
            v = NameManager()
            cls._current.value = v
        return v
