"""Device contexts (counterpart of mxnet_tpu/context.py).

``gpu(i)`` is ``cuda:i`` and ``cpu()`` the host. The default context is
``gpu(0)``: every entry point that takes ``ctx=None`` or ``device=None``
means the card, and without CUDA that raises instead of quietly running
on the CPU. The CPU is used only when a caller asks for it: ``ctx=cpu()``,
``device="cpu"`` or ``with cpu():``, as the CPU tests do.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "resolve_device"]


class Context:
    """A device context (device_type, device_id) resolving to a
    ``torch.device``; ``with ctx:`` makes it the current context."""

    _current = threading.local()
    default_ctx = None

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx = None

    def torch_device(self):
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    @staticmethod
    def of(device):
        """The Context of a torch.device."""
        device = torch.device(device)
        if device.type == "cpu":
            return Context("cpu", 0)
        return Context("gpu", device.index or 0)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = getattr(Context._current, "value", None)
        Context._current.value = self
        return self

    def __exit__(self, *exc):
        Context._current.value = self._old_ctx


Context.default_ctx = Context("gpu", 0)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` context, else ``gpu(0)``."""
    cur = getattr(Context._current, "value", None)
    return cur if cur is not None else Context.default_ctx


def resolve_device(device=None):
    """``None`` -> the current context (``gpu(0)`` unless a ``with``
    scope says otherwise; raises without CUDA); a Context, a string or a
    torch.device otherwise. A CUDA device that does not exist raises."""
    if device is None:
        device = getattr(Context._current, "value", None)
    if isinstance(device, Context):
        return device.torch_device()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' or ctx=mx.cpu() to run the plain versions on "
                "the host")
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise MXNetError(f"cuda:{idx} out of range "
                             f"({torch.cuda.device_count()} devices)")
        return torch.device("cuda", idx)
    if dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
