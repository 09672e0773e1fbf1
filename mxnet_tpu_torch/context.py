"""Device resolution (counterpart of mxnet_tpu/context.py).

``gpu(i)`` is ``cuda:i`` and ``cpu()`` the host. Every entry point of the
port takes ``device=None``, which means the card: without CUDA that
raises instead of quietly running on the CPU. The CPU is used only when a
caller asks for it (``device="cpu"``), as the CPU tests do.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "resolve_device"]


class Context:
    """A device context (device_type, device_id) resolving to a
    ``torch.device``."""

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self):
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without CUDA); a Context, a string or
    a torch.device otherwise. A CUDA device that does not exist raises."""
    if isinstance(device, Context):
        return device.torch_device()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain versions on the host")
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if idx >= torch.cuda.device_count():
            raise MXNetError(f"cuda:{idx} out of range "
                             f"({torch.cuda.device_count()} devices)")
        return torch.device("cuda", idx)
    if dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
