"""Autograd scopes and backward over ``torch.autograd`` (subset of
mxnet_tpu/autograd.py).

MXNet records only inside ``record()``; the port keeps that contract by
switching torch's grad mode: ``record()`` enables it, ``pause()``
disables it, and a Gluon block called outside ``record()`` runs with it
off. ``is_training()`` (set by ``record(train_mode=True)`` and
``train_mode()``) is what ``Dropout`` reads.

Two differences from torch's defaults are the reference's, not torch's:

* ``grad_req="write"`` (the default) overwrites: after each backward a
  parameter's gradient is that backward's gradient alone, from the second
  step on too. torch accumulates into ``.grad``; the port's ``Parameter``
  clears ``.grad`` in a hook that runs just before torch would
  accumulate, so ``loss.backward()`` (torch's own method) and
  :func:`backward` both overwrite. ``"add"`` accumulates, as torch does;
  ``"null"`` parameters do not require grad and get none.
* gradients are not scaled by the batch size here; ``Trainer.step``
  rescales by 1 / batch_size in the optimizer.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["is_recording", "is_training", "record", "pause", "train_mode",
           "predict_mode", "backward"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._is_record = is_record
        self._train = train_mode

    def __enter__(self):
        s = _st()
        self._prev = (s.recording, s.training, torch.is_grad_enabled())
        if self._is_record is not None:
            s.recording = self._is_record
            torch.set_grad_enabled(self._is_record)
        if self._train is not None:
            s.training = self._train
        return self

    def __exit__(self, *exc):
        s = _st()
        s.recording, s.training, grad = self._prev
        torch.set_grad_enabled(grad)


def record(train_mode=True):
    """Scope that records operations for backward (and sets train mode)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope that stops recording inside a ``record()`` scope."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def backward(heads, head_grads=None):
    """Gradients of ``heads`` into every reachable parameter, honouring
    each parameter's ``grad_req`` (see the module docstring).
    ``head_grads`` default to ones."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None:
        head_grads = [torch.ones_like(h) for h in heads]
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    torch.autograd.backward(list(heads), list(head_grads))
