"""Autograd over ``torch.autograd`` (counterpart of mxnet_tpu/autograd.py).

MXNet records only inside ``record()``; the port keeps that contract by
switching torch's grad mode: ``record()`` enables it, ``pause()``
disables it, and an op called outside ``record()`` (an ``mx.nd``
function, a Gluon block) runs with it off. ``is_training()`` (set by
``record(train_mode=True)`` and ``train_mode()``) is what ``Dropout``
and ``BatchNorm`` read.

A variable is a leaf tensor that requires grad: ``NDArray.attach_grad``
and ``mark_variables`` make one of an NDArray's tensor, a Gluon
``Parameter`` keeps its value as one. Its gradient buffer is the
tensor's ``.grad``, allocated once (the reference allocates one per
variable) and read as an NDArray (``x.grad``, ``Parameter.grad()``).
``NDArray.backward``, :func:`backward` and torch's own
``Tensor.backward`` all fill it. Two differences from torch's defaults
are the reference's, not torch's:

* ``grad_req="write"`` (the default) overwrites: after each backward a
  variable's gradient is that backward's gradient alone. torch
  accumulates into ``.grad``; a hook on the leaf (``_before_accumulate``)
  runs just before torch accumulates and zeroes the buffer in place, so
  the sum torch then makes in place is this backward's gradient, in the
  same buffer. ``"add"`` accumulates, as torch does; ``"null"`` variables
  do not require grad and get none.
* gradients are not scaled by the batch size here; ``Trainer.step``
  rescales by 1 / batch_size in the optimizer.

:class:`Function` (a user's differentiable function over NDArrays) is a
``torch.autograd.Function`` underneath. Higher-order gradients
(``grad(create_graph=True)``) and ``get_symbol`` raise, as in the JAX
package.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode",
           "mark_variables", "backward", "grad", "get_symbol", "Function"]

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


def set_recording(is_record: bool) -> bool:
    """Set recording on or off; returns the previous state."""
    s = _st()
    prev, s.recording = s.recording, bool(is_record)
    torch.set_grad_enabled(s.recording)
    return prev


def set_training(train_mode: bool) -> bool:
    s = _st()
    prev, s.training = s.training, bool(train_mode)
    return prev


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


# ---------------------------------------------------------------------------
# variables
# ---------------------------------------------------------------------------

def _before_accumulate(ref):
    def hook(g):
        t = ref()
        # "write": the buffer is zeroed just before torch adds this
        # backward's gradient into it in place
        if t is not None and t.grad is not None and \
                getattr(t, "_mx_grad_req", "write") == "write":
            t.grad.zero_()
    return hook


def _mark(t, grad_req, grad=None):
    """Make the leaf tensor ``t`` a variable with ``grad_req``: it
    requires grad, its ``.grad`` is ``grad`` (zeros when None) and the
    "write" hook is registered once. "null" drops the buffer."""
    if grad_req not in ("write", "add", "null"):
        raise ValueError("grad_req must be write, add, or null, but got "
                         f"{grad_req}")
    t._mx_grad_req = grad_req
    if grad_req == "null":
        t.requires_grad_(False)
        t.grad = None
        return t
    t.requires_grad_(True)
    if not getattr(t, "_mx_hooked", False):
        t.register_hook(_before_accumulate(weakref.ref(t)))
        t._mx_hooked = True
    if grad is not None:
        t.grad = grad
    elif t.grad is None:
        t.grad = torch.zeros_like(t)
    return t


def _leaf(t):
    """``t`` itself when it is a leaf, else a leaf over its storage."""
    return t if t.is_leaf else t.detach()


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as variables whose gradients go into ``gradients``
    (NDArrays of the same shapes), as ``attach_grad`` does."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        gt = None if g is None else g._data
        if gt is not None and (gt.shape != v._data.shape
                               or gt.dtype != v._data.dtype):
            raise MXNetError(f"mark_variables: gradient {tuple(gt.shape)} "
                             f"{gt.dtype} for a variable "
                             f"{tuple(v._data.shape)} {v._data.dtype}")
        v._data = _mark(_leaf(v._data), req, gt)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _tensors(xs):
    from .ndarray.ndarray import NDArray
    if isinstance(xs, (NDArray, torch.Tensor)):
        xs = [xs]
    return [x._data if isinstance(x, NDArray) else x for x in xs]


def _head_grads(heads, head_grads):
    if head_grads is None:
        return [torch.ones_like(h) for h in heads]
    gs = _tensors(head_grads)
    return [torch.ones_like(h) if g is None else
            g.to(device=h.device, dtype=h.dtype) for h, g in zip(heads, gs)]


def _recorded(heads):
    for h in heads:
        if not h.requires_grad:
            raise MXNetError("cannot differentiate: output not recorded "
                             "(is autograd.record() active?)")


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (NDArrays or tensors) into every reachable
    variable, honouring each one's ``grad_req`` (see the module
    docstring). ``head_grads`` default to ones."""
    heads = _tensors(heads)
    _recorded(heads)
    torch.autograd.backward(heads, _head_grads(heads, head_grads),
                            retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (marked
    NDArrays), returned as NDArrays and written into the variables'
    gradient buffers; other variables' buffers are left as they were."""
    from .ndarray.ndarray import NDArray
    if create_graph:
        raise MXNetError("create_graph=True not supported yet")
    heads = _tensors(heads)
    if isinstance(variables, NDArray):
        variables = [variables]
    _recorded(heads)
    leaves = []
    for v in variables:
        t = v._data
        if not (t.is_leaf and t.requires_grad):
            raise MXNetError("requested variable was not marked "
                             "(call attach_grad() before record)")
        leaves.append(t)
    gs = torch.autograd.grad(heads, leaves, _head_grads(heads, head_grads),
                             retain_graph=retain_graph, allow_unused=True)
    out = []
    with torch.no_grad():
        for t, g in zip(leaves, gs):
            g = torch.zeros_like(t) if g is None else g
            if t.grad is None:
                t.grad = g.clone()
            else:
                t.grad.copy_(g)
            out.append(NDArray(t.grad))
    return out


def get_symbol(x):
    raise MXNetError("autograd.get_symbol is not supported; use "
                     "Gluon HybridBlock tracing instead")


# ---------------------------------------------------------------------------
# custom differentiable functions
# ---------------------------------------------------------------------------

class Function:
    """User-defined differentiable NDArray function: subclass, implement
    ``forward(self, *inputs)`` (NDArrays in, an NDArray or a tuple out)
    and ``backward(self, *output_grads)`` (one gradient a forward output
    in, one a forward input out), and call the instance. Both run with
    recording paused. Underneath, each call is one application of a
    ``torch.autograd.Function``."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        fn_self = self
        single = []

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *ts):
                with pause():
                    outs = fn_self.forward(*[NDArray(t) for t in ts])
                single.append(not isinstance(outs, (list, tuple)))
                outs = [outs] if single[0] else list(outs)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *gs):
                with pause():
                    grads = fn_self.backward(*[NDArray(g) for g in gs])
                grads = [grads] if not isinstance(grads, (list, tuple)) \
                    else list(grads)
                return tuple(None if g is None else g._data for g in grads)

        ts = [x._data if isinstance(x, NDArray) else x for x in inputs]
        outs = _Apply.apply(*ts)
        outs = [NDArray(o) for o in (outs if isinstance(outs, tuple)
                                     else (outs,))]
        return outs[0] if single[0] else tuple(outs)
