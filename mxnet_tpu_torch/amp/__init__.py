"""mxnet_tpu_torch.amp — automatic mixed precision (counterpart of
mxnet_tpu/amp/__init__.py).

The policy hooks the one place every symbolic op call funnels through,
the executor's walk (``executor._Plan``: ``Executor.bind``,
``Module.fit``, hybridized Gluon, ``DataParallelTrainer``), and casts
each op's inputs per the ALLOW / WIDEN lists (``amp/policy.py``). A
``_Plan`` takes the policy when it is built, as the JAX package's trace
does: ``amp.init`` after a bind does not change a plan that already
exists, so flip it before binding. Leaving amp off, or
``amp.init("float32")``, changes nothing: the walk makes no cast.

    import mxnet_tpu_torch as mx
    mx.amp.init("bfloat16")     # before bind / fit
    mod.fit(...)                # matmuls and convs in bf16, softmax,
                                # norms and the update in fp32

Parameters stay fp32 masters; the policy casts them down where they are
used and autograd returns the gradient in fp32. fp16 also needs the
``DynamicLossScaler`` (``amp/scaler.py``), wired into
``DataParallelTrainer(dtype="float16")``.

``MXNET_AMP=1`` [``MXNET_AMP_DTYPE=bfloat16|float16``] calls :func:`init`
when the package is imported (``config.py``). :func:`counters` reports
amp_scale, amp_skipped_steps and amp_cast_bytes_saved, exported through
``profiler.register_counter_export("amp")``.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .policy import ALLOW, LOSS_HEADS, WIDEN
from .scaler import DynamicLossScaler

__all__ = ["init", "disable", "is_enabled", "get_dtype", "compute_dtype",
           "reduce_dtype", "cast_op_inputs", "counters", "DynamicLossScaler",
           "ALLOW", "LOSS_HEADS", "WIDEN"]

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

_lock = threading.Lock()
_state = {"enabled": False, "dtype": "float32"}
_cast_bytes_saved = [0]
_scale_sources = []          # weakrefs to objects with _amp_counters()
_tls = threading.local()     # the fp16 loss scale of the step being run


def init(dtype="bfloat16"):
    """Enable autocast with the given compute dtype ("bfloat16" or
    "float16"); "float32" disables. Call before binding: a plan built
    earlier keeps the policy it was built with. Returns the dtype."""
    dtype = str(dtype)
    if dtype not in _DTYPES:
        raise ValueError(f"amp.init: dtype must be one of {tuple(_DTYPES)}, "
                         f"got {dtype!r}")
    with _lock:
        _state["dtype"] = dtype
        _state["enabled"] = dtype != "float32"
    return dtype


def disable():
    with _lock:
        _state["enabled"] = False
        _state["dtype"] = "float32"


def is_enabled():
    return _state["enabled"]


def get_dtype():
    """Active compute dtype name ("float32" when disabled)."""
    return _state["dtype"]


def compute_dtype():
    """Active compute dtype as a torch dtype, or None when disabled."""
    return _DTYPES[_state["dtype"]] if _state["enabled"] else None


def reduce_dtype():
    """Dtype for a cross-device gradient reduction: bf16 when amp is on
    (fp16 gradients too: the same width with fp32's exponent, so the sum
    cannot overflow where the addends did not), else None (fp32)."""
    return torch.bfloat16 if _state["enabled"] else None


def _set_trace_loss_scale(scale):
    """The fp16 loss scale (a device tensor) of the step this thread is
    running: ``DataParallelTrainer`` sets it around its forward and clears
    it after. While set, each legacy loss head's data input gets the
    gradient-scale injection."""
    _tls.loss_scale = scale


def _trace_loss_scale():
    return getattr(_tls, "loss_scale", None)


class _InjectGradScale(torch.autograd.Function):
    """Identity forward; the backward multiplies the cotangent by the
    scale in fp32 and casts back to its dtype, so an fp16 overflow stays
    inf where the finiteness check sees it."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (scale,) = ctx.saved_tensors
        return (g.to(torch.float32) * scale).to(g.dtype), None


def _inject_grad_scale(x, scale):
    return _InjectGradScale.apply(x, scale)


_CURRENT = object()


def cast_op_inputs(op_name, ins, policy=_CURRENT, count=True):
    """The executor hook: an op's registry name and its input tensors in,
    the policy-cast inputs out. ``policy`` is the compute dtype a plan
    took when it was built (None: amp off for that plan); left out, the
    current one. Identity when amp is off, for NEUTRAL ops and for
    every non-float input. Independently of the policy, while a loss scale
    is set (fp16 training), a loss head's data input gets the gradient
    scale injected, after the policy casts, so the multiply runs in the
    widened dtype. ``count`` adds the bytes the casts remove to
    amp_cast_bytes_saved (a plan counts its first walk only)."""
    if policy is _CURRENT:
        policy = compute_dtype()
    scale = getattr(_tls, "loss_scale", None)
    if policy is None and scale is None:
        return ins
    out = list(ins)
    tgt = None
    if policy is not None:
        if op_name in ALLOW:
            tgt = policy
        elif op_name in WIDEN:
            tgt = torch.float32
    if tgt is not None:
        width = torch.finfo(tgt).bits // 8
        for i, x in enumerate(out):
            if isinstance(x, torch.Tensor) and x.is_floating_point() \
                    and x.dtype != tgt:
                saved = (x.element_size() - width) * x.numel()
                if saved > 0 and count:
                    with _lock:
                        _cast_bytes_saved[0] += saved
                out[i] = x.to(tgt)
    if scale is not None and op_name in LOSS_HEADS and out:
        out[0] = _inject_grad_scale(out[0], scale)
    return out


# -- counters ---------------------------------------------------------------

def _register_scale_source(obj):
    """Trainers with a loss scale register themselves (weakly);
    :func:`counters` polls whoever is still alive. ``obj`` exposes
    ``_amp_counters() -> {"amp_scale": float, "amp_skipped_steps": int}``.
    """
    with _lock:
        _scale_sources.append(weakref.ref(obj))


def counters():
    """The policy and the three amp counters."""
    out = {"enabled": _state["enabled"], "dtype": _state["dtype"],
           "amp_cast_bytes_saved": int(_cast_bytes_saved[0]),
           "amp_scale": None, "amp_skipped_steps": 0}
    with _lock:
        refs = list(_scale_sources)
    live = []
    for r in refs:
        src = r()
        if src is None:
            continue
        live.append(r)
        c = src._amp_counters()
        if c.get("amp_scale") is not None:
            out["amp_scale"] = float(c["amp_scale"])
        out["amp_skipped_steps"] += int(c.get("amp_skipped_steps", 0))
    with _lock:
        _scale_sources[:] = live
    return out


def _reset_for_tests():
    """Policy off, counters zeroed, no loss scale: the pristine state, so
    one test's amp cannot leak into the next."""
    with _lock:
        _state["enabled"] = False
        _state["dtype"] = "float32"
        _cast_bytes_saved[0] = 0
        _scale_sources[:] = []
    _tls.loss_scale = None


def _ensure_counter_export():
    from .. import profiler
    profiler.register_counter_export("amp", counters)


_ensure_counter_export()
