"""Kernel launch counters: each kernel wrapper's ``launches`` (raised
where it launches its kernel; the flash wrappers' ``by_dtype`` too), the
dense attention route's ``calls``,
and the own count of each kernel library already loaded
(``_build.launches``, as ``lib:<stem>``; a path without hand-written
kernels loads none). A CUDA graph's replay passes no wrapper and no
launch site, so the code that replays one adds what its capture moved
the counters by (:func:`add`): the decode plans and the data-parallel
trainer's step do."""
from __future__ import annotations

from .. import _build


def _counters():
    from . import attention as A, conv_fused as C, quantization as Q, \
        rcnn as R
    return (("flash_attention_fwd", A.flash_attention_fwd, "launches"),
            ("flash_attention_bwd_dq", A.flash_attention_bwd_dq, "launches"),
            ("flash_attention_bwd_dkv", A.flash_attention_bwd_dkv,
             "launches"),
            ("decode_attention", A.decode_attention, "launches"),
            ("quantized_matmul", Q.quantized_matmul, "launches"),
            ("conv1x1", C.conv1x1, "launches"),
            ("roi_pooling", R.roi_pooling, "launches"),
            ("proposal_nms", R.proposal_nms, "launches"),
            ("dense_attention", A.dense_attention, "calls"))


def counts():
    """{counter: value} of every wrapper (and ``name[dtype]`` of those
    that count by dtype) and loaded library."""
    out = {}
    for name, fn, attr in _counters():
        out[name] = getattr(fn, attr)
        for dt, n in getattr(fn, "by_dtype", {}).items():
            out[f"{name}[{dt}]"] = n
    out.update({"lib:" + s: _build.launches(s) for s in list(_build._LIBS)})
    return out


def add(delta):
    """Raise the counters of :func:`counts` by ``delta`` (the launches of
    one replay)."""
    for name, fn, attr in _counters():
        if delta.get(name):
            setattr(fn, attr, getattr(fn, attr) + delta[name])
        by = getattr(fn, "by_dtype", None)
        if by is not None:
            for key, n in delta.items():
                if n and key.startswith(name + "["):
                    by[key[len(name) + 1:-1]] += n
    for key, n in delta.items():
        if key.startswith("lib:") and n:
            _build.add_launches(key[4:], n)
