"""Attention operators: hand-written CUDA kernels and their plain versions.

Counterpart of mxnet_tpu/ops/attention.py. Four kernels, each beside the
plain PyTorch function it is held against:

* :func:`flash_attention_fwd` — causal / non-causal flash forward over
  q (B, H, S, D) and k/v (B, H_kv, S, D), returning out and the per-row
  logsumexp (B, H, S) f32. Kernel: ``csrc/flash_attention.cu``.
* :func:`flash_attention_bwd_dq` and :func:`flash_attention_bwd_dkv` —
  the recompute-based backward (dQ; dK/dV), called together by
  :func:`flash_attention_bwd`; plain twin
  :func:`reference_flash_attention_bwd`. Kernels:
  ``csrc/flash_attention_bwd.cu``.
* :func:`decode_attention` — single-token (q_len = 1) attention over a
  length-masked KV pool. Kernel: ``csrc/decode_attention.cu``.

:func:`flash_attention` and :func:`flash_attention_with_lse` are
trainable: ``_FlashAttention`` (a ``torch.autograd.Function``) saves q, k,
v, out and lse, and its backward is :func:`flash_attention_bwd`.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback between the two. The kernels take float32
only (the decode path keeps f32 params and caches). Each wrapper carries
an integer ``launches`` counter that is raised exactly where its kernel
launches.

Head dims: the kernels take 16, 32, 64 and the multiples of 128 up to
:data:`MAX_HEAD_DIM` (:func:`kernel_head_dim`, the head-dim rule of the
JAX package's ``_pallas_eligible`` / ``_decode_eligible``, which take 64
and the multiples of 128). Any other head dim (80, 96, ...) is routed by
:func:`flash_attention`, :func:`flash_attention_with_lse` and
:func:`decode_attention` to :func:`dense_attention`, as the JAX package
sends such shapes to its XLA path. The choice rests on the shape alone
and is made before any launch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["reference_attention", "reference_attention_with_lse",
           "reference_flash_attention_bwd", "reference_decode_attention",
           "flash_attention", "flash_attention_with_lse",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "decode_attention", "dense_attention", "kernel_head_dim",
           "MAX_HEAD_DIM"]

# Head dims up to 256 have a kernel instance each; above, the "wide"
# kernels loop over D in 128-column chunks and keep their accumulators in
# registers, which sets the ceiling (dK/dV spilled at D = 768).
MAX_HEAD_DIM = 512
_DECODE_GROUPS = (1, 2, 4, 8)


def kernel_head_dim(d):
    """True when some kernel of this module takes head dim ``d``: 16, 32,
    64 or a multiple of 128 (the JAX package's rule, plus 16 and 32).
    Multiples of 128 above :data:`MAX_HEAD_DIM` pass this test and are
    refused by the kernel wrappers, naming the limit."""
    return d in (16, 32, 64) or (d > 0 and d % 128 == 0)


def dense_attention(q, k, v, causal=False, scale=None, lengths=None):
    """The dense route for head dims no kernel takes: plain PyTorch ops,
    differentiated by autograd, the counterpart of the JAX package's XLA
    path (``reference_attention`` from ``flash_attention``,
    ``reference_decode_attention`` from ``decode_attention``). Returns
    (out, lse) or, given ``lengths``, a decode step's (B, H, D). Counts
    its calls in ``dense_attention.calls``."""
    dense_attention.calls += 1
    if lengths is not None:
        return reference_decode_attention(q, k, v, lengths, scale)
    return reference_attention_with_lse(q, k, v, causal, scale)


dense_attention.calls = 0


def _repeat_kv(k, v, h):
    if k.shape[1] != h:
        group = h // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return k, v


def reference_attention(q, k, v, causal=False, scale=None):
    """Dense oracle; one implementation shared with the with-lse variant."""
    return reference_attention_with_lse(q, k, v, causal, scale)[0]


def reference_attention_with_lse(q, k, v, causal=False, scale=None):
    """Dense oracle returning (out, lse (B,H,S) f32). Rows with no valid
    key get out=0 and lse=-inf (the logsumexp of an empty set). GQA
    (fewer kv heads) repeats kv across each query group."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k, v = _repeat_kv(k, v, q.shape[1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, float("-inf"))
    return _masked_softmax_out(scores, v, "bhqk,bhkd->bhqd", q.dtype)


def reference_flash_attention_bwd(q, k, v, o, lse, do, glse=None,
                                  causal=False, scale=None):
    """Dense twin of the flash backward kernels: the same recompute
    formulas (p = exp(s - lse), delta = rowsum(dO * O) - glse,
    dS = p (dP - delta) scale) on whole (S, S) matrices. A row whose lse
    is not finite has no valid key: +inf (the kernel forward's sentinel)
    and -inf (the dense forward's) both give p = 0, never NaN. GQA sums
    each group's per-q-head dK/dV. Returns (dq, dk, dv) in f32."""
    b, h, s_len, d = q.shape
    h_kv = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kr, vr = _repeat_kv(k, v, h)
    qf, dof = q.float(), do.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kr.float()) * scale
    if causal:
        mask = torch.ones(s_len, s_len, dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    lse = lse.float()
    finite = torch.isfinite(lse)
    p = torch.exp(scores - torch.where(finite, lse, 0.0)[..., None])
    p = p.masked_fill(~finite[..., None], 0.0)
    delta = (dof * o.float()).sum(-1)
    if glse is not None:
        delta = delta - glse.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if h != h_kv:
        dk = dk.reshape(b, h_kv, h // h_kv, s_len, d).sum(2)
        dv = dv.reshape(b, h_kv, h // h_kv, s_len, d).sum(2)
    return dq, dk, dv


def _masked_softmax_out(scores, v, spec, dtype):
    """Softmax over the last axis with -inf entries as absent keys, then
    the weighted sum of v; returns (out, lse)."""
    neg = torch.isneginf(scores)
    m = scores.amax(dim=-1)
    safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - safe[..., None]).masked_fill(neg, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum(spec, p, v.float()) / l_safe[..., None]
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      safe + torch.log(l_safe))
    return out.to(dtype), lse


def reference_decode_attention(q, k, v, lengths, scale=None):
    """Dense decode-step oracle: q (B, H, D), k/v (B, H_kv, S, D) of
    which only the first ``lengths[b]`` positions are valid (the rest is
    stale pool memory). Returns (B, H, D); lengths == 0 gives zeros."""
    b, h, d = q.shape
    s = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    k, v = _repeat_kv(k, v, h)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * scale
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int64)
    valid = torch.arange(s, device=q.device)[None, None, :] \
        < lengths.reshape(b, 1, 1)
    scores = scores.masked_fill(~valid, float("-inf"))
    return _masked_softmax_out(scores, v, "bhs,bhsd->bhd", q.dtype)[0]


# -- kernel wrappers ----------------------------------------------------------

def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require(cond, what):
    if not cond:
        raise MXNetError(what)


def _check_head_dim(name, d):
    _require(kernel_head_dim(d),
             f"{name}: head dim {d} has no kernel (16, 32, 64 or a multiple "
             "of 128); flash_attention and decode_attention route it to "
             "dense_attention")
    _require(d <= MAX_HEAD_DIM,
             f"{name}: head dim {d} is above {MAX_HEAD_DIM}, the kernels' "
             "limit (the flash backward's registers)")


def _check_cuda_f32(name, *ts):
    for t in ts:
        _require(t.is_cuda, f"{name}: tensors must all be on the card")
        _require(t.dtype == torch.float32,
                 f"{name}: the kernel takes float32, got {t.dtype}")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        _require(t.device == ts[0].device,
                 f"{name}: tensors on different devices")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Flash forward: (out (B,H,S,D), lse (B,H,S) f32).

    Replaces the TPU kernel mxnet_tpu/ops/attention.py:_flash_kernel
    (launched by _flash_pallas). On the card, ``csrc/flash_attention.cu``
    (float32, head dim 16/32/64 or a multiple of 128 up to
    :data:`MAX_HEAD_DIM`, self-attention: S_q == S_k). On
    the CPU, :func:`reference_attention_with_lse`. The kernel writes ``+inf`` as
    the lse of a row with no valid key (the TPU kernel's sentinel); the
    dense oracle writes ``-inf``. Self-attention never has such a row."""
    if q.device.type == "cpu":
        return reference_attention_with_lse(q, k, v, causal, scale)
    b, h, s, d = q.shape
    _check_cuda_f32("flash_attention_fwd", q, k, v)
    h_kv = k.shape[1]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[2] == s
             and k.shape[3] == d, "flash_attention_fwd: k/v must be "
             f"(B, H_kv, S, D) matching q {tuple(q.shape)}, got "
             f"{tuple(k.shape)}")
    _require(h_kv > 0 and h % h_kv == 0,
             "flash_attention_fwd: H must be a multiple of H_kv")
    _check_head_dim("flash_attention_fwd", d)
    _require(0 < b * h <= 65535, "flash_attention_fwd: B*H out of range")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attention", "mxt_flash_fwd_f32",
                     *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 5,
                     ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p)
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, h, h_kv,
             s, d, float(scale), int(bool(causal)), q.device.index,
             _stream(q))
    flash_attention_fwd.launches += 1
    _build.check(err, "flash_attention", "flash_attention_fwd")
    return out, lse


flash_attention_fwd.launches = 0


def _check_bwd(name, q, k, v, o, lse, do, glse):
    b, h, s, d = q.shape
    _check_head_dim(name, d)
    _check_cuda_f32(name, q, k, v, o, lse, do,
                    *([] if glse is None else [glse]))
    h_kv = k.shape[1]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[2] == s
             and k.shape[3] == d and o.shape == q.shape
             and do.shape == q.shape, f"{name}: shapes q/o/do "
             f"{tuple(q.shape)}, k/v {tuple(k.shape)} do not match")
    _require(lse.shape == (b, h, s) and (glse is None
                                         or glse.shape == (b, h, s)),
             f"{name}: lse/glse must be (B, H, S)")
    _require(h_kv > 0 and h % h_kv == 0,
             f"{name}: H must be a multiple of H_kv")
    _require(0 < b * h <= 65535, f"{name}: B*H out of range")
    return b, h, h_kv, s, d


def _bwd_argtypes(n_out):
    """q, k, v, o, do, lse, glse, n_out outputs; B, H, H_kv, S, D; scale;
    causal, device; stream."""
    return (*[ctypes.c_void_p] * (7 + n_out), *[ctypes.c_int] * 5,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def flash_attention_bwd_dq(q, k, v, o, lse, do, glse=None, causal=False,
                           scale=None):
    """dQ of the flash backward on the card: (B, H, S, D) f32.

    Replaces the TPU kernel mxnet_tpu/ops/attention.py:
    _flash_bwd_dq_kernel (launched by _flash_pallas_bwd). Kernel:
    ``csrc/flash_attention_bwd.cu`` (float32, the forward's head dims);
    ``glse`` (B, H, S) or None is the lse output's cotangent."""
    b, h, h_kv, s, d = _check_bwd("flash_attention_bwd_dq", q, k, v, o, lse,
                                  do, glse)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dq = torch.empty_like(q)
    fn = _build.bind("flash_attention_bwd", "mxt_flash_bwd_dq_f32",
                     *_bwd_argtypes(1))
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
             None if glse is None else _ptr(glse), _ptr(dq), b, h, h_kv, s,
             d, float(scale), int(bool(causal)), q.device.index, _stream(q))
    flash_attention_bwd_dq.launches += 1
    _build.check(err, "flash_attention_bwd", "flash_attention_bwd_dq")
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, o, lse, do, glse=None, causal=False,
                            scale=None):
    """dK/dV of the flash backward on the card: (dk, dv), each
    (B, H, S, D) f32 — one partial per q head; the caller sums each GQA
    group. Replaces the TPU kernel mxnet_tpu/ops/attention.py:
    _flash_bwd_dkv_kernel (launched by _flash_pallas_bwd). Kernel:
    ``csrc/flash_attention_bwd.cu``."""
    b, h, h_kv, s, d = _check_bwd("flash_attention_bwd_dkv", q, k, v, o,
                                  lse, do, glse)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    fn = _build.bind("flash_attention_bwd", "mxt_flash_bwd_dkv_f32",
                     *_bwd_argtypes(2))
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
             None if glse is None else _ptr(glse), _ptr(dk), _ptr(dv), b, h,
             h_kv, s, d, float(scale), int(bool(causal)), q.device.index,
             _stream(q))
    flash_attention_bwd_dkv.launches += 1
    _build.check(err, "flash_attention_bwd", "flash_attention_bwd_dkv")
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, glse=None, causal=False,
                        scale=None):
    """Flash backward: (dq, dk, dv) from the saved (q, k, v, out, lse),
    the output cotangent ``do`` and, when lse is itself a differentiated
    output, its cotangent ``glse`` (None means zeros). On the card the dQ
    and dK/dV kernels (one launch each; GQA groups summed here); on the
    CPU :func:`reference_flash_attention_bwd`."""
    if q.device.type == "cpu":
        return reference_flash_attention_bwd(q, k, v, o, lse, do, glse,
                                             causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do, glse, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, glse, causal,
                                     scale)
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    if h != h_kv:
        dk = dk.reshape(b, h_kv, h // h_kv, s, d).sum(2)
        dv = dv.reshape(b, h_kv, h // h_kv, s, d).sum(2)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash forward (kernel on the card) saving q, k, v, out and lse;
    its backward is :func:`flash_attention_bwd`. Both outputs are
    differentiable: an lse cotangent reaches the kernels as ``glse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        glse = None if dlse is None else dlse.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, glse,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """(out, lse (B,H,S) f32), both differentiable (the lse cotangent
    folds into the backward's row term, as in the JAX package). A head
    dim no kernel takes goes to :func:`dense_attention`."""
    if not kernel_head_dim(q.shape[-1]):
        return dense_attention(q, k, v, causal, scale)
    return _FlashAttention.apply(q, k, v, bool(causal), scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention output, trainable: the prefill's call and the
    ``_contrib_flash_attention`` role in ``MultiHeadAttention``."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]


def decode_attention(q, k, v, lengths, scale=None):
    """Single-token decode attention against a length-masked KV pool.

    q (B, H, D); k/v (B, H_kv, S, D); lengths (B,) int32 valid-prefix
    lengths. Replaces the TPU kernel mxnet_tpu/ops/attention.py:
    _decode_kernel (launched by _decode_pallas). On the card,
    ``csrc/decode_attention.cu`` (float32, the forward's head dims, GQA
    group 1/2/4/8); on the CPU, :func:`reference_decode_attention`. A
    head dim no kernel takes goes to :func:`dense_attention`."""
    if not kernel_head_dim(q.shape[-1]):
        return dense_attention(q, k, v, scale=scale, lengths=lengths)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, lengths, scale)
    b, h, d = q.shape
    _check_cuda_f32("decode_attention", q, k, v)
    h_kv, s = k.shape[1], k.shape[2]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d,
             f"decode_attention: k/v {tuple(k.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(h_kv > 0 and h % h_kv == 0,
             "decode_attention: H must be a multiple of H_kv")
    _check_head_dim("decode_attention", d)
    _require(h // h_kv in _DECODE_GROUPS,
             f"decode_attention: GQA group {h // h_kv} not in "
             f"{_DECODE_GROUPS}")
    lengths = torch.as_tensor(lengths, device=q.device)
    _require(lengths.dtype == torch.int32 and lengths.shape == (b,)
             and lengths.is_contiguous(),
             "decode_attention: lengths must be a contiguous (B,) int32 "
             "tensor")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    fn = _build.bind("decode_attention", "mxt_decode_attention_f32",
                     *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 5,
                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(lengths), _ptr(out), b, h,
             h_kv, s, d, float(scale), q.device.index, _stream(q))
    decode_attention.launches += 1
    _build.check(err, "decode_attention", "decode_attention")
    return out


decode_attention.launches = 0
