"""Attention operators: hand-written CUDA kernels and their plain versions.

Counterpart of mxnet_tpu/ops/attention.py. Two kernels, each beside the
plain PyTorch function it is held against:

* :func:`flash_attention_fwd` — causal / non-causal flash forward over
  q (B, H, S, D) and k/v (B, H_kv, S, D), returning out and the per-row
  logsumexp (B, H, S) f32. Kernel: ``csrc/flash_attention.cu``.
* :func:`decode_attention` — single-token (q_len = 1) attention over a
  length-masked KV pool. Kernel: ``csrc/decode_attention.cu``.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback between the two. The kernels take float32
only (the decode path keeps f32 params and caches). Each wrapper carries
an integer ``launches`` counter that is raised exactly where its kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..base import MXNetError

__all__ = ["reference_attention", "reference_attention_with_lse",
           "reference_decode_attention", "flash_attention",
           "flash_attention_fwd", "decode_attention"]

_HEAD_DIMS = (16, 32, 64, 128)
_DECODE_GROUPS = (1, 2, 4, 8)


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
    (float32, head dim 16/32/64/128, self-attention: S_q == S_k). On the CPU,
    :func:`reference_attention_with_lse`. The kernel writes ``+inf`` as
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
    _require(d in _HEAD_DIMS,
             f"flash_attention_fwd: head dim {d} not in {_HEAD_DIMS}")
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


def flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention output only (the prefill's call)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]


def decode_attention(q, k, v, lengths, scale=None):
    """Single-token decode attention against a length-masked KV pool.

    q (B, H, D); k/v (B, H_kv, S, D); lengths (B,) int32 valid-prefix
    lengths. Replaces the TPU kernel mxnet_tpu/ops/attention.py:
    _decode_kernel (launched by _decode_pallas). On the card,
    ``csrc/decode_attention.cu`` (float32, head dim 16/32/64/128, GQA
    group 1/2/4/8); on the CPU, :func:`reference_decode_attention`."""
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
    _require(d in _HEAD_DIMS,
             f"decode_attention: head dim {d} not in {_HEAD_DIMS}")
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
