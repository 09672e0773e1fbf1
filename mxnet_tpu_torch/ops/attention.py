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
  length-masked KV pool, split over the pool (flash-decoding,
  :func:`decode_plan`). Kernel: ``csrc/decode_attention.cu``.

:func:`flash_attention` and :func:`flash_attention_with_lse` are
trainable: ``_FlashAttention`` (a ``torch.autograd.Function``) saves q, k,
v, out and lse, and its backward is :func:`flash_attention_bwd`.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback between the two. The kernels take float32,
bfloat16 or float16 q/k/v (one type for all of them, and for o and dO),
as the JAX package's kernels keep the storage dtype: out and dq come back
in q's type, dk and dv in k's and v's, lse in float32. The flash forward
and dQ run their products on the tensor cores (bf16/f16: one mma a
product; f32: three TF32 pieces), decode too for bf16/f16 (f32 decode
takes f32 FMA products); dK/dV widens to f32 at load and rounds once at
store. Each wrapper carries an integer ``launches``
counter that is raised exactly where its kernel launches.

Head dims: the kernels take 16, 32, 64 and the multiples of 128 up to
:data:`MAX_HEAD_DIM` (:func:`kernel_head_dim` is the head-dim rule of the
JAX package's ``_pallas_eligible`` / ``_decode_eligible``, which take 64
and every multiple of 128). Any other head dim (80, 96, ...), and the
multiples of 128 above :data:`MAX_HEAD_DIM` (640, ...), are routed by
:func:`flash_attention`, :func:`flash_attention_with_lse` and
:func:`decode_attention` to :func:`dense_attention`, as the JAX package
sends the former to its XLA path. So is cross-attention (q's sequence
length differs from k's), as the JAX package's ``_pallas_eligible`` sends
it to its XLA path. The choice rests on the shapes alone and is made
before any launch. The raw kernel wrappers raise on all of these.
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
           "decode_attention", "decode_plan", "dense_attention",
           "kernel_head_dim", "MAX_HEAD_DIM"]

# Head dims up to 256 have a kernel instance each; above, the "wide"
# kernels loop over D in 128-column chunks and keep their accumulators in
# registers, which sets the ceiling (dK/dV spilled at D = 768).
MAX_HEAD_DIM = 512


def kernel_head_dim(d):
    """True when some kernel of this module takes head dim ``d``: 16, 32,
    64 or a multiple of 128 (the JAX package's rule, plus 16 and 32).
    Multiples of 128 above :data:`MAX_HEAD_DIM` pass this test and are
    refused by the kernel wrappers, naming the limit; the entry points
    send them to :func:`dense_attention` (:func:`_kernel_route`)."""
    return d in (16, 32, 64) or (d > 0 and d % 128 == 0)


def _kernel_route(d, s_q=None, s_k=None):
    """True when the entry points launch a kernel for head dim ``d`` (and,
    for the flash kernels, q and k of sequence lengths ``s_q`` and
    ``s_k``: self-attention only); else they take
    :func:`dense_attention`."""
    return kernel_head_dim(d) and d <= MAX_HEAD_DIM and s_q == s_k


def dense_attention(q, k, v, causal=False, scale=None, lengths=None):
    """The dense route for head dims no kernel takes and for
    cross-attention (S_q != S_k; causal masks bottom-right, as the JAX
    package's ``reference_attention_with_lse``): plain PyTorch ops,
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
    dS = p (dP - delta) scale) on whole (S_q, S_k) matrices, in f32. A
    row whose lse is not finite has no valid key: +inf (the kernel
    forward's sentinel) and -inf (the dense forward's) both give p = 0,
    never NaN. The causal mask is the forward's (bottom-right:
    ``tril(s_k - s_q)``). GQA sums each group's per-q-head dK/dV in f32.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kr, vr = _repeat_kv(k, v, h)
    qf, dof = q.float(), do.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kr.float()) * scale
    if causal:
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
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
        dk = dk.reshape(b, h_kv, h // h_kv, s_k, d).sum(2)
        dv = dv.reshape(b, h_kv, h // h_kv, s_k, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


# the element types of the attention kernels, by the C entries' codes
# (csrc/mxt_common.cuh: MXT_F32, MXT_BF16, MXT_F16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_cuda(name, ts, rows=()):
    """The card's checks of a launch: ``ts`` (q, k, v, and o, dO) on one
    card, contiguous, 16-byte aligned and of one type the kernels take,
    whose C code is returned; ``rows`` (lse, glse) float32 there."""
    dts = sorted({str(t.dtype) for t in ts})
    _require(len(dts) == 1, f"{name}: q, k, v (and o, do) must share one "
             f"dtype, got {', '.join(dts)}")
    _require(ts[0].dtype in _DTYPES, f"{name}: the kernels take float32, "
             f"bfloat16 or float16, got {ts[0].dtype}")
    for t in (*ts, *rows):
        _require(t.is_cuda, f"{name}: tensors must all be on the card")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        _require(t.device == ts[0].device,
                 f"{name}: tensors on different devices")
    for t in ts:
        _require(t.data_ptr() % 16 == 0,
                 f"{name}: tensors must start on 16 bytes")
    for t in rows:
        _require(t.dtype == torch.float32,
                 f"{name}: lse/glse must be float32, got {t.dtype}")
    return _DTYPES[ts[0].dtype]


def _check_self(name, q, k):
    _require(k.shape[2] == q.shape[2],
             f"{name}: k/v must be (B, H_kv, S, D) with q's S "
             f"{q.shape[2]}, got {tuple(k.shape)}; cross-attention "
             "(S_q != S_k) takes dense_attention through flash_attention")


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Flash forward: (out (B,H,S,D) in q's dtype, lse (B,H,S) f32).

    Replaces the TPU kernel mxnet_tpu/ops/attention.py:_flash_kernel
    (launched by _flash_pallas). On the card, ``csrc/flash_attention.cu``
    (float32, bfloat16 or float16; head dim 16/32/64 or a multiple of 128
    up to :data:`MAX_HEAD_DIM`; self-attention: S_q == S_k). On the CPU,
    :func:`reference_attention_with_lse`. The kernel writes ``+inf`` as
    the lse of a row with no valid key (the TPU kernel's sentinel); the
    dense oracle writes ``-inf``. Self-attention never has such a row."""
    if q.device.type == "cpu":
        return reference_attention_with_lse(q, k, v, causal, scale)
    b, h, s, d = q.shape
    code = _check_cuda("flash_attention_fwd", (q, k, v))
    h_kv = k.shape[1]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d,
             "flash_attention_fwd: k/v must be (B, H_kv, S, D) matching q "
             f"{tuple(q.shape)}, got {tuple(k.shape)}")
    _check_self("flash_attention_fwd", q, k)
    _require(h_kv > 0 and h % h_kv == 0,
             "flash_attention_fwd: H must be a multiple of H_kv")
    _check_head_dim("flash_attention_fwd", d)
    _require(0 < b * h <= 65535, "flash_attention_fwd: B*H out of range")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attention", "mxt_flash_fwd",
                     *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 5,
                     ctypes.c_float, *[ctypes.c_int] * 3, ctypes.c_void_p)
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, h, h_kv,
             s, d, float(scale), int(bool(causal)), code, q.device.index,
             _stream(q))
    flash_attention_fwd.launches += 1
    _build.check(err, "flash_attention", "flash_attention_fwd")
    return out, lse


flash_attention_fwd.launches = 0


def _check_bwd(name, q, k, v, o, lse, do, glse):
    b, h, s, d = q.shape
    _check_head_dim(name, d)
    code = _check_cuda(name, (q, k, v, o, do),
                       (lse,) if glse is None else (lse, glse))
    h_kv = k.shape[1]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d
             and o.shape == q.shape and do.shape == q.shape,
             f"{name}: shapes q/o/do {tuple(q.shape)}, k/v "
             f"{tuple(k.shape)} do not match")
    _check_self(name, q, k)
    _require(lse.shape == (b, h, s) and (glse is None
                                         or glse.shape == (b, h, s)),
             f"{name}: lse/glse must be (B, H, S)")
    _require(h_kv > 0 and h % h_kv == 0,
             f"{name}: H must be a multiple of H_kv")
    _require(0 < b * h <= 65535, f"{name}: B*H out of range")
    return b, h, h_kv, s, d, code


def _bwd_argtypes(n_out):
    """q, k, v, o, do, lse, glse, n_out outputs; B, H, H_kv, S, D; scale;
    causal, dtype, device; stream."""
    return (*[ctypes.c_void_p] * (7 + n_out), *[ctypes.c_int] * 5,
            ctypes.c_float, *[ctypes.c_int] * 3, ctypes.c_void_p)


def flash_attention_bwd_dq(q, k, v, o, lse, do, glse=None, causal=False,
                           scale=None):
    """dQ of the flash backward on the card: (B, H, S, D) in q's dtype.

    Replaces the TPU kernel mxnet_tpu/ops/attention.py:
    _flash_bwd_dq_kernel (launched by _flash_pallas_bwd). Kernel:
    ``csrc/flash_attention_bwd.cu`` (the forward's types and head dims);
    ``glse`` (B, H, S) f32 or None is the lse output's cotangent."""
    b, h, h_kv, s, d, code = _check_bwd("flash_attention_bwd_dq", q, k, v,
                                        o, lse, do, glse)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dq = torch.empty_like(q)
    fn = _build.bind("flash_attention_bwd", "mxt_flash_bwd_dq",
                     *_bwd_argtypes(1))
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
             None if glse is None else _ptr(glse), _ptr(dq), b, h, h_kv, s,
             d, float(scale), int(bool(causal)), code, q.device.index,
             _stream(q))
    flash_attention_bwd_dq.launches += 1
    _build.check(err, "flash_attention_bwd", "flash_attention_bwd_dq")
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, o, lse, do, glse=None, causal=False,
                            scale=None):
    """dK/dV of the flash backward on the card: (dk, dv), each
    (B, H, S, D) float32, whatever the inputs' type — one partial per q
    head; the caller sums each GQA group in f32 and rounds once to k's
    and v's dtypes (:func:`flash_attention_bwd`). Replaces the TPU kernel
    mxnet_tpu/ops/attention.py:_flash_bwd_dkv_kernel (launched by
    _flash_pallas_bwd). Kernel: ``csrc/flash_attention_bwd.cu``."""
    b, h, h_kv, s, d, code = _check_bwd("flash_attention_bwd_dkv", q, k, v,
                                        o, lse, do, glse)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attention_bwd", "mxt_flash_bwd_dkv",
                     *_bwd_argtypes(2))
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
             None if glse is None else _ptr(glse), _ptr(dk), _ptr(dv), b, h,
             h_kv, s, d, float(scale), int(bool(causal)), code,
             q.device.index, _stream(q))
    flash_attention_bwd_dkv.launches += 1
    _build.check(err, "flash_attention_bwd", "flash_attention_bwd_dkv")
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, glse=None, causal=False,
                        scale=None):
    """Flash backward: (dq, dk, dv) from the saved (q, k, v, out, lse),
    the output cotangent ``do`` and, when lse is itself a differentiated
    output, its cotangent ``glse`` (None means zeros). On the card the dQ
    and dK/dV kernels (one launch each; GQA groups summed here in f32);
    on the CPU :func:`reference_flash_attention_bwd`. dq, dk, dv come back
    in q's, k's and v's dtypes."""
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
    return dq, dk.to(k.dtype), dv.to(v.dtype)


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
    dim no kernel takes, one above :data:`MAX_HEAD_DIM`, and
    cross-attention (S_q != S_k) go to :func:`dense_attention`."""
    if not _kernel_route(q.shape[-1], q.shape[2], k.shape[2]):
        return dense_attention(q, k, v, causal, scale)
    return _FlashAttention.apply(q, k, v, bool(causal), scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """Blockwise attention output, trainable: the prefill's call and the
    ``_contrib_flash_attention`` role in ``MultiHeadAttention``."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]


# decode attention's split-KV plan (csrc/decode_attention.cu): a block
# takes up to 16 q heads of a GQA group and one split of the pool, whose
# keys are a multiple of 128. A grid whose (slot, kv head, tile) blocks
# fill DECODE_FULL of a wave of the card's SMs by themselves (8 slots of
# MHA at 16 heads: 128 blocks) is not split: splitting it adds only blocks
# that exit or merge, and the GPT-2-medium decode step ran slower so on
# the H100. A smaller grid takes splits (at most DECODE_MAX_SPLITS) for
# about DECODE_WAVES waves
DECODE_ROWS = 16
DECODE_SPLIT_KEYS = 128
DECODE_WAVES = 4
DECODE_FULL = 0.75
DECODE_MAX_SPLITS = 128
_SMS = {}
_ARRIVALS = {}


def decode_plan(b, h, h_kv, s, sms=132):
    """(tiles, splits, chunk) of the decode kernel for q (b, h, D) over a
    pool of ``s`` positions and ``h_kv`` kv heads: ``tiles`` blocks of up
    to :data:`DECODE_ROWS` q heads per (slot, kv head), ``splits`` blocks
    of ``chunk`` keys (a multiple of :data:`DECODE_SPLIT_KEYS`) per tile,
    ``splits * chunk >= s``: one split where ``b * h_kv * tiles`` fills
    :data:`DECODE_FULL` of ``sms``, else about :data:`DECODE_WAVES` waves
    of them. It rests on the shapes and the card's SM count alone, never
    on the lengths (which lie on the card: reading them would stall the
    serving step)."""
    tiles = -(-(h // h_kv) // DECODE_ROWS)
    blocks = max(1, b * h_kv * tiles)
    want = 1 if blocks >= DECODE_FULL * sms \
        else -(-DECODE_WAVES * sms // blocks)
    splits = max(1, min(want, -(-s // DECODE_SPLIT_KEYS),
                        DECODE_MAX_SPLITS))
    per = -(-s // splits)                     # keys a split, then rounded up
    chunk = max(1, -(-per // DECODE_SPLIT_KEYS)) * DECODE_SPLIT_KEYS
    return tiles, max(1, -(-s // chunk)), chunk


def _sm_count(device):
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _arrivals(device, stream, n):
    """At least ``n`` zeroed int32 arrival counters of the split decode
    kernel (one a slot, kv head and q-head tile) for calls on ``stream``:
    the block that arrives last sets its counter back to 0, so they stay
    zero between calls, which run in order on one stream."""
    key = (device.index, stream.value)
    t = _ARRIVALS.get(key)
    if t is None or t.numel() < n:
        t = _ARRIVALS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=device)
    return t


def decode_attention(q, k, v, lengths, scale=None):
    """Single-token decode attention against a length-masked KV pool.

    q (B, H, D); k/v (B, H_kv, S, D); lengths (B,) int32 valid-prefix
    lengths (clamped to [0, S]). Replaces the TPU kernel
    mxnet_tpu/ops/attention.py:_decode_kernel (launched by
    _decode_pallas). On the card, ``csrc/decode_attention.cu`` (float32,
    bfloat16 or float16 q and caches, out in q's dtype; the forward's head
    dims; any GQA group that divides H), split over the pool as
    :func:`decode_plan` says, in one launch: where a slot's keys span more
    than one split, its splits write f32 partials (scratch allocated here)
    and the last block of each (slot, kv head, q-head tile) to arrive
    merges them in split order; splits past a slot's length exit at once.
    ``launches`` counts calls. On the CPU,
    :func:`reference_decode_attention`. A head dim no kernel takes, or one
    above :data:`MAX_HEAD_DIM`, goes to :func:`dense_attention`."""
    if not _kernel_route(q.shape[-1]):
        return dense_attention(q, k, v, scale=scale, lengths=lengths)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k, v, lengths, scale)
    b, h, d = q.shape
    code = _check_cuda("decode_attention", (q, k, v))
    h_kv, s = k.shape[1], k.shape[2]
    _require(k.shape == v.shape and k.shape[0] == b and k.shape[3] == d,
             f"decode_attention: k/v {tuple(k.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(h_kv > 0 and h % h_kv == 0,
             "decode_attention: H must be a multiple of H_kv")
    _check_head_dim("decode_attention", d)
    lengths = torch.as_tensor(lengths, device=q.device)
    _require(lengths.dtype == torch.int32 and lengths.shape == (b,)
             and lengths.is_contiguous(),
             "decode_attention: lengths must be a contiguous (B,) int32 "
             "tensor")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    tiles, splits, chunk = decode_plan(b, h, h_kv, s, _sm_count(q.device))
    out = torch.empty_like(q)
    stream = _stream(q)
    pm = pl = pacc = count = None
    if splits > 1:
        rows = b * h * splits
        part = torch.empty(rows * (d + 2), dtype=torch.float32,
                           device=q.device)
        pacc, pm, pl = part[:rows * d], part[rows * d:rows * (d + 1)], \
            part[rows * (d + 1):]
        count = _arrivals(q.device, stream, b * h_kv * tiles)
    fn = _build.bind("decode_attention", "mxt_decode_attention",
                     *[ctypes.c_void_p] * 9, *[ctypes.c_int] * 7,
                     ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p)
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(lengths), _ptr(out),
             *(None if t is None else _ptr(t)
               for t in (pm, pl, pacc, count)),
             b, h, h_kv, s, d, chunk, splits, float(scale), code,
             q.device.index, stream)
    decode_attention.launches += 1
    _build.check(err, "decode_attention", "decode_attention")
    return out


decode_attention.launches = 0
