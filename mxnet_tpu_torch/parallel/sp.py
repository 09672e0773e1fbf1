"""Sequence parallelism: ring attention and Ulysses all-to-all
(counterpart of mxnet_tpu/parallel/sp.py).

The sequence axis of q/k/v (B, H, S, D) is split over a mesh axis, one
shard a replica, and the shard_map bodies of the JAX package run once a
replica over per-replica lists, their collectives the mesh's
(``parallel/mesh.py``: ``ppermute``, ``all_to_all``):

  - ``ring_attention``: Q stays, K/V blocks rotate around the ring
    (``ppermute``), per-block results merge by an online softmax, so no
    replica holds the (S, S) scores. ``impl="flash"`` (picked on a CUDA
    mesh) runs the flash kernels (``ops/attention.py``) on every (Q, K/V
    block) pair, keeps each block's lse and merges by ``logaddexp``; the
    merge is differentiated through the lse, so the backward kernels get
    a non-zero lse cotangent (``glse``). ``impl="dense"`` (picked on the
    host) is the blockwise online-softmax body in float32.
  - ``ulysses_attention``: ``all_to_all`` moves the split from sequence to
    heads, each replica attends over the whole sequence for its heads
    (``flash_attention``: the kernels on the card), and a second
    ``all_to_all`` moves it back.

Both take and return whole tensors on the mesh's first device; autograd
runs through the shards and the collectives. On the card every block is
a launch of its own (n^2 forward, dQ and dK/dV launches a ring step; the
blocks from higher ranks are computed and merged with lse = -inf, as in
the JAX body).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import attention as _attn
from .mesh import all_to_all, axis_size, ppermute, shard

__all__ = ["attention_reference", "ring_attention", "ulysses_attention"]


def attention_reference(q, k, v, causal=False, scale=None):
    """Dense scaled-dot-product attention: the one oracle shared with the
    flash wrappers (``ops.attention.reference_attention``)."""
    return _attn.reference_attention(q, k, v, causal=causal, scale=scale)


def _block_attend(q, k, v, acc, m, l, mask=None, scale=1.0):
    """One online-softmax accumulation step: q (B,H,Sq,D) against a K/V
    block (B,H,Sk,D), carrying acc (the unnormalised numerator), m (the
    running max) and l (the running denominator)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    m_blk = scores.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    # a row masked so far contributes nothing (exp(-inf - -inf) guarded)
    safe_m = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(scores - safe_m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    correction = torch.exp(
        torch.where(torch.isneginf(m), torch.zeros_like(m), m) - safe_m)
    correction = torch.where(torch.isneginf(m), torch.zeros_like(m),
                             correction)
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction[..., None] + \
        torch.einsum("bhqk,bhkd->bhqd", p, v)
    return acc_new, m_new, l_new


def _ring_perm(n):
    """Each replica sends to the next: at step s replica r holds the K/V
    block of replica (r - s) mod n."""
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_dense(qs, ks, vs, causal, scale):
    """The dense ring body over the replicas: Q stays, K/V rotate, the
    online softmax runs in float32 with causal positions by rank."""
    n = len(qs)
    b, h, s_loc, d = qs[0].shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    accs = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    ms = [torch.full_like(q[..., 0], float("-inf"), dtype=torch.float32)
          for q in qs]
    ls = [torch.zeros_like(q[..., 0], dtype=torch.float32) for q in qs]
    for step in range(n):
        for r in range(n):
            mask = None
            if causal:
                src = (r - step) % n             # owner of this K/V block
                dev = qs[r].device
                q_pos = r * s_loc + torch.arange(s_loc, device=dev)
                k_pos = src * s_loc + torch.arange(s_loc, device=dev)
                mask = (q_pos[:, None] >= k_pos[None, :]).expand(
                    b, h, s_loc, s_loc)
            accs[r], ms[r], ls[r] = _block_attend(
                qs[r].float(), ks[r].float(), vs[r].float(), accs[r],
                ms[r], ls[r], mask, scale)
        if step < n - 1:
            # the last step's rotation would be discarded: skipped
            ks = ppermute(ks, _ring_perm(n))
            vs = ppermute(vs, _ring_perm(n))
    return [(acc / torch.where(l == 0, torch.ones_like(l), l)[..., None])
            .to(q.dtype) for acc, l, q in zip(accs, ls, qs)]


def _merge(o, lse, o_i, lse_i):
    """The logsumexp merge of a block's normalised output into the
    running one."""
    lse_new = torch.logaddexp(lse, lse_i)
    safe = torch.where(torch.isneginf(lse_new), torch.zeros_like(lse_new),
                       lse_new)
    o = o * torch.exp(lse - safe)[..., None] \
        + o_i.to(torch.float32) * torch.exp(lse_i - safe)[..., None]
    return o, lse_new


def _ring_flash(qs, ks, vs, causal, scale):
    """The flash ring body: every (Q, K/V block) pair is one call of
    ``flash_attention_with_lse`` (the kernels on the card). The resident
    diagonal pair is causal; with ``causal`` a block from a higher rank is
    merged with lse = -inf (weight zero), masked after the call, so no
    call ever sees a row without keys (the kernel's empty-row lse is +inf,
    the plain version's -inf: neither reaches the merge)."""
    n = len(qs)
    d = qs[0].shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    os_ = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    lses = [torch.full_like(q[..., 0], float("-inf"), dtype=torch.float32)
            for q in qs]
    for step in range(n):
        for r in range(n):
            diag = causal and step == 0
            o_i, lse_i = _attn.flash_attention_with_lse(
                qs[r], ks[r], vs[r], causal=diag, scale=scale)
            if causal and step > 0:
                src = (r - step) % n             # owner of this K/V block
                if not src < r:
                    lse_i = torch.full_like(lse_i, float("-inf"))
            os_[r], lses[r] = _merge(os_[r], lses[r], o_i, lse_i)
        if step < n - 1:
            ks = ppermute(ks, _ring_perm(n))
            vs = ppermute(vs, _ring_perm(n))
    return [o.to(q.dtype) for o, q in zip(os_, qs)]


def _auto_impl(mesh):
    """flash on a CUDA mesh (the kernels), dense on the host."""
    return "flash" if mesh.replicas[0].type == "cuda" else "dense"


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False, scale=None,
                   impl=None):
    """Sequence-sharded attention over ``mesh[axis_name]``.

    q/k/v: (B, H, S, D) with S divisible by the axis size; returns the
    attention output (B, H, S, D) on the mesh's first device.

    impl: None (auto: 'flash' on a CUDA mesh, 'dense' on the host) |
    'dense' | 'flash'. 'flash' runs the flash forward and backward
    kernels on every (Q, K/V block) pair and merges the blocks by their
    lse; on the host the same calls take the kernels' plain versions."""
    nsp = axis_size(mesh, axis_name)
    if q.shape[2] % nsp != 0:
        raise MXNetError(
            f"ring_attention: sequence {q.shape[2]} not divisible by "
            f"{axis_name}={nsp}")
    if impl is None:
        impl = _auto_impl(mesh)
    if impl == "dense":
        body = _ring_dense
    elif impl == "flash":
        body = _ring_flash
    else:
        raise MXNetError(f"ring_attention: unknown impl {impl!r}")
    qs, ks, vs = (shard(x, mesh, 2, axis_name) for x in (q, k, v))
    outs = body(qs, ks, vs, causal, scale)
    dev0 = mesh.replicas[0]
    return torch.cat([o.to(dev0) for o in outs], dim=2)


def ulysses_attention(q, k, v, mesh, axis_name="sp", causal=False,
                      scale=None):
    """DeepSpeed-Ulysses sequence parallelism: all-to-all swaps the split
    axis from sequence to heads, each replica attends over the full
    sequence for its head group (``flash_attention``: the kernels on the
    card), and a second all-to-all restores the sequence split. Requires
    heads % axis_size == 0."""
    nsp = axis_size(mesh, axis_name)
    if q.shape[1] % nsp != 0:
        raise MXNetError(
            f"ulysses_attention: heads {q.shape[1]} not divisible by "
            f"{axis_name}={nsp}")
    if q.shape[2] % nsp != 0:
        raise MXNetError(
            f"ulysses_attention: sequence {q.shape[2]} not divisible by "
            f"{axis_name}={nsp}")
    # local (B, H, S/n, D) -> (B, H/n, S, D) and back
    qh, kh, vh = (all_to_all(shard(x, mesh, 2, axis_name), split_axis=1,
                             concat_axis=2) for x in (q, k, v))
    outs = [_attn.flash_attention(a, b_, c, causal=causal, scale=scale)
            for a, b_, c in zip(qh, kh, vh)]
    outs = all_to_all(outs, split_axis=2, concat_axis=1)
    dev0 = mesh.replicas[0]
    return torch.cat([o.to(dev0) for o in outs], dim=2)
