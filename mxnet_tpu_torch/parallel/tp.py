"""Tensor and expert parallelism (counterpart of
mxnet_tpu/parallel/tp.py).

The JAX package's shard_map bodies run once a replica over per-replica
lists, their collectives the mesh's (``parallel/mesh.py``):

  - ``megatron_mlp``: a column-parallel first projection and a
    row-parallel second one over the ``tp`` axis, one ``psum`` on the
    block's output; the hidden activations never exist unsharded.
  - ``moe_ffn``: a top-1 switch mixture of experts with the experts split
    over the ``ep`` axis. Every replica runs its local experts over the
    whole token batch and masks the tokens routed elsewhere (dense
    dispatch), and a ``psum`` combines them.

Inputs and weights are whole tensors; each replica takes its shard, and
the result comes back on the mesh's first device. Autograd runs through
the shards and the ``psum``. No kernel of the port lies on these paths:
the products are PyTorch's.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .mesh import axis_size, psum, shard

__all__ = ["megatron_mlp", "moe_ffn", "moe_ffn_reference"]


def _replicate(x, mesh, n):
    return [x.to(d) for d in mesh.replicas[:n]]


def megatron_mlp(x, w1, b1, w2, b2, mesh, axis_name="tp"):
    """x (B, D); w1 (D, H) column-sharded; w2 (H, D_out) row-sharded.

    H must divide by the axis size. Returns (B, D_out)."""
    n = axis_size(mesh, axis_name)
    if w1.shape[1] != w2.shape[0]:
        raise MXNetError(
            f"megatron_mlp: w1 hidden dim {w1.shape[1]} != w2 input dim "
            f"{w2.shape[0]}")
    if w1.shape[1] % n != 0:
        raise MXNetError(
            f"megatron_mlp: hidden dim {w1.shape[1]} not divisible by "
            f"{axis_name}={n}")
    xs = _replicate(x, mesh, n)
    w1s = shard(w1, mesh, 1, axis_name)
    b1s = shard(b1, mesh, 0, axis_name)
    w2s = shard(w2, mesh, 0, axis_name)
    # the local hidden shard (column-parallel), its row-parallel partial
    partials = [torch.relu(xr @ w1r + b1r) @ w2r
                for xr, w1r, b1r, w2r in zip(xs, w1s, b1s, w2s)]
    return psum(partials)[0] + b2.to(mesh.replicas[0])


def moe_ffn_reference(x, gate_w, w1, w2):
    """Dense oracle: top-1 switch MoE over all experts."""
    logits = x @ gate_w                              # (B, E)
    choice = torch.argmax(logits, dim=1)             # (B,)
    gate = torch.softmax(logits, dim=1)
    gate_val = torch.gather(gate, 1, choice[:, None])
    h = torch.relu(torch.einsum("bd,edh->beh", x, w1))
    out = torch.einsum("beh,ehd->bed", h, w2)        # (B, E, D)
    picked = torch.gather(
        out, 1, choice[:, None, None].expand(-1, 1, out.shape[-1]))[:, 0]
    return picked * gate_val


def _moe_local(rank, x, gate_w, w1, w2, experts_per_dev):
    # routing is replicated arithmetic (gate_w replicated)
    logits = x @ gate_w
    choice = torch.argmax(logits, dim=1)
    gate = torch.softmax(logits, dim=1)
    gate_val = torch.gather(gate, 1, choice[:, None])
    # this replica's experts: ids [rank * epd, (rank + 1) * epd)
    local_ids = rank * experts_per_dev + torch.arange(experts_per_dev,
                                                      device=x.device)
    h = torch.relu(torch.einsum("bd,edh->beh", x, w1))
    out = torch.einsum("beh,ehd->bed", h, w2)        # (B, epd, D)
    routed = choice[:, None] == local_ids[None, :]   # (B, epd)
    return torch.einsum("bed,be->bd", out, routed.to(out.dtype)), gate_val


def moe_ffn(x, gate_w, w1, w2, mesh, axis_name="ep"):
    """Expert-parallel top-1 MoE FFN.

    x (B, D); gate_w (D, E) replicated; w1 (E, D, H) / w2 (E, H, D) split
    over the experts on ``axis_name`` (E % axis_size == 0)."""
    n = axis_size(mesh, axis_name)
    n_experts = w1.shape[0]
    if n_experts % n != 0:
        raise MXNetError(f"moe_ffn: {n_experts} experts not divisible by "
                         f"{axis_name}={n}")
    xs = _replicate(x, mesh, n)
    gs = _replicate(gate_w, mesh, n)
    w1s = shard(w1, mesh, 0, axis_name)
    w2s = shard(w2, mesh, 0, axis_name)
    res = [_moe_local(r, xs[r], gs[r], w1s[r], w2s[r],
                      n_experts // n) for r in range(n)]
    total = psum([loc for loc, _ in res])
    return total[0] * res[0][1]
