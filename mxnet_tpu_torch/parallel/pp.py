"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis
(counterpart of mxnet_tpu/parallel/pp.py).

Each replica on the ``pp`` axis owns one stage's weights. Activations
move stage to stage by ``ppermute`` while microbatches stream in: after
the n - 1 ticks of the fill every stage computes at once, and the
schedule runs ``n_micro + n - 1`` ticks (the JAX package's fill and
drain). The last stage retires its outputs and a ``psum`` shares them.
The body runs once a replica per tick over per-replica lists
(``parallel/mesh.py``); gradients come from autograd through the ticks,
which replays the communication in reverse. No kernel of the port lies on
this path.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .mesh import axis_size, ppermute, psum, shard

__all__ = ["pipeline_mlp", "pipeline_reference"]


def pipeline_reference(x_micro, w_stack, b_stack):
    """Oracle: every microbatch through all stages in turn.
    x_micro (M, B, D); w_stack (S, D, D); b_stack (S, D)."""
    x = x_micro
    for s in range(w_stack.shape[0]):
        x = torch.relu(x @ w_stack[s] + b_stack[s])
    return x


def pipeline_mlp(x_micro, w_stack, b_stack, mesh, axis_name="pp"):
    """Pipelined stack of relu-Dense stages.

    x_micro (M, B, D) microbatches (replicated); w_stack (S, D, D) /
    b_stack (S, D) with S == the axis size: stage s lives on replica s.
    Returns (M, B, D) on the mesh's first device."""
    n = axis_size(mesh, axis_name)
    if w_stack.shape[0] != n:
        raise MXNetError(
            f"pipeline_mlp: {w_stack.shape[0]} stages but {axis_name} axis "
            f"has {n} devices (one stage per device)")
    n_micro = x_micro.shape[0]
    devs = mesh.replicas[:n]
    ws = [w[0] for w in shard(w_stack, mesh, 0, axis_name)]
    bs = [b[0] for b in shard(b_stack, mesh, 0, axis_name)]
    xs = [x_micro.to(d) for d in devs]
    fwd_perm = [(i, i + 1) for i in range(n - 1)]     # stage s -> s + 1
    ys = [torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype, device=d)
          for d in devs]
    retired = [None] * n_micro
    for t in range(n_micro + n - 1):
        # the previous tick's activations shipped down the pipe
        shifted = ppermute(ys, fwd_perm)
        for r in range(n):
            if r == 0:
                # stage 0 injects microbatch t (zeros once drained)
                inj = xs[r][t] if t < n_micro else torch.zeros_like(xs[r][0])
            else:
                inj = shifted[r]
            ys[r] = torch.relu(inj @ ws[r] + bs[r])
        if t >= n - 1:
            # the last stage retires microbatch t - (n - 1)
            retired[t - (n - 1)] = ys[n - 1]
    # only the last stage holds outputs: zeros elsewhere, the psum shares
    outs = [torch.stack(retired) if r == n - 1
            else torch.zeros_like(xs[r]) for r in range(n)]
    return psum(outs)[0]
