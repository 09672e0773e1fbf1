"""Gather/scatter sparse compute (counterpart of
mxnet_tpu/ops/sparse_ops.py): the ELL layout of a CSR matrix and its two
products, the static-shape dedup and segment sum of row ids, and the lazy
row updates of SGD, SGD with momentum and Adam.

Plain PyTorch, as the JAX module is plain XLA. Every function keeps its
shapes static and reads nothing back to the host, so a training step
built from them never waits on the card:

  - ``unique_rows`` sorts and numbers the ids instead of calling
    ``torch.unique`` (whose size depends on the data, a host read);
  - out-of-range rows are handled by construction, never by a boolean
    compaction (a host read) and never by an out-of-range index (a
    device-side assert that ends the process's CUDA context): reads
    clamp the index, writes go to a trash row one past the rows;
  - sums of duplicate rows (:func:`accumulate_rows_`) add each row's
    terms in their input order, on the card and on the host alike, so a
    step repeats bit for bit: on the card an accumulating index_put,
    which sorts the indices (stable) and sums each run in order (the
    atomics of ``index_add_`` would not repeat), in ATen's unchecked
    form (the public ``index_put_`` reads the indices' min and max back
    to the host; these are in range by construction); on the host
    ``index_add_``, which adds index by index (the host's accumulating
    index_put adds with atomics across threads past 32k elements).

The ``rows_*`` updates come in two forms. ``rows_*_update`` returns new
tensors, as the JAX functions do (the weight is copied once, with a
trash row). ``rows_*_update_`` updates in place tensors that already
carry the trash row as their last row; the embedding trainer keeps its
table and its moments so, and copies nothing.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["ell_from_csr", "ell_dot", "ell_dot_t", "unique_rows",
           "accumulate_rows_", "segment_sum_rows", "take_rows",
           "rows_sgd_update",
           "rows_sgd_mom_update", "rows_adam_update", "rows_sgd_update_",
           "rows_sgd_mom_update_", "rows_adam_update_", "sgd_rows_math",
           "sgd_mom_rows_math", "adam_rows_math"]


def ell_from_csr(data, indices, indptr, pad_to_multiple=8,
                 num_features=None):
    """Host-side CSR -> ELL conversion (numpy, vectorized): ``(val (R, K),
    idx (R, K), counts (R,))`` with K the largest row's nnz rounded up to
    ``pad_to_multiple``; ``counts`` keeps the exact nnz structure. With
    ``num_features`` the column indices are bounds-checked here: the
    device gathers downstream clamp instead of raising."""
    data = _np.asarray(data)
    indices = _np.asarray(indices, dtype=_np.int32)
    indptr = _np.asarray(indptr, dtype=_np.int64)
    if len(indices) and (int(indices.min()) < 0 or (
            num_features is not None
            and int(indices.max()) >= num_features)):
        raise ValueError(
            f"ell_from_csr: column index out of range [0, {num_features}) "
            f"(got min {int(indices.min())}, max {int(indices.max())})")
    rows = len(indptr) - 1
    counts = _np.diff(indptr).astype(_np.int32)
    k = int(counts.max()) if rows else 0
    k = max(1, -(-k // pad_to_multiple) * pad_to_multiple)
    val = _np.zeros((rows, k), dtype=data.dtype)
    idx = _np.zeros((rows, k), dtype=_np.int32)
    nnz = len(data)
    if nnz:
        row_of = _np.repeat(_np.arange(rows), counts)
        slot = _np.arange(nnz) - _np.repeat(indptr[:-1], counts)
        val[row_of, slot] = data
        idx[row_of, slot] = indices
    return val, idx, counts


def _check_host_idx(idx, limit, what):
    if isinstance(idx, _np.ndarray) and idx.size and \
            int(idx.max()) >= limit:
        raise ValueError(f"{what}: column index {int(idx.max())} out of "
                         f"range for {limit} rows")


def accumulate_rows_(out, idx, vals):
    """``out[idx[i]] += vals[i]`` in place, each row's terms summed in
    input order; ``idx`` (int64) must lie in [0, len(out)): on the card
    it is not checked (that check is a host read)."""
    if out.device.type == "cpu":
        return out.index_add_(0, idx, vals)
    return torch.ops.aten._index_put_impl_(out, (idx,), vals, True, True)


def ell_dot(val, idx, weight):
    """dot(csr, dense): ``out[r] = sum_j val[r, j] * weight[idx[r, j]]``
    (padding has val 0). out (R, M)."""
    _check_host_idx(idx, weight.shape[0], "ell_dot")
    idx = torch.as_tensor(idx, device=weight.device).long()
    val = torch.as_tensor(val, device=weight.device).to(weight.dtype)
    gathered = weight.index_select(0, idx.reshape(-1)) \
        .reshape(idx.shape + weight.shape[1:])               # (R, K, M)
    return torch.einsum("rk,rkm->rm", val, gathered)


def ell_dot_t(val, idx, dense, num_features):
    """dot(csr.T, dense): ``out[f] += val[r, j] * dense[r]`` over the
    entries with ``idx[r, j] == f``. out (F, M), one ordered scatter-add."""
    _check_host_idx(idx, num_features, "ell_dot_t")
    idx = torch.as_tensor(idx, device=dense.device).long()
    val = torch.as_tensor(val, device=dense.device).to(dense.dtype)
    r, k = val.shape
    contrib = val[..., None] * dense[:, None, :]              # (R, K, M)
    out = dense.new_zeros((num_features, dense.shape[1]))
    return accumulate_rows_(out, idx.reshape(-1), contrib.reshape(r * k, -1))


def unique_rows(ids, size, fill):
    """Static-shape dedup of a flat int row-id vector, as
    ``jnp.unique(ids, size=size, fill_value=fill, return_inverse=True)``:
    ``(uniq (size,), inv (len(ids),), count)``. ``uniq`` is sorted and
    padded with ``fill`` (one past the valid ids); ``inv`` maps each
    position to its slot (slots past ``size`` when there are more unique
    ids than slots: the smallest are kept); ``count`` is the number of
    live slots, a device scalar. int32 throughout; no host read."""
    ids = torch.as_tensor(ids).reshape(-1).to(torch.int32)
    n = ids.numel()
    srt, perm = torch.sort(ids, stable=True)
    new = torch.ones_like(srt, dtype=torch.int32)
    if n > 1:
        new[1:] = (srt[1:] != srt[:-1]).to(torch.int32)
    slot = torch.cumsum(new, 0, dtype=torch.int32) - 1
    # slots past `size` land in a trash entry, dropped by the slice
    buf = ids.new_full((size + 1,), int(fill))
    buf.index_copy_(0, slot.clamp(max=size).long(), srt)
    uniq = buf[:size]
    inv = torch.empty_like(slot)
    inv.index_copy_(0, perm, slot)
    count = (uniq != int(fill)).sum(dtype=torch.int32)
    return uniq, inv, count


def segment_sum_rows(vals, inv, num_segments):
    """``out[inv[i]] += vals[i]`` into zeros (num_segments, ...): each
    segment's terms summed in input order; an ``inv`` outside the
    segments is dropped. Each dropped entry gets a trash row of its own:
    the card sums a row's terms one after another, so one trash row for
    thousands of dropped entries (a unique list's slack) would be one
    long serial sum."""
    vals = torch.as_tensor(vals)
    inv = torch.as_tensor(inv, device=vals.device).reshape(-1).long()
    n = inv.numel()
    out = vals.new_zeros((num_segments + n,) + tuple(vals.shape[1:]))
    keep = (inv >= 0) & (inv < num_segments)
    spare = torch.arange(num_segments, num_segments + n, device=inv.device)
    accumulate_rows_(out, torch.where(keep, inv, spare), vals)
    return out[:num_segments]


class _TakeRows(torch.autograd.Function):
    """``rows[inv]`` whose backward sums each row's cotangents with
    :func:`accumulate_rows_` (ordered, repeatable on the card), where
    ``index_select``'s backward would use atomics."""

    @staticmethod
    def forward(ctx, rows, inv):
        ctx.save_for_backward(inv)
        ctx.n = rows.shape[0]
        return rows.index_select(0, inv)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        out = g.new_zeros((ctx.n,) + tuple(g.shape[1:]))
        return accumulate_rows_(out, inv, g), None


def take_rows(rows, inv):
    """``jnp.take(rows, inv, axis=0)`` (mode "fill"): rows of ``inv``,
    NaN where ``inv`` is past the rows (an over-cap slot of
    :func:`unique_rows`), with a repeatable backward."""
    n = rows.shape[0]
    inv = inv.long()
    out = _TakeRows.apply(rows, inv.clamp(0, n - 1))
    return torch.where((inv < n)[:, None], out, float("nan"))


# -- the lazy row updates -----------------------------------------------------
# Reads clamp an out-of-range row (its values feed math whose result is
# dropped); writes of out-of-range rows go to the trash row. `rows` must
# be unique among in-range entries (the row_sparse invariant). The math
# is shared with the dense paths (the trainer's dense exchange and its
# MLP apply it to whole tensors), so every mode computes a row alike.


def _prep_sgd(g, rescale_grad, clip_gradient):
    g = g.to(torch.float32) * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def sgd_rows_math(w_rows, g, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """The SGD increment of rows: rescale, clip, then the decay."""
    g = _prep_sgd(g, rescale_grad, clip_gradient)
    return -lr * (g + wd * w_rows.to(torch.float32))


def sgd_mom_rows_math(w_rows, m_rows, g, lr, momentum, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """The new momentum of rows (also the weight's increment)."""
    g = _prep_sgd(g, rescale_grad, clip_gradient)
    return momentum * m_rows.to(torch.float32) \
        - lr * (g + wd * w_rows.to(torch.float32))


def adam_rows_math(w_rows, m_rows, v_rows, g, lr, beta1, beta2, epsilon,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """(increment, new mean, new var) of rows: rescale, + wd * w, clip
    (the Adam family's order). ``lr`` may be a device scalar."""
    g = g.to(torch.float32) * rescale_grad + wd * w_rows.to(torch.float32)
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    m_new = beta1 * m_rows.to(torch.float32) + (1 - beta1) * g
    v_new = beta2 * v_rows.to(torch.float32) + (1 - beta2) * g * g
    step = -lr * m_new / (torch.sqrt(v_new) + epsilon)
    return step, m_new, v_new


def _read(t, rows):
    return t[:-1].index_select(0, rows.clamp(0, t.shape[0] - 2))


def _write_index(t, rows):
    n = t.shape[0] - 1
    return torch.where((rows >= 0) & (rows < n), rows, n)


def rows_sgd_update_(weight, rows, grad_rows, lr, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """In place on ``weight`` (n + 1 rows, the last the trash row)."""
    rows = rows.long()
    upd = sgd_rows_math(_read(weight, rows), grad_rows, lr, wd,
                        rescale_grad, clip_gradient)
    weight.index_add_(0, _write_index(weight, rows), upd.to(weight.dtype))
    return weight


def rows_sgd_mom_update_(weight, mom, rows, grad_rows, lr, momentum,
                         wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """In place on ``weight`` and ``mom`` (each with a trash row)."""
    rows = rows.long()
    m_new = sgd_mom_rows_math(_read(weight, rows), _read(mom, rows),
                              grad_rows, lr, momentum, wd, rescale_grad,
                              clip_gradient)
    at = _write_index(weight, rows)
    weight.index_add_(0, at, m_new.to(weight.dtype))
    mom.index_copy_(0, at, m_new.to(mom.dtype))
    return weight, mom


def rows_adam_update_(weight, mean, var, rows, grad_rows, lr, beta1, beta2,
                      epsilon, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """In place on ``weight``, ``mean`` and ``var`` (each with a trash
    row); moments decay only on the listed rows."""
    rows = rows.long()
    step, m_new, v_new = adam_rows_math(
        _read(weight, rows), _read(mean, rows), _read(var, rows), grad_rows,
        lr, beta1, beta2, epsilon, wd, rescale_grad, clip_gradient)
    at = _write_index(weight, rows)
    weight.index_add_(0, at, step.to(weight.dtype))
    mean.index_copy_(0, at, m_new.to(mean.dtype))
    var.index_copy_(0, at, v_new.to(var.dtype))
    return weight, mean, var


def _with_trash(t):
    t = torch.as_tensor(t)
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _rows_on(rows, like):
    return torch.as_tensor(rows, device=like.device)


def rows_sgd_update(weight, rows, grad_rows, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    """Row-sparse SGD: only the listed rows move (untouched rows skip
    the decay too); out-of-range rows are dropped. A new weight."""
    w = _with_trash(weight)
    rows_sgd_update_(w, _rows_on(rows, w), torch.as_tensor(grad_rows), lr,
                     wd, rescale_grad, clip_gradient)
    return w[:-1]


def rows_sgd_mom_update(weight, mom, rows, grad_rows, lr, momentum,
                        wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Row-sparse SGD with momentum: the momentum decays only on the
    listed rows. New (weight, mom)."""
    w, m = _with_trash(weight), _with_trash(mom)
    rows_sgd_mom_update_(w, m, _rows_on(rows, w), torch.as_tensor(grad_rows),
                         lr, momentum, wd, rescale_grad, clip_gradient)
    return w[:-1], m[:-1]


def rows_adam_update(weight, mean, var, rows, grad_rows, lr, beta1, beta2,
                     epsilon, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Row-sparse (lazy) Adam: the moments decay only on the listed rows;
    the decay folds into the gradient before the clip. New (weight,
    mean, var)."""
    w, m, v = _with_trash(weight), _with_trash(mean), _with_trash(var)
    rows_adam_update_(w, m, v, _rows_on(rows, w), torch.as_tensor(grad_rows),
                      lr, beta1, beta2, epsilon, wd, rescale_grad,
                      clip_gradient)
    return w[:-1], m[:-1], v[:-1]
