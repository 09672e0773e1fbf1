"""Sparse NDArrays (counterpart of mxnet_tpu/ndarray/sparse.py, the
parity surface of python/mxnet/ndarray/sparse.py).

The JAX package's design, kept: ``row_sparse`` and ``csr`` arrays are
dense-backed views with sparse metadata, so every dense op keeps
working on them. An array built from its parts (``(data, indices[,
indptr])``) also retains those parts on its device: ELL components for a
CSR (``ops/sparse_ops.py``), ``(values, row ids)`` for a row_sparse
array. ``sparse.dot`` and the optimizers' lazy updates then gather and
scatter over the parts, with work that scales with nnz. Any in-place
write into the dense backing drops the parts (``_invalidate``), so
nothing reads stale ones.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from .ndarray import NDArray, array, zeros

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "merge_row_sparse", "dot",
           "zeros_sparse"]


def _host(x, dtype=None):
    x = x.asnumpy() if isinstance(x, NDArray) else x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return _np.asarray(x, dtype=dtype)


class BaseSparseNDArray(NDArray):
    # the parts on the device when built from them, else None:
    # CSR (val (R, K) ELL, idx (R, K), counts (R,) numpy);
    # row_sparse (data (N, ...), row ids (N,) int32)
    __slots__ = ("_ell",)

    def __init__(self, data, ell=None):
        super().__init__(data)
        self._ell = ell

    def _invalidate(self):
        # a write into the dense backing: the parts no longer describe it
        self._ell = None

    def __repr__(self):
        return (f"\n{self.asnumpy()!s}\n<{type(self).__name__} "
                f"{self.shape} @{self.context}>")


class CSRNDArray(BaseSparseNDArray):
    __slots__ = ()

    @property
    def stype(self):
        return "csr"

    def _csr_parts(self):
        """(data, indices, indptr) numpy: from the parts when present
        (explicit zeros kept), else derived from the dense backing."""
        if self._ell is not None:
            val, idx = (_host(x) for x in self._ell[:2])
            counts = _np.asarray(self._ell[2])
            keep = _np.arange(val.shape[1])[None, :] < counts[:, None]
            indptr = _np.concatenate(
                [[0], _np.cumsum(counts)]).astype(_np.int64)
            return val[keep], idx[keep].astype(_np.int64), indptr
        a = self.asnumpy()
        counts = (a != 0).sum(axis=1)
        indptr = _np.concatenate([[0], _np.cumsum(counts)])
        return a[a != 0], _np.nonzero(a)[1], indptr

    @property
    def indices(self):
        return array(self._csr_parts()[1], ctx=self.context, dtype="int64")

    @property
    def indptr(self):
        return array(self._csr_parts()[2], ctx=self.context, dtype="int64")

    @property
    def data(self):
        d = self._csr_parts()[0]
        return array(d, ctx=self.context, dtype=d.dtype)

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "csr":
            return self
        raise MXNetError(f"cannot convert csr to {stype}")


class RowSparseNDArray(BaseSparseNDArray):
    __slots__ = ()

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self):
        if self._ell is not None:
            # the true index list: explicit all-zero rows kept
            return NDArray(self._ell[1].to(torch.int64))
        a = self._data.reshape(self.shape[0], -1)
        nz = torch.nonzero((a != 0).any(dim=1)).reshape(-1)
        return NDArray(nz.to(torch.int64))

    @property
    def data(self):
        if self._ell is not None:
            return NDArray(self._ell[0])
        a = self._data.reshape(self.shape[0], -1)
        nz = torch.nonzero((a != 0).any(dim=1)).reshape(-1)
        return NDArray(self._data.index_select(0, nz))

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "row_sparse":
            return self
        raise MXNetError(f"cannot convert row_sparse to {stype}")


def _dense_of(arg1, ctx, dtype):
    if isinstance(arg1, NDArray) and dtype is None:
        return array(arg1, ctx=ctx if ctx is not None else arg1.context)
    src = _host(arg1)
    return array(src, ctx=ctx, dtype=dtype)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` (the parts are kept
    on the device as ELL components, for ``sparse.dot``) or from a dense
    source. Duplicate (row, column) entries are summed, in the backing and
    the parts alike; a column out of range raises."""
    from ..ops import sparse_ops as sp
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _host(data)
        indices = _host(indices, _np.int64)
        indptr = _host(indptr, _np.int64)
        if shape is None:
            raise MXNetError("csr_matrix: shape= is required with parts")
        dense = _np.zeros(shape, dtype=data.dtype if dtype is None else dtype)
        rows = _np.repeat(_np.arange(shape[0]), _np.diff(indptr))
        if len(indices) and (int(indices.min()) < 0
                             or int(indices.max()) >= shape[1]):
            raise MXNetError(
                f"csr_matrix: column index out of range [0, {shape[1]}) "
                f"(min {int(indices.min())}, max {int(indices.max())})")
        key = rows * shape[1] + indices
        uniq, inv = _np.unique(key, return_inverse=True)
        if len(uniq) != len(key):
            summed = _np.zeros(len(uniq), dtype=data.dtype)
            _np.add.at(summed, inv, data)
            data = summed
            rows = (uniq // shape[1]).astype(_np.int64)
            indices = (uniq % shape[1]).astype(_np.int64)
            indptr = _np.concatenate(
                [[0], _np.cumsum(_np.bincount(rows, minlength=shape[0]))]
            ).astype(_np.int64)
        dense[rows, indices] = data
        nd = array(dense, ctx=ctx, dtype=dtype)
        val, idx, counts = sp.ell_from_csr(data, indices, indptr,
                                           num_features=shape[1])
        # the parts in the backing's dtype: the fast paths compute at
        # the dense path's precision
        ell = (array(val, ctx=nd.context, dtype=nd._data.dtype)._data,
               array(idx, ctx=nd.context, dtype="int32")._data, counts)
        return CSRNDArray(nd._data, ell)
    return CSRNDArray(_dense_of(arg1, ctx, dtype)._data)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` (kept on the device
    for the optimizers' scatter path; duplicate row ids raise) or from a
    dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _host(data)
        indices = _host(indices, _np.int64).reshape(-1)
        if len(_np.unique(indices)) != len(indices):
            raise MXNetError("row_sparse_array: duplicate row indices")
        if shape is None:
            if not len(indices):
                raise MXNetError("row_sparse_array: shape= is required "
                                 "without indices")
            shape = (int(indices.max()) + 1,) + data.shape[1:]
        shape = tuple(shape)
        if len(indices) and (int(indices.min()) < 0
                             or int(indices.max()) >= shape[0]):
            raise MXNetError(
                f"row_sparse_array: row index out of range [0, {shape[0]}) "
                f"(min {int(indices.min())}, max {int(indices.max())})")
        dense = _np.zeros(shape, dtype=data.dtype if dtype is None else dtype)
        dense[indices] = data
        nd = array(dense, ctx=ctx, dtype=dtype)
        comp = (array(data.reshape((len(indices),) + shape[1:]),
                      ctx=nd.context, dtype=nd._data.dtype)._data,
                array(indices, ctx=nd.context, dtype="int32")._data)
        return RowSparseNDArray(nd._data, comp)
    return RowSparseNDArray(_dense_of(arg1, ctx, dtype)._data)


def merge_row_sparse(parts, shape=None, ctx=None, dtype=None):
    """Sum row_sparse values (RowSparseNDArrays or ``(data, indices)``
    pairs) into one canonical RowSparseNDArray: the row ids of every part
    deduplicated, duplicate rows' values summed in part order. The reduce
    of a row-sparse push (the reference's comm.h Reduce over
    kRowSparseStorage); the result feeds the optimizers' scatter path."""
    datas, idxs = [], []
    for p in parts:
        if isinstance(p, RowSparseNDArray):
            if shape is None:
                shape = p.shape
            if ctx is None:
                ctx = p.context
            d = p.data.asnumpy()
            i = p.indices.asnumpy().astype(_np.int64).ravel()
        elif isinstance(p, tuple) and len(p) == 2:
            d = _host(p[0])
            i = _host(p[1], _np.int64).ravel()
        else:
            raise MXNetError(
                "merge_row_sparse: parts must be RowSparseNDArray or "
                f"(data, indices) pairs, got {type(p).__name__}")
        if d.shape[:1] != i.shape:
            raise MXNetError(
                f"merge_row_sparse: {len(i)} indices for "
                f"{d.shape[0] if d.ndim else 0} value rows")
        datas.append(d)
        idxs.append(i)
    if shape is None:
        raise MXNetError("merge_row_sparse: shape= required when no part "
                         "is an NDArray")
    all_idx = _np.concatenate(idxs) if idxs else _np.zeros(0, _np.int64)
    if all_idx.size == 0:
        empty = _np.zeros((0,) + tuple(shape[1:]),
                          _np.float32 if dtype is None else dtype)
        return row_sparse_array((empty, all_idx), shape=shape, ctx=ctx,
                                dtype=dtype)
    if int(all_idx.min()) < 0 or int(all_idx.max()) >= shape[0]:
        raise MXNetError(
            f"merge_row_sparse: row index out of range [0, {shape[0]}) "
            f"(min {int(all_idx.min())}, max {int(all_idx.max())})")
    all_dat = _np.concatenate(datas)
    uniq, inv = _np.unique(all_idx, return_inverse=True)
    summed = _np.zeros((len(uniq),) + all_dat.shape[1:], all_dat.dtype)
    _np.add.at(summed, inv, all_dat)
    return row_sparse_array((summed, uniq), shape=shape, ctx=ctx,
                            dtype=dtype)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """sparse.dot: the gather path for dot(csr, dense) and dot(csr.T,
    dense) when the csr carries its parts (built from a triplet), else
    the dense op (the reference's DotCsrDnsDns / DotCsrTransDnsDns).
    Inside ``autograd.record()`` the recorded dense op runs always, so
    the rhs gets its gradient."""
    from ..ops import sparse_ops as sp
    from .ndarray import _invoke
    from .. import autograd
    if isinstance(lhs, CSRNDArray) and lhs._ell is not None \
            and not transpose_b and getattr(rhs, "ndim", 0) == 2 \
            and not autograd.is_recording() \
            and rhs.shape[0] == (lhs.shape[0] if transpose_a
                                 else lhs.shape[1]):
        val, idx, _counts = lhs._ell
        with torch.no_grad():
            if transpose_a:
                out = sp.ell_dot_t(val, idx, rhs._data, lhs.shape[1])
            else:
                out = sp.ell_dot(val, idx, rhs._data)
        return NDArray(out)
    return _invoke("dot", NDArray(lhs._data) if isinstance(
        lhs, BaseSparseNDArray) else lhs, rhs, transpose_a=transpose_a,
        transpose_b=transpose_b)


def zeros_sparse(stype, shape, ctx=None, dtype=None):
    nd = zeros(shape, ctx=ctx, dtype=dtype)
    if stype == "csr":
        return CSRNDArray(nd._data)
    if stype == "row_sparse":
        return RowSparseNDArray(nd._data)
    return nd
