"""Gluon utilities (counterpart of mxnet_tpu/gluon/utils.py):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``
and ``download``. ``split_and_load`` over several contexts returns, as
the JAX package does, a one-element list: the whole batch, on the first
context's device, marked as sharded on ``batch_axis`` over the mesh of
those contexts (a ``MeshNDArray``), or as replicated when the batch does
not split evenly and ``even_split`` is false. ``download`` serves local
files: a ``file://`` URL is copied, any other URL raises (nothing here
reaches a network).
"""
from __future__ import annotations

import hashlib
import math
import os
import shutil

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "MeshNDArray"]


class MeshNDArray(NDArray):
    """A whole batch on the first of ``contexts``' devices, placed over the
    mesh of those contexts: sharded on ``batch_axis``, or replicated when
    ``batch_axis`` is None. A hybridized block runs it through the mesh
    walk (``executor._run_mesh``); ops on it compute the whole batch."""

    __slots__ = ("contexts", "batch_axis")

    def __init__(self, data, contexts, batch_axis):
        super().__init__(data)
        self.contexts = list(contexts)
        self.batch_axis = batch_axis

    @property
    def mesh(self):
        from ..parallel.mesh import mesh_for_contexts
        return mesh_for_contexts(self.contexts)


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last
    one takes the remainder unless ``even_split``)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            f"Too many slices for data with shape {data.shape}. Arguments "
            f"are batch_axis={batch_axis} and num_slice={num_slice}.")
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's multiple of {num_slice} or set even_split=False to "
            "allow uneven partitioning of data.")
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` loaded onto ``ctx_list``, as a one-element list: on the
    one context, or a ``MeshNDArray`` over several."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    data = data.as_in_context(ctx_list[0])
    if len(ctx_list) == 1:
        return [data]
    size = data.shape[batch_axis]
    if size % len(ctx_list) != 0:
        if even_split:
            raise ValueError(
                f"data with shape {tuple(data.shape)} cannot be evenly "
                f"split into {len(ctx_list)} slices along axis "
                f"{batch_axis}. Use a batch size that's a multiple of "
                f"{len(ctx_list)} or set even_split=False.")
        # every replica computes the whole (short) batch
        return [MeshNDArray(data._data, ctx_list, None)]
    return [MeshNDArray(data._data, ctx_list, batch_axis)]


def clip_global_norm(arrays, max_norm):
    """Rescale ``arrays`` in place so that the 2-norm of all of them
    together is at most ``max_norm``; returns that norm before
    rescaling."""
    if not arrays:
        raise ValueError("clip_global_norm: no arrays")
    total_norm = math.sqrt(sum(
        float((arr.astype("float32") ** 2).sum().asscalar())
        for arr in arrays))
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """The file at ``url`` saved to ``path`` (a directory or a file
    name): an existing file that matches ``sha1_hash`` is kept, a
    ``file://`` URL is copied, any other URL raises."""
    fname = path if path and not os.path.isdir(path) else \
        os.path.join(path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        shutil.copyfile(url[len("file://"):], fname)
        if sha1_hash and not check_sha1(fname, sha1_hash):
            raise MXNetError(f"download({url}): sha1 mismatch")
        return fname
    raise MXNetError(
        f"download({url}): only local files (file://) are served; place "
        "the file at the target path")
