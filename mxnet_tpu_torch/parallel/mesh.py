"""Device meshes (counterpart of mxnet_tpu/parallel/mesh.py).

A :class:`Mesh` is a numpy object array of ``torch.device``s with named
axes, the shape of ``jax.sharding.Mesh``. The JAX package's mesh is one
program over several devices, with sharding as placement; the port keeps
that single-process design: a data-parallel step walks the graph once
over the mesh's replicas in lock step (``executor.py``), so a mesh of
``cpu(i)`` contexts holds n replicas on the host and the CPU tests run
n-way arithmetic. A mesh may list one device several times, a CUDA
device too: ``build_mesh({"sp": 4}, [cuda:0] * 4)`` is four replicas of
one card, each with its own shards, so the sharded semantics (shards,
collectives in replica order, per-replica BatchNorm under ZeRO, the ring's
merge) run on a machine with one card. Memory is then the card's, not a
replica's, and no interconnect is exercised. ``devices=None`` means the
CUDA devices and raises without a card.

Collectives: the JAX package runs ``shard_map`` bodies with ``jax.lax``
collectives over a named axis. Here a body runs once a replica, in
replica order, over per-replica lists of tensors, and the collectives are
plain functions over those lists (:func:`psum`, :func:`pmean`,
:func:`psum_scatter`, :func:`all_gather`, :func:`ppermute`,
:func:`all_to_all`; ``jax.lax.axis_index`` is the body's position in the
lists). They are torch ops, so autograd runs through them, and every sum
is taken in one fixed order (replica 0 first unless the caller gives
another), so a step repeats bit for bit.

Placement: :func:`put_replicated` gives one copy a replica,
:func:`put_batch_sharded` equal shards of the batch axis, one a replica
(a batch that does not divide raises); :func:`replicated_sharding` /
:func:`batch_sharding` name those placements for :func:`put`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Mesh", "AXIS_NAMES", "AXIS_ALIASES", "build_mesh",
           "data_parallel_mesh", "single_axis_mesh", "axis_size",
           "data_axis", "mesh_for_devices", "mesh_for_contexts",
           "mesh_descriptor", "mesh_from_descriptor", "current_topology",
           "Sharding", "replicated_sharding", "batch_sharding", "put",
           "put_replicated", "put_batch_sharded", "psum",
           "sum_to", "pmean", "psum_scatter", "all_gather", "ppermute",
           "all_to_all", "shard", "cast_wire", "axis_groups",
           "replica_coords", "wire_bytes", "add_wire", "reset_wire"]

AXIS_NAMES = ("data", "model", "pipe", "sp", "ep")
AXIS_ALIASES = {"dp": "data", "tp": "model", "pp": "pipe"}


class Mesh:
    """Named axes over an array of torch devices (``devices.shape`` is
    the axis sizes, in ``axis_names`` order)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(str(n) for n in axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def replicas(self):
        """The devices in mesh order, one a replica."""
        return list(self.devices.flat)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.replicas]})"


def _cuda_devices():
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device: a mesh defaults to the cards; pass devices= "
            "or build it from cpu(i) contexts (mesh_for_contexts) to run "
            "the replicas on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices):
    if devices is None:
        return _cuda_devices()
    from ..context import Context, resolve_device
    return [d.torch_device() if isinstance(d, Context) else
            resolve_device(d) for d in devices]


def build_mesh(axis_sizes: dict, devices=None):
    """A mesh with named axes, e.g. {'data': 4}: the first prod(sizes)
    devices, reshaped in dict order."""
    devices = _devices(devices)
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(
            f"mesh {axis_sizes} needs {total} devices, have {len(devices)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(sizes), names)


def data_parallel_mesh(n=None, devices=None):
    """1-D data-parallel mesh over n (default: all) devices."""
    devices = _devices(devices)
    return build_mesh({"data": len(devices) if n is None else n}, devices)


def single_axis_mesh(axis_name, n=None, devices=None):
    """1-D mesh over one named axis."""
    devices = _devices(devices)
    return build_mesh({str(axis_name): len(devices) if n is None else n},
                      devices)


def axis_size(mesh, axis_name, default=None):
    """Size of a named axis (aliases dp/tp/pp accepted); ``default``
    instead of a KeyError for an absent axis."""
    name = AXIS_ALIASES.get(axis_name, axis_name)
    for n, s in zip(mesh.axis_names, mesh.devices.shape):
        if n == name or n == axis_name:
            return int(s)
    if default is not None:
        return int(default)
    raise KeyError(f"mesh {tuple(mesh.axis_names)} has no axis "
                   f"{axis_name!r}")


def data_axis(mesh):
    """The batch axis: 'data' when present, else the leading axis."""
    return "data" if "data" in mesh.axis_names else mesh.axis_names[0]


_MESH_CACHE: dict = {}


def mesh_for_devices(devices):
    """The cached 1-D data mesh over a device list."""
    key = tuple(devices)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = data_parallel_mesh(len(key), list(key))
        _MESH_CACHE[key] = mesh
    return mesh


def mesh_for_contexts(ctx_list):
    """The cached 1-D data mesh of a context list: ``[gpu(0), gpu(1)]``
    over two cards (raises without them), ``[cpu(0), cpu(1)]`` two
    replicas on the host. Keyed by the contexts, so n host replicas are n
    entries though they share one torch device."""
    key = ("ctx",) + tuple(ctx_list)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = data_parallel_mesh(len(ctx_list), list(ctx_list))
        _MESH_CACHE[key] = mesh
    return mesh


def mesh_descriptor(mesh):
    """JSON-safe {axis_name: size}."""
    return {str(n): int(s)
            for n, s in zip(mesh.axis_names, mesh.devices.shape)}


def mesh_from_descriptor(desc, devices=None):
    """Inverse of :func:`mesh_descriptor` (cached by devices and axes)."""
    devices = _devices(devices)
    items = tuple((str(k), int(v)) for k, v in desc.items())
    key = (tuple(devices), items)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = build_mesh(dict(items), devices)
        _MESH_CACHE[key] = mesh
    return mesh


def current_topology(mesh=None):
    """JSON-safe device topology of this process (one process: the
    port's mesh is single-controller)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    d = {"device_count": n, "local_device_count": n, "process_count": 1,
         "process_index": 0}
    if mesh is not None:
        d["mesh_axes"] = mesh_descriptor(mesh)
    return d


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement over a mesh: replicated (``batch_axis`` None) or
    split into equal shards of ``batch_axis``, one a replica."""
    mesh: Mesh
    batch_axis: int = None


def replicated_sharding(mesh):
    return Sharding(mesh)


def batch_sharding(mesh, batch_axis=0):
    return Sharding(mesh, int(batch_axis))


def _tensor(data):
    from ..executor import _from_numpy
    data = getattr(data, "_data", data)
    return data if isinstance(data, torch.Tensor) else _from_numpy(data)


def put(data, sharding):
    """One tensor a replica: a copy of ``data`` on each replica's device,
    or its equal shards of ``sharding.batch_axis``."""
    data = _tensor(data)
    devs = sharding.mesh.replicas
    if sharding.batch_axis is None:
        return [data.to(d) for d in devs]
    n, ax = len(devs), sharding.batch_axis
    if data.shape[ax] % n != 0:
        raise MXNetError(
            f"batch axis {ax} of shape {tuple(data.shape)} must be "
            f"divisible by the {n}-way data axis")
    return [s.to(d) for s, d in zip(torch.chunk(data, n, dim=ax), devs)]


def put_replicated(data, mesh):
    return put(data, replicated_sharding(mesh))


def put_batch_sharded(data, mesh, batch_axis=0):
    return put(data, batch_sharding(mesh, batch_axis))


def replica_coords(mesh):
    """Each replica's index along every axis, in mesh order: one
    ``{axis: index}`` dict a replica (row-major over the axes, the order
    of :attr:`Mesh.replicas`)."""
    sizes = mesh.devices.shape
    return [dict(zip(mesh.axis_names, (int(i) for i in
                                       np.unravel_index(r, sizes))))
            for r in range(int(np.prod(sizes)))]


def axis_groups(mesh, axis_name):
    """The replicas that differ only along ``axis_name``: one list of
    replica positions a group, each group in axis order (``"model"`` on a
    data x model mesh: the T replicas that share a data index; ``"data"``:
    the D replicas that share a model index)."""
    name = AXIS_ALIASES.get(axis_name, axis_name)
    coords = replica_coords(mesh)
    groups = {}
    for r, c in enumerate(coords):
        key = tuple(v for k, v in c.items() if k != name)
        groups.setdefault(key, []).append(r)
    return [groups[k] for k in sorted(groups)]


# -- wire accounting ----------------------------------------------------------

_WIRE = [0.0]


def wire_bytes():
    """Bytes the collectives have moved a device so far (ring
    accounting; a float: per-device shares of a group's bytes)."""
    return _WIRE[0]


def add_wire(nbytes):
    """Add ``nbytes`` a device to the counter (a reduction that autograd
    takes, as dp's gradient all-reduce, counts itself here)."""
    _WIRE[0] += float(nbytes)


def reset_wire():
    _WIRE[0] = 0.0


def _nbytes(x):
    return x.numel() * x.element_size()


def _ring(kind, g, nbytes):
    """Bytes a device of a g-replica group moves for one collective over
    an ``nbytes`` buffer (all-gather: the gathered buffer; reduce-scatter
    and all-reduce: the reduced buffer)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    return (2 * frac if kind == "all_reduce" else frac) * nbytes


def _grouped(fn, xs, groups, **kw):
    """Apply the per-list collective ``fn`` within each group of
    replica positions; the results back in replica order. The groups run
    side by side, so a device's bytes are one group's (their mean)."""
    out = [None] * len(xs)
    before = _WIRE[0]
    for grp in groups:
        res = fn([xs[r] for r in grp], **kw)
        for r, v in zip(grp, res):
            out[r] = v
    _WIRE[0] = before + (_WIRE[0] - before) / max(len(groups), 1)
    return out


# -- collectives over per-replica lists ---------------------------------------

def shard(x, mesh, dim, axis_name=None):
    """x split into the mesh's equal shards along ``dim``, one a replica
    on its device and contiguous, as a replica holds its own shard: the
    ``P(..., axis, ...)`` in_spec of a shard_map. Differentiable."""
    devs = mesh.replicas
    n = len(devs) if axis_name is None else axis_size(mesh, axis_name)
    if x.shape[dim] % n != 0:
        raise MXNetError(f"dimension {dim} of shape {tuple(x.shape)} does "
                         f"not split into {n} shards")
    return [c.to(d).contiguous()
            for c, d in zip(torch.chunk(x, n, dim=dim), devs)]


def _wire_add(acc, x):
    """acc + x rounded to their dtype. A float8 sum is taken in float32
    and rounded back (torch has no float8 arithmetic), as a float8 add
    rounds its exact sum."""
    if acc.dtype in _FP8:
        return cast_wire(acc.to(torch.float32) + x.to(torch.float32),
                         acc.dtype)
    return acc + x


def sum_to(xs, device, order=None):
    """The sum of per-replica tensors on ``device``: replica ``order[0]``
    first (default 0, 1, ..., n-1), each partial sum in the tensors'
    dtype."""
    order = range(len(xs)) if order is None else order
    acc = None
    for r in order:
        x = xs[r].to(device)
        acc = x if acc is None else _wire_add(acc, x)
    return acc


def psum(xs, devices=None, order=None, groups=None, count=True):
    """``jax.lax.psum``: every replica gets the sum (on its device, from
    ``devices`` or the tensors' own), taken once in a fixed order.
    ``count=False`` leaves the wire counter alone (the aux statistics'
    average, which the planner's estimate leaves out)."""
    if groups is not None:
        return _grouped(psum, xs, groups, order=order, count=count)
    devices = devices or [x.device for x in xs]
    total = sum_to(xs, devices[0], order)
    if count:
        add_wire(_ring("all_reduce", len(xs), _nbytes(total))
                 * len(devices) / len(xs))
    return [total if d == devices[0] else total.to(d) for d in devices]


def pmean(xs, devices=None, order=None, groups=None, count=True):
    """``jax.lax.pmean``: the psum over the replica count."""
    if groups is not None:
        return _grouped(pmean, xs, groups, order=order, count=count)
    n = len(xs)
    return [s / n for s in psum(xs, devices, order, count=count)]


def psum_scatter(xs, dim=0, order=None, groups=None):
    """``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``:
    replica k gets the sum of everyone's k-th slice along ``dim`` (the same
    order and rounding as :func:`psum`, one slice a replica)."""
    if groups is not None:
        return _grouped(psum_scatter, xs, groups, dim=dim, order=order)
    n = len(xs)
    parts = [torch.chunk(x, n, dim=dim) if x.shape[dim] % n == 0 else None
             for x in xs]
    if any(p is None for p in parts):
        raise MXNetError(f"psum_scatter: dimension {dim} of "
                         f"{tuple(xs[0].shape)} does not split {n} ways")
    add_wire(_ring("reduce_scatter", n, _nbytes(xs[0])))
    return [sum_to([p[k] for p in parts], xs[k].device, order)
            for k in range(n)]


def all_gather(xs, dim=0, devices=None, groups=None):
    """``jax.lax.all_gather(..., tiled=True)``: every replica gets the
    replicas' tensors concatenated along ``dim`` in replica order."""
    if groups is not None:
        return _grouped(all_gather, xs, groups, dim=dim)
    devices = devices or [x.device for x in xs]
    add_wire(_ring("all_gather", len(xs), len(xs) * _nbytes(xs[0]))
             * len(devices) / len(xs))
    return [torch.cat([x.to(d) for x in xs], dim) for d in devices]


def ppermute(xs, perm):
    """``jax.lax.ppermute``: replica ``dst`` gets replica ``src``'s tensor
    for each ``(src, dst)`` in ``perm``; a replica no pair sends to gets
    zeros."""
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def all_to_all(xs, split_axis, concat_axis):
    """``jax.lax.all_to_all(..., tiled=True)``: replica j gets chunk j of
    every replica's ``split_axis``, concatenated along ``concat_axis`` in
    replica order."""
    n = len(xs)
    if xs[0].shape[split_axis] % n:
        raise MXNetError(f"all_to_all: axis {split_axis} of "
                         f"{tuple(xs[0].shape)} does not split {n} ways")
    parts = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([p[j].to(xs[j].device) for p in parts], concat_axis)
            for j in range(n)]


_FP8 = tuple(getattr(torch, n) for n in ("float8_e4m3fn", "float8_e5m2")
             if hasattr(torch, n))
# the largest finite float8 e4m3fn value and the midpoint above it: a
# value past the midpoint rounds to NaN in the format's own rounding
# (ml_dtypes, XLA); torch's cast saturates to 448 instead
_E4M3_MAX_MID = 464.0


def cast_wire(x, dtype):
    """x rounded to the wire dtype as the JAX package's ``astype`` does:
    float8 e4m3fn takes ties to even and turns a value beyond ±464 (and
    ±inf) into NaN, where torch's own cast saturates to ±448."""
    c = x.to(dtype)
    if dtype == getattr(torch, "float8_e4m3fn", None):
        x32 = x.to(torch.float32)
        c = torch.where(x32.abs() > _E4M3_MAX_MID,
                        torch.full_like(x32, float("nan")),
                        c.to(torch.float32)).to(dtype)
    return c
