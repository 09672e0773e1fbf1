"""Device meshes (counterpart of mxnet_tpu/parallel/mesh.py).

A :class:`Mesh` is a numpy object array of ``torch.device``s with named
axes, the shape of ``jax.sharding.Mesh``. The JAX package's mesh is one
program over several devices, with sharding as placement; the port keeps
that single-process design: a data-parallel step walks the graph once
over the mesh's replicas in lock step (``executor.py``), so a mesh of
``cpu(i)`` contexts holds n replicas on the host and the CPU tests run
n-way arithmetic. ``devices=None`` means the CUDA devices and raises
without a card.

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
           "put_replicated", "put_batch_sharded"]

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
