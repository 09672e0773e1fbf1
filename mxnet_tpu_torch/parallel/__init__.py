"""mx.parallel — data parallelism over a device mesh (counterpart of
mxnet_tpu/parallel).

``DataParallelTrainer`` runs forward, backward, the gradient sum over the
replicas and the optimizer update as one step over a :class:`Mesh`
(single-process, like the JAX package's one program over its mesh), as a
CUDA graph on one card. ZeRO, tensor, pipeline and sequence parallelism,
the embedding trainer and the planner are not ported yet (ROADMAP queue 1
items 11 and 15), so their names are absent here.
"""
from .mesh import (Mesh, build_mesh, data_parallel_mesh, single_axis_mesh,
                   mesh_for_contexts, mesh_for_devices, axis_size,
                   data_axis, mesh_descriptor, mesh_from_descriptor,
                   current_topology, replicated_sharding, batch_sharding,
                   put_replicated, put_batch_sharded)
from .dp import DataParallelTrainer

__all__ = ["Mesh", "build_mesh", "data_parallel_mesh", "single_axis_mesh",
           "DataParallelTrainer", "mesh_for_contexts", "mesh_for_devices",
           "axis_size", "data_axis", "mesh_descriptor",
           "mesh_from_descriptor", "current_topology",
           "replicated_sharding", "batch_sharding", "put_replicated",
           "put_batch_sharded"]
