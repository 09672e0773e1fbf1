"""mx.parallel — data parallelism over a device mesh (counterpart of
mxnet_tpu/parallel).

``DataParallelTrainer`` runs forward, backward, the gradient sum over the
replicas and the optimizer update as one step over a :class:`Mesh`
(single-process, like the JAX package's one program over its mesh), as a
CUDA graph on one card. ``EmbeddingTrainer`` (``parallel.embedding``)
trains a row-sharded table with a row-sparse gradient exchange. ZeRO,
tensor, pipeline and sequence parallelism and the planner are not ported
yet (ROADMAP queue 1 items 11 and 15), so their names are absent here.
"""
from .mesh import (Mesh, build_mesh, data_parallel_mesh, single_axis_mesh,
                   mesh_for_contexts, mesh_for_devices, axis_size,
                   data_axis, mesh_descriptor, mesh_from_descriptor,
                   current_topology, replicated_sharding, batch_sharding,
                   put_replicated, put_batch_sharded)
from .dp import DataParallelTrainer
from . import embedding
from .embedding import EmbeddingTrainer

__all__ = ["Mesh", "build_mesh", "data_parallel_mesh", "single_axis_mesh",
           "DataParallelTrainer", "EmbeddingTrainer", "embedding",
           "mesh_for_contexts", "mesh_for_devices",
           "axis_size", "data_axis", "mesh_descriptor",
           "mesh_from_descriptor", "current_topology",
           "replicated_sharding", "batch_sharding", "put_replicated",
           "put_batch_sharded"]
