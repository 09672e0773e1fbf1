"""mx.parallel — parallelism over a device mesh (counterpart of
mxnet_tpu/parallel).

``DataParallelTrainer`` runs forward, backward, the gradient sum over the
replicas and the optimizer update as one step over a :class:`Mesh`
(single-process, like the JAX package's one program over its mesh), as a
CUDA graph on one card; ``zero_stage > 0`` (or ``MXNET_ZERO_STAGE``) makes
it a ``ZeroTrainer`` (``parallel.zero``: sharded masters and optimizer
states, bf16/fp8 gradient compression). ``EmbeddingTrainer``
(``parallel.embedding``) trains a row-sharded table with a row-sparse
gradient exchange. ``sp`` (ring and Ulysses attention), ``tp``
(Megatron MLP, expert-parallel MoE) and ``pp`` (GPipe pipelining) run the
JAX package's shard_map bodies once a replica, with the mesh's
collectives (``mesh.psum``, ``all_gather``, ``ppermute``, ...). A mesh may
list one card several times. ``DataParallelTrainer(param_specs=)`` is
tensor parallelism on a data x model mesh, and ``ZeroTrainer`` splits its
state over an N-D mesh's joint axes; ``planner`` (MXNET_PLAN: ``Plan``,
``make_trainer``, ``PlanReport``, ``ModelSpec``) prices the compositions
and builds the one it picks.
"""
from .mesh import (Mesh, build_mesh, data_parallel_mesh, single_axis_mesh,
                   mesh_for_contexts, mesh_for_devices, axis_size,
                   data_axis, mesh_descriptor, mesh_from_descriptor,
                   current_topology, replicated_sharding, batch_sharding,
                   put_replicated, put_batch_sharded)
from .dp import DataParallelTrainer
from . import zero
from .zero import ZeroTrainer
from . import embedding
from .embedding import EmbeddingTrainer
from . import planner
from .planner import Plan, PlanReport, ModelSpec, make_trainer
from . import sp
from . import tp
from . import pp
from .sp import ring_attention, ulysses_attention
from .tp import megatron_mlp, moe_ffn
from .pp import pipeline_mlp

__all__ = ["Mesh", "build_mesh", "data_parallel_mesh", "single_axis_mesh",
           "DataParallelTrainer", "ZeroTrainer", "zero",
           "EmbeddingTrainer", "embedding", "planner", "Plan",
           "PlanReport", "ModelSpec", "make_trainer", "mesh_for_contexts",
           "mesh_for_devices", "axis_size", "data_axis", "mesh_descriptor",
           "mesh_from_descriptor", "current_topology",
           "replicated_sharding", "batch_sharding", "put_replicated",
           "put_batch_sharded", "sp", "tp", "pp", "ring_attention",
           "ulysses_attention", "megatron_mlp", "moe_ffn", "pipeline_mlp"]
