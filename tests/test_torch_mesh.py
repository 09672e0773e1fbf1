"""The port's device mesh against the JAX package's, on the CPU.

The JAX meshes are built over the conftest's 8 virtual CPU devices; the
port's over ``cpu(i)`` contexts (n replicas on the host). Axis names,
sizes, descriptors, the data axis and the shards of a batch must be the
same, exactly.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx  # noqa: F401
from mxnet_tpu.parallel import mesh as jmesh
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import mesh as tmesh

AXES = [{"data": 8}, {"data": 4, "model": 2}, {"data": 2, "model": 2,
                                                "pipe": 2},
        {"model": 4}, {"sp": 2, "data": 4}]


def _cpus(n=8):
    return [tmx.cpu(i) for i in range(n)]


@pytest.mark.parametrize("axes", AXES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_build_mesh_matches_jax(axes):
    j = jmesh.build_mesh(axes)
    t = tmesh.build_mesh(axes, _cpus())
    assert t.axis_names == tuple(j.axis_names)
    assert t.devices.shape == j.devices.shape
    assert tmesh.mesh_descriptor(t) == jmesh.mesh_descriptor(j)
    assert tmesh.data_axis(t) == jmesh.data_axis(j)
    for name in ("data", "model", "pipe", "dp", "tp", "pp", "sp", "ep"):
        assert tmesh.axis_size(t, name, default=1) == \
            jmesh.axis_size(j, name, default=1)
    assert all(d == torch.device("cpu") for d in t.replicas)


@pytest.mark.parametrize("axes", AXES[:3], ids=["d8", "d4m2", "d2m2p2"])
def test_descriptor_round_trip(axes):
    t = tmesh.build_mesh(axes, _cpus())
    back = tmesh.mesh_from_descriptor(tmesh.mesh_descriptor(t), _cpus())
    assert tmesh.mesh_descriptor(back) == tmesh.mesh_descriptor(t)
    assert back is tmesh.mesh_from_descriptor(tmesh.mesh_descriptor(t),
                                              _cpus())


def test_too_many_devices_raise_as_jax():
    with pytest.raises(ValueError):
        jmesh.build_mesh({"data": 64})
    with pytest.raises(ValueError):
        tmesh.build_mesh({"data": 64}, _cpus())


def test_axis_size_without_default_raises():
    t = tmesh.data_parallel_mesh(4, _cpus(4))
    with pytest.raises(KeyError):
        tmesh.axis_size(t, "model")
    with pytest.raises(KeyError):
        jmesh.axis_size(jmesh.data_parallel_mesh(4, jax.devices()[:4]),
                        "model")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_data_parallel_mesh_and_single_axis(n):
    t = tmesh.data_parallel_mesh(n, _cpus())
    j = jmesh.data_parallel_mesh(n, jax.devices())
    assert tmesh.mesh_descriptor(t) == jmesh.mesh_descriptor(j) == \
        {"data": n}
    s = tmesh.single_axis_mesh("sp", n, _cpus())
    assert tmesh.mesh_descriptor(s) == jmesh.mesh_descriptor(
        jmesh.single_axis_mesh("sp", n, jax.devices()))
    assert tmesh.data_axis(s) == "sp"


def test_mesh_for_contexts_is_cached_per_context_list():
    a = tmesh.mesh_for_contexts(_cpus(2))
    assert tmesh.mesh_for_contexts(_cpus(2)) is a
    b = tmesh.mesh_for_contexts(_cpus(4))
    assert b is not a and tmesh.mesh_descriptor(b) == {"data": 4}
    assert tmesh.mesh_descriptor(a) == {"data": 2}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(16, 3), (8,), (24, 2, 5)])
def test_batch_shards_match_jax(n, shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jm = jmesh.data_parallel_mesh(n, jax.devices())
    tm = tmesh.data_parallel_mesh(n, _cpus())
    if shape[0] % n:
        with pytest.raises(ValueError):
            jmesh.put_batch_sharded(x, jm)
        with pytest.raises(MXNetError):
            tmesh.put_batch_sharded(x, tm)
        return
    jarr = jmesh.put_batch_sharded(x, jm)
    jshards = sorted(((s.index[0].start or 0, np.asarray(s.data))
                      for s in jarr.addressable_shards),
                     key=lambda kv: kv[0])
    tshards = tmesh.put_batch_sharded(x, tm)
    assert len(tshards) == n
    for (_, a), b in zip(jshards, tshards):
        np.testing.assert_array_equal(a, b.numpy())
    for r in tmesh.put_replicated(x, tm):
        np.testing.assert_array_equal(r.numpy(), x)


def test_batch_shards_on_another_axis():
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    tm = tmesh.data_parallel_mesh(3, _cpus())
    shards = tmesh.put(x, tmesh.batch_sharding(tm, 1))
    np.testing.assert_array_equal(torch.cat(shards, 1).numpy(), x)
    assert tmesh.replicated_sharding(tm).batch_axis is None


def test_current_topology_without_a_card():
    topo = tmesh.current_topology(tmesh.data_parallel_mesh(2, _cpus()))
    assert topo["process_count"] == 1 and topo["mesh_axes"] == {"data": 2}
