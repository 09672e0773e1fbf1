"""The port's tensor, expert and pipeline parallelism
(``mxnet_tpu_torch.parallel.tp`` / ``pp``) against the JAX package's, on
the CPU.

The same seeded numpy inputs and weights go through the JAX functions on
a 4-device virtual CPU mesh (one jitted value-and-gradient program) and
through the port over a mesh listing the host device 4 times. Outputs
and the gradients of a squared-sum loss with respect to every input are
held to 1e-5 relative to each array's largest element (float32 products
summed in another order than XLA's; the psum adds 4 partial products in
replica order). Top-1 routing compares argmax over the same float32
logits: the inputs are drawn so no two experts tie.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from mxnet_tpu.parallel import tp as jtp, pp as jpp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import build_mesh, megatron_mlp, moe_ffn, \
    pipeline_mlp
from mxnet_tpu_torch.parallel import tp, pp

N = 4
TOL = 1e-5


def _jmesh(axis):
    return JMesh(np.array(jax.devices()[:N]), (axis,))


def _tmesh(axis):
    return build_mesh({axis: N}, ["cpu"] * N)


def _draw(shapes, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, scale, s).astype(np.float32) for s in shapes]


def _jax_vg(fn, arrs):
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out ** 2), out
    with jax.default_matmul_precision("highest"):
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(len(arrs))), has_aux=True))(
                *(jnp.asarray(a) for a in arrs))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_vg(fn, arrs):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = fn(*ts)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want):
    bound = TOL * max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= bound


def _check(jfn, tfn, arrs):
    want, gwant = _jax_vg(jfn, arrs)
    got, ggot = _torch_vg(tfn, arrs)
    assert got.shape == want.shape
    _close(got, want)
    for g, w in zip(ggot, gwant):
        _close(g, w)


def test_megatron_mlp_matches_jax():
    arrs = _draw([(8, 16), (16, 32), (32,), (32, 12), (12,)], seed=0)
    _check(lambda *a: jtp.megatron_mlp(*a, _jmesh("tp")),
           lambda *a: megatron_mlp(*a, _tmesh("tp")), arrs)


def test_moe_ffn_matches_jax_and_its_reference():
    arrs = _draw([(16, 8), (8, 8), (8, 8, 24), (8, 24, 8)], seed=1)
    logits = arrs[0] @ arrs[1]
    top2 = np.sort(logits, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-3).all()       # no routing tie
    _check(lambda *a: jtp.moe_ffn(*a, _jmesh("ep")),
           lambda *a: moe_ffn(*a, _tmesh("ep")), arrs)
    _check(jtp.moe_ffn_reference, tp.moe_ffn_reference, arrs)
    ts = [torch.from_numpy(a) for a in arrs]
    _close(moe_ffn(*ts, _tmesh("ep")).numpy(),
           tp.moe_ffn_reference(*ts).numpy())


def test_pipeline_mlp_matches_jax_and_its_reference():
    arrs = _draw([(6, 4, 16), (N, 16, 16), (N, 16)], seed=2)
    _check(lambda *a: jpp.pipeline_mlp(*a, _jmesh("pp")),
           lambda *a: pipeline_mlp(*a, _tmesh("pp")), arrs)
    _check(jpp.pipeline_reference, pp.pipeline_reference, arrs)


@pytest.mark.parametrize("case", ["megatron_dims", "megatron_div", "moe",
                                  "pipe"])
def test_errors_match_jax(case):
    z = lambda *s: np.zeros(s, np.float32)
    if case == "megatron_dims":
        arrs = [z(2, 4), z(4, 8), z(8), z(6, 4), z(4)]
        jf, tf = jtp.megatron_mlp, megatron_mlp
        axis = "tp"
    elif case == "megatron_div":
        arrs = [z(2, 4), z(4, 6), z(6), z(6, 4), z(4)]
        jf, tf = jtp.megatron_mlp, megatron_mlp
        axis = "tp"
    elif case == "moe":
        arrs = [z(2, 4), z(4, 6), z(6, 4, 8), z(6, 8, 4)]
        jf, tf = jtp.moe_ffn, moe_ffn
        axis = "ep"
    else:
        arrs = [z(3, 2, 4), z(3, 4, 4), z(3, 4)]
        jf, tf = jpp.pipeline_mlp, pipeline_mlp
        axis = "pp"
    with pytest.raises(Exception) as je:
        jf(*(jnp.asarray(a) for a in arrs), _jmesh(axis))
    with pytest.raises(MXNetError) as te:
        tf(*(torch.from_numpy(a) for a in arrs), _tmesh(axis))
    assert str(te.value) == str(je.value)
