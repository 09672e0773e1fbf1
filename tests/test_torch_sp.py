"""The port's sequence parallelism (``mxnet_tpu_torch.parallel.sp``)
against the JAX package's, on the CPU.

The same seeded numpy q/k/v go through ``mxnet_tpu.parallel.sp`` on a
4-device virtual CPU mesh and through the port over a mesh that lists the
host device 4 times (4 replicas of one device). Outputs and the
gradients of a squared-sum loss are held to 2e-5 (float32: the ring's
block merge and the dense body sum in another order than XLA's, a few
float32 ulps of the O(1) outputs; JAX's own ring test holds 2e-5 against
dense attention). The flash ring runs the kernels' plain versions here
(the same calls launch the kernels on a CUDA mesh), so its lse cotangent
reaches ``reference_flash_attention_bwd`` as ``glse``; dropping it, or
leaving the off-diagonal blocks unmasked, must break the agreement.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from mxnet_tpu.parallel import sp as jsp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.parallel import build_mesh, sp, ring_attention, \
    ulysses_attention

TOL = 2e-5
N = 4


def _jmesh(n=N):
    return JMesh(np.array(jax.devices()[:n]), ("sp",))


def _tmesh(n=N):
    return build_mesh({"sp": n}, ["cpu"] * n)


def _qkv(b=1, h=4, s=32, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _jax_run(fn, arrs, **kw):
    """JAX's output and the gradients of its squared sum (one jitted
    program: un-jitted shard_map gradients run op by op, ~20x slower)."""
    mesh = _jmesh()

    def loss(q, k, v):
        out = fn(q, k, v, mesh, **kw)
        return jnp.sum(out ** 2), out

    with jax.default_matmul_precision("highest"):
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a) for a in arrs))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(fn, arrs, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = fn(*ts, _tmesh(), **kw)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_mesh_lists_one_device_several_times():
    """A mesh over one device repeated keeps one replica an entry: the
    cached meshes too (a repeated device never collapses the mesh)."""
    from mxnet_tpu_torch.parallel import mesh_for_devices
    m = _tmesh()
    assert m.shape == {"sp": 4}
    assert len(m.replicas) == 4
    assert all(d == torch.device("cpu") for d in m.replicas)
    dev = torch.device("cpu")
    m4 = mesh_for_devices([dev] * 4)
    m1 = mesh_for_devices([dev])
    assert len(m4.replicas) == 4 and len(m1.replicas) == 1
    assert mesh_for_devices([dev] * 4) is m4


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(impl, causal):
    arrs = _qkv(seed=1 + causal)
    want, gwant = _jax_run(jsp.ring_attention, arrs, causal=causal,
                           impl=impl)
    got, ggot = _torch_run(ring_attention, arrs, causal=causal, impl=impl)
    _close(got, want)
    for g, w in zip(ggot, gwant):
        _close(g, w)
    # and against dense attention over the whole sequence
    _close(got, np.asarray(jsp.attention_reference(
        *(jnp.asarray(a) for a in arrs), causal=causal)), 5e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(causal):
    arrs = _qkv(h=8, seed=3 + causal)
    want, gwant = _jax_run(jsp.ulysses_attention, arrs, causal=causal)
    got, ggot = _torch_run(ulysses_attention, arrs, causal=causal)
    _close(got, want)
    for g, w in zip(ggot, gwant):
        _close(g, w)


def test_auto_impl_is_dense_on_the_host(monkeypatch):
    calls = []
    monkeypatch.setattr(sp, "_ring_dense",
                        lambda *a, **k: calls.append(1) or
                        sp.__dict__["_ring_flash"](*a))
    arrs = _qkv()
    ring_attention(*(torch.from_numpy(a) for a in arrs), _tmesh())
    assert calls == [1]


def test_divisibility_errors_match_jax():
    q = np.zeros((1, 6, 30, 8), np.float32)
    for jfn, tfn in ((jsp.ring_attention, ring_attention),
                     (jsp.ulysses_attention, ulysses_attention)):
        with pytest.raises(Exception) as je:
            jfn(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), _jmesh())
        t = torch.from_numpy(q)
        with pytest.raises(MXNetError) as te:
            tfn(t, t, t, _tmesh())
        assert str(te.value) == str(je.value)
    q = np.zeros((1, 6, 32, 8), np.float32)
    with pytest.raises(Exception) as je:
        jsp.ulysses_attention(*(jnp.asarray(q),) * 3, _jmesh())
    t = torch.from_numpy(q)
    with pytest.raises(MXNetError) as te:
        ulysses_attention(t, t, t, _tmesh())
    assert str(te.value) == str(je.value)


def _recording(monkeypatch):
    """Records every block's lse as the ring's merge receives it, and the
    lse cotangent each backward receives."""
    seen = {"lse": [], "glse": []}
    fwd = tattn.flash_attention_with_lse
    bwd = tattn.reference_flash_attention_bwd

    def rec_fwd(*a, **k):
        o, lse = fwd(*a, **k)
        seen["lse"].append(lse.detach().clone())
        return o, lse

    def rec_bwd(q, k, v, o, lse, do, glse=None, *rest):
        seen["glse"].append(None if glse is None else glse.clone())
        return bwd(q, k, v, o, lse, do, glse, *rest)

    monkeypatch.setattr(tattn, "flash_attention_with_lse", rec_fwd)
    monkeypatch.setattr(tattn, "reference_flash_attention_bwd", rec_bwd)
    return seen


def test_flash_ring_blocks_have_no_empty_rows_and_get_glse(monkeypatch):
    """No block call of the causal ring has a row without keys, so no
    empty-row lse (+inf from the kernel, -inf from the plain version)
    ever reaches the merge; the backward runs n^2 times, and the blocks
    the merge keeps get a non-zero lse cotangent (all but rank 0's
    diagonal: its only block, whose lse cancels out of the merge)."""
    seen = _recording(monkeypatch)
    arrs = _qkv(seed=5)
    _torch_run(ring_attention, arrs, causal=True, impl="flash")
    assert len(seen["lse"]) == N * N
    for lse in seen["lse"]:
        assert torch.isfinite(lse).all()
    assert len(seen["glse"]) == N * N
    kept = [g for g in seen["glse"] if g is not None]
    # the diagonal (n) and the blocks from lower ranks (n(n-1)/2)
    assert len(kept) == N + N * (N - 1) // 2
    assert sum(float(g.abs().max()) > 0 for g in kept) == len(kept) - 1


def test_empty_row_lse_would_poison_the_merge():
    """The merge is exposed to an empty row's +inf lse (the kernel's
    value): a +inf reaching it makes the output non-finite, which the
    test above rules out for the ring's blocks."""
    o = torch.zeros(1, 1, 2, 4)
    lse = torch.full((1, 1, 2), float("-inf"))
    o_i = torch.ones(1, 1, 2, 4)
    lse_i = torch.tensor([[[0.5, float("inf")]]])
    out, _ = sp._merge(o, lse, o_i, lse_i)
    assert torch.isfinite(out[0, 0, 0]).all()
    assert not torch.isfinite(out[0, 0, 1]).all()


def test_controls_fail(monkeypatch):
    """The two controls of the card's ring check disagree here too:
    off-diagonal blocks left unmasked, and the lse cotangent dropped."""
    arrs = _qkv(seed=7)
    want, gwant = _jax_run(jsp.ring_attention, arrs, causal=True,
                           impl="flash")
    fwd, merge = tattn.flash_attention_with_lse, sp._merge
    last = {}

    def keep_lse(*a, **k):
        o, last["lse"] = fwd(*a, **k)
        return o, last["lse"]

    # every block merged with its own lse: the -inf mask undone
    with monkeypatch.context() as m:
        m.setattr(tattn, "flash_attention_with_lse", keep_lse)
        m.setattr(sp, "_merge", lambda o, lse, o_i, lse_i: merge(
            o, lse, o_i, last["lse"]))
        unmasked, _ = _torch_run(ring_attention, arrs, causal=True,
                                 impl="flash")
    assert float(np.abs(unmasked - want).max()) > 1e-2

    def no_glse(*a, **k):
        o, lse = fwd(*a, **k)
        return o, lse.detach()

    monkeypatch.setattr(tattn, "flash_attention_with_lse", no_glse)
    got, ggot = _torch_run(ring_attention, arrs, causal=True, impl="flash")
    _close(got, want)              # the forward is unchanged
    assert max(float(np.abs(g - w).max())
               for g, w in zip(ggot, gwant)) > 1e-3


def _jax_collective(body, x, out_spec_axis=None):
    """``body`` under the JAX package's shard_map over 4 CPU devices, x
    split on axis 0 (one shard a device); each device's result stacked on
    a new leading axis."""
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.parallel.mesh import shard_map
    fn = shard_map(lambda s: body(s)[None], mesh=_jmesh(),
                   in_specs=(P("sp"),), out_specs=P("sp"))
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["psum", "pmean", "psum_scatter",
                                  "all_gather", "ppermute", "all_to_all"])
def test_collectives_match_jax_lax(name):
    """The mesh's collectives over per-replica lists against jax.lax's
    over a named axis: replica r's list entry against device r's value."""
    from mxnet_tpu_torch.parallel import mesh as M
    rng = np.random.RandomState(9)
    x = rng.normal(size=(N * 4, 8, 4)).astype(np.float32)
    perm = [(0, 2), (2, 1), (1, 3)]         # replica 0 receives nothing
    lax = jax.lax
    jbody, tfn = {
        "psum": (lambda s: lax.psum(s, "sp"), M.psum),
        "pmean": (lambda s: lax.pmean(s, "sp"), M.pmean),
        "psum_scatter": (lambda s: lax.psum_scatter(
            s, "sp", scatter_dimension=0, tiled=True), M.psum_scatter),
        "all_gather": (lambda s: lax.all_gather(s, "sp", tiled=True),
                       M.all_gather),
        "ppermute": (lambda s: lax.ppermute(s, "sp", perm),
                     lambda xs: M.ppermute(xs, perm)),
        "all_to_all": (lambda s: lax.all_to_all(
            s, "sp", split_axis=1, concat_axis=2, tiled=True),
            lambda xs: M.all_to_all(xs, 1, 2)),
    }[name]
    want = _jax_collective(jbody, x)
    got = tfn([torch.from_numpy(s) for s in np.split(x, N)])
    assert len(got) == N
    for r in range(N):
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=1e-6,
                                   atol=1e-6)
