"""The port's flash backward against the JAX package's, on the CPU.

* ``reference_flash_attention_bwd`` (the plain twin of the dQ and dK/dV
  kernels) against ``mxnet_tpu.ops.attention._flash_pallas_bwd`` run
  under the Pallas interpreter (``interpret=True``), fed the same q, k,
  v, out, lse (broadcast to the TPU kernel's (B*H, S, 8) layout), dO and
  ``g_lse``: causal and not, MHA and GQA, head dims 64, 128 and 256, one
  and two 128-blocks.
* The gradients of the port's trainable ``flash_attention`` and
  ``flash_attention_with_lse`` (its autograd Function, whose CPU
  backward is the plain twin) against ``jax.vjp`` of the JAX functions
  with ``force="interpret"``.
* A ragged S (no TPU tiling) against JAX's dense autodiff.

Inputs are seeded numpy arrays handed to both packages. Tolerance
rtol 2e-4 / atol 2e-5 (the 1e-5 of test_torch_attention.py widened for
the backward's longer sums: ~S products of O(1) terms per gradient
element, summed blockwise on one side and densely on the other).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.ops import attention as TA

TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(b, h, h_kv, s, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    glse = rng.standard_normal((b, h, s)).astype(np.float32)
    return q, k, v, do, glse


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(t_list, j_list):
    for t, j in zip(t_list, j_list):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("with_glse", [False, True], ids=["no_glse", "glse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h_kv,d,s,block", [
    (2, 64, 128, None), (1, 64, 256, 128), (2, 128, 128, None),
    (2, 256, 128, None)], ids=["mha_d64", "gqa_d64_2blk", "mha_d128",
                               "mha_d256"])
def test_plain_backward_matches_jax_pallas_interpret(h_kv, d, s, block,
                                                     causal, with_glse):
    b, h = 1, 2
    q, k, v, do, glse = _inputs(b, h, h_kv, s, d, seed=d + s + h_kv)
    tq, tk, tv, tdo, tglse = _t(q, k, v, do, glse)
    out, lse = TA.flash_attention_fwd(tq, tk, tv, causal=causal)
    lse8 = jnp.broadcast_to(jnp.asarray(lse.numpy()).reshape(b * h, s, 1),
                            (b * h, s, 8))
    scale = 1.0 / d ** 0.5
    j = JA._flash_pallas_bwd(q, k, v, out.numpy(), lse8, do, causal, scale,
                             interpret=True,
                             g_lse=glse if with_glse else None,
                             block_q=block, block_k=block)
    t = TA.reference_flash_attention_bwd(
        tq, tk, tv, out, lse, tdo, tglse if with_glse else None, causal)
    assert t[1].shape == (b, h_kv, s, d)
    _close(t, j)


@pytest.mark.parametrize("h_kv", [2, 1], ids=["mha", "gqa"])
def test_flash_attention_grads_match_jax_vjp_interpret(h_kv):
    q, k, v, do, _ = _inputs(1, 2, h_kv, 128, 64, seed=11 + h_kv)
    _, vjp = jax.vjp(lambda q, k, v: JA.flash_attention(
        q, k, v, causal=True, force="interpret"), q, k, v)
    j = vjp(jnp.asarray(do))
    tq, tk, tv = [x.requires_grad_() for x in _t(q, k, v)]
    before = (TA.flash_attention_bwd_dq.launches,
              TA.flash_attention_bwd_dkv.launches)
    out = TA.flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(do))
    # CPU tensors take the plain twin: no kernel launch is counted
    assert (TA.flash_attention_bwd_dq.launches,
            TA.flash_attention_bwd_dkv.launches) == before
    _close([tq.grad, tk.grad, tv.grad], j)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_with_lse_grads_match_jax_vjp_interpret(causal):
    q, k, v, do, glse = _inputs(1, 2, 2, 128, 64, seed=21)
    _, vjp = jax.vjp(lambda q, k, v: JA.flash_attention_with_lse(
        q, k, v, causal=causal, force="interpret"), q, k, v)
    j = vjp((jnp.asarray(do), jnp.asarray(glse)))
    tq, tk, tv = [x.requires_grad_() for x in _t(q, k, v)]
    out, lse = TA.flash_attention_with_lse(tq, tk, tv, causal=causal)
    torch.autograd.backward([out, lse], _t(do, glse))
    _close([tq.grad, tk.grad, tv.grad], j)
    # lse alone: its cotangent is the only row term (dO is zeros)
    _, vjp_l = jax.vjp(lambda q, k, v: JA.flash_attention_with_lse(
        q, k, v, causal=causal, force="interpret")[1], q, k, v)
    jl = vjp_l(jnp.asarray(glse))
    tq, tk, tv = [x.requires_grad_() for x in _t(q, k, v)]
    TA.flash_attention_with_lse(tq, tk, tv, causal=causal)[1].backward(
        torch.from_numpy(glse))
    _close([tq.grad, tk.grad, tv.grad], jl)


@pytest.mark.parametrize("s,h_kv", [(100, 2), (37, 1)])
def test_ragged_s_matches_jax_dense_autodiff(s, h_kv):
    q, k, v, do, _ = _inputs(2, 2, h_kv, s, 16, seed=s)
    _, vjp = jax.vjp(lambda q, k, v: JA.reference_attention(
        q, k, v, causal=True), q, k, v)
    j = vjp(jnp.asarray(do))
    tq, tk, tv = [x.requires_grad_() for x in _t(q, k, v)]
    TA.flash_attention(tq, tk, tv, causal=True).backward(
        torch.from_numpy(do))
    _close([tq.grad, tk.grad, tv.grad], j)


@pytest.mark.parametrize("sentinel", [float("inf"), float("-inf")])
def test_plain_backward_gives_zero_not_nan_on_empty_rows(sentinel):
    # +inf is the kernel forward's lse of a row with no valid key, -inf
    # the dense forward's: both must give p = 0 for the whole row
    q, k, v, do, glse = _inputs(1, 2, 2, 8, 16, seed=5)
    tq, tk, tv, tdo, tglse = _t(q, k, v, do, glse)
    out, lse = TA.reference_attention_with_lse(tq, tk, tv, causal=True)
    lse = lse.clone()
    lse[:, :, :3] = sentinel
    out = out.clone()
    out[:, :, :3] = 0.0
    dq, dk, dv = TA.reference_flash_attention_bwd(tq, tk, tv, out, lse, tdo,
                                                  tglse, causal=True)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert not dq[:, :, :3].any()
    # the empty rows contribute nothing to dK/dV: same as dropping them
    keep = torch.ones(8, dtype=torch.bool)
    keep[:3] = False
    p_rows = TA.reference_flash_attention_bwd(
        tq, tk, tv, out, lse.masked_fill(~keep, float("inf")), tdo, tglse,
        causal=True)
    np.testing.assert_array_equal(dk.numpy(), p_rows[1].numpy())


def test_wrappers_on_cpu_never_count_launches():
    q, k, v, do, _ = _inputs(1, 2, 2, 16, 16, seed=3)
    tq, tk, tv, tdo = _t(q, k, v, do)
    counts = (TA.flash_attention_fwd.launches,
              TA.flash_attention_bwd_dq.launches,
              TA.flash_attention_bwd_dkv.launches)
    out, lse = TA.flash_attention_fwd(tq, tk, tv, causal=True)
    TA.flash_attention_bwd(tq, tk, tv, out, lse, tdo, None, causal=True)
    assert (TA.flash_attention_fwd.launches,
            TA.flash_attention_bwd_dq.launches,
            TA.flash_attention_bwd_dkv.launches) == counts
