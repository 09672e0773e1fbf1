"""Head dims beyond the port's first kernels, against the JAX package.

* D = 384 (a multiple of 128 above 256: the port's "wide" kernels on the
  card, the JAX package's Pallas kernels on a TPU): the JAX side runs its
  kernels under the Pallas interpreter (``force="interpret"``), the port
  its plain versions on CPU tensors.
* D = 96 (no kernel in either package): the JAX package's auto route
  takes its XLA path; the port routes to ``dense_attention``, before any
  launch, and counts it.

Forward, backward (gradients through autograd on both sides) and decode,
at a tiny size, from the same seeded numpy inputs. Tolerances as
tests/test_torch_attention.py (forward, decode: 1e-5) and
tests/test_torch_flash_backward.py (gradients: rtol 2e-4, atol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.ops import attention as TA

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(b, h, h_kv, s, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_force(d):
    # 384: the JAX kernels under the interpreter; 96: its own auto route
    return "interpret" if d % 128 == 0 else None


def test_kernel_head_dim_mirrors_the_jax_eligibility_rule():
    for d in range(1, 1200):
        q = np.zeros((1, 2, 128, d), np.float32)
        jax_kernel = JA._pallas_eligible(q, q, platform="tpu")
        dq = np.zeros((1, 2, d), np.float32)
        assert JA._decode_eligible(dq, q, platform="tpu") == jax_kernel
        # the port takes every D the JAX kernels take, and 16 and 32
        assert TA.kernel_head_dim(d) == (jax_kernel or d in (16, 32)), d


@pytest.mark.parametrize("d", [96, 384])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_matches_jax(d, causal):
    q, k, v, _ = _inputs(1, 2, 1, 16, d, seed=d)
    j_out, j_lse = JA.flash_attention_with_lse(q, k, v, causal=causal,
                                               force=_jax_force(d))
    dense = TA.dense_attention.calls
    t_out, t_lse = TA.flash_attention_with_lse(*_t(q, k, v), causal=causal)
    assert TA.dense_attention.calls == dense + (d == 96)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               **FWD_TOL)
    np.testing.assert_allclose(t_lse.detach().numpy(), np.asarray(j_lse),
                               **FWD_TOL)


@pytest.mark.parametrize("d", [96, 384])
def test_backward_matches_jax_vjp(d):
    q, k, v, do = _inputs(1, 2, 2, 16, d, seed=d + 1)
    _, vjp = jax.vjp(lambda q, k, v: JA.flash_attention(
        q, k, v, causal=True, force=_jax_force(d)), q, k, v)
    j = vjp(jnp.asarray(do))
    tq, tk, tv = [x.requires_grad_() for x in _t(q, k, v)]
    dense = TA.dense_attention.calls
    TA.flash_attention(tq, tk, tv, causal=True).backward(torch.from_numpy(do))
    assert TA.dense_attention.calls == dense + (d == 96)
    for t, jg in zip((tq, tk, tv), j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **BWD_TOL)


@pytest.mark.parametrize("d,h_kv", [(96, 2), (384, 2), (384, 1)])
def test_decode_matches_jax(d, h_kv):
    rng = np.random.RandomState(d + h_kv)
    b, h, s = 3, 4, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    lengths = np.array([0, 5, 16], np.int32)
    for i, n in enumerate(lengths):          # stale pool memory
        k[i, :, n:] = 50.0
        v[i, :, n:] = -50.0
    j = JA.decode_attention(q, k, v, lengths, force=_jax_force(d))
    counts = (TA.dense_attention.calls, TA.decode_attention.launches)
    t = TA.decode_attention(*_t(q, k, v), torch.from_numpy(lengths))
    assert (TA.dense_attention.calls,
            TA.decode_attention.launches) == (counts[0] + (d == 96),
                                              counts[1])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **FWD_TOL)
    assert not t[0].any()


def test_kernel_wrappers_name_what_they_do_not_take():
    from mxnet_tpu_torch.base import MXNetError
    # the check runs before any launch, so CPU tensors show the messages
    x = torch.zeros(1, 1, 4, 96)
    g = torch.zeros(1, 1, 4)
    with pytest.raises(MXNetError, match="head dim 96 has no kernel"):
        TA.flash_attention_bwd_dq(x, x, x, x, g, x)
    x = torch.zeros(1, 1, 4, 640)
    with pytest.raises(MXNetError, match="above 512"):
        TA.flash_attention_bwd_dkv(x, x, x, x, g, x)
