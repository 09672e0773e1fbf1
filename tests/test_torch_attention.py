"""mxnet_tpu_torch.ops.attention against the JAX package's kernels.

The same numpy inputs (from a seeded RandomState) go through the JAX
Pallas kernels under the interpreter (``force="interpret"``, as
tests/test_attention.py runs them on the CPU) and through the port's
wrappers on CPU tensors, which run the plain PyTorch versions.
Tolerance 1e-5: float32 softmax over <= 32 keys of O(1) scores, summed
in another order (blockwise online softmax vs dense), differs by a few
ulps of values <= ~10.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.ops import attention as TA

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, h, h_kv, s, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_flash_fwd_matches_jax_interpret(causal, h_kv):
    q, k, v = _qkv(2, 4, h_kv, 16, 8, seed=h_kv)
    j_out, j_lse = JA.flash_attention_with_lse(q, k, v, causal=causal,
                                               force="interpret")
    before = TA.flash_attention_fwd.launches
    t_out, t_lse = TA.flash_attention_fwd(*_t(q, k, v), causal=causal)
    # a CPU tensor runs the plain version: no kernel launch counted
    assert TA.flash_attention_fwd.launches == before
    assert t_lse.shape == (2, 4, 16) and t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


def test_flash_attention_output_matches_jax_multi_block():
    # S = 256 tiles the JAX kernel in two 128-blocks: the causal skip and
    # the cross-block online softmax are exercised on the JAX side
    q, k, v = _qkv(1, 2, 2, 256, 16, seed=3)
    j = JA.flash_attention(q, k, v, causal=True, force="interpret")
    t = TA.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_reference_empty_rows_keep_minus_inf_lse():
    # cross-length causal attention leaves the first rows with no key:
    # the dense oracles of both packages give out 0 and lse -inf
    rng = np.random.RandomState(4)
    q = rng.standard_normal((1, 2, 8, 4)).astype(np.float32)
    k = rng.standard_normal((1, 2, 4, 4)).astype(np.float32)
    v = rng.standard_normal((1, 2, 4, 4)).astype(np.float32)
    j_out, j_lse = JA.reference_attention_with_lse(q, k, v, causal=True)
    t_out, t_lse = TA.reference_attention_with_lse(*_t(q, k, v),
                                                   causal=True)
    assert np.isneginf(np.asarray(j_lse)[..., :4]).all()
    np.testing.assert_array_equal(np.isneginf(t_lse.numpy()),
                                  np.isneginf(np.asarray(j_lse)))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


@pytest.mark.parametrize("h_kv", [4, 2], ids=["mha", "gqa"])
def test_decode_attention_matches_jax_interpret(h_kv):
    rng = np.random.RandomState(10 + h_kv)
    b, h, s, d = 4, 4, 32, 8
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    lengths = np.array([0, 1, 19, 32], np.int32)
    # stale pool memory past each cursor is large: a leak would show
    for i, n in enumerate(lengths):
        k[i, :, n:] = 50.0
        v[i, :, n:] = -50.0
    j = JA.decode_attention(q, k, v, lengths, force="interpret")
    before = TA.decode_attention.launches
    t = TA.decode_attention(*_t(q, k, v), torch.from_numpy(lengths))
    assert TA.decode_attention.launches == before
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # lengths == 0 gives zeros in both packages
    assert not t[0].any()


def test_decode_equals_last_row_of_causal_attention():
    # the decode step at length n is row n-1 of causal attention over the
    # first n positions — the identity incremental decode rests on
    q, k, v = _qkv(1, 4, 2, 12, 8, seed=6)
    full = TA.reference_attention(*_t(q, k, v), causal=True)
    tq = torch.from_numpy(q[:, :, 11])
    got = TA.decode_attention(tq, *_t(k, v),
                              torch.tensor([12], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), full[:, :, 11].numpy(), **TOL)
