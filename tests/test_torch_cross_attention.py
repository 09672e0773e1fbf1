"""Cross-attention (q's sequence length differs from k's) against the JAX
package, on the CPU.

The JAX package sends S_q != S_k to its XLA path (``_pallas_eligible``),
``reference_attention_with_lse`` with a bottom-right causal mask
(``tril(s_k - s_q)``), differentiated by JAX. The port's entry points send
it to ``dense_attention``, decided by shape before any launch and counted;
its plain flash backward (``reference_flash_attention_bwd``) takes the same
shapes. Covered: S_q < S_k and S_q > S_k (causal rows with no key: out 0,
lse -inf, finite gradients), causal and not, MHA and GQA, the forward and
all three gradients (with an lse cotangent), through
``flash_attention_with_lse`` and through the Gluon
``MultiHeadAttention(query, key)``, from the same seeded numpy inputs.

Tolerance: 1e-5 absolute plus 1e-5 of the reference's largest magnitude
(float32 sums of at most 48 terms taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch import autograd as tag, cpu, gluon as tgluon
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.ops import attention as TA

ATOL = RTOL = 1e-5

SHAPES = [  # (s_q, s_k, h, h_kv)
    (16, 48, 4, 4), (48, 16, 4, 4), (16, 48, 4, 2), (48, 16, 4, 1),
    (7, 33, 2, 2)]
IDS = ["sq<sk", "sq>sk", "sq<sk-gqa", "sq>sk-mqa", "ragged"]


def _close(got, ref, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref),
                                  err_msg=what)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin], ref[~fin], err_msg=what)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0,
                               atol=ATOL + RTOL * scale, err_msg=what)


def _inputs(s_q, s_k, h, h_kv, seed, d=32):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((2, h, s_q, d)).astype(np.float32)
    k = rng.standard_normal((2, h_kv, s_k, d)).astype(np.float32)
    v = rng.standard_normal((2, h_kv, s_k, d)).astype(np.float32)
    do = rng.standard_normal((2, h, s_q, d)).astype(np.float32)
    glse = rng.standard_normal((2, h, s_q)).astype(np.float32)
    return q, k, v, do, glse


def _jax_grads(q, k, v, do, glse, causal):
    """(out, lse) and (dq, dk, dv) of <out, do> + <lse, glse> through the
    JAX package's auto route (its XLA path for S_q != S_k). Rows with no
    key have lse = -inf; their lse cotangent is dropped (their lse does
    not depend on the inputs)."""
    def f(q, k, v):
        out, lse = JA.flash_attention_with_lse(q, k, v, causal=causal)
        g = jnp.where(jnp.isfinite(lse), glse, 0.0)
        return jnp.sum(out * do) + jnp.sum(jnp.where(jnp.isfinite(lse),
                                                     lse, 0.0) * g)
    out, lse = JA.flash_attention_with_lse(q, k, v, causal=causal)
    grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(out), np.asarray(lse)), [np.asarray(g)
                                                for g in grads]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_q,s_k,h,h_kv", SHAPES, ids=IDS)
def test_flash_attention_with_lse_matches_jax(s_q, s_k, h, h_kv, causal):
    q, k, v, do, glse = _inputs(s_q, s_k, h, h_kv, seed=s_q * 7 + s_k)
    (j_out, j_lse), j_grads = _jax_grads(q, k, v, do, glse, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    dense = TA.dense_attention.calls
    t_out, t_lse = TA.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert TA.dense_attention.calls == dense + 1     # routed by shape
    _close(t_out.detach(), j_out, "out")
    _close(t_lse.detach(), j_lse, "lse")
    fin = torch.isfinite(t_lse)
    loss = (t_out * torch.from_numpy(do)).sum() + (
        torch.where(fin, t_lse, 0.0)
        * torch.where(fin, torch.from_numpy(glse), 0.0)).sum()
    loss.backward()
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        assert torch.isfinite(t.grad).all(), name
        _close(t.grad, j, "d" + name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_q,s_k,h,h_kv", SHAPES, ids=IDS)
def test_plain_flash_backward_takes_cross_attention(s_q, s_k, h, h_kv,
                                                    causal):
    """reference_flash_attention_bwd (the plain twin of the backward
    kernels) on S_q != S_k: the forward's causal mask and the key length
    in the GQA sum; glse folded into the row term."""
    q, k, v, do, glse = _inputs(s_q, s_k, h, h_kv, seed=s_q + s_k)
    _, j_grads = _jax_grads(q, k, v, do, glse, causal)
    tq, tk, tv, tdo, tgl = (torch.from_numpy(a) for a in (q, k, v, do, glse))
    out, lse = TA.reference_attention_with_lse(tq, tk, tv, causal)
    got = TA.reference_flash_attention_bwd(tq, tk, tv, out, lse, tdo,
                                           torch.where(torch.isfinite(lse),
                                                       tgl, 0.0),
                                           causal=causal)
    for name, t, j in zip("qkv", got, j_grads):
        assert t.shape == j.shape and t.dtype == torch.float32
        _close(t, j, "d" + name)


def _mha(g, causal):
    return g.nn.MultiHeadAttention(32, 4, causal=causal, prefix="xattn_")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_q,s_k", [(12, 40), (40, 12)],
                         ids=["sq<sk", "sq>sk"])
def test_gluon_multi_head_attention_with_a_key_sequence(s_q, s_k, causal):
    rng = np.random.RandomState(s_q + 3 * s_k + causal)
    query = rng.standard_normal((2, s_q, 32)).astype(np.float32)
    key = rng.standard_normal((2, s_k, 32)).astype(np.float32)
    ct = rng.standard_normal((2, s_q, 32)).astype(np.float32)

    jmx.random.seed(5)
    jnet = _mha(jgluon, causal)
    jnet.initialize(jmx.init.Xavier())
    jq, jk = jmx.nd.array(query), jmx.nd.array(key)
    jnet(jq, jk)                                   # finish deferred shapes
    jparams = jnet.collect_params()
    with jag.record():
        jout = jnet(jq, jk)
        jloss = (jout * jmx.nd.array(ct)).sum()
    jloss.backward()

    tnet = _mha(tgluon, causal)
    load_gluon_params(tnet, {n: p.data().asnumpy()
                             for n, p in jparams.items()}, ctx=cpu())
    tparams = tnet.collect_params()
    assert list(tparams) == list(jparams)
    dense = TA.dense_attention.calls
    with tag.record():
        tout = tnet(torch.from_numpy(query), torch.from_numpy(key))
        tloss = (tout * torch.from_numpy(ct)).sum()
    tloss.backward()
    assert TA.dense_attention.calls == dense + 1
    assert tuple(tout.shape) == (2, s_q, 32)
    _close(tout.detach(), jout.asnumpy(), "out")
    for n, p in tparams.items():
        _close(p.grad(), jparams[n].grad().asnumpy(), "grad " + n)
