"""bfloat16 and float16 attention against the JAX package, and the f32
kernels' 3xTF32 products emulated, on the CPU.

* Parity: the same seeded numpy inputs, cast to bf16 / f16, go through
  the JAX package (bf16: its Pallas kernels under the interpreter,
  ``force="interpret"``; f16: its XLA path, ``force="xla"``) and through
  the port's plain versions on CPU tensors: the forward (out, lse), the
  three gradients of the trainable attention, and a decode step. Outputs
  keep the JAX package's dtypes: out, dq, dk, dv and the decode output in
  the inputs' type, lse in float32. Tolerance: out, gradients and decode
  element by element within 2 units of (one ulp of the reference there +
  one ulp of the root-sum-square of the terms it sums), in the output
  type (``mxnet_tpu_torch.test_utils.half_units``): the JAX kernels round
  P and dS to the input type before their second product, which moves an
  element by a fraction of its terms, and the port's plain versions
  compute in f32 and round once; lse 1e-5 absolute plus 1e-5 relative
  (f32). The same attention with one tile of keys left out of every row
  must fail that check.
* Precision of the card's f32 kernels (csrc/mxt_tc.cuh): every product
  runs as three TF32 products (small*big + big*small + big*big of
  big = tf32(x), small = tf32(x - big)), emulated here in torch with f32
  accumulation. The emulated flash forward and dQ stay within 4x the
  plain f32 versions' own error against float64 (the bound chip_smoke.py
  and the card tests hold the kernels to); a single TF32 pass exceeds it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch import test_utils as U
from mxnet_tpu_torch.ops import attention as TA

ULPS = 2
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
F64_FACTOR = 4
DTYPES = [(jnp.bfloat16, torch.bfloat16, "interpret"),
          (jnp.float16, torch.float16, "xla")]
DT_IDS = ["bf16", "f16"]


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _inputs(h, h_kv, s, d, seed, jdt):
    rng = np.random.RandomState(seed)
    shapes = ((2, h, s, d), (2, h_kv, s, d), (2, h_kv, s, d), (2, h, s, d))
    return [jnp.asarray(rng.standard_normal(sh).astype(np.float32))
            .astype(jdt) for sh in shapes]


def _ref(x):
    return torch.from_numpy(_np(x))


def _torch(x, tdt):
    return torch.from_numpy(_np(x)).to(tdt)


CASES = [(4, 4, 64, 64, True), (4, 2, 40, 128, False), (4, 1, 48, 64, True),
         (2, 2, 33, 32, False)]
CASE_IDS = ["mha-causal", "gqa-d128", "mqa-causal", "ragged-d32"]


@pytest.mark.parametrize("h,h_kv,s,d,causal", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("jdt,tdt,force", DTYPES, ids=DT_IDS)
def test_forward_and_gradients_match_jax(jdt, tdt, force, h, h_kv, s,
                                         d, causal):
    jq, jk, jv, jdo = _inputs(h, h_kv, s, d, s + d + h_kv, jdt)

    def f(q, k, v):
        return JA.flash_attention_with_lse(q, k, v, causal=causal,
                                           force=force)
    (j_out, j_lse), vjp = jax.vjp(f, jq, jk, jv)
    j_grads = vjp((jdo, jnp.zeros_like(j_lse)))

    tq, tk, tv = (_torch(a, tdt).requires_grad_() for a in (jq, jk, jv))
    t_out, t_lse = TA.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    t_do = _torch(jdo, tdt)
    t_out.backward(t_do)
    terms = U.attention_term_scales(tq.detach(), tk.detach(), tv.detach(),
                                    causal, o=t_out.detach(), do=t_do)
    assert U.half_units(t_out.detach(), _ref(j_out), terms[0]) <= ULPS
    np.testing.assert_allclose(t_lse.detach().numpy(), np.asarray(j_lse),
                               **LSE_TOL)
    for name, t, j, r in zip("qkv", (tq, tk, tv), j_grads, terms[1:]):
        assert t.grad.dtype == tdt and j.dtype == jdt, name
        assert U.half_units(t.grad, _ref(j), r) <= ULPS, name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("jdt,tdt,force", DTYPES, ids=DT_IDS)
def test_check_rejects_a_dropped_key_tile(jdt, tdt, force, causal):
    """The check has teeth: the forward and gradients with keys
    S/2 .. S/2 + 16 left out of every row (a kernel that skipped one K/V
    tile) fail it against the whole attention, at S 256."""
    h, h_kv, s, d = 4, 2, 256, 64
    q, k, v, do = (_torch(a, tdt) for a in _inputs(h, h_kv, s, d, 5, jdt))
    out, lse = TA.reference_attention_with_lse(q, k, v, causal)
    ref = (out, *TA.reference_flash_attention_bwd(q, k, v, out, lse, do,
                                                  causal=causal))
    terms = U.attention_term_scales(q, k, v, causal, o=out, do=do)
    ctrl = U.attention_without_keys(q, k, v, s // 2, s // 2 + 16, causal,
                                    do=do)
    for name, c, r, t in zip(("out", "dq", "dk", "dv"), ctrl, ref, terms):
        assert U.half_units(r, r, t) == 0, name
        assert U.half_units(c, r, t) > ULPS, name


@pytest.mark.parametrize("h,h_kv,d", [(4, 4, 64), (8, 2, 128), (6, 3, 32)],
                         ids=["mha", "gqa4-d128", "gqa2-d32"])
@pytest.mark.parametrize("jdt,tdt,force", DTYPES, ids=DT_IDS)
def test_decode_matches_jax(jdt, tdt, force, h, h_kv, d):
    rng = np.random.RandomState(h + d)
    s = 40
    q = jnp.asarray(rng.standard_normal((3, h, d)), jnp.float32).astype(jdt)
    k, v = (jnp.asarray(rng.standard_normal((3, h_kv, s, d)), jnp.float32)
            .astype(jdt) for _ in range(2))
    lengths = np.array([1, 17, 40], np.int32)
    j_out = JA.decode_attention(q, k, v, jnp.asarray(lengths), force=force)
    tq, tk, tv = (_torch(a, tdt) for a in (q, k, v))
    t_out = TA.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert t_out.dtype == tdt
    terms = U.decode_term_scales(tq, tk, tv, lengths)
    assert U.half_units(t_out, _ref(j_out), terms) <= ULPS


# -- the f32 kernels' tensor-core pieces ---------------------------------------

def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away: the
    card's cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the f32 kernels form it: three TF32 products of the
    operands' big and small pieces, f32 sums."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _mm1(a, b):
    """The control: one TF32 pass, f32 sums."""
    return _tf32(a) @ _tf32(b)


def _attention(q, k, v, mm, causal_mask):
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~causal_mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l)).squeeze(-1)


def _dq(q, k, v, o, lse, do, mm, causal_mask):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~causal_mask, 0.0)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(-1, keepdim=True)) * scale
    return mm(ds, k)


def test_three_tf32_pieces_keep_float32_accuracy():
    """The premise of the f32 flash forward and dQ kernels
    (csrc/mxt_tc.cuh), emulated on the CPU: attention whose products are
    three TF32 products stays within F64_FACTOR times the plain f32
    version's error against float64; one TF32 pass does not."""
    rng = np.random.RandomState(11)
    b, h, s, d = 1, 2, 128, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                    .astype(np.float32)) for _ in range(4))
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = _attention(q64, k64, v64, torch.matmul, mask)
    dq64 = _dq(q64, k64, v64, o64, lse64, do64, torch.matmul, mask)

    plain_o, plain_lse = TA.reference_attention_with_lse(q, k, v, True)
    plain_dq = TA.reference_flash_attention_bwd(q, k, v, plain_o, plain_lse,
                                                do, causal=True)[0]

    def err(got, ref):
        return float((got.double() - ref).abs().max())

    bound_o = F64_FACTOR * err(plain_o, o64)
    bound_dq = F64_FACTOR * err(plain_dq, dq64)
    assert bound_o > 0 and bound_dq > 0
    for mm, within in ((_mm3, True), (_mm1, False)):
        o, lse = _attention(q, k, v, mm, mask)
        dq = _dq(q, k, v, o, lse, do, mm, mask)
        assert (err(o, o64) <= bound_o) == within, (mm.__name__, err(o, o64),
                                                     bound_o)
        assert (err(dq, dq64) <= bound_dq) == within, (mm.__name__,
                                                       err(dq, dq64),
                                                       bound_dq)
