"""Split-KV decode attention (flash-decoding) against the JAX package.

The card's decode kernel (csrc/decode_attention.cu) cuts each slot's pool
into the chunks that ``ops.attention.decode_plan`` picks from the shapes
alone, attends each chunk that holds keys separately (a chunk that starts
at or past the slot's length takes no part), and merges the partials in
split order. ``_split_merge`` below does the same
arithmetic in float32 on the CPU, with the wrapper's plan, and is held
against the JAX decode kernel under the Pallas interpreter
(``decode_attention(..., force="interpret")``) and against the port's
plain version: chunks wholly past the length, lengths 0 and > S (clamped
to S), GQA groups 1, 4, 7 and 16, one split and many. Stale pool memory
past each length holds large values that would show if they leaked.
Tolerance 2e-5 absolute and relative: float32 softmax sums of <= 640
terms in another order.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.ops import attention as TA

TOL = dict(rtol=2e-5, atol=2e-5)


def _split_merge(q, k, v, lengths, chunk, splits):
    """Decode attention as the kernel computes it: per (slot, q head) a
    partial (m, l, acc) per chunk of ``chunk`` keys that holds keys (the
    first ceil(length / chunk) of ``splits``), merged in order."""
    b, h, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    g = h // h_kv
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b, h, d)
    for i in range(b):
        n = min(max(int(lengths[i]), 0), s)
        for hq in range(h):
            kv = hq // g
            parts = []
            for z in range(min(splits, -(-n // chunk))):
                start, end = z * chunk, min(n, (z + 1) * chunk)
                sc = k[i, kv, start:end] @ q[i, hq] * scale
                m = float(sc.max())
                p = torch.exp(sc - m)
                parts.append((m, float(p.sum()), p @ v[i, kv, start:end]))
            if not parts:
                continue                      # no key: zeros
            mt = max(m for m, _, _ in parts)
            lt, acc = 0.0, torch.zeros(d)
            for m, l, a in parts:
                f = math.exp(m - mt)
                lt += l * f
                acc += a * f
            out[i, hq] = acc / lt
    return out


CASES = {
    # b, h, h_kv, s, d, lengths
    "g7_past_end": (3, 7, 1, 512, 64, [0, 700, 130]),
    "g7_kv2_d128": (2, 14, 2, 384, 128, [384, 1]),
    "mha_d32": (2, 4, 4, 512, 32, [257, 0]),
    "g16": (2, 32, 2, 256, 64, [200, 256]),
    "g4_d16": (1, 8, 2, 640, 16, [5]),
    "g7_long": (2, 7, 1, 640, 64, [640, 385]),
}


@pytest.mark.parametrize("sms", [132, 2], ids=["h100_sms", "few_sms"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_merge_matches_jax_interpret(case, sms):
    b, h, h_kv, s, d, lengths = CASES[case]
    rng = np.random.RandomState(len(case) * 7 + sms)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    for i, n in enumerate(lens):              # stale pool memory
        k[i, :, n:] = 40.0
        v[i, :, n:] = -40.0
    tiles, splits, chunk = TA.decode_plan(b, h, h_kv, s, sms)
    assert tiles == -(-(h // h_kv) // TA.DECODE_ROWS)
    assert chunk % TA.DECODE_SPLIT_KEYS == 0 and splits * chunk >= s
    j = np.asarray(JA.decode_attention(q, k, v, lens, force="interpret"))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _split_merge(tq, tk, tv, lens, chunk, splits)
    np.testing.assert_allclose(got.numpy(), j, **TOL)
    np.testing.assert_allclose(
        TA.decode_attention(tq, tk, tv, torch.from_numpy(lens)).numpy(), j,
        **TOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()


@pytest.mark.parametrize("b,h,h_kv,s", [(8, 16, 16, 1024), (8, 28, 4, 1024),
                                        (2, 32, 8, 32768), (1, 4, 4, 7),
                                        (64, 16, 16, 4096), (3, 7, 1, 0),
                                        (1, 1, 1, 131072)])
def test_decode_plan_fills_the_card_from_shapes_alone(b, h, h_kv, s):
    """The plan covers the pool in 128-key multiples with no split wholly
    past S, in at most DECODE_MAX_SPLITS splits; a grid that fills
    DECODE_FULL of the SMs alone is not split, a smaller one spans most of
    DECODE_WAVES waves of them where S and that cap allow."""
    tiles, splits, chunk = TA.decode_plan(b, h, h_kv, s, 132)
    assert chunk >= TA.DECODE_SPLIT_KEYS
    assert chunk % TA.DECODE_SPLIT_KEYS == 0
    assert splits * chunk >= s and (splits - 1) * chunk < max(s, 1)
    assert 1 <= splits <= TA.DECODE_MAX_SPLITS
    blocks = b * h_kv * tiles
    if blocks >= TA.DECODE_FULL * 132:
        assert splits == 1
        return
    most = min(-(-max(s, 1) // TA.DECODE_SPLIT_KEYS), TA.DECODE_MAX_SPLITS)
    assert blocks * splits >= min(TA.DECODE_WAVES * 132 * 0.75,
                                  blocks * most)
    assert blocks * splits < TA.DECODE_WAVES * 132 + blocks
