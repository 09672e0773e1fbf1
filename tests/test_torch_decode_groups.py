"""Decode attention at GQA groups other than 1, 2, 4 and 8, against the
JAX package.

The JAX decode kernel takes any group that divides H
(mxnet_tpu/ops/attention.py:_decode_eligible); here it runs under the
Pallas interpreter (``force="interpret"``), the port its plain version on
CPU tensors (the card runs csrc/decode_attention.cu, whose head tiles
of 1/2/4/8 cover any group: tests/test_torch_kernels_cuda.py). Groups 3,
7 (Qwen2-7B: 28 q heads over 4 kv heads, head dim 128) and 16
(Falcon-40B: 128 over 8, head dim 64), at a few heads. Tolerance 1e-5
absolute and relative: float32 softmax sums of <= 32 terms in another
order, as tests/test_torch_attention.py.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.ops import attention as TA

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,h_kv,d", [(6, 2, 64), (7, 1, 128), (14, 2, 128),
                                      (16, 1, 64), (32, 2, 64)],
                         ids=["g3", "g7", "g7_kv2", "g16", "g16_kv2"])
def test_decode_any_group_matches_jax_interpret(h, h_kv, d):
    rng = np.random.RandomState(h * 10 + h_kv)
    b, s = 3, 32
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h_kv, s, d)).astype(np.float32)
    lengths = np.array([0, 9, 32], np.int32)
    for i, n in enumerate(lengths):          # stale pool memory
        k[i, :, n:] = 50.0
        v[i, :, n:] = -50.0
    j = JA.decode_attention(q, k, v, lengths, force="interpret")
    dense = TA.dense_attention.calls
    t = TA.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(lengths))
    assert TA.dense_attention.calls == dense    # a kernel head dim
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert not t[0].any()


def test_decode_model_serves_a_group_of_7():
    """DecodeModel with 28 q heads over 4 kv heads (Qwen2-7B's grouping)
    at a tiny width: a decode step's logits against a full recompute."""
    from mxnet_tpu_torch.serving.decode import DecodeModel
    model = DecodeModel(vocab=64, layers=2, d_model=448, heads=28,
                        kv_heads=4, d_ff=64, max_len=32)
    model.load_params(model.init_params(seed=0))
    model = model.to("cpu")
    kc, vc = model.init_cache(1, device="cpu")
    toks = torch.tensor([[5, 9, 2, 7]], dtype=torch.int64)
    padded = torch.zeros(1, 8, dtype=torch.int64)
    padded[0, :4] = toks
    kc, vc, tok0, _ = model.prefill(kc, vc, padded, 4, 0)
    _, _, _, _, logits = model.step(
        kc, vc, tok0.reshape(1), torch.tensor([4], dtype=torch.int32),
        torch.tensor([True]))
    kc2, vc2 = model.init_cache(1, device="cpu")
    padded[0, 4] = tok0
    _, _, _, ref = model.prefill(kc2, vc2, padded, 5, 0)
    np.testing.assert_allclose(logits[0].numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-4)
