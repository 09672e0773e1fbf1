"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card they build the
kernels from mxnet_tpu_torch/csrc and run them:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerance 1e-4 absolute plus 1e-4 of the reference's largest magnitude:
float32 sums taken in another order (chip_smoke.py states the same).
"""
import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref):
    tol = 1e-4 + 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("s,h_kv,causal,d", [
    (64, 4, True, 64), (100, 4, True, 64), (100, 2, False, 64),
    (7, 1, True, 64), (100, 2, True, 128), (70, 4, False, 128),
    (33, 4, True, 16), (33, 4, True, 32)])
def test_flash_kernel_matches_plain(dev, s, h_kv, causal, d):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(2, 4, s, d, generator=g, device=dev)
    k = torch.randn(2, h_kv, s, d, generator=g, device=dev)
    v = torch.randn(2, h_kv, s, d, generator=g, device=dev)
    n0 = A.flash_attention_fwd.launches
    out, lse = A.flash_attention_fwd(q, k, v, causal=causal)
    assert A.flash_attention_fwd.launches == n0 + 1
    ref, rlse = A.reference_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(out, ref)
    _close(lse, rlse)


@pytest.mark.parametrize("h_kv", [8, 2])
def test_decode_kernel_matches_plain(dev, h_kv):
    from mxnet_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev).manual_seed(h_kv)
    q = torch.randn(4, 8, 64, generator=g, device=dev)
    k = torch.randn(4, h_kv, 80, 64, generator=g, device=dev)
    v = torch.randn(4, h_kv, 80, 64, generator=g, device=dev)
    lengths = torch.tensor([0, 1, 33, 80], dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, lengths)
    _close(out, A.reference_decode_attention(q, k, v, lengths))
    assert not out[0].any()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 256, 512), (3, 100, 50257 // 16),
                                   (37, 300, 129)])
def test_quantized_matmul_kernel_matches_plain(dev, dtype, m, k, n):
    from mxnet_tpu_torch.ops import quantization as Q
    g = torch.Generator(device=dev).manual_seed(m)
    x = torch.randn(m, k, generator=g, device=dev)
    q, s = Q.quantize_rows(torch.randn(k, n, generator=g, device=dev)
                           / math.sqrt(k), dtype)
    _close(Q.quantized_matmul(x, q, s), Q.reference_quantized_matmul(x, q, s))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import attention as A, quantization as Q
    q = torch.randn(1, 2, 8, 64, device=dev)
    with pytest.raises(MXNetError, match="float32"):
        A.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(MXNetError, match="head dim"):
        x = torch.randn(1, 2, 8, 48, device=dev)
        A.flash_attention_fwd(x, x, x)
    with pytest.raises(MXNetError, match="float32"):
        Q.quantized_matmul(torch.randn(2, 4, device=dev).half(),
                           torch.zeros(4, 4, dtype=torch.int8, device=dev),
                           torch.ones(4, device=dev))
