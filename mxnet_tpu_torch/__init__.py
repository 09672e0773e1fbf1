"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package is its
counterpart on PyTorch, module by module under the same names. It imports
``torch`` and ``numpy`` and nothing of JAX or of ``mxnet_tpu``. Every
kernel the JAX package wrote in Pallas for the TPU is, here, a CUDA C++
kernel for ``sm_90a`` under ``csrc/``, built by ``nvcc`` at first use
(``_build.py``) and held against a plain PyTorch version of the same
function.

Covered so far: continuous-batching decode serving
(``serving.DecodeEngine``) with the flash-prefill, decode-attention and
weight-only quantized-matmul kernels. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
from .base import MXNetError
from .context import Context, cpu, gpu, resolve_device

__version__ = "0.1.0"

__all__ = ["MXNetError", "Context", "cpu", "gpu", "resolve_device"]
