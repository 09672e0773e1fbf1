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
weight-only quantized-matmul kernels; imperative Gluon training
(``gluon.nn.TransformerEncoder``, ``autograd.record()``,
``gluon.Trainer``) with the flash forward and the flash backward (dQ,
dK/dV) kernels. Entry points run on the card unless the caller asks for
the host (``device="cpu"``, ``ctx=cpu()``).
"""
from .base import MXNetError, NameManager
from .context import Context, cpu, gpu, resolve_device
from . import autograd, initializer, optimizer, random  # noqa: F401
from . import initializer as init  # noqa: F401
from . import gluon  # noqa: F401

__version__ = "0.2.0"

__all__ = ["MXNetError", "NameManager", "Context", "cpu", "gpu",
           "resolve_device", "autograd", "gluon", "init", "initializer",
           "optimizer", "random"]
