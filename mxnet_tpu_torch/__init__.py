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
dK/dV) kernels; the fused 1x1 convolution with a BN prologue and a
BN-statistics epilogue (``ops.conv_fused.conv1x1``); runtime compilation
of CUDA C++ through NVRTC (``rtc.CudaModule``); the symbolic training
path (``nd`` arrays over tensors, the op registry, ``sym.Symbol``,
``simple_bind`` and the executor, ``mod.Module.fit`` with ``io``,
``metric``, ``lr_scheduler``, ``callback`` and ``model`` checkpoints);
data-parallel training (``parallel.DataParallelTrainer`` over a mesh,
with ``step_k`` as CUDA graph replays, ``kvstore``, ``Module`` over
several contexts and ``fit(steps_per_dispatch=K)``).
Entry points run on the card unless the caller asks for the host
(``device="cpu"``, ``ctx=cpu()``, ``with cpu():``; the ops follow their
tensors' device).
"""
from .base import AttrScope, MXNetError, NameManager
from .context import Context, cpu, current_context, gpu, resolve_device
from . import autograd, initializer, optimizer, random, rtc  # noqa: F401
from . import initializer as init  # noqa: F401
from . import ops  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import executor, imperative  # noqa: F401
from . import callback, io, lr_scheduler, metric, model  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import kvstore, parallel  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import gluon  # noqa: F401

__version__ = "0.4.0"

__all__ = ["AttrScope", "MXNetError", "NameManager", "Context", "cpu",
           "gpu", "current_context", "resolve_device",
           "autograd", "callback", "executor", "gluon", "imperative", "init",
           "initializer", "io", "kv", "kvstore", "lr_scheduler", "metric",
           "mod", "model", "module", "nd", "ndarray", "optimizer",
           "parallel", "random", "rtc", "sym", "symbol"]
