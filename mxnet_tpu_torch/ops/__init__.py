"""Operators of the port: attention, weight-only quantized matmul and the
fused 1x1 convolution, each a hand-written CUDA kernel beside its plain
PyTorch version; and the registered operators of the symbolic path and
``mx.nd`` (``registry``: ``tensor``, ``nn``, ``optimizer_ops``), plain
PyTorch ops as the JAX package's are plain XLA ops."""
from . import registry  # noqa: F401
from . import attention, conv_fused, nn, quantization  # noqa: F401
from . import optimizer_ops, tensor  # noqa: F401
