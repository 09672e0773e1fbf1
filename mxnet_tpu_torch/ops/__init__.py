"""Operators of the port: attention, weight-only quantized matmul and the
fused 1x1 convolution, each a hand-written CUDA kernel beside its plain
PyTorch version, and the neural-network ops of the training path
(``nn``)."""
from . import attention, conv_fused, nn, quantization  # noqa: F401
