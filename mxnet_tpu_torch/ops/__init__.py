"""Operators of the port: attention and weight-only quantized matmul,
each a hand-written CUDA kernel beside its plain PyTorch version, and the
neural-network ops of the training path (``nn``)."""
from . import attention, nn, quantization  # noqa: F401
