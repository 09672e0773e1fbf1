"""Operators of the port: attention and weight-only quantized matmul,
each a hand-written CUDA kernel beside its plain PyTorch version."""
from . import attention, quantization  # noqa: F401
