"""Operators of the port: attention, weight-only quantized matmul and the
fused 1x1 convolution, each a hand-written CUDA kernel beside its plain
PyTorch version; and the registered operators of the symbolic path and
``mx.nd`` (``registry``: ``tensor``, ``nn``, ``contrib``'s detection
family, ``extra``, ``optimizer_ops``, ``random_ops`` and ``rnn_ops``'
fused RNN), plain PyTorch ops as the JAX package's are plain XLA ops."""
from . import registry  # noqa: F401
from . import attention, conv_fused, nn, quantization  # noqa: F401
from . import contrib, optimizer_ops, random_ops, rnn_ops  # noqa: F401
from . import tensor  # noqa: F401
from . import extra  # noqa: F401  (aliases of the ops above)
