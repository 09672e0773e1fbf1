"""Gluon of the port (subset of mxnet_tpu/gluon): blocks are
``torch.nn.Module``s that take and return ``torch.Tensor``s."""
from . import loss, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (DeferredInitializationError, Parameter,  # noqa: F401
                        ParameterDict)
from .trainer import Trainer  # noqa: F401
