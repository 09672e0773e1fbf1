"""Gluon of the port (counterpart of mxnet_tpu/gluon): blocks are
``torch.nn.Module``s that take and return NDArrays, run eagerly through
``mx.nd`` or, hybridized, through the executor. ``gluon.data``,
``gluon.rnn`` and ``fused_fit`` are not ported yet (ROADMAP queue 1
items 9 and 12)."""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, utils, model_zoo  # noqa: F401

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "loss", "utils", "model_zoo"]
