"""Gluon of the port (counterpart of mxnet_tpu/gluon): blocks are
``torch.nn.Module``s that take and return NDArrays, run eagerly through
``mx.nd`` or, hybridized, through the executor; parameters over one
context or several (one buffer, replicated over their mesh); the
``Trainer`` with its kvstore; ``trainer.fused_fit`` (K steps a dispatch
through ``parallel.DataParallelTrainer``); ``gluon.data`` (datasets,
samplers, the DataLoader, vision datasets and transforms); ``gluon.rnn``
(recurrent cells and the fused RNN, LSTM and GRU layers)."""
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, utils, model_zoo, data, rnn, trainer  # noqa: F401

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "loss", "utils", "model_zoo",
           "data", "rnn", "trainer"]
