"""Gluon layers of the port (counterpart of mxnet_tpu/gluon/nn)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
from . import basic_layers, conv_layers, transformer  # noqa: F401

__all__ = basic_layers.__all__ + conv_layers.__all__ + transformer.__all__
