"""Gluon layers of the port (subset of mxnet_tpu/gluon/nn)."""
from .basic_layers import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
