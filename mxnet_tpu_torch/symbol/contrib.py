"""``mx.sym.contrib`` (counterpart of mxnet_tpu/symbol/contrib.py): the
symbolic twins of ``mx.nd.contrib``, ``mx.sym.contrib.foo`` composing
the registered op ``_contrib_foo``."""
from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry

_PREFIX = "_contrib_"


def __getattr__(name):
    from . import __getattr__ as _sym_getattr  # late: avoids an import cycle
    full = _PREFIX + name
    if full in _registry._REGISTRY:
        fn = _sym_getattr(full)
    elif name in _registry._REGISTRY:
        fn = _sym_getattr(name)
    else:
        raise AttributeError(f"module 'mxnet_tpu_torch.symbol.contrib' has "
                             f"no attribute {name!r}")
    setattr(_sys.modules[__name__], name, fn)
    return fn
