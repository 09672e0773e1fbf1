"""``mx.nd.contrib`` (counterpart of mxnet_tpu/ndarray/contrib.py):
``mx.nd.contrib.foo`` is the registered op ``_contrib_foo`` run
imperatively, as the reference generates the namespace from its
registry."""
from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry

_PREFIX = "_contrib_"


def __getattr__(name):
    from . import __getattr__ as _nd_getattr  # late: avoids an import cycle
    full = _PREFIX + name
    if full in _registry._REGISTRY:
        fn = _nd_getattr(full)
    elif name in _registry._REGISTRY:
        fn = _nd_getattr(name)
    else:
        raise AttributeError(f"module 'mxnet_tpu_torch.ndarray.contrib' has "
                             f"no attribute {name!r}")
    setattr(_sys.modules[__name__], name, fn)
    return fn
