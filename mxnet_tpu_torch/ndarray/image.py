"""``mx.nd.image`` (counterpart of mxnet_tpu/ndarray/image.py):
``mx.nd.image.foo`` is the registered op ``_image_foo`` run
imperatively (``to_tensor``, ``normalize``)."""
from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry


def __getattr__(name):
    from . import __getattr__ as _nd_getattr  # late: avoids an import cycle
    full = "_image_" + name
    if full in _registry._REGISTRY:
        fn = _nd_getattr(full)
        setattr(_sys.modules[__name__], name, fn)
        return fn
    raise AttributeError(f"module 'mxnet_tpu_torch.ndarray.image' has no "
                         f"attribute {name!r}")
