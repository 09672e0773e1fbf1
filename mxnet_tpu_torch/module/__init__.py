"""``mx.mod``: symbolic training modules (counterpart of
mxnet_tpu/module/). ``BucketingModule``, ``SequentialModule`` and
``PythonModule`` are not ported yet (ROADMAP queue 1 item 12)."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
