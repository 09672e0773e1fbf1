"""Random state of the port (counterpart of mxnet_tpu/random.py).

The JAX package threads explicit keys; the port draws from explicit
``torch.Generator`` objects. :func:`seed` fixes the port-owned default
generators (one per device, created on first use from that seed), which
initializers, ``nd.random``, ``Dropout`` and the executor use when no generator is passed. The numbers
differ from the JAX package's for the same seed: tests hand both packages
the same numpy draws instead.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_LOCK = threading.Lock()
_SEED = [None]
_GENERATORS = {}


def seed(seed_state, ctx=None):
    """Seed the port's default generators (every device; ``ctx`` is
    accepted for the reference's signature)."""
    with _LOCK:
        _SEED[0] = int(seed_state)
        _GENERATORS.clear()


def generator(device="cpu"):
    """The default ``torch.Generator`` of ``device``: seeded by the last
    :func:`seed`, or nondeterministically when none was called."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            if _SEED[0] is None:
                gen.seed()
            else:
                gen.manual_seed(_SEED[0])
            _GENERATORS[dev] = gen
        return gen
