"""Random state of the port (counterpart of mxnet_tpu/random.py).

The JAX package threads explicit keys; the port draws from explicit
``torch.Generator`` objects. :func:`seed` fixes the port-owned default
generators (one per device, created on first use from that seed), which
initializers, ``nd.random``, ``Dropout`` and the executor use when no generator is passed. The numbers
differ from the JAX package's for the same seed: tests hand both packages
the same numpy draws instead.

:func:`get_state` / :func:`set_state` snapshot and restore the seed and
every default generator made so far (the CPU's and each card's), JSON-
safe, for checkpoints: a resumed run draws what the uninterrupted one
would. They are not the JAX package's key, and neither package reads
the other's.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "get_state", "set_state"]

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


def get_state():
    """{"seed": the last seed or None, "generators": {device: state as
    a list of byte values}} of the default generators made so far."""
    with _LOCK:
        return {"seed": _SEED[0],
                "generators": {str(d): g.get_state().tolist()
                               for d, g in _GENERATORS.items()}}


def set_state(state):
    """Restore :func:`get_state`'s snapshot: the seed, and each listed
    generator of a device this process sees (made now if it was not)."""
    with _LOCK:
        _SEED[0] = state.get("seed")
        _GENERATORS.clear()
    for dev, st in state.get("generators", {}).items():
        d = torch.device(dev)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            continue
        gen = generator(d)
        gen.set_state(torch.tensor(st, dtype=torch.uint8))
