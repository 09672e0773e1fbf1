"""Samplers (counterpart of mxnet_tpu/gluon/data/sampler.py).

``RandomSampler`` draws from numpy's global ``np.random.permutation``, as
the JAX package's does, so a run seeded with ``np.random.seed`` visits
the samples in the same order in both packages. ``BatchSampler`` streams
batches from any index sampler: ``last_batch`` "keep" yields the short
tail batch, "discard" drops it, "rollover" carries it into the next
epoch.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_LAST_BATCH_POLICIES = ("keep", "discard", "rollover")


class Sampler:
    """Iterable over sample indices."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Group a sampler's indices into batches.

    last_batch: 'keep' the short tail batch, 'discard' it, or 'rollover'
    it into the next epoch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST_BATCH_POLICIES:
            raise ValueError(f"last_batch must be one of "
                             f"{_LAST_BATCH_POLICIES}, got {last_batch!r}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._carry = []

    def __iter__(self):
        # streaming: never materialize the sampler (it may be lazy/huge)
        batch = self._carry
        self._carry = []
        for index in self._sampler:
            batch.append(index)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if not batch:
            return
        if self._last_batch == "keep":
            yield batch
        elif self._last_batch == "rollover":
            self._carry = batch
        # 'discard': drop the tail

    def __len__(self):
        n = len(self._sampler)
        bs = self._batch_size
        if self._last_batch == "keep":
            return -(-n // bs)
        if self._last_batch == "discard":
            return n // bs
        return (len(self._carry) + n) // bs
