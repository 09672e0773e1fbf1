"""DataLoader (counterpart of mxnet_tpu/gluon/data/dataloader.py).

Batches are NDArrays on the current context at the time of iteration
(the card unless a ``with mx.cpu():`` scope says otherwise). Samples are
stacked in numpy on the host; on a card the stacked batch is pinned
before its one copy to the device, so the copy is asynchronous.

``num_workers > 0`` fetches batches ahead on a pool (``2 * num_workers``
in flight) chosen by ``worker_type``:

- "thread": threads of this process;
- "process": forked processes. Forking after CUDA is initialised is safe
  only if the child never touches CUDA, so the children stack pure numpy
  (a user's ``batchify_fn`` runs there too, and its NDArrays come back
  pickled through the host) and the parent alone makes the NDArrays.
  The dataset and ``batchify_fn`` reach the children by fork, not
  pickle: each task ships only its index list.
"""
from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from ...context import current_context
from ...ndarray.ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _numpy_batchify(data):
    """Samples stacked into numpy batches (a list of columns for tuple
    samples)."""
    first = data[0]
    if isinstance(first, tuple):
        return tuple(_numpy_batchify(list(col)) for col in zip(*data))
    if isinstance(first, NDArray):
        return np.stack([d.asnumpy() for d in data])
    return np.asarray(data)


def _to_context(arr, ctx):
    """One numpy batch as an NDArray on ``ctx``: float64 becomes float32
    (as ``nd.array`` does); on a card through pinned memory."""
    dev = ctx.torch_device()
    if dev.type != "cuda":
        return array(arr, ctx=ctx)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    host = torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
    return NDArray(host.to(dev, non_blocking=True))


def _wrap_tree(out, ctx):
    """Numpy batches (from a worker or the default stacking) -> NDArrays
    on ``ctx``; NDArrays a user's ``batchify_fn`` made go there too."""
    if isinstance(out, (tuple, list)):
        return [_wrap_tree(o, ctx) for o in out]
    if isinstance(out, np.ndarray):
        return _to_context(out, ctx)
    if isinstance(out, NDArray):
        return out.as_in_context(ctx)
    return out


def default_batchify_fn(data):
    """Stack samples into batch NDArrays on the current context (a list
    of them for tuple samples)."""
    return _wrap_tree(_numpy_batchify(data), current_context())


# process workers' state, installed by the pool's initializer and
# inherited by fork: a task is only its index list (a closure over a
# lambda transform would not pickle)
_PROC_STATE = {}


def _proc_init(dataset, batchify_fn):
    _PROC_STATE["ds"] = dataset
    _PROC_STATE["fn"] = batchify_fn


def _proc_fetch(batch):
    ds, fn = _PROC_STATE["ds"], _PROC_STATE["fn"]
    samples = [ds[idx] for idx in batch]
    return (fn or _numpy_batchify)(samples)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, worker_type="thread"):
        if worker_type not in ("thread", "process"):
            raise ValueError("worker_type must be 'thread' or 'process'")
        self._worker_type = worker_type
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._user_fn = batchify_fn
        self._pool = None
        if self._num_workers and worker_type == "process":
            import multiprocessing
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self._num_workers,
                mp_context=multiprocessing.get_context("fork"),
                initializer=_proc_init, initargs=(dataset, batchify_fn))
        elif self._num_workers:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._num_workers)

    def _fetch(self, batch, ctx):
        """One batch in this process: the user's ``batchify_fn`` under
        ``ctx`` (a worker thread has no ``with`` scope of its own), else
        numpy stacking."""
        samples = [self._dataset[idx] for idx in batch]
        if self._user_fn is None:
            return _numpy_batchify(samples)
        with ctx:
            return self._user_fn(samples)

    def __iter__(self):
        ctx = current_context()
        procs = self._pool is not None and self._worker_type == "process"
        # numpy batches become NDArrays here; a user's batchify_fn output
        # is returned as it is, but what came back from a process
        if self._user_fn is None or procs:
            finish = lambda out: _wrap_tree(out, ctx)  # noqa: E731
        else:
            finish = lambda out: out  # noqa: E731
        if self._pool is None:
            for batch in self._batch_sampler:
                yield finish(self._fetch(batch, ctx))
            return
        if procs:
            submit = lambda b: self._pool.submit(_proc_fetch, b)  # noqa: E731
        else:
            submit = lambda b: self._pool.submit(  # noqa: E731
                self._fetch, b, ctx)
        batches = iter(self._batch_sampler)
        futures = []
        for batch in batches:
            futures.append(submit(batch))
            if len(futures) == 2 * self._num_workers:
                break
        while futures:
            out = finish(futures.pop(0).result())
            nxt = next(batches, None)
            if nxt is not None:
                futures.append(submit(nxt))
            yield out

    def __len__(self):
        return len(self._batch_sampler)
