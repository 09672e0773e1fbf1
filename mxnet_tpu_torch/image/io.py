"""ImageRecordIter: the record image pipeline (counterpart of
mxnet_tpu/image/io.py; the C++ iterator src/io/iter_image_recordio_2.cc).

Two routes, as the JAX factory's:

- the card route (``_NativeImageRecordIter``, the JAX package's native
  C++ pipeline's counterpart), when the augmentations are within
  ``_NATIVE_AUG_KEYS`` (resize, rand_crop, rand_mirror, mean, std) and
  the payloads are JPEG. A producer thread walks the epoch's order a
  batch at a time: ``preprocess_threads`` host threads read the records
  and draw each one's crop and mirror (``assemble.plan_record``: the
  pipeline's xorshift64* from its per-record seed), nvJPEG decodes the
  batch into one device buffer (``codec.decode_batch``, a chunk a
  thread, each on a stream of its own), and the assembly kernel builds
  the (B, 3, H, W) batch on the card (``assemble.assemble``, one
  launch). Every buffer the producer makes is allocated on the
  iterator's own stream, and the decode streams wait on it, so the
  caching allocator never hands the producer a block that work on
  another stream (the training step's) may still read.
  ``prefetch_buffer`` batches wait in a queue. With ``ctx=cpu()`` the same
  route decodes on the host (OpenCV or PIL) and assembles with the plain
  version, for the tests;
- otherwise the Python route, ``_RawImageRecordIter`` (the augmenter
  list of ``image.CreateAugmenter`` on each decoded image, on ``ctx``),
  wrapped in ``io.PrefetchingIter``.

Batches come back as NDArrays on ``ctx`` (default: the current context,
the card), so ``DataParallelTrainer`` and ``Module.fit`` take them
without a host copy.
"""
from __future__ import annotations

import collections
import concurrent.futures
import os
import queue
import random as pyrandom
import threading
import time

import numpy as np
import torch

from .. import config
from .. import io as io_mod
from .. import recordio
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, array
from . import assemble as _asm
from . import codec
from .image import (AUG_KEYS, CreateAugmenter, IMAGENET_DEFAULT_MEAN,
                    IMAGENET_DEFAULT_STD, _tensor, imdecode)

__all__ = ["ImageRecordIter"]


def _ctx(ctx):
    return Context(ctx) if ctx is not None else current_context()


class _RawImageRecordIter(io_mod.DataIter):
    """The Python route: decode and the augmenter list, image by image on
    a thread pool, batched on ``ctx``."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, preprocess_threads=4,
                 label_width=1, data_name="data",
                 label_name="softmax_label", round_batch=True,
                 num_parts=1, part_index=0, seed=0,
                 output_dtype="float32", ctx=None, **aug_kwargs):
        super().__init__(batch_size)
        if output_dtype == "uint8" and (
                aug_kwargs.get("mean") is not None
                or aug_kwargs.get("std") is not None):
            raise MXNetError("uint8 output excludes host-side mean/std — "
                             "normalize on device instead")
        self.ctx = _ctx(ctx)
        self._out_u8 = output_dtype == "uint8"
        self._label_width = label_width
        self._round_batch = round_batch
        self.data_shape = tuple(data_shape)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, preprocess_threads))
        self._aug = CreateAugmenter(self.data_shape, **{
            k: v for k, v in aug_kwargs.items() if k in AUG_KEYS})
        self._rng = pyrandom.Random(seed)
        if path_imgidx:
            self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                                   "r")
            seq = list(self._rec.keys)
        elif shuffle or num_parts > 1:
            self._rec = recordio.MXIndexedRecordIO(None, path_imgrec, "r")
            seq = list(self._rec.keys)
        else:
            self._rec = recordio.MXRecordIO(path_imgrec, "r")
            seq = None
        if seq is not None and num_parts > 1:
            part = len(seq) // num_parts
            seq = seq[part_index * part:(part_index + 1) * part]
        self._seq = seq
        self._shuffle = shuffle
        self._cur = 0
        c, h, w = self.data_shape
        self.provide_data = [io_mod.DataDesc(data_name, (batch_size, c, h, w))]
        self.provide_label = [io_mod.DataDesc(
            label_name, (batch_size,) if label_width == 1
            else (batch_size, label_width))]
        self.reset()

    def reset(self):
        self._cur = 0
        if self._seq is not None:
            if self._shuffle:
                self._rng.shuffle(self._seq)
        else:
            self._rec.reset()

    def _read_raw(self):
        if self._seq is not None:
            if self._cur >= len(self._seq):
                return None
            s = self._rec.read_idx(self._seq[self._cur])
            self._cur += 1
            return s
        return self._rec.read()

    def _decode_one(self, s):
        header, img = recordio.unpack(s)
        img = imdecode(img, ctx=self.ctx)
        for aug in self._aug:
            img = aug(img)
        label = np.asarray(header.label, dtype=np.float32).reshape(-1)
        return _tensor(img), label

    def next(self):
        raws = []
        while len(raws) < self.batch_size:
            s = self._read_raw()
            if s is None:
                break
            raws.append(s)
        if not raws:
            raise StopIteration
        pad = self.batch_size - len(raws)
        decoded = list(self._pool.map(self._decode_one, raws))
        c, h, w = self.data_shape
        batch_data = torch.zeros((self.batch_size, h, w, c),
                                 dtype=torch.float32,
                                 device=self.ctx.torch_device())
        batch_label = np.zeros((self.batch_size, self._label_width),
                               np.float32)
        for i, (d, l_) in enumerate(decoded):
            batch_data[i] = d
            batch_label[i, :len(l_)] = l_[:self._label_width]
        if pad and self._round_batch and decoded:
            for i in range(len(decoded), self.batch_size):
                d, l_ = decoded[i % len(decoded)]
                batch_data[i] = d
                batch_label[i, :len(l_)] = l_[:self._label_width]
        data_nchw = batch_data.permute(0, 3, 1, 2).contiguous()
        if self._out_u8:
            data_nchw = torch.clamp(data_nchw, 0, 255).to(torch.uint8)
        label = batch_label[:, 0] if self._label_width == 1 else batch_label
        return io_mod.DataBatch(data=[NDArray(data_nchw)],
                                label=[array(label, ctx=self.ctx)],
                                pad=pad, provide_data=self.provide_data,
                                provide_label=self.provide_label)


class _NotJpeg(MXNetError):
    """The card route cannot take this file (the Python route can)."""


class _NativeImageRecordIter(io_mod.DataIter):
    """The card route (see the module's docstring). ``last_plans``: the
    last batch's plans (``assemble.RecordPlan`` a slot), ``last_draws``
    their (resized h, w, y0, x0, mirror); ``stage_seconds``: the
    producer's seconds in reading and drawing, decoding and assembling,
    a (read, decode, assemble) triple for each of the last
    ``STAGE_HISTORY`` batches it made (the first after a reset makes its
    threads' codec contexts)."""

    STAGE_HISTORY = 256

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle=False,
                 preprocess_threads=4, label_width=1, data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0,
                 seed=0, resize=0, rand_crop=False, rand_mirror=False,
                 mean=None, std=None, prefetch_depth=2,
                 output_dtype="float32", ctx=None):
        super().__init__(batch_size)
        if mean is True:
            mean = IMAGENET_DEFAULT_MEAN
        if std is True:
            std = IMAGENET_DEFAULT_STD
        if output_dtype not in ("float32", "uint8"):
            raise ValueError("out_dtype must be float32 or uint8")
        if output_dtype == "uint8" and (mean is not None or std is not None):
            raise ValueError("uint8 output excludes host-side mean/std — "
                             "normalize on device instead")
        offsets, lengths = recordio.scan_record_positions(path_imgrec)
        idx = np.arange(len(offsets))
        if num_parts > 1:
            part = len(idx) // num_parts
            idx = idx[part_index * part:(part_index + 1) * part]
        if len(idx) == 0:
            raise _NotJpeg(f"no records in {path_imgrec}")
        self._fd = os.open(path_imgrec, os.O_RDONLY)
        self._offsets, self._lengths = offsets, lengths
        _, payload = _asm.split_record(self._read(int(idx[0])), label_width)
        if not codec.is_jpeg(payload):
            os.close(self._fd)
            self._fd = None
            raise _NotJpeg("first record is not JPEG")
        self.ctx = _ctx(ctx)
        self._device = self.ctx.torch_device()
        self._indices = idx
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._seed = int(seed)
        self._epoch = 0
        self.data_shape = tuple(data_shape)
        self._label_width = label_width
        self._aug = dict(resize=int(resize), rand_crop=bool(rand_crop),
                         rand_mirror=bool(rand_mirror))
        self._mean, self._std = mean, std
        self._dtype = output_dtype
        self._threads = max(1, int(preprocess_threads))
        self._pool = concurrent.futures.ThreadPoolExecutor(self._threads)
        self._depth = max(1, int(prefetch_depth))
        self._queue = None
        self._producer = None
        self._stop = threading.Event()
        self.last_plans = self.last_draws = None
        self.stage_seconds = collections.deque(maxlen=self.STAGE_HISTORY)
        c, h, w = self.data_shape
        self.provide_data = [io_mod.DataDesc(data_name,
                                             (batch_size, c, h, w))]
        self.provide_label = [io_mod.DataDesc(
            label_name, (batch_size,) if label_width == 1
            else (batch_size, label_width))]
        self.reset()

    def _read(self, idx):
        return os.pread(self._fd, int(self._lengths[idx]),
                        int(self._offsets[idx]))

    def _plan(self, idx):
        return _asm.plan_record(
            self._read(idx), lambda p: codec.jpeg_size(p)[:2], self._seed,
            self._epoch, int(idx), self.data_shape,
            self._aug["resize"], self._aug["rand_crop"],
            self._aug["rand_mirror"], self._label_width)

    def plans(self, batch):
        """The host's part of batch ``batch`` of this epoch: the records'
        plans (payload, label, sizes, crop, mirror) and the pad."""
        n = len(self._order)
        start = batch * self.batch_size
        ids = [int(self._order[(start + i) % n])
               for i in range(self.batch_size)]
        pad = max(0, start + self.batch_size - n)
        return list(self._pool.map(self._plan, ids)), pad

    def _decode_card(self, plans):
        sizes = [(p.sh, p.sw) for p in plans]
        offs = np.concatenate([[0], np.cumsum([h * w * 3 for h, w in sizes])])
        with torch.cuda.stream(self._stream):
            raw = torch.empty(int(offs[-1]), dtype=torch.uint8,
                              device=self._device)
        chunks = [c for c in np.array_split(np.arange(len(plans)),
                                            self._threads) if len(c)]
        for side in self._side[:len(chunks)]:
            side.wait_stream(self._stream)
            raw.record_stream(side)

        def run(ids, side):
            with torch.cuda.stream(side):
                codec.decode_batch([plans[i].payload for i in ids], raw,
                                   [offs[i] for i in ids],
                                   [sizes[i] for i in ids])
        list(self._pool.map(run, chunks, self._side))
        return raw, [int(o) for o in offs[:-1]]

    def _decode_host(self, plans):
        imgs = list(self._pool.map(
            lambda p: codec.host_imdecode(p.payload, 1, True), plans))
        for p, im in zip(plans, imgs):
            if im.shape[:2] != (p.sh, p.sw) or im.shape[2] != 3:
                raise MXNetError("decoded size %s differs from the JPEG "
                                 "header's %s" % (im.shape, (p.sh, p.sw)))
        offs = np.concatenate([[0], np.cumsum([im.size for im in imgs])])
        raw = torch.from_numpy(np.concatenate([im.reshape(-1)
                                               for im in imgs]))
        return raw, [int(o) for o in offs[:-1]]

    def _make(self, batch):
        t0 = time.perf_counter()
        plans, pad = self.plans(batch)
        t1 = time.perf_counter()
        card = self._device.type == "cuda"
        raw, offs = (self._decode_card if card else self._decode_host)(plans)
        t2 = time.perf_counter()
        label = np.stack([p.label for p in plans])
        if card:
            with torch.cuda.stream(self._stream):
                data = _asm.assemble(raw, plans, offs, self.data_shape[1:],
                                     self._dtype, self._mean, self._std)
                label_t = torch.from_numpy(label).to(self._device,
                                                     non_blocking=False)
            self._stream.synchronize()
        else:
            data = _asm.assemble(raw, plans, offs, self.data_shape[1:],
                                 self._dtype, self._mean, self._std)
            label_t = torch.from_numpy(label)
        t3 = time.perf_counter()
        self.stage_seconds.append((t1 - t0, t2 - t1, t3 - t2))
        return data, label_t, pad, plans

    def _produce(self, q, stop, nbatches):
        try:
            for b in range(nbatches):
                if stop.is_set():
                    return
                item = self._make(b)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            q.put(None)
        except BaseException as e:           # raised where it is read
            q.put(e)

    def _halt(self):
        if self._producer is not None:
            self._stop.set()
            while self._producer.is_alive():
                try:
                    self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass
            self._producer.join()
            self._producer = None

    def reset(self):
        self._halt()
        order = self._indices.copy()
        if self._shuffle:
            self._rng.shuffle(order)
        self._order = order
        self._epoch += 1
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(self._device)
            self._side = [torch.cuda.Stream(self._device)
                          for _ in range(self._threads)]
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._depth)
        nbatches = -(-len(order) // self.batch_size)
        self._producer = threading.Thread(
            target=self._produce, args=(self._queue, self._stop, nbatches),
            daemon=True)
        self._producer.start()

    def next(self):
        if self._producer is None:
            raise StopIteration
        item = self._queue.get()
        if item is None:
            self._producer.join()
            self._producer = None
            raise StopIteration
        if isinstance(item, BaseException):
            self._producer.join()
            self._producer = None
            raise item
        data, label, pad, plans = item
        if data.is_cuda:
            cur = torch.cuda.current_stream(data.device)
            data.record_stream(cur)
            label.record_stream(cur)
        self.last_plans = plans
        self.last_draws = [p.draws() for p in plans]
        label = label[:, 0] if self._label_width == 1 else label
        return io_mod.DataBatch(data=[NDArray(data)], label=[NDArray(label)],
                                pad=pad, provide_data=self.provide_data,
                                provide_label=self.provide_label)

    def close(self):
        self._halt()
        self._pool.shutdown(wait=True)
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# augmentations the card route implements; anything else -> python
_NATIVE_AUG_KEYS = {"resize", "rand_crop", "rand_mirror", "mean", "std"}


def ImageRecordIter(path_imgrec, data_shape, batch_size, prefetch_buffer=2,
                    ctx=None, **kwargs):
    """The record image pipeline with background prefetch (the C++
    iterator's registry factory, io.cc:29), on ``ctx`` (default: the
    current context, the card). The card route when the requested
    augmentations are within its set and the first payload is JPEG (see
    the module's docstring), else the Python route. ``output_dtype=
    "uint8"``: raw bytes (crop and mirror only, no mean/std), normalized
    on the card by the consumer (``DataParallelTrainer``'s
    ``input_preproc``)."""
    _pass_keys = ("shuffle", "preprocess_threads", "label_width",
                  "data_name", "label_name", "num_parts", "part_index",
                  "seed", "output_dtype")

    # augmentation kwargs with an effect: a falsy unsupported one
    # (brightness=0.0) neither blocks the card route nor is passed to it
    def _has_effect(v):
        if isinstance(v, np.ndarray):
            return v.size > 0
        return bool(v)

    aug_keys = {k for k, v in kwargs.items()
                if k not in _pass_keys + ("path_imgidx", "round_batch")
                and _has_effect(v)}
    if (not config.get("MXNET_TPU_DISABLE_NATIVE_ITER")
            and tuple(data_shape)[0] == 3
            and kwargs.get("round_batch", True)
            and aug_keys <= _NATIVE_AUG_KEYS):
        try:
            return _NativeImageRecordIter(
                path_imgrec, data_shape, batch_size,
                prefetch_depth=max(2, int(prefetch_buffer or 2)), ctx=ctx,
                **{k: v for k, v in kwargs.items()
                   if k in _pass_keys or k in (aug_keys & _NATIVE_AUG_KEYS)})
        except (_NotJpeg, IOError):
            pass                  # non-JPEG payloads: the Python route
    inner = _RawImageRecordIter(path_imgrec=path_imgrec,
                                data_shape=data_shape,
                                batch_size=batch_size, ctx=ctx, **kwargs)
    if prefetch_buffer and int(prefetch_buffer) > 0:
        return io_mod.PrefetchingIter(inner)
    return inner
