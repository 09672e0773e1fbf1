"""Data iterators (counterpart of mxnet_tpu/io.py): ``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter`` (pad, discard and roll_over
last batches; shuffled once by ``np.random`` as the JAX package does),
``ResizeIter``, ``CSVIter`` and ``MNISTIter`` with its synthetic fallback.

Batches are built on the host, as NDArrays over host tensors (pinned
when the current context is a card); the executor copies them into its
bound arrays on the card. ``PrefetchingIter`` and ``ImageRecordIter`` are not ported.
"""
from __future__ import annotations

import logging
import os
import struct

import numpy as np
import torch

from .base import dtype_name
from .context import current_context
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "CSVIter", "MNISTIter"]


class DataDesc(tuple):
    """Name + shape (+dtype +layout) of one input stream
    (io.py DataDesc namedtuple extension)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, (name, shape))
        ret.name = name
        ret.shape = shape
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return (f"DataDesc[{self.name},{self.shape},{self.dtype},"
                f"{self.layout}]")

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch: data list + label list + padding/bucket metadata."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return (f"{self.__class__.__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Base iterator (io.py:182): next/reset/iter protocol plus the
    provide_data/provide_label contract Module binds against."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class ResizeIter(DataIter):
    """Resize another iterator to `size` batches per epoch (io.py:284)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Input data as a sorted list of (name, numpy array)."""
    assert (data is not None) or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {}
    for k, v in data.items():
        out[k] = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
    return list(sorted(out.items()))


def _host_tensor(a, order, pin):
    """A batch source held on the host as a torch tensor, the only copy
    the iterator keeps: float64 becomes float32 (MXNet's default dtype, as
    ``nd.array`` does), rows are taken in ``order`` when shuffled, and the
    memory is pinned when the batches feed a card, so the executor's copy
    of each batch slice to it is asynchronous."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if order is not None:
        a = a[order]
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle + pad/discard/roll_over
    last-batch handling (io.py:546). The sources are pinned when the
    current context is a card."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        data = _init_data(data, allow_empty=False, default_name=data_name)
        label = _init_data(label, allow_empty=True, default_name=label_name)

        self.idx = np.arange(data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
        order = self.idx if shuffle else None
        pin = current_context().device_type == "gpu" and \
            torch.cuda.is_available()
        self.data = [(k, _host_tensor(v, order, pin)) for k, v in data]
        self.label = [(k, _host_tensor(v, order, pin)) for k, v in label]
        del data, label

        if last_batch_handle == "discard":
            n = self.idx.shape[0]
            self.idx = self.idx[:n - n % batch_size]

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle

    def _descs(self, source):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         np.dtype(dtype_name(v.dtype))) for k, v in source]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % \
                self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)
        raise StopIteration

    def _getdata(self, data_source):
        """Host NDArrays of the batch: views of the (pinned) sources, or,
        for a padded last batch, the tail and the head joined."""
        assert self.cursor < self.num_data, "DataIter needs reset."
        c, bs = self.cursor, self.batch_size
        if c + bs <= self.num_data:
            return [NDArray(v[c:c + bs]) for _, v in data_source]
        pad = bs - self.num_data + c
        return [NDArray(torch.cat([v[c:], v[:pad]])) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class CSVIter(DataIter):
    """CSV reader (role of src/io/iter_csv.cc; pure python)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._iter = NDArrayIter(data=data, label=label,
                                 batch_size=batch_size,
                                 last_batch_handle="pad" if round_batch
                                 else "discard",
                                 label_name="label")
        self.provide_data = self._iter.provide_data
        self.provide_label = self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


def _read_mnist_images(path):
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad MNIST image magic {magic}"
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(
            num, rows, cols)


def _read_mnist_labels(path):
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad MNIST label magic {magic}"
        return np.frombuffer(f.read(), dtype=np.uint8)


class MNISTIter(DataIter):
    """MNIST reader (role of src/io/iter_mnist.cc). Reads idx-format files
    from disk; if absent, generates a deterministic synthetic digit set so
    zero-egress environments can still run the LeNet pipeline."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 num_parts=1, part_index=0, synthetic_size=6000, **kwargs):
        super().__init__(batch_size)
        if os.path.exists(image) or os.path.exists(image + ".gz"):
            path = image if os.path.exists(image) else image + ".gz"
            lpath = label if os.path.exists(label) else label + ".gz"
            images = _read_mnist_images(path).astype(np.float32) / 255.0
            labels = _read_mnist_labels(lpath).astype(np.float32)
        else:
            if not silent:
                logging.info("MNISTIter: %s not found, generating synthetic "
                             "digits (%d samples)", image, synthetic_size)
            images, labels = _synthetic_mnist(synthetic_size, seed)
        if num_parts > 1:
            part = len(images) // num_parts
            images = images[part_index * part:(part_index + 1) * part]
            labels = labels[part_index * part:(part_index + 1) * part]
        if flat:
            data = images.reshape(len(images), -1)
        else:
            data = images.reshape(len(images), 1, images.shape[1],
                                  images.shape[2])
        self._iter = NDArrayIter(data=data, label=labels,
                                 batch_size=batch_size, shuffle=shuffle,
                                 last_batch_handle="discard")
        self.provide_data = self._iter.provide_data
        self.provide_label = self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


def _synthetic_mnist(n, seed=0):
    """Deterministic digit-like 28x28 images: each class is a fixed random
    template + per-sample noise — linearly separable enough for convergence
    tests while exercising the full conv pipeline."""
    rng = np.random.RandomState(seed)
    templates = rng.uniform(0, 1, size=(10, 28, 28)).astype(np.float32)
    # smooth the templates so convs have local structure to find
    for _ in range(2):
        templates = (templates +
                     np.roll(templates, 1, axis=1) +
                     np.roll(templates, -1, axis=1) +
                     np.roll(templates, 1, axis=2) +
                     np.roll(templates, -1, axis=2)) / 5.0
    # threshold to stroke-like sparsity (real MNIST mean pixel ≈ 0.13) so
    # gradient scales match the real dataset's
    thresh = np.quantile(templates.reshape(10, -1), 0.85, axis=1)
    templates = np.where(templates > thresh[:, None, None], 1.0, 0.0) \
        .astype(np.float32)
    labels = rng.randint(0, 10, size=n).astype(np.float32)
    noise = rng.normal(0, 0.15, size=(n, 28, 28)).astype(np.float32)
    images = templates[labels.astype(np.int64)] + noise
    return np.clip(images, 0, 1).astype(np.float32), labels
