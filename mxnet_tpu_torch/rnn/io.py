"""RNN data iterators: bucketed sentence batching (counterpart of
mxnet_tpu/rnn/io.py; the reference's python/mxnet/rnn/io.py).

``BucketSentenceIter`` feeds a ``BucketingModule`` fixed shapes per
bucket: sentences are binned once into dense padded matrices, one per
bucket length; language-model labels are the data shifted left by one;
an epoch is a shuffled list of (bucket, row offset) batch cursors. The
shuffles use ``np.random`` and ``random`` as the JAX package's do, so one
seed of both gives both packages the same batches. Batches are NDArrays
over host tensors (pinned when the current context is a card), as
``io.NDArrayIter``'s are.
"""
from __future__ import annotations

import logging
import random as _pyrandom

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray.ndarray import NDArray

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Map token sequences to int id sequences, growing ``vocab`` when it
    was not given. An unknown word extends the vocab (building mode),
    maps to ``unknown_token``, or raises."""
    building = vocab is None
    if building:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sentence in sentences:
        ids = []
        for word in sentence:
            if word not in vocab:
                if not building and not unknown_token:
                    raise MXNetError(f"unknown token {word!r} and no "
                                     "unknown_token fallback")
                if unknown_token:
                    word = unknown_token
                if word not in vocab:
                    if next_id == invalid_label:
                        next_id += 1
                    vocab[word] = next_id
                    next_id += 1
            ids.append(vocab[word])
        encoded.append(ids)
    return encoded, vocab


def _auto_buckets(lengths, batch_size):
    """One bucket per sentence length that has at least a full batch."""
    counts = np.bincount(lengths)
    return [int(ln) for ln in np.nonzero(counts >= batch_size)[0] if ln > 0]


def _host_array(a):
    """A batch as an NDArray over its own host memory: the bucket matrices
    are shuffled in place by the next reset."""
    t = torch.from_numpy(np.array(a, order="C", copy=True))
    if current_context().device_type == "gpu" and torch.cuda.is_available():
        t = t.pin_memory()
    return NDArray(t)


class BucketSentenceIter(DataIter):
    """Fixed-shape batches of padded sentences, bucketed by length.

    Layout 'NT' yields (batch, time); 'TN' yields (time, batch). Labels
    are the next-token shift of the data (language-model convention)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if layout not in ("NT", "TN"):
            raise MXNetError(f"layout must be 'NT' or 'TN', got {layout!r}")
        lengths = [len(s) for s in sentences]
        if not buckets:
            buckets = _auto_buckets(lengths, batch_size)
        self.buckets = sorted(buckets)
        if not self.buckets:
            raise MXNetError("no buckets: provide `buckets` explicitly")

        # the smallest bucket that fits; longer sentences are dropped
        per_bucket = [[] for _ in self.buckets]
        dropped = 0
        for sent in sentences:
            slot = int(np.searchsorted(self.buckets, len(sent)))
            if slot == len(self.buckets):
                dropped += 1
                continue
            per_bucket[slot].append(sent)
        if dropped:
            logging.warning("BucketSentenceIter: dropped %d sentences "
                            "longer than the largest bucket", dropped)
        self._bucket_data = []
        for width, sents in zip(self.buckets, per_bucket):
            mat = np.full((len(sents), width), invalid_label, dtype=dtype)
            for r, sent in enumerate(sents):
                mat[r, :len(sent)] = sent
            self._bucket_data.append(mat)

        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(self.buckets)
        shape = (batch_size, self.default_bucket_key) \
            if layout == "NT" else (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(data_name, shape, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, layout=layout)]

        self._cursors = []
        self._pos = 0
        self.reset()

    def _shift_labels(self, mat):
        lab = np.roll(mat, -1, axis=1)
        lab[:, -1] = self.invalid_label
        return lab

    def reset(self):
        self._pos = 0
        for mat in self._bucket_data:
            np.random.shuffle(mat)
        self._labels = [self._shift_labels(m) for m in self._bucket_data]
        self._cursors = [
            (b, row)
            for b, mat in enumerate(self._bucket_data)
            for row in range(0, len(mat) - self.batch_size + 1,
                             self.batch_size)]
        _pyrandom.shuffle(self._cursors)

    def next(self):
        if self._pos >= len(self._cursors):
            raise StopIteration
        b, row = self._cursors[self._pos]
        self._pos += 1
        data = self._bucket_data[b][row:row + self.batch_size]
        label = self._labels[b][row:row + self.batch_size]
        if self.layout == "TN":
            data, label = data.T, label.T
        data, label = _host_array(data), _host_array(label)
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[b],
            provide_data=[DataDesc(self.data_name, data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, label.shape,
                                    layout=self.layout)])
