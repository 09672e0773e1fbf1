"""Vision datasets (counterpart of
mxnet_tpu/gluon/data/vision/datasets.py).

MNIST, FashionMNIST, CIFAR10 and CIFAR100 read their local files (idx,
or CIFAR's binary batches) when present under ``root``, else the JAX
package's deterministic synthetic sets (``io._synthetic_mnist``, seeded
templates for CIFAR); nothing is downloaded. Samples are host NDArrays
(uint8 HWC images) and numpy int32 labels: the DataLoader makes the one
copy of a batch to the device. ``ImageRecordDataset`` (a ``.rec`` of
im2rec) and ``ImageFolderDataset`` (one folder a class) decode with
``image.imdecode`` on ``ctx``: the card's nvJPEG by default, as every
entry point of the port, or the host with ``ctx=cpu()``, which a
DataLoader's process workers need (they cannot reach the card).
"""
from __future__ import annotations

import os

import numpy as np

from ....context import cpu
from ..dataset import Dataset, RecordFileDataset
from ....ndarray.ndarray import array
from ....io import (_read_mnist_images, _read_mnist_labels,
                    _synthetic_mnist)

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (train-images-idx3-ubyte under root, or synthetic)."""

    _files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    _synthetic_seed = 0

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        imgf = os.path.join(self._root,
                            self._files[0] if self._train else self._files[2])
        lblf = os.path.join(self._root,
                            self._files[1] if self._train else self._files[3])
        if os.path.exists(imgf) or os.path.exists(imgf + ".gz"):
            images = _read_mnist_images(
                imgf if os.path.exists(imgf) else imgf + ".gz")
            labels = _read_mnist_labels(
                lblf if os.path.exists(lblf) else lblf + ".gz")
            data = images[..., None]
            label = labels.astype(np.int32)
        else:
            n = 4096 if self._train else 1024
            images, labels = _synthetic_mnist(
                n, seed=self._synthetic_seed + (0 if self._train else 1))
            data = (images[..., None] * 255).astype(np.uint8)
            label = labels.astype(np.int32)
        self._data = [array(x, ctx=cpu(), dtype=np.uint8) for x in data]
        self._label = label


class FashionMNIST(MNIST):
    _files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
              "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    _synthetic_seed = 42

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root=root, train=train, transform=transform)


class _CIFAR(_DownloadedDataset):
    _n_classes = 10

    def __init__(self, root, train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        files = sorted(f for f in (os.listdir(self._root)
                                   if os.path.isdir(self._root) else [])
                       if f.endswith(".bin"))
        train_files = [f for f in files if "test" not in f]
        test_files = [f for f in files if "test" in f]
        chosen = train_files if self._train else test_files
        if chosen:
            data, label = [], []
            rec = 3073 if self._n_classes == 10 else 3074
            off = 1 if self._n_classes == 10 else 2
            for f in chosen:
                raw = np.fromfile(os.path.join(self._root, f),
                                  dtype=np.uint8).reshape(-1, rec)
                label.append(raw[:, off - 1])
                data.append(raw[:, off:].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
            data = np.concatenate(data)
            label = np.concatenate(label).astype(np.int32)
        else:
            rng = np.random.RandomState(0 if self._train else 1)
            n = 2048 if self._train else 512
            label = rng.randint(0, self._n_classes, n).astype(np.int32)
            templates = rng.uniform(0, 255, (self._n_classes, 32, 32, 3))
            data = np.clip(templates[label] +
                           rng.normal(0, 30, (n, 32, 32, 3)), 0,
                           255).astype(np.uint8)
        self._data = [array(x, ctx=cpu(), dtype=np.uint8) for x in data]
        self._label = label


class CIFAR10(_CIFAR):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR100(_CIFAR):
    _n_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), fine_label=False,
                 train=True, transform=None):
        super().__init__(root, train, transform)


class ImageRecordDataset(RecordFileDataset):
    """(image, label) of each record of a ``.rec``: the image decoded by
    ``imdecode(flag)`` on ``ctx`` (default: the context current where an
    item is read, the card), the header's label. Under a ``DataLoader``
    with process workers pass ``ctx=cpu()``: a forked worker cannot use
    the card."""

    def __init__(self, filename, flag=1, transform=None, ctx=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform
        self._ctx = ctx

    def __getitem__(self, idx):
        from .... import recordio
        from ....image import imdecode
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        img = imdecode(img, self._flag, ctx=self._ctx)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """(image, label) of every .jpg / .jpeg / .png under ``root``'s
    folders, one folder a class (``synsets``, in sorted order), decoded
    by ``imread(flag)`` on ``ctx`` (default: the context current where an
    item is read, the card; ``ctx=cpu()`` under a ``DataLoader`` with
    process workers)."""

    def __init__(self, root, flag=1, transform=None, ctx=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._ctx = ctx
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from ....image import imread
        img = imread(self.items[idx][0], self._flag, ctx=self._ctx)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
