"""gluon.data.vision: datasets and transforms."""
from .datasets import MNIST, FashionMNIST, CIFAR10, CIFAR100, \
    ImageRecordDataset, ImageFolderDataset
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]
