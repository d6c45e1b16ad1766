"""Vision data of the port (reference: python/mxnet/gluon/data/vision/)."""
from . import transforms
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageFolderDataset, ImageRecordDataset,
                       SyntheticImageDataset)

__all__ = ["transforms", "MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset",
           "SyntheticImageDataset"]
