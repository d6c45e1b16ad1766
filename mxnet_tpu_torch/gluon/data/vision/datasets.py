"""Vision datasets.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py`` (reference:
python/mxnet/gluon/data/vision/datasets.py: MNIST, FashionMNIST, CIFAR10,
CIFAR100, ImageFolderDataset, ImageRecordDataset).  The idx(.gz) MNIST
and pickled CIFAR files are read from an existing ``root`` only: nothing
is downloaded.  ``SyntheticImageDataset`` is the deterministic stand-in
(per-class Gaussian prototypes from numpy ``RandomState``s) that smoke
and convergence runs use; the same seeds give the reference's images.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Optional

import numpy as _np

from ..dataset import Dataset, ArrayDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset",
           "SyntheticImageDataset"]


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
    """MNIST from idx-ubyte(.gz) files (reference: datasets.MNIST)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return _np.frombuffer(f.read(), _np.uint8).reshape(dims)

    def _find(self, name):
        for cand in (name, name + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            "MNIST file %s not found under %s (no network egress; place the "
            "idx files there or use SyntheticImageDataset for smoke tests)"
            % (name, self._root))

    def _get_data(self):
        img_name, lbl_name = self._train_files if self._train else \
            self._test_files
        images = self._read_idx(self._find(img_name))
        labels = self._read_idx(self._find(lbl_name))
        self._data = images[..., None]  # HWC, C=1
        self._label = labels.astype(_np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickle batches (reference: datasets.CIFAR10
    reads the binary .bin variant; both are supported here)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _load_pickles(self, names):
        data, labels = [], []
        for n in names:
            path = os.path.join(self._root, n)
            if not os.path.exists(path):
                alt = os.path.join(self._root, "cifar-10-batches-py", n)
                if os.path.exists(alt):
                    path = alt
                else:
                    raise FileNotFoundError(
                        "CIFAR batch %s not found under %s" % (n, self._root))
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            data.append(_np.asarray(batch["data"], _np.uint8))
            labels.extend(batch.get("labels", batch.get("fine_labels")))
        data = _np.concatenate(data).reshape(-1, 3, 32, 32)
        return data.transpose(0, 2, 3, 1), _np.asarray(labels, _np.int32)

    def _get_data(self):
        names = ["data_batch_%d" % i for i in range(1, 6)] if self._train \
            else ["test_batch"]
        self._data, self._label = self._load_pickles(names)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        names = ["train"] if self._train else ["test"]
        self._data, self._label = self._load_pickles(names)


class ImageFolderDataset(Dataset):
    """A folder of class subfolders of images (reference:
    ImageFolderDataset).  Decoding goes through mx.image.imread."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp", ".npy"]
        self.synsets = []
        self.items = []
        self._list_images(self._root)

    def _list_images(self, root):
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = _np.load(path)
        else:
            img = imread(path, self._flag).asnumpy()
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(Dataset):
    """Images in a RecordIO file (reference: ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = self._record[idx]
        header, img = unpack_img(record)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class SyntheticImageDataset(Dataset):
    """Deterministic learnable dataset: per-class Gaussian prototypes.
    Stand-in for MNIST/ImageNet smoke+convergence tests in a no-egress
    environment (the reference nightly uses real data; SURVEY.md §4.4)."""

    def __init__(self, num_samples=1000, shape=(28, 28, 1), num_classes=10,
                 seed=42, noise=0.15, dtype="uint8", proto_seed=1234):
        # class prototypes come from proto_seed so train/test splits built
        # with different `seed`s share the same underlying classes
        protos = _np.random.RandomState(proto_seed).rand(
            num_classes, *shape).astype(_np.float32)
        rng = _np.random.RandomState(seed)
        labels = rng.randint(0, num_classes, num_samples).astype(_np.int32)
        imgs = protos[labels] + noise * rng.randn(num_samples, *shape) \
            .astype(_np.float32)
        imgs = _np.clip(imgs, 0, 1)
        if dtype == "uint8":
            self._data = (imgs * 255).astype(_np.uint8)
        else:
            self._data = imgs.astype(dtype)
        self._label = labels

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]
