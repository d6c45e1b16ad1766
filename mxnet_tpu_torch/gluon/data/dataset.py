"""Datasets.

Counterpart of ``mxnet_tpu/gluon/data/dataset.py`` (reference:
python/mxnet/gluon/data/dataset.py: Dataset, SimpleDataset, ArrayDataset,
RecordFileDataset, _LazyTransformDataset), unchanged in behaviour: host
objects indexed by the loader, with ``filter``, ``shard``, ``take``,
``sample``, ``transform`` and ``transform_first``.
"""
from __future__ import annotations

from typing import Any, Callable, List

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__ (reference: data.Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn: Callable) -> "Dataset":
        indices = [i for i in range(len(self)) if fn(self[i])]
        return _FilteredDataset(self, indices)

    def shard(self, num_shards: int, index: int) -> "Dataset":
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _ShardedDataset(self, list(range(start, end)))

    def take(self, count: int) -> "Dataset":
        return _ShardedDataset(self, list(range(min(count, len(self)))))

    def sample(self, sampler) -> "Dataset":
        return _ShardedDataset(self, list(sampler))

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _FilteredDataset(SimpleDataset):
    def __init__(self, dataset, indices):
        super().__init__(dataset)
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


_ShardedDataset = _FilteredDataset


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset, fn):
        self._data = dataset
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays (reference: data.ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data: List[Any] = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has length " \
                "%d while array[%d] has %d." % (self._length, i, len(data))
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)


class RecordFileDataset(Dataset):
    """Dataset over an indexed RecordIO file (reference:
    data.RecordFileDataset over MXIndexedRecordIO)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        self._filename = filename
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
