"""Gluon data API of the port (reference: python/mxnet/gluon/data/)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,
                      FilterSampler, IntervalSampler)
from .dataloader import (DataLoader, default_batchify_fn,
                         default_mp_batchify_fn)
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler", "DataLoader",
           "default_batchify_fn", "default_mp_batchify_fn", "vision"]
