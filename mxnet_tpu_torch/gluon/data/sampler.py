"""Samplers.

Counterpart of ``mxnet_tpu/gluon/data/sampler.py`` (reference:
python/mxnet/gluon/data/sampler.py), unchanged: ``RandomSampler`` draws
its permutation from numpy's global generator, so the same
``np.random.seed`` gives the reference's order.
"""
from __future__ import annotations

import numpy as _np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = _np.random.permutation(self._length)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i, sample in enumerate(dataset) if fn(sample)]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        assert interval <= length
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Wrap a sampler into batches; last_batch in {'keep','discard',
    'rollover'} (reference semantics)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of 'keep', 'discard', or "
                    "'rollover', but got %s" % self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError("last_batch must be one of 'keep', 'discard', or "
                         "'rollover', but got %s" % self._last_batch)
