"""DataLoader.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (reference:
python/mxnet/gluon/data/dataloader.py: DataLoader, _MultiWorkerIter,
worker_loop, default_batchify_fn, default_mp_batchify_fn).

Workers, as in the reference: ``num_workers > 0`` decodes and augments in
a pool of worker processes, the way Python-side augmentation escapes the
GIL; ``thread_pool=True`` takes a thread pool instead.  The process pool:

* starts its workers with ``spawn``: a forked child of a process that
  holds a CUDA context is undefined, a spawned one inherits none;
* pins each worker to the CPU (``_worker_initializer``: no visible CUDA
  device and an explicit ``mx.cpu()`` context), so a worker never touches
  the card, and to one torch thread, as PyTorch's own loader does: the
  work is per sample, and eight workers of eight threads each would only
  contend for the cores;
* ships the dataset and batchify function once per worker, as raw pickle
  bytes unpickled after the pin, not once per batch;
* has the workers return plain numpy trees, which the parent assembles
  into NDArrays.

Where the parent's batches land: with ``pin_memory=True`` in pinned host
memory (page-locked, so a copy to the card can run without blocking, as
``io.DevicePrefetcher`` makes it; plain host memory on a machine without
CUDA, where nothing can be pinned), else on the current context, as
``nd.array`` puts them.  The thread pool's threads run in the context
that was current where the iteration began (the current context is
thread-local).  A ``DataLoader`` iterated by a ``DevicePrefetcher``
therefore assembles its batches on the prefetcher's producer thread.
"""
from __future__ import annotations

import multiprocessing as _mp
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as _np
import torch

from ... import ndarray as nd
from ...base import torch_dtype
from ...device import Context, current_context, in_context
from ...ndarray.ndarray import NDArray
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference: default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return nd.stack(list(data))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    out = _np.asarray(data)
    return nd.array(out)


def default_mp_batchify_fn(data):
    """Worker-side batchify: stack into NumPy (reference:
    default_mp_batchify_fn — workers must not build device arrays)."""
    if isinstance(data[0], NDArray):
        return _np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_mp_batchify_fn(list(i)) for i in data]
    return _np.asarray(data)


def _to_numpy_tree(batch):
    if isinstance(batch, NDArray):
        return batch.asnumpy()
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):  # namedtuple
        return type(batch)(*(_to_numpy_tree(b) for b in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_numpy_tree(b) for b in batch)
    return batch


def _pinned(arr: _np.ndarray) -> NDArray:
    """``arr`` as ``nd.array`` would hold it (float64 data as float32,
    int64 as int32), copied once into pinned host memory where CUDA is
    present."""
    dtype = torch.float32 if arr.dtype == _np.float64 else \
        torch_dtype(arr.dtype)
    out = torch.empty(arr.shape, dtype=dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(torch.from_numpy(_np.ascontiguousarray(arr)))
    return NDArray(out)


def _to_nd_tree(batch, pin=False):
    if isinstance(batch, _np.ndarray):
        return _pinned(batch) if pin else nd.array(batch)
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_to_nd_tree(b, pin) for b in batch))
    if isinstance(batch, (list, tuple)):
        return [_to_nd_tree(b, pin) for b in batch]
    return batch


# -- worker-process globals (reference: worker_loop module state) -----------
_worker_dataset = None
_worker_batchify = None


_worker_init_error = None


def _worker_initializer(dataset_bytes, batchify_bytes):
    """Runs once in each spawned worker: pin the CPU (no visible CUDA
    device, and ``mx.cpu()`` as the worker's current context), then
    unpickle the dataset and batchify function.  They travel as raw pickle
    bytes so that no user object is unpickled before the pin; a pool's
    replacement worker spawns the same way.

    An unpickling failure must not raise here: a raising initializer
    makes multiprocessing respawn dying workers forever and the user only
    sees a timeout.  The error is kept; :func:`_worker_fn` reports it for
    every task."""
    import pickle
    global _worker_dataset, _worker_batchify, _worker_init_error
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    Context("cpu").__enter__()
    # per-sample work: workers of several torch threads each would only
    # contend for the cores
    torch.set_num_threads(1)
    try:
        _worker_dataset = pickle.loads(dataset_bytes)
        _worker_batchify = pickle.loads(batchify_bytes)
    except Exception as e:  # e.g. a dataset class only the parent imports
        _worker_init_error = "%s: %s" % (type(e).__name__, e)


def _worker_fn(indices):
    if _worker_init_error is not None:
        raise RuntimeError(
            "DataLoader worker could not reconstruct the dataset in the "
            "spawned process (%s). The dataset/batchify must be importable "
            "from the worker — move classes out of __main__, or use "
            "thread_pool=True." % _worker_init_error)
    samples = [_worker_dataset[i] for i in indices]
    return _to_numpy_tree(_worker_batchify(samples))


class DataLoader:
    """Iterate a Dataset in mini-batches (reference: gluon.data.DataLoader)."""

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: Optional[str] = None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn: Optional[Callable] = None,
                 num_workers: int = 0, pin_memory: bool = False,
                 pin_device_id: int = 0, prefetch: Optional[int] = None,
                 thread_pool: bool = False, timeout: int = 120):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn
        self._mp_pool = None

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        self._shutdown_pool()

    def _shutdown_pool(self):
        pool = getattr(self, "_mp_pool", None)
        if pool is not None:
            pool.terminate()
            pool.join()
            self._mp_pool = None

    def _get_mp_pool(self):
        """Persistent spawn pool, created lazily and reused across epochs
        (reference keeps its worker pool for the DataLoader's lifetime)."""
        if self._mp_pool is None:
            import pickle
            ctx = _mp.get_context("spawn")
            batchify = self._batchify_fn or default_mp_batchify_fn
            try:
                payload = (pickle.dumps(self._dataset),
                           pickle.dumps(batchify))
            except Exception as e:
                raise RuntimeError(
                    "DataLoader(num_workers=%d) could not spawn workers "
                    "(dataset/batchify must be picklable for the process "
                    "pool — use thread_pool=True for unpicklable ones): %s"
                    % (self._num_workers, e)) from e
            self._mp_pool = ctx.Pool(
                self._num_workers, initializer=_worker_initializer,
                initargs=payload)
        return self._mp_pool

    def _load_batch(self, indices):
        samples = [self._dataset[i] for i in indices]
        if self._pin_memory and self._batchify_fn is None:
            return _to_nd_tree(default_mp_batchify_fn(samples), True)
        return (self._batchify_fn or default_batchify_fn)(samples)

    def _depth(self):
        """In-flight batches: explicit prefetch honored (min 1 — the
        push-one-pop-one floor), default 2x workers."""
        return max(1, self._prefetch)

    def _iter_threads(self):
        """Thread-pool path (thread_pool=True): decode in threads, PIL's C
        codecs release the GIL.  The threads run in the iterating thread's
        context."""
        load = in_context(current_context(), self._load_batch)
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = []
            it = iter(self._batch_sampler)
            try:
                for _ in range(self._depth()):
                    futures.append(pool.submit(load, next(it)))
            except StopIteration:
                pass
            while futures:
                fut = futures.pop(0)
                try:
                    futures.append(pool.submit(load, next(it)))
                except StopIteration:
                    pass
                yield fut.result(timeout=self._timeout)

    def _iter_processes(self):
        """Process-pool path (reference: _MultiWorkerIter) — ordered
        prefetch pipeline over the persistent spawn pool."""
        pool = self._get_mp_pool()
        pending = []
        it = iter(self._batch_sampler)
        try:
            for _ in range(self._depth()):
                pending.append(pool.apply_async(_worker_fn,
                                                (list(next(it)),)))
        except StopIteration:
            pass
        while pending:
            res = pending.pop(0)
            try:
                pending.append(pool.apply_async(_worker_fn,
                                                (list(next(it)),)))
            except StopIteration:
                pass
            yield _to_nd_tree(res.get(timeout=self._timeout),
                              self._pin_memory)

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
        elif self._thread_pool:
            yield from self._iter_threads()
        else:
            yield from self._iter_processes()
