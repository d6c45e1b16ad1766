"""mx.io: data iterators.

Counterpart of ``mxnet_tpu/io/__init__.py`` (reference:
python/mxnet/io/io.py: DataDesc, DataBatch, DataIter, NDArrayIter,
ResizeIter, PrefetchingIter, CSVIter; src/io/iter_mnist.cc: MNISTIter;
src/io/iter_image_recordio_2.cc: ImageRecordIter, the threaded
.rec -> decode -> augment -> batch pipeline).  The iterator protocol is
host plumbing; the .rec parser is native C++ (:mod:`..recordio`), and
``ImageRecordIter`` decodes and augments on a thread pool and assembles
NCHW batches.  Batches are NDArrays on the CPU, as in the reference; a
``DevicePrefetcher`` (:mod:`.prefetch`) moves them to the card off the
training loop.  Shuffles draw from numpy (``NDArrayIter`` from the global
generator, ``ImageRecordIter`` from its own ``RandomState(seed)``) and
augmenters from Python's ``random``, in the reference's order, so the
same seeds give the reference's batches bit for bit.

Background threads (``PrefetchingIter``'s, ``ImageRecordIter``'s pool)
run in the context current where the iterator was made, since the
current context is thread-local.  ``LibSVMIter`` yields CSR batches and
sparse storage is not ported: it raises ``MXNetError``.
"""
from __future__ import annotations

import threading
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as _np

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..device import cpu, current_context, in_context

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "ImageRecordIter", "ImageRecordUInt8Iter", "LibSVMIter",
           "MNISTIter", "DevicePrefetcher"]

from .prefetch import DevicePrefetcher


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Shape/type descriptor (reference: io.DataDesc)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), _np.dtype(dtype),
                               layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One batch (reference: io.DataBatch)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None, bucket_key=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label
        self.bucket_key = bucket_key  # BucketingModule routing

    def __repr__(self):
        shapes = [getattr(d, "shape", None) for d in (self.data or [])]
        return "DataBatch: data shapes %s" % (shapes,)


class DataIter:
    """Iterator protocol (reference: io.DataIter — next/reset/provide_*)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        raise NotImplementedError

    def __next__(self):
        return self.next()

    @property
    def provide_data(self) -> List[DataDesc]:
        raise NotImplementedError

    @property
    def provide_label(self) -> List[DataDesc]:
        raise NotImplementedError

    # reference's default implementations
    def iter_next(self) -> bool:
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            self._next_batch = None
            return False

    def getdata(self):
        return self._next_batch.data[0]

    def getlabel(self):
        return self._next_batch.label[0]

    def getindex(self):
        return self._next_batch.index

    def getpad(self):
        return self._next_batch.pad


def _as_arrays(data, default_name="data"):
    """Normalize data= argument to [(name, numpy)] (reference: _init_data)."""
    if data is None:
        return []
    if isinstance(data, (NDArray, _np.ndarray)):
        data = [(default_name, data)]
    elif isinstance(data, (list, tuple)):
        data = [(default_name if i == 0 else "%s%d" % (default_name, i), d)
                for i, d in enumerate(data)]
    elif isinstance(data, dict):
        data = sorted(data.items())
    out = []
    for name, arr in data:
        if isinstance(arr, NDArray):
            arr = arr.asnumpy()
        out.append((name, _np.asarray(arr)))
    return out


class NDArrayIter(DataIter):
    """Batch iterator over in-memory arrays (reference: io.NDArrayIter —
    shuffle, pad/discard/roll_over last-batch handling, multi-input dicts).
    """

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _as_arrays(data, data_name)
        self.label = _as_arrays(label, label_name)
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("bad last_batch_handle %r" % last_batch_handle)
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle
        self.cursor = -batch_size
        self._roll = 0  # carried samples for roll_over
        self._order = _np.arange(self.num_data)
        if shuffle:
            _np.random.shuffle(self._order)

    @property
    def provide_data(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in self.data]

    @property
    def provide_label(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self._order)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor - self.num_data) % self.batch_size or \
                -self.batch_size
        else:
            self.cursor = -self.batch_size

    def _take(self, arrays, start, count):
        idx = self._order[start:start + count]
        return [arr[idx] for _name, arr in arrays]

    def next(self) -> DataBatch:
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            datas = self._take(self.data, self.cursor, self.batch_size)
            labels = self._take(self.label, self.cursor, self.batch_size)
            pad = 0
        else:
            pad = end - self.num_data
            if self.last_batch_handle == "discard":
                raise StopIteration
            tail_d = self._take(self.data, self.cursor,
                                self.num_data - self.cursor)
            tail_l = self._take(self.label, self.cursor,
                                self.num_data - self.cursor)
            # pad: wrap around to the head (reference pads with first
            # samples; roll_over keeps them for the next epoch)
            head_d = self._take(self.data, 0, pad)
            head_l = self._take(self.label, 0, pad)
            datas = [_np.concatenate([t, h]) for t, h in zip(tail_d, head_d)]
            labels = [_np.concatenate([t, h]) for t, h in zip(tail_l, head_l)]
        return DataBatch(
            data=[nd.array(d, ctx=cpu(), dtype=d.dtype) for d in datas],
            label=[nd.array(l, ctx=cpu(), dtype=l.dtype) for l in labels],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)


class ResizeIter(DataIter):
    """Truncate/extend an iterator to a fixed number of batches
    (reference: io.ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators (reference:
    io.PrefetchingIter — hides iterator latency behind compute).

    Lifecycle: the prefetch threads live in a ThreadPoolExecutor that
    must be shut down — ``close()`` (idempotent; also called by
    ``__del__`` and ``with``-statement exit) drains the in-flight
    batches and releases the threads, so a training job that churns
    through many iterators doesn't leak a pool per iterator.  A
    prefetch worker that raises is surfaced by the NEXT ``next()`` call
    as an :class:`MXNetError` naming which inner iterator failed, with
    the original exception chained (``raise ... from``)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self._pool = ThreadPoolExecutor(max_workers=len(iters))
        self._ctx = current_context()
        self._futures = None
        self._closed = False
        self._submit()

    def _submit(self):
        def _one(it, i):
            try:
                return it.next()
            except StopIteration:
                return None
            except Exception as e:
                raise MXNetError(
                    "PrefetchingIter: inner iterator %d (%s) raised "
                    "%s: %s" % (i, type(it).__name__, type(e).__name__,
                                e)) from e
        one = in_context(self._ctx, _one)
        self._futures = [self._pool.submit(one, it, i)
                         for i, it in enumerate(self.iters)]

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])

    def reset(self):
        if self._closed:
            raise MXNetError("PrefetchingIter is closed")
        for f in self._futures:
            try:
                f.result()
            except MXNetError:
                pass        # reset clears a poisoned prefetch slot
        for it in self.iters:
            it.reset()
        self._submit()

    def next(self):
        if self._closed:
            raise MXNetError("PrefetchingIter is closed")
        batches = [f.result() for f in self._futures]
        if any(b is None for b in batches):
            raise StopIteration
        self._submit()
        if len(batches) == 1:
            return batches[0]
        return DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([(b.label or []) for b in batches], []),
            pad=max(b.pad for b in batches))

    def close(self):
        """Shut down the prefetch threads.  Safe to call repeatedly;
        further next()/reset() calls raise.  Never blocks: pending
        fetches are cancelled and an in-flight one releases its thread
        when it returns — close() (and __del__, possibly running inside
        GC on the training thread) must not hang on a wedged inner
        iterator."""
        if self._closed:
            return
        self._closed = True
        for f in self._futures or []:
            f.cancel()
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass    # interpreter shutdown: executor internals may be gone


class CSVIter(DataIter):
    """Batches from CSV files (reference: src/io/iter_csv.cc via io.CSVIter).
    Loads eagerly (host RAM) — the reference streams, but CSV workloads
    that matter fit; documented trade."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **_kw):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32,
                           ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32,
                                ndmin=2).reshape((-1,) + tuple(label_shape))
        else:
            label = _np.zeros((data.shape[0], 1), _np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """Sparse batches from LibSVM text files (reference: io.LibSVMIter over
    src/io/iter_libsvm.cc).  Its batches are CSR arrays, and sparse
    storage is not ported yet: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("io.LibSVMIter is not ported: it yields CSR "
                         "batches and sparse storage (ndarray/sparse.py) is "
                         "not ported yet")


def _read_idx_ubyte(path):
    """Parse the MNIST IDX format (magic 0x801/0x803)."""
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    magic = int.from_bytes(raw[:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(raw[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    data = _np.frombuffer(raw, _np.uint8, offset=4 + 4 * ndim)
    return data.reshape(dims)


class MNISTIter(DataIter):
    """Batches over the classic MNIST idx-ubyte pair (reference:
    src/io/iter_mnist.cc MNISTIter — the v1.x `mx.io.MNISTIter` surface).

    ``flat=True`` yields (batch, 784) float rows scaled to [0,1);
    ``flat=False`` yields (batch, 1, 28, 28).  ``part_index``/``num_parts``
    shard for distributed training like the reference."""

    def __init__(self, image, label, batch_size=128, shuffle=False,
                 flat=False, seed=0, silent=True, num_parts=1, part_index=0,
                 **_kw):
        super().__init__(batch_size)
        images = _read_idx_ubyte(image).astype(_np.float32) / 255.0
        labels = _read_idx_ubyte(label).astype(_np.float32)
        if images.ndim != 3 or labels.ndim != 1 or                 images.shape[0] != labels.shape[0]:
            raise ValueError("not an MNIST idx pair: %r %r"
                             % (images.shape, labels.shape))
        images = images[part_index::num_parts]
        labels = labels[part_index::num_parts]
        self._flat = flat
        data = images.reshape(len(images), -1) if flat else             images[:, None, :, :]
        self._inner = NDArrayIter(
            data, labels, batch_size, shuffle=shuffle,
            last_batch_handle="pad", label_name="softmax_label")
        if not silent:
            print("MNISTIter: loaded %d images %s" % (len(images),
                                                      data.shape[1:]))

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class ImageRecordIter(DataIter):
    """.rec → decode → augment → NCHW batches (reference:
    src/io/iter_image_recordio_2.cc ImageRecordIOParser2::ParseNext).

    Decode+augment runs on ``preprocess_threads`` workers (PIL releases
    the GIL in its C codec); records are dealt round-robin into an order
    that is reshuffled per epoch when ``shuffle``.  ``part_index``/
    ``num_parts`` shard the record set for multi-host data parallelism,
    matching the reference's distributed slicing.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_resize=False, rand_mirror=False,
                 mean_r=0, mean_g=0, mean_b=0, std_r=0, std_g=0, std_b=0,
                 resize=0, preprocess_threads=4, num_parts=1, part_index=0,
                 round_batch=True, seed=0, aug_list=None, dtype="float32",
                 **_kw):
        super().__init__(batch_size)
        from .. import recordio, image
        self._rec_path = path_imgrec
        self._idx_path = path_imgidx or path_imgrec[:-4] + ".idx"
        self._label_width = label_width
        self._dtype = _np.dtype(dtype)
        self.data_shape = tuple(data_shape)
        self._record = recordio.MXIndexedRecordIO(self._idx_path,
                                                  self._rec_path, "r")
        keys = self._record.keys
        if not keys:
            raise OSError("no .idx sidecar for %r — ImageRecordIter needs "
                          "indexed records" % path_imgrec)
        keys = keys[part_index::num_parts]  # distributed shard
        self._keys = _np.asarray(keys)
        self._shuffle = shuffle
        self._rng = _np.random.RandomState(seed)
        self._round_batch = round_batch
        mean = None
        std = None
        if mean_r or mean_g or mean_b:
            mean = _np.array([mean_r, mean_g, mean_b], _np.float32)
        if std_r or std_g or std_b:
            std = _np.array([std_r, std_g, std_b], _np.float32)
        if aug_list is None:
            aug_list = image.CreateAugmenter(
                data_shape=(3,) + tuple(data_shape[1:]), resize=resize,
                rand_crop=rand_crop, rand_resize=rand_resize,
                rand_mirror=rand_mirror, mean=mean, std=std)
        self._augs = aug_list
        self._pool = ThreadPoolExecutor(max_workers=preprocess_threads)
        self._load = in_context(current_context(), self._load_one)
        self._lock = threading.Lock()  # recordio handle is stateful
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self._dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 else \
            (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shape, _np.float32)]

    def reset(self):
        self._order = self._keys.copy()
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _load_one(self, key):
        from .. import recordio as rio, image
        with self._lock:
            payload = self._record.read_idx(int(key))
        header, img_bytes = rio.unpack(payload)
        img = image.imdecode(img_bytes)
        for aug in self._augs:
            img = aug(img)
        arr = img.asnumpy()
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)  # HWC → CHW
        label = header.label
        if isinstance(label, _np.ndarray):
            label = label[:self._label_width]
        return arr, label

    def next(self) -> DataBatch:
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        pad = 0
        keys = self._order[self._cursor:min(end, n)]
        if end > n:
            pad = end - n
            if not self._round_batch:
                raise StopIteration
            keys = _np.concatenate([keys, self._order[:pad]])
        self._cursor = end
        results = list(self._pool.map(self._load, keys))
        data = _np.stack([r[0] for r in results]).astype(self._dtype,
                                                         copy=False)
        labels = _np.asarray([r[1] for r in results], _np.float32)
        return DataBatch(
            data=[nd.array(data, ctx=cpu(), dtype=data.dtype)],
            label=[nd.array(labels, ctx=cpu())],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)


class ImageRecordUInt8Iter(ImageRecordIter):
    """Reference: io.ImageRecordUInt8Iter — ImageRecordIter that hands
    out RAW uint8 pixels (no mean/std normalization), for pipelines that
    normalize on-device (e.g. the INT8 quantized path)."""

    def __init__(self, *args, **kwargs):
        for banned in ("mean_r", "mean_g", "mean_b",
                       "std_r", "std_g", "std_b"):
            if kwargs.pop(banned, 0):
                raise MXNetError(
                    "ImageRecordUInt8Iter hands out raw uint8 pixels; "
                    "%s is not applicable (normalize on-device)" % banned)
        if str(kwargs.pop("dtype", "uint8")) != "uint8":
            raise MXNetError(
                "ImageRecordUInt8Iter is uint8 by definition; use "
                "ImageRecordIter for other dtypes")
        kwargs["dtype"] = "uint8"
        super().__init__(*args, **kwargs)
