"""The device input prefetcher: the next batch's host work and its copy to
the card run on a background thread while the current step computes.

Counterpart of ``mxnet_tpu/io/prefetch.py``.  :class:`DevicePrefetcher`
iterates a source one batch ahead of the consumer (``depth`` batches,
``MX_PREFETCH_DEPTH``, default 2), so the copy of batch N+1 overlaps the
compute of batch N and the loop's wait for data shrinks to the queue
handoff.  The reference's four guarantees hold:

* **bit parity**: leaves are copied, never rounded or reordered, so a
  prefetched run's losses equal the synchronous run's bit for bit.
  A numpy leaf becomes a tensor of its own dtype, except that int64 and
  float64 become int32 and float32, as ``jax.device_put`` without x64
  makes them in the reference.
* **bounded**: the queue holds at most ``depth`` batches; the producer
  waits (stop-aware, bounded polls) when the consumer falls behind.
* **clean shutdown**: :meth:`close` (idempotent; also ``with`` exit and
  ``__del__``) stops the producer, drains the queue and joins the thread
  with a bounded wait; a source wedged inside ``next`` cannot wedge it.
* **errors surface**: a source that raises makes the consumer's next
  ``next()`` raise ``MXNetError`` naming the source, the original
  exception chained.

On the card the producer does the copying and the consumer only the
handoff.  A host leaf (numpy, a CPU tensor or NDArray) is staged in
pinned host memory (a leaf already pinned is used as it is) and copied
with ``non_blocking=True`` on a side stream the prefetcher owns; the
producer runs the source and ``transform`` on that stream too, and
records an event after each batch.  ``next()`` makes the consumer's
current stream wait on the event (the host never waits for the copy) and
calls ``record_stream`` on every device leaf, so the caching allocator
does not hand a batch's memory to the next prefetch while the consumer's
stream may still read it.  Leaves already on the target device pass
through.

A background thread does not see the caller's ``with mx.cpu():`` scope
(the current context is thread-local), so the producer enters the
context that was current when the prefetcher was made; ``device=None``
means that context's device.

The wait the consumer does pay is measured: :meth:`data_wait` gives the
sum of seconds and the count of ``next()`` calls, by the injectable
``clock``; each wait is also observed as the ``data_wait`` phase of
the step's telemetry, as the reference records it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque, namedtuple
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..base import MXNetError, get_env
from ..device import Context, current_context, resolve
from ..ndarray.ndarray import NDArray

__all__ = ["DevicePrefetcher", "prefetch_enabled", "prefetch_depth"]

_POLL_S = 0.05          # stop-aware bounded wait tick
#: numpy dtypes the reference's device_put (no x64) narrows
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def prefetch_enabled() -> bool:
    """MX_PREFETCH (default on): device input prefetch in the loops that
    support it."""
    return bool(get_env("MX_PREFETCH", dtype=bool))


def prefetch_depth() -> int:
    """MX_PREFETCH_DEPTH: batches in flight ahead of the consumer
    (2 = double buffering; values below 1 clamp to 1)."""
    try:
        val = get_env("MX_PREFETCH_DEPTH", 2, int)
        n = 2 if val is None else int(val)
    except (TypeError, ValueError):
        n = 2
    return max(1, n)


class _Stop:
    """Queue sentinel: source exhausted."""


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


_Batch = namedtuple("_Batch", ["tree", "event", "leaves"])


def _tree_map(fn, tree):
    """``fn`` over the leaves of tuples, lists, namedtuples and dicts; an
    NDArray is a leaf; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype in _NARROW:
        arr = arr.astype(_NARROW[arr.dtype])
    return torch.from_numpy(np.ascontiguousarray(arr))


class DevicePrefetcher:
    """Iterate ``source`` one batch ahead, moving each leaf to ``device``.

    ``source`` is any iterable of trees (tuples, lists, dicts) of numpy
    arrays, tensors or NDArrays.  ``transform`` (optional) runs on the
    producer thread before the copy: host-side batch assembly belongs
    there, not in the training loop.  ``device=None`` is the caller's
    current context (the GPU unless a ``with mx.cpu():`` scope says
    otherwise).  An NDArray leaf comes out as an NDArray, any other as a
    ``torch.Tensor``."""

    def __init__(self, source: Iterable, device=None,
                 depth: Optional[int] = None,
                 transform: Optional[Callable[[Any], Any]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self._source = source
        self._ctx = current_context()
        self._device = resolve(device)
        self._depth = depth if depth is not None else prefetch_depth()
        if self._depth < 1:
            raise MXNetError("DevicePrefetcher depth must be >= 1, got %d"
                             % self._depth)
        self._transform = transform
        self._clock = clock
        self._wait_s = 0.0
        self._waits = 0
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="DevicePrefetcher", daemon=True)
        self._thread.start()

    # -- producer -----------------------------------------------------------
    def _put(self, item) -> bool:
        """Bounded, stop-aware enqueue; False once stopped."""
        with self._cv:
            while len(self._q) >= self._depth:
                if self._stop.is_set():
                    return False
                self._cv.wait(timeout=_POLL_S)
            if self._stop.is_set():
                return False
            self._q.append(item)
            self._cv.notify_all()
        return True

    def _move(self, x, leaves):
        """One leaf on the target device: staged in pinned memory and
        copied without blocking when it comes from the host (the caching
        host allocator keeps a pinned buffer until its copy is done)."""
        wrap = isinstance(x, NDArray)
        t = _as_tensor(x.data if wrap else x)
        if t.device != self._device:
            if self._stream is not None and t.device.type == "cpu":
                if not t.is_pinned():
                    pinned = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                    pinned.copy_(t)
                    t = pinned
                t = t.to(self._device, non_blocking=True)
            else:
                t = t.to(self._device)
        if t.device.type == "cuda":
            leaves.append(t)
        return NDArray(t) if wrap else t

    def _next_batch(self, it):
        batch = next(it)
        if self._transform is not None:
            batch = self._transform(batch)
        leaves = []
        tree = _tree_map(lambda x: self._move(x, leaves), batch)
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Batch(tree, event, leaves)

    def _run(self):
        with Context(self._ctx), \
                (torch.cuda.stream(self._stream) if self._stream is not None
                 else contextlib.nullcontext()):
            it = iter(self._source)
            while not self._stop.is_set():
                try:
                    try:
                        item = self._next_batch(it)
                    except StopIteration:
                        self._put(_Stop)
                        return
                except Exception as e:    # surfaced by the consumer's next()
                    err = MXNetError(
                        "DevicePrefetcher: source %s raised %s: %s"
                        % (type(self._source).__name__, type(e).__name__, e))
                    err.__cause__ = e
                    self._put(_Err(err))
                    self._put(_Stop)
                    return
                if not self._put(item):
                    return

    # -- consumer -----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise MXNetError("DevicePrefetcher is closed")
        t0 = self._clock()
        with self._cv:
            while not self._q:
                if self._stop.is_set() or not self._thread.is_alive():
                    # the producer died without a sentinel (interpreter
                    # teardown): treat as exhausted
                    if not self._q:
                        raise StopIteration
                    break
                self._cv.wait(timeout=_POLL_S)
            item = self._q.popleft()
            self._cv.notify_all()
        waited = self._clock() - t0
        self._wait_s += waited
        self._waits += 1
        _telemetry.observe_phase("data_wait", waited)
        if item is _Stop:
            raise StopIteration
        if isinstance(item, _Err):
            raise item.exc
        if item.event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(item.event)
            for t in item.leaves:
                t.record_stream(stream)
        return item.tree

    next = __next__

    def data_wait(self) -> Tuple[float, int]:
        """``(seconds, calls)``: the time ``next()`` spent waiting for the
        producer, summed, and the number of ``next()`` calls."""
        return self._wait_s, self._waits

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop the producer and release the thread.  Idempotent; never
        blocks without bound (a source wedged inside ``next`` keeps its
        daemon thread, which exits at its next queue interaction)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        with self._cv:
            self._q.clear()
            self._cv.notify_all()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass    # interpreter shutdown: locks and threads may be gone
