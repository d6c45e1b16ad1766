"""Dynamic micro-batcher: admission queue -> pad to a bucket -> one
dispatch -> scatter.

Counterpart of ``mxnet_tpu/serve/batcher.py``.  Requests admit into a
bounded queue (``MX_SERVE_QUEUE_CAP`` rows; past it :class:`Overloaded`);
the batcher thread coalesces up to ``MX_SERVE_MAX_BATCH`` rows of one
input signature, holding an under-full batch open at most
``MX_SERVE_MAX_DELAY_US`` for more arrivals, pads them to the smallest
bucket and dispatches once.  Each request's handler thread waits on its
own future and reads its rows back: the device-to-host copy happens there,
once per batch, while the batcher thread already collects the next batch.

The dispatch runs on the batcher thread.  :meth:`Servable.dispatch` sets
the CUDA device there and launches on that thread's current stream, the
device's default stream, which the handler threads' copies also use, so
they are ordered after the batch's kernels.

Telemetry, as in the reference: per-request ``queue_wait`` and per-batch
``pad`` and ``serve_dispatch`` phases land in ``step_phase_seconds``
(``scatter`` is stamped on the handler thread that reads its rows); the
``serve_dispatch`` span carries one event per member request with its
wire-propagated (trace_id, span_id); counters ``serve.requests`` /
``rejected`` / ``rows`` / ``padding_rows``, the ``serve.queue_rows``
gauge and the ``serve.batch_occupancy`` histogram, with per-model
twins of requests, rows and occupancy.  ``on_tick`` runs once a loop
turn (a replica's heartbeat).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, get_env
from .. import telemetry as _telemetry
from .servable import Servable

__all__ = ["Overloaded", "Batcher", "result_timeout"]


class Overloaded(MXNetError):
    """Admission refused: the bounded queue is full (load shedding)."""


def result_timeout(timeout: Optional[float]) -> float:
    """A request-wait bound: the explicit value, else ``MX_SERVE_TIMEOUT``."""
    if timeout is not None:
        return float(timeout)
    return get_env("MX_SERVE_TIMEOUT", 30.0, float) or 30.0


class _Batch:
    """One dispatched micro-batch's outputs, copied to the host at most
    once (the first reader pays the copy; the rest slice)."""

    __slots__ = ("_outs", "_host", "_lk", "version")

    def __init__(self, outs, version: int):
        self._outs = outs
        self._host: Optional[List[np.ndarray]] = None
        self._lk = threading.Lock()
        self.version = version

    def host(self) -> List[np.ndarray]:
        with self._lk:
            if self._host is None:
                self._host = Servable.to_host(self._outs)
                self._outs = None
            return self._host


class _Pending:
    """One admitted request and the future its handler thread waits on."""

    __slots__ = ("inputs", "rows", "sig", "trace_ctx", "enq_t", "_event",
                 "_lk", "_batch", "_err")

    def __init__(self, inputs: List[np.ndarray], rows: int, sig: Tuple,
                 trace_ctx: Optional[Tuple[str, str]] = None):
        self.inputs = inputs
        self.rows = rows
        self.sig = sig
        self.trace_ctx = trace_ctx
        self.enq_t = time.perf_counter()
        self._event = threading.Event()
        self._lk = threading.Lock()
        self._batch: Optional[Tuple[_Batch, int, int]] = None
        self._err: Optional[BaseException] = None

    def _fulfill(self, batch: _Batch, start: int, stop: int) -> None:
        with self._lk:
            self._batch = (batch, start, stop)
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        with self._lk:
            self._err = err
        self._event.set()

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[int, List[np.ndarray]]:
        """Wait (bounded) for the dispatch, then return (version, this
        request's rows of every output)."""
        timeout = result_timeout(timeout)
        if not self._event.wait(timeout=timeout):
            raise MXNetError("serve: request timed out after %.3gs in the "
                             "batcher" % timeout)
        with self._lk:
            err, ent = self._err, self._batch
        if err is not None:
            raise err
        batch, start, stop = ent
        with _telemetry.phase("scatter"):
            outs = [leaf[start:stop] for leaf in batch.host()]
        return batch.version, outs


_OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class Batcher:
    """The dispatch loop: one daemon thread per serving process."""

    def __init__(self, host, max_batch: Optional[int] = None,
                 max_delay_us: Optional[float] = None,
                 queue_cap: Optional[int] = None, on_tick=None,
                 autostart: bool = True, model: Optional[str] = None):
        self._host = host
        self._model = model
        self._max_batch = int(max_batch if max_batch is not None else
                              get_env("MX_SERVE_MAX_BATCH", 16, int))
        delay_us = max_delay_us if max_delay_us is not None else \
            get_env("MX_SERVE_MAX_DELAY_US", 2000.0, float)
        self._max_delay = max(0.0, float(delay_us) / 1e6)
        self._cap = int(queue_cap if queue_cap is not None else
                        get_env("MX_SERVE_QUEUE_CAP", 256, int))
        self._on_tick = on_tick
        self._q: deque = deque()
        self._qrows = 0
        self._cv = threading.Condition()
        self._stop = threading.Event()
        reg = _telemetry.registry
        self._c_requests = reg.counter(
            "serve.requests", doc="admitted predict requests")
        self._c_rejected = reg.counter(
            "serve.rejected", doc="requests shed at admission (queue cap) "
            "or refused (too large / bad signature)")
        self._c_rows = reg.counter(
            "serve.rows", doc="admitted request rows (examples)")
        self._c_pad_rows = reg.counter(
            "serve.padding_rows", doc="pad rows dispatched (bucket minus "
            "occupancy: the padding waste)")
        self._g_depth = reg.gauge(
            "serve.queue_rows", doc="rows currently queued")
        self._h_occupancy = reg.histogram(
            "serve.batch_occupancy", doc="real rows per dispatched "
            "micro-batch", buckets=_OCCUPANCY_BUCKETS)
        self.requests = 0
        self.rejected = 0
        self.padding_rows = 0
        #: real rows per dispatched micro-batch -> number of dispatches
        self.occupancy: Dict[int, int] = {}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mx-serve-batcher")
        if autostart:
            self._thread.start()

    # -- admission ----------------------------------------------------------
    def queue_rows(self) -> int:
        with self._cv:
            return self._qrows

    def stats(self) -> dict:
        """Admission and batching counts: queued rows, admitted and refused
        requests, padding rows, and real rows per dispatch -> dispatches."""
        with self._cv:
            return {"queue_rows": self._qrows, "requests": self.requests,
                    "rejected": self.rejected,
                    "padding_rows": self.padding_rows,
                    "occupancy": dict(sorted(self.occupancy.items()))}

    def _refuse(self, err: MXNetError):
        with self._cv:
            self.rejected += 1
        self._c_rejected.inc()
        raise err

    def submit(self, arrays: Sequence,
               trace_ctx: Optional[Tuple[str, str]] = None) -> _Pending:
        """Admit one request (per-input row-batched arrays).  Raises
        :class:`Overloaded` when the queue is full, MXNetError when the
        request can never be served (too many rows, signature mismatch)."""
        inputs = [np.ascontiguousarray(a) for a in arrays]
        if not inputs or any(i.ndim < 1 for i in inputs):
            self._refuse(MXNetError("serve: a request needs >=1 row-batched "
                                    "input array"))
        rows = int(inputs[0].shape[0])
        if any(int(i.shape[0]) != rows for i in inputs):
            self._refuse(MXNetError("serve: input leading (batch) dims "
                                    "disagree"))
        sv = self._host.active(self._model)
        if sv.buckets.bucket_for(rows) is None:
            self._refuse(MXNetError(
                "serve: request of %d rows exceeds the top bucket %d "
                "(MX_SERVE_BUCKETS)" % (rows, sv.buckets.max_size)))
        sig = Servable.signature_of(inputs)
        want = sv.warmed_signature
        if want is not None and sig != want:
            self._refuse(MXNetError(
                "serve: input signature %r does not match the deployed "
                "model's %r" % (sig, want)))
        p = _Pending(inputs, rows, sig, trace_ctx=trace_ctx)
        with self._cv:
            if self._qrows + rows > self._cap:
                self.rejected += 1
                self._c_rejected.inc()
                raise Overloaded(
                    "serve: admission queue full (%d/%d rows; "
                    "MX_SERVE_QUEUE_CAP) - retry later or add replicas"
                    % (self._qrows, self._cap))
            self._q.append(p)
            self._qrows += rows
            self.requests += 1
            self._g_depth.set(self._qrows)
            self._cv.notify_all()
        self._c_requests.inc()
        self._c_rows.inc(rows)
        # per-model twins: the fleet rolls them up per hosted model
        reg = _telemetry.registry
        lbl = {"model": sv.name}
        reg.counter("serve.requests", doc="admitted predict requests",
                    labels=lbl).inc()
        reg.counter("serve.rows", doc="admitted request rows (examples)",
                    labels=lbl).inc(rows)
        return p

    # -- the dispatch loop --------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if batch:
                self._dispatch(batch)
            if self._on_tick is not None:
                self._on_tick()
        with self._cv:
            leftover = list(self._q)
            self._q.clear()
            self._qrows = 0
            self._g_depth.set(0)
        for p in leftover:
            p._fail(MXNetError("serve: batcher stopped"))

    def _effective_max(self) -> int:
        try:
            top = self._host.active(self._model).buckets.max_size
        except MXNetError:
            return self._max_batch
        return max(1, min(self._max_batch, top))

    def _collect(self) -> List[_Pending]:
        """Pop the next coalesced batch of one signature, holding the
        window open ``max_delay`` for stragglers; [] on an idle tick."""
        eff = self._effective_max()
        with self._cv:
            if not self._q:
                self._cv.wait(timeout=0.05)
                if not self._q:
                    return []
            if self._max_delay > 0 and self._q[0].rows < eff:
                deadline = time.monotonic() + self._max_delay
                while not self._stop.is_set() and self._qrows < eff:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            head = self._q[0]
            take: List[_Pending] = []
            taken = 0
            while self._q:
                p = self._q[0]
                if take and (p.sig != head.sig or taken + p.rows > eff):
                    break
                self._q.popleft()
                take.append(p)
                taken += p.rows
                if taken >= eff:
                    break
            self._qrows -= taken
            self._g_depth.set(self._qrows)
            return take

    def _dispatch(self, take: List[_Pending]) -> None:
        """Pad the coalesced rows to the smallest bucket, dispatch once,
        and hand each member its row span."""
        rows = sum(p.rows for p in take)
        sv = None
        while sv is None:
            sv = self._host.active(self._model)
            if not sv.begin():        # raced a hot-swap drain: re-read
                sv = None
        try:
            want = sv.warmed_signature
            if want is not None and take[0].sig != want:
                raise MXNetError(
                    "serve: model hot-swapped to an incompatible input "
                    "signature (%r -> %r) while this request was queued; "
                    "resubmit" % (take[0].sig, want))
            bucket = sv.buckets.bucket_for(rows)
            if bucket is None:
                raise MXNetError("serve: %d rows exceed the deployed bucket "
                                 "table" % rows)
            now_t = time.perf_counter()
            for p in take:
                _telemetry.observe_phase("queue_wait", now_t - p.enq_t)
            with _telemetry.phase("pad"):
                pad_rows = bucket - rows
                padded = []
                for i, (trail, dt) in enumerate(take[0].sig):
                    parts = [p.inputs[i] for p in take]
                    if pad_rows:
                        parts.append(np.zeros((pad_rows,) + trail,
                                              dtype=dt))
                    padded.append(parts[0] if len(parts) == 1
                                  else np.concatenate(parts, axis=0))
            with _telemetry.phase("serve_dispatch") as span:
                # link each member's wire-propagated span into the batch
                for p in take:
                    if p.trace_ctx is not None:
                        span.event("request", req_trace=p.trace_ctx[0],
                                   req_span=p.trace_ctx[1], rows=p.rows)
                outs = sv.dispatch(bucket, padded)
            with self._cv:
                self.padding_rows += pad_rows
                self.occupancy[rows] = self.occupancy.get(rows, 0) + 1
            self._h_occupancy.observe(rows)
            self._c_pad_rows.inc(pad_rows)
            _telemetry.registry.histogram(
                "serve.batch_occupancy", doc="real rows per dispatched "
                "micro-batch", labels={"model": sv.name},
                buckets=_OCCUPANCY_BUCKETS).observe(rows)
            batch = _Batch(outs, sv.version)
            offset = 0
            for p in take:
                p._fulfill(batch, offset, offset + p.rows)
                offset += p.rows
        except Exception as e:      # every member gets the reason
            for p in take:
                p._fail(e)
        finally:
            sv.release()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Batcher":
        if not self._thread.is_alive():
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        else:
            self._loop()   # never started: fail whatever is queued
