"""Runtime telemetry: the instrument registry, step-phase spans, trace
context and a crash flight recorder.

Counterpart of ``mxnet_tpu/telemetry.py``, kept as the port's own copy.
It is host code only: the parameter server reads it on every request.

* **Instruments** -- :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` in a process-wide :class:`Registry`, exposed as JSON
  (:meth:`Registry.snapshot`) and Prometheus text
  (:meth:`Registry.to_prometheus`).  Every instrument guards its state
  with its own leaf lock, never held across a call out.  The engine's
  ``dispatch_count`` / ``wire_bytes`` / ``compiled_*`` counters live
  here (``engine.py`` aliases them).

* **Step-phase spans** -- :func:`phase` wraps one phase of a training
  step (``data_wait`` / ``forward`` / ``backward`` / ``exchange`` /
  ``optimizer_apply`` / ``metric_update`` / ...).  A span measures
  *dispatch* latency -- it never waits for the device -- and feeds three
  sinks: the per-phase histogram (``step_phase_seconds{phase=...}``),
  the profiler (so phases land in ``profiler.dumps()``) and the trace
  buffer below.

* **Trace context** -- :func:`rpc_span` spans carry (trace_id, span_id,
  parent_id); the kvstore client attaches its context to the SEQ wire
  envelope and the server opens a child span per request, so a push, its
  handling, retries and replay-cache hits form one causal trace.
  :func:`dump_trace` writes a per-process chrome trace
  (``MX_TELEMETRY_TRACE`` directory).

* **Flight recorder** -- a ring of the last ``MX_TELEMETRY_RING`` step
  records (phase durations, dispatch and wire deltas, retries,
  throughput), appended by :func:`note_step`; :func:`dump_crash` writes
  it with the counters to ``MX_CRASH_DIR``, and :func:`heartbeat_payload`
  summarises the latest record for a supervisor.

Record timestamps read :func:`fault.now`, so virtual-clock tests order
coherently; span *durations* are real ``perf_counter`` deltas.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import fault as _fault
from . import profiler as _profiler
from .base import get_env

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "registry",
    "enabled", "tracing_enabled", "start_tracing", "stop_tracing",
    "Span", "phase", "rpc_span", "current_trace", "observe_phase",
    "FlightRecorder", "flight_recorder", "note_step",
    "heartbeat_payload", "HEARTBEAT_SCHEMA", "parse_heartbeat",
    "phase_snapshot",
    "dump_trace", "trace_events", "clear_trace", "dump_crash",
    "register_step_observer", "register_crash_section",
]


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Counter:
    """Monotonic counter (Prometheus counter semantics, plus ``set`` so
    the engine aliases' test-reset idiom ``engine.wire_bytes = 0`` keeps
    working)."""

    kind = "counter"

    def __init__(self, name: str, doc: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.doc = doc
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self.value}


class Gauge(Counter):
    """A value that can go both ways (queue depth, live sessions)."""

    kind = "gauge"

    def dec(self, n: int = 1) -> None:
        self.inc(-n)


# seconds-scale latency buckets: 100us .. 60s, roughly 2.5x apart
_DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                    2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                    30.0, 60.0)


class Histogram:
    """Fixed-bucket histogram (Prometheus histogram semantics: cumulative
    bucket counts + sum + count, plus min/max for the JSON snapshot)."""

    kind = "histogram"

    def __init__(self, name: str, doc: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.doc = doc
        self.labels = dict(labels or {})
        self.bounds = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, count = self._sum, self._count
            mn, mx = self._min, self._max
        cum: Dict[str, int] = {}
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            cum["%g" % bound] = running
        cum["+Inf"] = running + counts[-1]
        return {"type": self.kind, "count": count, "sum": total,
                "min": mn if count else 0.0, "max": mx if count else 0.0,
                "avg": (total / count) if count else 0.0, "buckets": cum}


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _escape_label_value(v) -> str:
    """Prometheus text-exposition label-value escaping (format 0.0.4):
    backslash, double-quote and newline must be escaped IN THIS ORDER
    (backslash first, or the escapes themselves get re-escaped) — a
    model name or checkpoint path containing any of them otherwise
    emits an unparseable scrape line."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = ['%s="%s"' % (_prom_name(k), _escape_label_value(v))
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{%s}" % ",".join(parts) if parts else ""


class Registry:
    """Process-wide get-or-create instrument store.

    The registry lock guards only the name→instrument dict; instrument
    state updates take the instrument's own leaf lock — no instrument
    lock is ever acquired while the registry lock is held, so the lock
    graph has no telemetry cycles.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Tuple], Any] = {}

    def _get(self, cls, name: str, doc: str,
             labels: Optional[Dict[str, str]], **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, doc=doc, labels=labels, **kwargs)
                self._instruments[key] = inst
        if not isinstance(inst, cls):
            raise ValueError(
                "telemetry instrument %r already registered as %s, not %s"
                % (name, type(inst).__name__, cls.__name__))
        return inst

    def counter(self, name: str, doc: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, doc, labels)

    def gauge(self, name: str, doc: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, doc, labels)

    def histogram(self, name: str, doc: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, doc, labels, buckets=buckets)

    def instruments(self) -> List[Any]:
        with self._lock:
            return list(self._instruments.values())

    def find(self, name: str,
             labels: Optional[Dict[str, str]] = None) -> Optional[Any]:
        with self._lock:
            return self._instruments.get((name, _label_key(labels)))

    def value(self, name: str,
              labels: Optional[Dict[str, str]] = None, default=0):
        inst = self.find(name, labels)
        return inst.value if isinstance(inst, Counter) else default

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dict keyed ``name{label=value,...}``.  Each entry
        additionally carries ``name`` and (when labeled) ``labels`` so
        consumers that merge snapshots across processes never have to
        parse the display key back apart."""
        out: Dict[str, Any] = {}
        for inst in self.instruments():   # copies the list; no lock held
            key = inst.name + _prom_labels(inst.labels).replace('"', "")
            entry = inst.snapshot()
            entry["name"] = inst.name
            if inst.labels:
                entry["labels"] = dict(inst.labels)
            out[key] = entry
        return out

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        by_name: Dict[str, List[Any]] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            insts = by_name[name]
            pname = "mx_" + _prom_name(name)
            doc = next((i.doc for i in insts if i.doc), "")
            if doc:
                # HELP text escapes backslash + newline (same format)
                doc = doc.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append("# HELP %s %s" % (pname, doc))
            lines.append("# TYPE %s %s" % (pname, insts[0].kind))
            for inst in insts:
                snap = inst.snapshot()
                if snap["type"] in ("counter", "gauge"):
                    lines.append("%s%s %s" % (
                        pname, _prom_labels(inst.labels), snap["value"]))
                    continue
                for le, cum in snap["buckets"].items():
                    lines.append("%s_bucket%s %d" % (
                        pname, _prom_labels(inst.labels, 'le="%s"' % le),
                        cum))
                lines.append("%s_sum%s %g" % (
                    pname, _prom_labels(inst.labels), snap["sum"]))
                lines.append("%s_count%s %d" % (
                    pname, _prom_labels(inst.labels), snap["count"]))
        return "\n".join(lines) + "\n"


registry = Registry()


# ---------------------------------------------------------------------------
# Enablement
# ---------------------------------------------------------------------------

def enabled() -> bool:
    """MX_TELEMETRY (default on): phase histograms + step records."""
    return bool(get_env("MX_TELEMETRY", dtype=bool))


_trace_lock = threading.Lock()
_trace_events: List[dict] = []
_trace_forced = [0]          # start_tracing() holds (tests; under _trace_lock)
_TRACE_CAP = 200_000         # drop-newest bound; a leaked trace must not OOM
_atexit_armed = [False]


def tracing_enabled() -> bool:
    """Span buffering is on: ``start_tracing()`` held, or
    ``MX_TELEMETRY_TRACE`` names a directory to flush into at exit."""
    with _trace_lock:
        if _trace_forced[0]:
            return True
    return bool(get_env("MX_TELEMETRY_TRACE", ""))


def start_tracing() -> None:
    """Force span buffering on (tests / embedders); pairs with
    :func:`stop_tracing`."""
    with _trace_lock:
        _trace_forced[0] += 1


def stop_tracing() -> None:
    with _trace_lock:
        _trace_forced[0] = max(0, _trace_forced[0] - 1)


def trace_events() -> List[dict]:
    """Snapshot of the buffered chrome-trace events."""
    with _trace_lock:
        return list(_trace_events)


def clear_trace() -> None:
    with _trace_lock:
        _trace_events.clear()


def _buffer_event(ev: dict) -> None:
    arm = False
    with _trace_lock:
        if len(_trace_events) < _TRACE_CAP:
            _trace_events.append(ev)
        if not _atexit_armed[0]:
            _atexit_armed[0] = arm = True
    if arm:
        import atexit
        atexit.register(_flush_trace_atexit)


def _flush_trace_atexit() -> None:
    try:
        if get_env("MX_TELEMETRY_TRACE", ""):
            dump_trace()
    except Exception:
        pass    # never fail interpreter shutdown over telemetry


# ---------------------------------------------------------------------------
# Spans + trace context
# ---------------------------------------------------------------------------

class _TLS(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []
        self.phases: Dict[str, float] = {}


_tls = _TLS()


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace() -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, span_id) of this thread's innermost open span."""
    stack = _tls.stack
    if stack:
        return stack[-1].trace_id, stack[-1].span_id
    return None, None


class Span:
    """One timed, trace-linked range.

    Context manager: entering assigns ``span_id`` and inherits (or
    creates) ``trace_id``/``parent_id`` from the thread's span stack;
    exiting buffers a chrome-trace ``X`` event (when tracing is on) and,
    while the profiler runs, a profiler span so the range lands in
    ``profiler.dumps()``.  :meth:`event` adds instant child events
    (retries, replays).  Measures dispatch latency only — it must never
    touch device buffers (hot-path lint roots this class)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "_t0", "_wall0", "_prof_ts", "_events")

    def __init__(self, name: str, cat: str = "span",
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id: Optional[str] = None
        self.parent_id = parent_id
        self._events: List[dict] = []

    def __enter__(self) -> "Span":
        cur_trace, cur_span = current_trace()
        if self.trace_id is None:
            self.trace_id = cur_trace or _new_id()
        if self.parent_id is None:
            self.parent_id = cur_span
        self.span_id = _new_id()
        _tls.stack.append(self)
        self._prof_ts = _profiler._now_us() if _profiler.RUNNING else None
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def wire_context(self) -> Optional[Tuple[str, str]]:
        """(trace_id, span_id) to ship on an outgoing RPC envelope, or
        None before ``__enter__``/when ids were never assigned."""
        if self.span_id is None:
            return None
        return (self.trace_id, self.span_id)

    def event(self, name: str, **args) -> None:
        """Instant child event (chrome ``i`` phase) inside this span."""
        if self.span_id is None or not tracing_enabled():
            return
        self._events.append({
            "name": name, "cat": self.cat, "ph": "i", "s": "t",
            "ts": time.time() * 1e6, "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": dict(args, trace_id=self.trace_id,
                         span_id=self.span_id)})

    def _close(self, dur: float) -> None:
        if tracing_enabled():
            _buffer_event({
                "name": self.name, "cat": self.cat, "ph": "X",
                "ts": self._wall0 * 1e6, "dur": dur * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident(),
                "args": {"trace_id": self.trace_id,
                         "span_id": self.span_id,
                         "parent_id": self.parent_id}})
            for ev in self._events:
                _buffer_event(ev)
        self._events = []
        if _profiler.RUNNING and self._prof_ts is not None:
            _profiler.record_span(self.name, self.cat, self._prof_ts,
                                  dur * 1e6)

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        stack = _tls.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:            # unbalanced exit: drop through it
            stack.remove(self)
        self._close(dur)
        return False


class _PhaseSpan(Span):
    """A :class:`Span` that also accumulates into the per-phase
    histogram and this thread's current step record."""

    __slots__ = ()

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        stack = _tls.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._close(dur)
        # a same-name phase still open on the stack means this was a
        # nested re-entry (Module.forward_backward wrapping a backward
        # that wraps autograd.backward): the outer span owns the
        # accounting — accumulating both would double the phase
        if enabled() and not any(isinstance(s, _PhaseSpan) and
                                 s.name == self.name for s in stack):
            pname = self.name[len("phase."):] \
                if self.name.startswith("phase.") else self.name
            _phase_hist(pname).observe(dur)
            _tls.phases[pname] = _tls.phases.get(pname, 0.0) + dur
        return False


class _NullSpan:
    """Shared no-op when every sink is off (the hot path pays three
    global reads and no allocation)."""

    __slots__ = ()
    trace_id = span_id = parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def event(self, name, **args):
        return None

    def wire_context(self):
        return None


_NULL_SPAN = _NullSpan()

_phase_hist_lock = threading.Lock()
_phase_hists: Dict[str, Histogram] = {}


def _phase_hist(name: str) -> Histogram:
    with _phase_hist_lock:
        h = _phase_hists.get(name)
    if h is None:
        h = registry.histogram("step_phase_seconds",
                               doc="training-step phase durations "
                                   "(dispatch-time; see docs/ARCHITECTURE"
                                   ".md span taxonomy)",
                               labels={"phase": name})
        with _phase_hist_lock:
            _phase_hists[name] = h
    return h


def phase(name: str):
    """One training-step phase span (``data_wait`` / ``forward`` / ...).

    Dispatch-time semantics only: the span brackets host work and async
    asynchronous launches, never a device sync.  Returns a shared no-op when
    telemetry, tracing and the profiler are all off."""
    if not (_profiler.RUNNING or enabled() or tracing_enabled()):
        return _NULL_SPAN
    return _PhaseSpan("phase." + name, cat="phase")


def observe_phase(name: str, seconds: float) -> None:
    """Record one already-measured phase duration into the per-phase
    histogram (``step_phase_seconds{phase=name}``).

    The span form (:func:`phase`) needs the phase to be a lexical block
    on ONE thread; a duration that straddles threads — the serving
    batcher's ``queue_wait`` starts at admission on an RPC handler
    thread and ends at dequeue on the batcher thread — is measured by
    the consumer and observed here instead.  No-op when telemetry is
    off."""
    if enabled():
        _phase_hist(name).observe(float(seconds))


def rpc_span(name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None):
    """A wire-RPC span (kvstore client request / server handling).

    Records when tracing or the profiler is on, or when the caller
    supplies an inbound trace context (a traced client deserves a
    server-side child span even if the server's own env never enabled
    tracing — the buffered event is simply dropped at the sink)."""
    if not (tracing_enabled() or _profiler.RUNNING or trace_id):
        return _NULL_SPAN
    return Span(name, cat="rpc", trace_id=trace_id, parent_id=parent_id)


def phase_snapshot() -> Dict[str, Dict[str, float]]:
    """{phase: {count, avg_ms, total_ms, max_ms}} from the per-phase
    histograms — what a benchmark embeds in its JSON report."""
    out: Dict[str, Dict[str, float]] = {}
    for inst in registry.instruments():
        if inst.name != "step_phase_seconds" or \
                not isinstance(inst, Histogram):
            continue
        snap = inst.snapshot()
        pname = inst.labels.get("phase", "?")
        if pname.startswith("phase."):
            pname = pname[len("phase."):]
        out[pname] = {
            "count": snap["count"],
            "avg_ms": round(snap["avg"] * 1e3, 4),
            "total_ms": round(snap["sum"] * 1e3, 4),
            "max_ms": round(snap["max"] * 1e3, 4),
        }
    return out


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

# counters whose per-step deltas ride every step record, and the record
# field each delta lands in
_DELTA_COUNTERS = {
    "engine.dispatch_count": "dispatches",
    "engine.wire_bytes": "wire_bytes",
    "kvstore.client_retries": "retries",
    "health.nan_events": "nan_events",
}


class FlightRecorder:
    """Ring buffer of the last N structured step records.

    Cheap by construction — one dict build + deque append per step; the
    deltas come off registry counters the hot paths were already
    bumping.  ``dump()``/:func:`dump_crash` serialize it on failure."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._ring: Optional[deque] = None
        self._prev: Dict[str, int] = {}
        self._prev_t: Optional[float] = None
        self._steps = 0

    def _ensure_ring(self) -> deque:
        # lazily sized so tests can flip MX_TELEMETRY_RING before the
        # first record; resizing after that needs clear()
        if self._ring is None:
            cap = self._capacity
            if cap is None:
                try:
                    cap = int(get_env("MX_TELEMETRY_RING", 256, int) or 256)
                except (TypeError, ValueError):
                    cap = 256
            self._ring = deque(maxlen=max(1, cap))
        return self._ring

    def record(self, phases: Optional[Dict[str, float]] = None,
               steps: int = 1, epoch: Optional[int] = None,
               batch: Optional[int] = None,
               batch_size: Optional[int] = None,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Append one step record; returns it."""
        now_t = time.perf_counter()
        cur = {name: registry.value(name) for name in _DELTA_COUNTERS}
        rec: Dict[str, Any] = {
            "ts": _fault.now(),           # injectable clock: chaos tests
            "wall_time": time.time(),     # humans reading crash dumps
            "steps": int(steps),
        }
        if epoch is not None:
            rec["epoch"] = int(epoch)
        if batch is not None:
            rec["batch"] = int(batch)
        if phases:
            rec["phases"] = {k[len("phase."):] if k.startswith("phase.")
                             else k: round(v, 6) for k, v in phases.items()}
        with self._lock:
            ring = self._ensure_ring()
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = cur, now_t
            self._steps += int(steps)
            rec["step"] = self._steps
            for name, key in _DELTA_COUNTERS.items():
                rec[key] = cur[name] - prev.get(name, cur[name])
            if prev_t is not None and now_t > prev_t:
                dt = now_t - prev_t
                rec["steps_per_sec"] = round(steps / dt, 4)
                if batch_size:
                    rec["throughput"] = round(steps * batch_size / dt, 4)
            if extra:
                rec.update(extra)
            ring.append(rec)
        return rec

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring or ())

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def clear(self) -> None:
        with self._lock:
            self._ring = None
            self._prev = {}
            self._prev_t = None
            self._steps = 0


flight_recorder = FlightRecorder()

# Step observers / crash sections: device-aware layers hook in from
# outside so this module stays host-only for the kvstore server.  An
# observer returns a dict to merge into the step record (or None); a
# crash section returns a JSON-able payload keyed under its name.
_step_observers: List = []
_crash_sections: List[Tuple[str, Any]] = []


def register_step_observer(fn) -> None:
    """`fn() -> Optional[dict]` called per note_step (telemetry on);
    non-None results merge into that step's flight-recorder record."""
    _step_observers.append(fn)


def register_crash_section(name: str, fn) -> None:
    """`fn() -> payload` embedded as `name` in every crash dump."""
    _crash_sections.append((str(name), fn))


def note_step(steps: int = 1, epoch: Optional[int] = None,
              batch: Optional[int] = None,
              batch_size: Optional[int] = None,
              extra: Optional[Dict[str, Any]] = None):
    """End-of-step hook the training lanes call (Trainer.step, the fit
    loops' StepGuard, CompiledStep dispatches).  Snapshots the phase
    durations this thread accumulated since the last call and appends
    one flight-recorder record.  No-op (beyond dropping the phase
    accumulator) when telemetry is off."""
    phases = _tls.phases
    if phases:
        _tls.phases = {}
    if not enabled():
        return None
    for fn in list(_step_observers):
        try:
            obs = fn()
        except Exception:
            obs = None      # observers must never fail a training step
        if obs:
            extra = dict(extra or {})
            extra.update(obs)
    return flight_recorder.record(phases=phases, steps=steps, epoch=epoch,
                                  batch=batch, batch_size=batch_size,
                                  extra=extra)


_HEARTBEAT_FIELDS = ("step", "epoch", "batch", "steps_per_sec",
                     "throughput", "wire_bytes", "dispatches", "retries",
                     "nan_events", "phases")

# version stamp of the heartbeat JSON payload: parse_heartbeat
# IGNORES payloads stamped with a newer schema than this process
# understands — an old reader must drop a future beat's payload rather
# than mis-render fields whose semantics changed (the head line still
# proves liveness)
HEARTBEAT_SCHEMA = 1


def heartbeat_payload() -> Optional[Dict[str, Any]]:
    """Compact dict of the latest step record for the heartbeat file's
    JSON line (step, throughput, last-exchange bytes, per-phase
    seconds) — what a supervisor's status table renders.  None
    when no step has been recorded (the heartbeat then stays the
    classic one-liner).

    ``schema`` versions the payload; ``ts`` is the record's
    injectable-clock stamp (:func:`fault.now`), which lets a
    virtual-clock supervisor compute beat ages on the SAME clock the
    beat was stamped with instead of racing wall time against st_mtime.
    """
    rec = flight_recorder.last()
    if rec is None:
        return None
    out = {k: rec[k] for k in _HEARTBEAT_FIELDS if k in rec}
    out["schema"] = HEARTBEAT_SCHEMA
    out["ts"] = rec.get("ts")
    return out


def parse_heartbeat(lines) -> Tuple[str, Dict[str, Any], int]:
    """Parse a heartbeat file's lines -> ``(head, payload, malformed)``.

    Line 1 is the classic ``<unix-time> <epoch> <batch>`` beat; line 2,
    when present, is :func:`heartbeat_payload` JSON.  A second line that
    fails to parse OR parses to a non-object (a torn write can leave
    valid-JSON garbage like a bare number) is tolerated-and-counted:
    ``payload`` comes back empty, ``malformed`` is 1, and the head line
    still proves liveness."""
    head = lines[0] if lines else ""
    payload: Dict[str, Any] = {}
    malformed = 0
    if len(lines) > 1 and lines[1].strip():
        try:
            payload = json.loads(lines[1])
            if not isinstance(payload, dict):
                raise ValueError("heartbeat payload is not an object")
        except ValueError:
            payload = {}
            malformed = 1
    try:
        if payload.get("schema", HEARTBEAT_SCHEMA) > HEARTBEAT_SCHEMA:
            payload = {}    # future schema: ignore, don't mis-render
    except TypeError:
        payload = {}
        malformed = 1
    return head, payload, malformed


# ---------------------------------------------------------------------------
# Crash dumps + trace files
# ---------------------------------------------------------------------------

_dump_lock = threading.Lock()
_dump_seq = [0]


def _rank() -> str:
    return str(get_env("MX_PROCESS_ID") or
               os.environ.get("DMLC_WORKER_ID") or 0)


def dump_crash(reason: str, directory: Optional[str] = None,
               extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Write flight-recorder ring + counters snapshot to a crash-dump
    JSON under ``directory`` (default ``MX_CRASH_DIR``); returns the
    path, or None when no directory is configured.  Never raises — this
    runs on the way out of a dying process."""
    d = directory if directory is not None else \
        (get_env("MX_CRASH_DIR", "") or "")
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        with _dump_lock:
            _dump_seq[0] += 1
            seq = _dump_seq[0]
        path = os.path.join(d, "crash-rank%s-pid%d-%d.json"
                            % (_rank(), os.getpid(), seq))
        payload = {
            "reason": str(reason),
            "rank": _rank(),
            "pid": os.getpid(),
            "ts": _fault.now(),
            "wall_time": time.time(),
            "records": flight_recorder.records(),
            "counters": registry.snapshot(),
        }
        for name, fn in list(_crash_sections):
            try:
                payload[name] = fn()
            except Exception:
                payload[name] = None    # a dying process still dumps
        if extra:
            payload["extra"] = extra
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def dump_trace(path: Optional[str] = None, reset: bool = False,
               role: Optional[str] = None) -> Optional[str]:
    """Write this process's buffered spans as a chrome-trace JSON.

    Default path: ``MX_TELEMETRY_TRACE`` directory,
    ``trace-<role>-r<rank>-p<pid>.trace.json``, one file a process,
    to be merged across workers and servers.  ``role`` overrides the
    DMLC_ROLE-derived label."""
    if role is None:
        role = os.environ.get("DMLC_ROLE", "worker")
    if path is None:
        d = get_env("MX_TELEMETRY_TRACE", "")
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "trace-%s-r%s-p%d.trace.json"
                            % (role, _rank(), os.getpid()))
    with _trace_lock:
        events = list(_trace_events)
        if reset:
            _trace_events.clear()
    payload = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"pid": os.getpid(), "rank": _rank(), "role": role},
    }
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path
