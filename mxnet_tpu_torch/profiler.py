"""mx.profiler -- the profiling API over ``torch.profiler``.

Counterpart of ``mxnet_tpu/profiler.py`` (reference:
``python/mxnet/profiler.py``: set_config, set_state, start/stop/
pause/resume, dump, dumps, Task/Frame/Event/Counter/Marker; and
``src/profiler/profiler.cc``: Profiler::DumpProfile and the aggregate
table).

The host-side statistics the MXNet API promises (the ``dumps()`` table,
the ``dump()`` chrome trace) are collected in the eager dispatch layer
(``ndarray.invoke`` wraps each op in a span while the profiler runs), by
telemetry's spans and by the instrumentation objects below.  The device
side belongs to PyTorch: ``set_config(device_trace_dir=...)`` runs a
``torch.profiler.profile`` over the ``run`` interval, with the CPU
activity and, where CUDA is available, the CUDA activity, and writes its
chrome trace (kernel names and device times) into that directory at
``stop``.

Eager launches are asynchronous, so a span measures *dispatch* latency
by default.  ``MXNET_PROFILER_SYNC=1`` (or ``set_config(sync=True)``)
makes each op span wait for the device, trading throughput for true
per-op times.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

from .base import get_env

__all__ = [
    "set_config", "set_state", "state", "start", "stop", "pause", "resume",
    "dump", "dumps", "dump_profile", "Domain", "Task", "Frame", "Event",
    "Counter", "Marker", "scope", "annotate",
]

# module-level fast flags read by the dispatch hot loop -----------------------
RUNNING = False          # profiler collecting?
IMPERATIVE = False       # collect eager op spans?

_lock = threading.RLock()
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": False,
    "profile_imperative": False,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": True,
    "continuous_dump": False,
    "sync": get_env("MXNET_PROFILER_SYNC", dtype=bool),
    # directory for the torch.profiler chrome trace; None: no device trace
    "device_trace_dir": None,
}
_torch_prof = None          # the running torch.profiler.profile, or None
_trace_path: Optional[str] = None
_paused = False

# chrome-trace events: (name, category, ts_us, dur_us, tid)
_events: List[tuple] = []
# aggregate: name -> [count, total_us, min_us, max_us]
_agg: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
_counters: List[tuple] = []   # (name, ts_us, value)
_t0 = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _t0) * 1e6


def set_config(**kwargs):
    """Configure the profiler (reference: profiler.set_config).

    Accepts the reference's kwargs (``filename``, ``profile_all``,
    ``profile_symbolic``, ``profile_imperative``, ``profile_memory``,
    ``profile_api``, ``aggregate_stats``, ``continuous_dump``) plus the
    port's ``sync`` (wait for each op for exact times) and
    ``device_trace_dir`` (a torch.profiler chrome trace there).
    """
    with _lock:
        for k, v in kwargs.items():
            if k not in _config:
                raise ValueError("profiler.set_config: unknown option %r" % k)
            _config[k] = v


def set_state(state_: str = "stop"):
    """'run' starts collection, 'stop' ends it (reference: set_state)."""
    global RUNNING, IMPERATIVE, _paused
    if state_ not in ("run", "stop"):
        raise ValueError("profiler state must be 'run' or 'stop'")
    with _lock:
        run = state_ == "run"
        RUNNING = run
        _paused = False
        IMPERATIVE = run and (_config["profile_all"] or _config["profile_imperative"])
        tdir = _config["device_trace_dir"]
        if run and tdir and _torch_prof is None:
            _start_device_trace(tdir)
        elif not run and _torch_prof is not None:
            _stop_device_trace()
        if not run and _config["continuous_dump"]:
            dump()


def _start_device_trace(tdir: str) -> None:
    """Open a ``torch.profiler.profile`` over the CPU and, where CUDA is
    available, the CUDA activity (the counterpart of
    ``jax.profiler.start_trace``)."""
    global _torch_prof, _trace_path
    import os
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(tdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _torch_prof = prof
    _trace_path = os.path.join(tdir, "trace-p%d-%d.json"
                               % (os.getpid(), int(time.time() * 1e3)))


def _stop_device_trace() -> None:
    """Close the device trace and write its chrome trace (after waiting
    for the device, so every kernel of the interval is in it)."""
    global _torch_prof
    import torch
    prof, _torch_prof = _torch_prof, None
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
    finally:
        prof.export_chrome_trace(_trace_path)


def device_trace_path() -> Optional[str]:
    """The chrome trace the last device-traced ``run`` interval wrote (or
    writes at ``stop``), or None."""
    return _trace_path


def state() -> str:
    return "run" if RUNNING else "stop"


def start():
    set_state("run")


def stop():
    set_state("stop")


def pause():
    """Temporarily suspend collection without closing the trace."""
    global IMPERATIVE, _paused
    with _lock:
        _paused = True
        IMPERATIVE = False


def resume():
    global IMPERATIVE, _paused
    with _lock:
        _paused = False
        IMPERATIVE = RUNNING and (_config["profile_all"] or _config["profile_imperative"])


def record_span(name: str, category: str, ts_us: float, dur_us: float):
    """Append one completed span (called from dispatch and Task/Frame/Event)."""
    with _lock:
        _events.append((name, category, ts_us, dur_us, threading.get_ident()))
        if _config["aggregate_stats"]:
            a = _agg[name]
            a[0] += 1
            a[1] += dur_us
            a[2] = min(a[2], dur_us)
            a[3] = max(a[3], dur_us)


class _OpSpan:
    """Context manager wrapped around one eager op dispatch.

    While a device trace runs it also opens a
    ``torch.profiler.record_function`` range, so op names show in the
    trace beside the kernels they launched.
    """
    __slots__ = ("name", "t0", "ann")

    def __init__(self, name: str):
        self.name = name
        self.ann = None

    def __enter__(self):
        if _torch_prof is not None:
            import torch
            self.ann = torch.profiler.record_function(self.name)
            self.ann.__enter__()
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc):
        record_span(self.name, "operator", self.t0, _now_us() - self.t0)
        if self.ann is not None:
            self.ann.__exit__(*exc)
        return False


def op_span(name: str) -> _OpSpan:
    return _OpSpan(name)


def want_sync() -> bool:
    return _config["sync"]


# -- user instrumentation objects (reference: profiler.Task/Frame/Event...) ---

class Domain:
    """A named grouping for instrumentation objects."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return "Domain(%s)" % self.name


class _DurationObject:
    _category = "task"

    def __init__(self, domain: Optional[Domain] = None, name: str = "task"):
        if isinstance(domain, str) and name == "task":  # Event(name) form
            domain, name = None, domain
        self.domain = domain
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = _now_us()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("%s %r stopped before start" %
                               (type(self).__name__, self.name))
        record_span(self.name, self._category, self._t0, _now_us() - self._t0)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Task(_DurationObject):
    _category = "task"


class Frame(_DurationObject):
    _category = "frame"


class Event(_DurationObject):
    _category = "event"


class Counter:
    """A named monotonic-timestamped counter (reference: profiler.Counter)."""

    def __init__(self, domain: Optional[Domain] = None, name: str = "counter",
                 value: int = 0):
        if isinstance(domain, str) and name == "counter":
            domain, name = None, domain
        self.domain = domain
        self.name = name
        self._value = value
        self._record()

    def _record(self):
        with _lock:
            _counters.append((self.name, _now_us(), self._value))

    def set_value(self, value):
        self._value = value
        self._record()

    def increment(self, delta=1):
        self._value += delta
        self._record()

    def decrement(self, delta=1):
        self._value -= delta
        self._record()

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Marker:
    """An instant event (reference: profiler.Marker.mark)."""

    def __init__(self, domain: Optional[Domain] = None, name: str = "marker"):
        if isinstance(domain, str) and name == "marker":
            domain, name = None, domain
        self.domain = domain
        self.name = name

    def mark(self, scope_: str = "process"):
        record_span(self.name, "marker", _now_us(), 0.0)


class scope:
    """Context manager: a named range around everything inside -- a host
    span, and a ``record_function`` range in the device trace while one
    runs (the counterpart of the reference's ``jax.named_scope``)."""

    def __init__(self, name: str):
        self.name = name
        self._span = _OpSpan(name)

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)


class _NullSpan:
    """Free when the profiler is stopped (annotate's fast path)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def annotate(name: str):
    """Phase range for the steady-state training step (allreduce / update /
    metric): a full scope() when the profiler is running, and a shared
    no-op context otherwise, so the hot loop pays one global read per
    phase."""
    return scope(name) if RUNNING else _NULL_SPAN


# -- output -------------------------------------------------------------------

def dump(finished: bool = True, profile_process: str = "worker"):
    """Write collected spans as a chrome-trace JSON to ``filename``.

    Reference: Profiler::DumpProfile writes the same ``traceEvents`` format;
    the file opens in chrome://tracing / Perfetto.  The device trace (if
    ``device_trace_dir`` was set) is written by torch.profiler at stop().
    """
    with _lock:
        events = []
        for name, cat, ts, dur, tid in _events:
            events.append({"name": name, "cat": cat, "ph": "X",
                           "ts": ts, "dur": dur, "pid": 0, "tid": tid})
        for name, ts, value in _counters:
            events.append({"name": name, "cat": "counter", "ph": "C",
                           "ts": ts, "pid": 0,
                           "args": {"value": value}})
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(_config["filename"], "w") as f:
            json.dump(payload, f)
        if finished:
            _events.clear()
            _counters.clear()


dump_profile = dump  # deprecated reference alias


def dumps(reset: bool = False, format: str = "table") -> str:
    """Aggregate per-op statistics (reference: MXAggregateProfileStatsPrint).

    ``format='table'`` renders the reference-style text table;
    ``format='json'`` returns a JSON object keyed by op name.
    """
    with _lock:
        if format == "json":
            out = json.dumps({
                name: {"count": int(c), "total_us": t, "min_us": mn,
                       "max_us": mx, "avg_us": t / c if c else 0.0}
                for name, (c, t, mn, mx) in sorted(_agg.items())
            })
        else:
            lines = ["Profile Statistics:",
                     "%-40s %-12s %-14s %-12s %-12s %-12s" %
                     ("Name", "Total Count", "Time (us)", "Min (us)",
                      "Max (us)", "Avg (us)")]
            for name, (c, t, mn, mx) in sorted(_agg.items(),
                                               key=lambda kv: -kv[1][1]):
                lines.append("%-40s %-12d %-14.1f %-12.1f %-12.1f %-12.1f" %
                             (name[:40], c, t, mn, mx, t / c if c else 0.0))
            out = "\n".join(lines)
        if reset:
            _agg.clear()
        return out


def reset():
    """Drop all collected data."""
    with _lock:
        _events.clear()
        _counters.clear()
        _agg.clear()
