"""Execution-engine semantics over CUDA's asynchronous launches.

Counterpart of ``mxnet_tpu/engine.py`` (reference:
src/engine/threaded_engine.cc, naive_engine.cc, include/mxnet/engine.h).

The reference schedules every op as a DAG node over read/write variables
on per-device worker threads.  A CUDA stream already gives those
semantics: launches are asynchronous, kernels on one stream run in order,
and results block only at explicit sync points.  What remains of the
"engine" is:

  * the counters of the step accounting (``dispatch_count``,
    ``wire_bytes``, ``compiled_step_windows``, ``compiled_steps``), kept
    in the telemetry registry, with one consistent :meth:`snapshot`;
  * the sync surface -- :meth:`wait_for_var` and :meth:`wait_for_all`,
    a device synchronisation on the card;
  * a debug mode (``MXNET_ENGINE_TYPE=NaiveEngine``) that synchronises
    after every eager op (:meth:`maybe_sync`);
  * bulking (``Engine::StartBulk``), kept as no-ops.
"""
from __future__ import annotations

import os
import threading

import torch

from . import telemetry as _telemetry
from .base import get_env

__all__ = ["Engine", "engine", "is_naive", "wait_all", "set_bulk_size"]


def _sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Process-wide engine facade (a singleton, like Engine::Get())."""

    def __init__(self):
        self._kind_raw = object()   # sentinel: never equals a str
        self._naive = False
        # - engine.dispatch_count: device-program launches since the
        #   process started -- eager op invokes, fused optimizer applies,
        #   kvstore collectives and concatenations, metric accumulates,
        #   servable batches.
        # - engine.wire_bytes: gradient-exchange payload bytes in their
        #   wire representation (compressed codes and scales, the bf16
        #   cast, or full width).
        # - compiled windows and steps: a captured window of N steps is
        #   one launch; compiled_steps attributes the N.
        self._c_dispatch = _telemetry.registry.counter(
            "engine.dispatch_count",
            doc="device-program dispatches since process start")
        self._c_wire = _telemetry.registry.counter(
            "engine.wire_bytes",
            doc="gradient-exchange wire bytes (compressed representation)")
        self._c_windows = _telemetry.registry.counter(
            "engine.compiled_step_windows",
            doc="whole-step-compiled window launches")
        self._c_steps = _telemetry.registry.counter(
            "engine.compiled_steps",
            doc="optimizer steps covered by compiled windows")
        # one mutation lock over the counter group, so that snapshot()
        # is consistent (count_step_window bumps three counters).  Order:
        # _snap_lock, then a counter's own lock.
        self._snap_lock = threading.Lock()

    # -- the counters (read/write properties: harnesses read them as ints
    # and tests reset them with `engine.wire_bytes = 0`) ------------------
    @property
    def dispatch_count(self) -> int:
        return self._c_dispatch.value

    @dispatch_count.setter
    def dispatch_count(self, v: int) -> None:
        with self._snap_lock:
            self._c_dispatch.set(int(v))

    @property
    def wire_bytes(self) -> int:
        return self._c_wire.value

    @wire_bytes.setter
    def wire_bytes(self, v: int) -> None:
        with self._snap_lock:
            self._c_wire.set(int(v))

    @property
    def compiled_step_windows(self) -> int:
        return self._c_windows.value

    @compiled_step_windows.setter
    def compiled_step_windows(self, v: int) -> None:
        with self._snap_lock:
            self._c_windows.set(int(v))

    @property
    def compiled_steps(self) -> int:
        return self._c_steps.value

    @compiled_steps.setter
    def compiled_steps(self, v: int) -> None:
        with self._snap_lock:
            self._c_steps.set(int(v))

    def count_dispatch(self, n: int = 1) -> None:
        """Note ``n`` device-program dispatches (one counter add)."""
        with self._snap_lock:
            self._c_dispatch.inc(n)

    def count_step_window(self, steps: int, dispatches: int = 1) -> None:
        """Note one compiled window: ``steps`` optimizer steps run under
        ``dispatches`` device launches."""
        with self._snap_lock:
            self._c_dispatch.inc(int(dispatches))
            self._c_windows.inc(1)
            self._c_steps.inc(int(steps))

    def count_wire_bytes(self, n: int) -> None:
        """Note ``n`` gradient-exchange wire bytes (one counter add)."""
        with self._snap_lock:
            self._c_wire.inc(int(n))

    def snapshot(self) -> dict:
        """One consistent view of the counter group, taken under the lock
        every ``count_*`` holds, plus ``"programs"``: the size of the
        program registry (:func:`.programs.program_count`)."""
        with self._snap_lock:
            snap = {
                "dispatches": self._c_dispatch.value,
                "wire_bytes": self._c_wire.value,
                "compiled_step_windows": self._c_windows.value,
                "compiled_steps": self._c_steps.value,
            }
        from . import programs as _programs
        snap["programs"] = _programs.program_count()
        return snap

    # -- engine type -------------------------------------------------------
    @property
    def kind(self) -> str:
        return get_env("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")

    def is_naive(self) -> bool:
        # called after every eager op: one raw environment read, cached by
        # value (so monkeypatched variables are seen too)
        val = os.environ.get("MXNET_ENGINE_TYPE")
        if val != self._kind_raw:
            self._kind_raw = val
            self._naive = val in ("NaiveEngine", "naive")
        return self._naive

    # -- sync points -------------------------------------------------------
    def wait_for_var(self, value) -> None:
        """Wait until ``value`` (a tensor or NDArray) is computed
        (WaitForVar): a synchronisation of its device when it is on the
        card, nothing on the CPU."""
        data = getattr(value, "_data", value)
        if isinstance(data, torch.Tensor):
            _sync_device(data.device)

    def wait_for_all(self) -> None:
        """Wait for every queued device operation (MXNDArrayWaitAll);
        device errors surface here, at the sync point, as in the
        reference."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def maybe_sync(self, value):
        """Called by the dispatch layer after every eager op."""
        if self.is_naive():
            self.wait_for_var(value)
        return value

    # -- bulking (no-ops: a stream already orders the launches) -------------
    def set_bulk_size(self, size: int) -> int:
        return 0

    def start_bulk(self):
        return None

    def stop_bulk(self):
        return None


engine = Engine()


def is_naive() -> bool:
    return engine.is_naive()


def wait_all() -> None:
    engine.wait_for_all()


def set_bulk_size(size: int) -> int:
    return engine.set_bulk_size(size)
