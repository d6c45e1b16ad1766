"""In-process training health guards: NaN policy, step watchdog, heartbeat.

Counterpart of ``mxnet_tpu/health.py``.  The recovery half of the failure
posture is :mod:`.checkpoint` (crash-safe checkpoints, resume from the
latest step) and the launcher's supervisor
(``python -m mxnet_tpu_torch.tools.launch --restart on-failure``); this
module is the *detection* half that makes them fire.  Three small guards
a training loop installs and the supervisor observes from outside:

* :class:`GradientGuard` -- ``MX_NAN_POLICY`` (``warn`` | ``skip_batch``
  | ``raise``; empty turns it off).  Scans a step's gradients for
  NaN/Inf after backward, before the update: ``skip_batch`` drops the
  poisoned update so the parameters stay finite, ``raise`` fails the rank
  fast (the supervisor then restarts it from the last checkpoint).

* :class:`Watchdog` -- ``MX_STEP_TIMEOUT``.  A daemon thread that, when
  the loop stops petting it for longer than the timeout, dumps every
  thread's stack to stderr and exits the process with
  :data:`WATCHDOG_EXIT_CODE`, turning a silent wedge (a deadlocked
  collective, a hung host callback) into a crash the supervisor can see
  and restart.  All timing goes through :mod:`.fault`'s module clock, so
  tests drive expiry on a virtual clock with no real sleeps.

* :class:`Heartbeat` -- ``MX_HEARTBEAT_FILE``.  Atomically rewrites a
  per-rank liveness file every batch; the supervisor reads its mtime to
  tell *slow* (fresh file, left alone) from *wedged* (stale beyond
  ``--hang-timeout``: killed and restarted), with no wire protocol
  between them.

:class:`StepGuard` bundles the three behind the calls a training loop
makes (``batch_start`` / ``allow_update`` / ``batch_end`` /
``epoch_end`` / ``close``); ``StepGuard.from_env()`` arms only what the
environment asks for.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from . import fault as _fault
from . import telemetry as _telemetry
from .base import MXNetError, get_env

__all__ = ["WATCHDOG_EXIT_CODE", "NAN_POLICIES", "nonfinite_grads",
           "dump_all_stacks", "GradientGuard", "Watchdog", "Heartbeat",
           "StepGuard"]

# apart from a generic failure (1) and the injected-crash server exit (17),
# so the supervisor's log says why a rank died; clear of the shell's
# 126/127/128+n
WATCHDOG_EXIT_CODE = 86

NAN_POLICIES = ("", "warn", "skip_batch", "raise")


def nonfinite_grads(named_grads: Iterable[Tuple[str, object]]) -> List[str]:
    """Names of the gradients that hold a NaN or an Inf.  Takes (name,
    tensor or NDArray) pairs; a None gradient (a fixed parameter) is
    skipped.

    The finite case costs one host sync: each gradient's all-finite
    reduction stays on its device and the flags are stacked and reduced
    once; the names are read (one more sync) only for a poisoned batch."""
    named = [(n, g if isinstance(g, torch.Tensor) else g.data)
             for n, g in named_grads if g is not None]
    if not named:
        return []
    dev = named[0][1].device
    finite = torch.stack([torch.isfinite(g).all().to(dev)
                          for _n, g in named])
    if bool(finite.all()):
        return []
    return [n for (n, _g), f in zip(named, finite.tolist()) if not f]


def dump_all_stacks(file=None) -> None:
    """Write every live thread's stack to ``file`` (default stderr), in
    pure Python so that the output can go to any text stream."""
    file = file if file is not None else sys.stderr
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in frames.items():
        print("--- thread %s (%s) ---" % (ident, names.get(ident, "?")),
              file=file)
        for line in traceback.format_stack(frame):
            file.write(line)
    file.flush()


class GradientGuard:
    """Apply the ``MX_NAN_POLICY`` to one step's gradients.

    ``allow_update(named_grads)`` returns False when the update must be
    skipped; the ``raise`` policy raises :class:`MXNetError` naming the
    offending gradients instead."""

    def __init__(self, policy: str = "", logger=None):
        if policy not in NAN_POLICIES:
            raise ValueError(
                "MX_NAN_POLICY must be one of %s, got %r"
                % ("|".join(p for p in NAN_POLICIES if p), policy))
        self.policy = policy
        self.logger = logger or logging
        self.nan_events = 0          # batches with any non-finite gradient
        self.skipped_batches = 0     # updates dropped under skip_batch

    def allow_update(self, named_grads) -> bool:
        if not self.policy:
            return True
        bad = nonfinite_grads(named_grads)
        if not bad:
            return True
        self.nan_events += 1
        _telemetry.registry.counter(
            "health.nan_events",
            doc="batches with non-finite gradients (MX_NAN_POLICY)").inc()
        shown = ", ".join(bad[:4]) + ("..." if len(bad) > 4 else "")
        if self.policy == "raise":
            # the raise kills this rank: leave the flight recorder's last
            # step records in MX_CRASH_DIR on the way out
            _telemetry.dump_crash(
                "nan_policy_raise: non-finite gradient(s) in %s" % shown)
            raise MXNetError(
                "non-finite gradient(s) in %s (MX_NAN_POLICY=raise)"
                % shown)
        if self.policy == "skip_batch":
            self.skipped_batches += 1
            self.logger.warning(
                "health: non-finite gradient(s) in %s - skipping this "
                "batch's update (MX_NAN_POLICY=skip_batch, %d skipped "
                "so far)", shown, self.skipped_batches)
            return False
        self.logger.warning(
            "health: non-finite gradient(s) in %s (MX_NAN_POLICY=warn: "
            "update applied anyway)", shown)
        return True


class Watchdog:
    """Hung-step watchdog: no ``pet()`` for more than ``timeout`` seconds
    dumps every thread's stack and exits nonzero, so that the supervisor
    restarts the rank.

    Timing reads :func:`.fault.now`: under ``fault.use_virtual_time()``
    tests drive ``expired()`` / ``check()`` with no real sleeps.  The
    background thread (``start()``) polls ``check()`` every ``poll`` real
    seconds, ``timeout / 2`` by default (within [0.05, 1.0] s), so a hang
    is detected within twice the timeout."""

    def __init__(self, timeout: float,
                 on_timeout: Optional[Callable[[], None]] = None,
                 poll: Optional[float] = None, logger=None):
        self.timeout = float(timeout)
        if self.timeout <= 0:
            raise ValueError("Watchdog timeout must be > 0")
        self.poll = float(poll) if poll is not None else \
            min(1.0, max(0.05, self.timeout / 2.0))
        self.on_timeout = on_timeout
        self.logger = logger or logging
        # petted by the loop's thread, read by the watchdog's: the lock
        # makes arming and disarming atomic with the expiry read
        self._lock = threading.Lock()
        self._last: Optional[float] = None   # None: not armed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def pet(self) -> None:
        """Mark progress: the step window restarts now."""
        with self._lock:
            self._last = _fault.now()

    def suspend(self) -> None:
        """Disarm until the next pet() (known slow phases: evaluation, a
        checkpoint)."""
        with self._lock:
            self._last = None

    def expired(self) -> bool:
        with self._lock:
            last = self._last
        return last is not None and (_fault.now() - last) > self.timeout

    def check(self) -> bool:
        """One poll tick: fire on expiry.  Returns True when it fired."""
        if self.fired or not self.expired():
            return False
        self.fired = True
        self._fire()
        return True

    def _fire(self) -> None:
        sys.stderr.write(
            "watchdog: no training-step progress for > %.3gs "
            "(MX_STEP_TIMEOUT) - dumping thread stacks and exiting %d\n"
            % (self.timeout, WATCHDOG_EXIT_CODE))
        # the flight recorder's dump first: its last step records say what
        # the rank was doing when it wedged, even if stderr then hangs
        _telemetry.dump_crash(
            "watchdog: no step progress for > %.3gs (MX_STEP_TIMEOUT)"
            % self.timeout)
        dump_all_stacks(sys.stderr)
        if self.on_timeout is not None:
            self.on_timeout()
            return
        os._exit(WATCHDOG_EXIT_CODE)

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="mx-step-watchdog", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            if self.check():
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class Heartbeat:
    """Per-rank liveness file: ``beat()`` atomically rewrites it.  Line 1
    is ``<unix-time> <epoch> <batch>`` (or ``<unix-time> done``); line 2,
    once telemetry has recorded a step in this process, is
    :func:`.telemetry.heartbeat_payload` as compact JSON.  The supervisor
    reads the file's mtime and :func:`.telemetry.parse_heartbeat` its
    lines."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def beat(self, epoch: int = 0, nbatch: int = 0) -> None:
        self._write("%d %d" % (epoch, nbatch),
                    payload=_telemetry.heartbeat_payload())

    def done(self) -> None:
        """Final beat: training finished, and the process may go silent
        now (export, a last evaluation); the supervisor stops enforcing
        the hang timeout on it."""
        self._write("done")

    def _write(self, tail: str, payload=None) -> None:
        tmp = "%s.tmp.%d" % (self.path, os.getpid())
        try:
            with open(tmp, "w") as f:
                # wall clock on purpose: a readable stamp; liveness reads
                # the file's mtime
                f.write("%f %s\n" % (time.time(), tail))
                if payload:
                    f.write(json.dumps(payload, separators=(",", ":"))
                            + "\n")
            os.replace(tmp, self.path)
        except (OSError, TypeError, ValueError):
            pass    # liveness is advisory: never fail training over it

    def remove(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass


class StepGuard:
    """A training loop's composite guard: watchdog, heartbeat, NaN policy.

    Each is optional; :meth:`from_env` arms what the environment
    configures.  Use::

        guard = StepGuard.from_env()
        try:
            for epoch ...:
                for nbatch, batch ...:
                    guard.batch_start()
                    grads = forward_backward(batch)
                    if guard.allow_update(named_grads):
                        update()
                    guard.batch_end(epoch, nbatch)
                guard.epoch_end(epoch)
                save_checkpoint()
        finally:
            guard.close()
    """

    def __init__(self, nan_policy: str = "",
                 step_timeout: Optional[float] = None,
                 heartbeat_path: Optional[str] = None,
                 logger=None, on_timeout=None):
        self.logger = logger or logging
        self.grad_guard = GradientGuard(nan_policy, logger=self.logger) \
            if nan_policy else None
        self.watchdog = None
        if step_timeout:
            self.watchdog = Watchdog(step_timeout, logger=self.logger,
                                     on_timeout=on_timeout).start()
        self.heartbeat = Heartbeat(heartbeat_path) if heartbeat_path \
            else None
        self._steps = 0     # completed batches: arms the watchdog

    @classmethod
    def from_env(cls, logger=None, **overrides) -> "StepGuard":
        timeout = get_env("MX_STEP_TIMEOUT", dtype=float)
        kwargs = dict(
            nan_policy=get_env("MX_NAN_POLICY", "") or "",
            step_timeout=timeout if timeout and timeout > 0 else None,
            heartbeat_path=get_env("MX_HEARTBEAT_FILE", "") or None,
        )
        kwargs.update(overrides)
        return cls(logger=logger, **kwargs)

    @property
    def armed(self) -> bool:
        return (self.grad_guard is not None or self.watchdog is not None
                or self.heartbeat is not None)

    def batch_start(self) -> None:
        # the watchdog arms once a batch has completed: the first batch
        # (and a restart's) loads kernels and warms the allocator, which a
        # steady-state MX_STEP_TIMEOUT must not count as a hang -- the
        # grace the supervisor gives a process before its first beat
        if self.watchdog is not None and self._steps > 0:
            self.watchdog.pet()

    def allow_update(self, named_grads) -> bool:
        if self.grad_guard is None:
            return True
        return self.grad_guard.allow_update(named_grads)

    def batch_end(self, epoch: int = 0, nbatch: int = 0) -> None:
        self._steps += 1
        # one flight-recorder record a completed batch, before the beat so
        # the beat's payload carries this step
        _telemetry.note_step(epoch=epoch, batch=nbatch)
        if self.watchdog is not None:
            self.watchdog.pet()
        if self.heartbeat is not None:
            self.heartbeat.beat(epoch, nbatch)

    def epoch_end(self, epoch: int = 0) -> None:
        """Between epochs (a checkpoint, an evaluation) steps stall
        legitimately: keep the heartbeat fresh and the watchdog
        disarmed."""
        if self.watchdog is not None:
            self.watchdog.suspend()
        if self.heartbeat is not None:
            self.heartbeat.beat(epoch, -1)

    @property
    def skipped_batches(self) -> int:
        return self.grad_guard.skipped_batches if self.grad_guard else 0

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.heartbeat is not None:
            self.heartbeat.done()   # silence after the loop is no wedge
