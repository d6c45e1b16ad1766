"""Fault tolerance: a retry policy and deterministic fault injection.

Counterpart of ``mxnet_tpu/fault.py``, kept as the port's own copy (the
port imports nothing of the JAX package).  Between "fail fast" and a
restart there is a band of transient faults (a parameter-server restart,
a dropped TCP connection, a slow peer) that the reference's ps-lite
resender absorbed; this module is the vocabulary for that band:

* :class:`RetryPolicy` -- deadline, exponential backoff and jitter, tuned
  by ``MX_KVSTORE_RETRY_*``.  The dist_async client (kvstore/kvstore.py)
  retries under it.

* :class:`FaultInjector` / :func:`inject` -- a process-wide registry of
  armed faults keyed by *site* name.  Code calls ``fire(site)`` at
  instrumented points (one dict lookup when the site is unarmed); tests
  and the launcher's ``--fault`` arm rules that drop, delay or fail
  deterministically on the n-th call.  ``MX_FAULT_INJECT`` arms rules at
  import, so processes under the launcher misbehave on cue.

* Virtual time -- ``use_virtual_time()`` swaps the module clock for a
  counter, so tests run whole backoff schedules without real sleeps.

Instrumented sites of the port (grep for ``fault.fire``):
  ``kvstore.send``        before each dist_async client RPC send
  ``kvstore.recv``        before each dist_async client RPC receive
  ``server.handle``       server side, before dispatching a request
  ``kvstore.membership``  server side, before a JOIN/LEAVE mutation
  ``checkpoint.commit``   between a checkpoint's write and its atomic
                          rename (checkpoint.py)
  ``worker.step``         start of each batch of a supervised training
                          loop -- what ``launch --restart on-failure
                          --fault 'worker.step:crash:after=N'`` kills into
                          (a ``delay`` spec here models a hang for the
                          ``MX_STEP_TIMEOUT`` watchdog)
"""
from __future__ import annotations

import random as _random
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional

from .base import get_env

__all__ = ["FaultError", "RetryPolicy", "FaultInjector", "inject", "fire",
           "clear", "site_calls", "arm_from_env", "use_virtual_time",
           "VirtualClock", "now", "sleep", "is_virtual", "Deadline"]


class FaultError(ConnectionError):
    """Raised by an armed ``error``/``close`` fault.  Subclasses
    ConnectionError so transport-level retry loops treat an injected
    fault exactly like a real dropped connection."""

    def __init__(self, site: str, action: str = "error"):
        super().__init__("injected fault at %r (action=%s)" % (site, action))
        self.site = site
        self.action = action


# ---------------------------------------------------------------------------
# Clock: real by default; virtual (counter-based) under use_virtual_time()
# so retry/backoff schedules run instantly in tests.
# ---------------------------------------------------------------------------

class VirtualClock:
    """Monotonic counter standing in for (time.monotonic, time.sleep)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()
        self.sleeps: List[float] = []   # log of requested sleeps (asserted on)

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._now += max(0.0, float(seconds))
            self.sleeps.append(float(seconds))

    def advance(self, seconds: float) -> None:
        self.sleep(seconds)


class _RealClock:
    # the injectable clock's real backend
    now = staticmethod(_time.monotonic)
    sleep = staticmethod(_time.sleep)


_clock: Any = _RealClock()
_clock_lock = threading.Lock()


def now() -> float:
    return _clock.now()


def sleep(seconds: float) -> None:
    _clock.sleep(seconds)


def is_virtual() -> bool:
    """True while a use_virtual_time() context governs the module clock.
    Waits that cannot ride sleep() directly (condition variables, socket
    timeouts) branch on this to charge their tick to the virtual clock
    instead of blocking real time."""
    return isinstance(_clock, VirtualClock)


class Deadline:
    """A wait budget that survives clock-regime switches.

    ``now()``-anchored absolute deadlines break when a use_virtual_time()
    context starts or ends around a parked thread: a virtual anchor
    compared against real monotonic mis-fires by tens of thousands of
    seconds (either direction).  Deadline instead consumes elapsed time
    per same-regime segment — the interval spanning a switch is simply
    not charged — so long-lived waits (barrier parks, connect retries,
    drain loops) keep an honest budget on whichever clock is current.
    """

    __slots__ = ("_remaining", "_anchor", "_virtual")

    def __init__(self, seconds: float):
        self._remaining = float(seconds)
        self._anchor = now()
        self._virtual = is_virtual()

    def remaining(self) -> float:
        cur_virtual = is_virtual()
        cur = now()
        if cur_virtual == self._virtual:
            self._remaining -= max(0.0, cur - self._anchor)
        else:
            self._virtual = cur_virtual
        self._anchor = cur
        return self._remaining

    def expired(self) -> bool:
        return self.remaining() <= 0


class use_virtual_time:
    """Context manager: swap the module clock for a VirtualClock.

    ``with fault.use_virtual_time() as clk: ...`` — every RetryPolicy
    sleep inside advances ``clk`` instead of blocking; ``clk.sleeps``
    records the schedule for assertions.
    """

    def __init__(self, start: float = 0.0):
        self._vc = VirtualClock(start)
        self._saved = None

    def __enter__(self) -> VirtualClock:
        global _clock
        with _clock_lock:
            self._saved = _clock
            _clock = self._vc
        return self._vc

    def __exit__(self, *exc):
        global _clock
        with _clock_lock:
            _clock = self._saved
        return False


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

class RetryPolicy:
    """Deadline-bounded exponential backoff with jitter.

    Delay for attempt k is ``min(base * 2**k, max_delay)`` plus uniform
    jitter in ``[0, jitter * delay]``; retries stop when the deadline
    (seconds from the first attempt) would be exceeded.  Defaults read
    the ``MX_KVSTORE_RETRY_{DEADLINE,BASE,MAX,JITTER}`` env knobs so a
    deployment can re-tune recovery without code changes.

    Usage::

        policy = RetryPolicy.from_env()
        for attempt in policy:           # yields 0, 1, 2, ... sleeping
            try:                         # between attempts
                return do_rpc()
            except ConnectionError as e:
                policy.note(e)           # remembered for the final raise
        raise MXNetError("gave up: %s" % policy.last_error)
    """

    def __init__(self, deadline: Optional[float] = None,
                 base: Optional[float] = None,
                 max_delay: Optional[float] = None,
                 jitter: Optional[float] = None,
                 rng: Optional[_random.Random] = None):
        self.deadline = float(deadline if deadline is not None else
                              get_env("MX_KVSTORE_RETRY_DEADLINE",
                                      dtype=float))
        self.base = float(base if base is not None else
                          get_env("MX_KVSTORE_RETRY_BASE", dtype=float))
        self.max_delay = float(max_delay if max_delay is not None else
                               get_env("MX_KVSTORE_RETRY_MAX", dtype=float))
        self.jitter = float(jitter if jitter is not None else
                            get_env("MX_KVSTORE_RETRY_JITTER", dtype=float))
        self._rng = rng or _random.Random()
        self.last_error: Optional[BaseException] = None

    @classmethod
    def from_env(cls, **overrides) -> "RetryPolicy":
        return cls(**overrides)

    def delay(self, attempt: int) -> float:
        d = min(self.base * (2.0 ** attempt), self.max_delay)
        if self.jitter > 0:
            d += self._rng.uniform(0.0, self.jitter * d)
        return d

    def note(self, err: BaseException) -> None:
        self.last_error = err

    def __iter__(self):
        start = now()
        attempt = 0
        while True:
            yield attempt
            d = self.delay(attempt)
            if now() + d - start > self.deadline:
                return      # next attempt would blow the deadline
            sleep(d)
            attempt += 1


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------

class _Rule:
    """One armed fault: fires on calls [after, after+count) at `site`."""

    __slots__ = ("site", "action", "after", "count", "delay", "exc",
                 "fired", "armed_at_call")

    def __init__(self, site, action, after, count, delay, exc):
        self.site = site
        self.action = action        # "error" | "close" | "delay" | "crash"
        self.after = int(after)     # skip this many calls first
        self.count = int(count)     # then fire this many times (-1 = forever)
        self.delay = float(delay)
        self.exc = exc
        self.fired = 0
        self.armed_at_call = None   # site call-counter when armed (lazy)

    def matches(self, nth_since_armed: int) -> bool:
        if nth_since_armed < self.after:
            return False
        if self.count >= 0 and self.fired >= self.count:
            return False
        return True


class FaultInjector:
    """Registry of armed fault rules, keyed by site name.

    Deterministic by construction: rules trigger on exact call ordinals
    (``after=n`` → skip n calls, then fire), never on probabilities, so
    a chaos test replays identically every run.  ``delay`` actions go
    through the module clock and therefore cost nothing under
    ``use_virtual_time()``.
    """

    def __init__(self):
        self._rules: Dict[str, List[_Rule]] = {}
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- arming -------------------------------------------------------------
    def inject(self, site: str, action: str = "error", after: int = 0,
               count: int = 1, delay: float = 0.0,
               exc: Optional[BaseException] = None) -> _Rule:
        if action not in ("error", "close", "delay", "crash"):
            raise ValueError("unknown fault action %r" % (action,))
        rule = _Rule(site, action, after, count, delay, exc)
        with self._lock:
            rule.armed_at_call = self._calls.get(site, 0)
            self._rules.setdefault(site, []).append(rule)
        return rule

    def disarm(self, rule: _Rule) -> None:
        with self._lock:
            rules = self._rules.get(rule.site, [])
            if rule in rules:
                rules.remove(rule)

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._rules.clear()
                self._calls.clear()
            else:
                self._rules.pop(site, None)
                self._calls.pop(site, None)

    def site_calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    # -- firing -------------------------------------------------------------
    def fire(self, site: str, context: Any = None,
             on_close: Optional[Callable[[], None]] = None) -> None:
        """Call at an instrumented point.  No-op unless a rule matches.

        error  — raise FaultError (or the rule's custom exc)
        close  — run `on_close` (e.g. sock.close) then raise FaultError
        delay  — sleep `rule.delay` via the module clock, continue
        crash  — raise SystemExit (simulated process death; tests catch
                 it, subprocess workers genuinely die)
        """
        with self._lock:
            n = self._calls.get(site, 0)
            self._calls[site] = n + 1
            rules = self._rules.get(site)
            if not rules:
                return
            hit = None
            for rule in rules:
                if rule.matches(n - rule.armed_at_call):
                    rule.fired += 1
                    hit = rule
                    break
        if hit is None:
            return
        if hit.action == "delay":
            sleep(hit.delay)
            return
        if hit.action == "crash":
            raise SystemExit("injected crash at %r" % (site,))
        if hit.action == "close" and on_close is not None:
            try:
                on_close()
            except OSError:
                pass
        if hit.exc is not None:
            raise hit.exc
        raise FaultError(site, hit.action)


_default = FaultInjector()

# module-level convenience API (the spelling production code uses)
inject = _default.inject
fire = _default.fire
clear = _default.clear
disarm = _default.disarm
site_calls = _default.site_calls


def arm_from_env(spec: Optional[str] = None) -> List[_Rule]:
    """Arm rules from an ``MX_FAULT_INJECT`` spec string.

    Grammar: ``site:action[:key=val[,key=val...]]`` joined by ``;``.
    Keys: after, count, delay.  Example (what the launcher's
    ``--fault`` forwards to every process)::

        MX_FAULT_INJECT="kvstore.send:close:after=3;server.handle:delay:delay=0.5,count=2"
    """
    spec = spec if spec is not None else get_env("MX_FAULT_INJECT", "")
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError("bad MX_FAULT_INJECT entry %r "
                             "(want site:action[:k=v,...])" % (part,))
        site, action = fields[0], fields[1]
        kwargs: Dict[str, Any] = {}
        if len(fields) > 2 and fields[2]:
            for kv in fields[2].split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k not in ("after", "count", "delay"):
                    raise ValueError("bad MX_FAULT_INJECT key %r in %r"
                                     % (k, part))
                kwargs[k] = float(v) if k == "delay" else int(v)
        rules.append(inject(site, action=action, **kwargs))
    return rules


# arm automatically in any process launched with the env spec set
# (the launcher's --fault); a bad spec fails loudly at import
if get_env("MX_FAULT_INJECT", ""):
    arm_from_env()
