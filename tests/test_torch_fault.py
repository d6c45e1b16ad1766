"""``mxnet_tpu_torch.fault`` against ``mxnet_tpu.fault`` on the CPU.

The port's copy of the retry policy, the fault injector and the virtual
clock is held to the reference's: under ``use_virtual_time`` both give the
same backoff schedules; under the same seed the same jitter, draw for
draw; the same armed rules fire on the same call ordinals; and
``arm_from_env`` parses a spec into the same rules.  These are the
counterparts of ``tests/test_fault.py``'s policy and injector cases.
"""
import random
import time

import pytest

from mxnet_tpu import fault as jfault
from mxnet_tpu_torch import fault as tfault

PACKAGES = {"jax": jfault, "port": tfault}


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in PACKAGES.values():
        f.clear()
    yield
    for f in PACKAGES.values():
        f.clear()


def _both(fn):
    """``fn(fault_module)`` in both packages; asserts they agree and
    returns the port's answer."""
    out = {name: fn(f) for name, f in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


@pytest.mark.parametrize("deadline,base,max_delay", [
    (10.0, 0.5, 4.0), (1.0, 0.05, 2.0), (60.0, 0.05, 2.0), (0.0, 1.0, 1.0),
    (7.4, 0.1, 0.8)])
def test_backoff_schedule_is_the_reference_s(deadline, base, max_delay):
    def run(f):
        with f.use_virtual_time() as clk:
            p = f.RetryPolicy(deadline=deadline, base=base,
                              max_delay=max_delay, jitter=0.0)
            attempts = list(p)
        return attempts, clk.sleeps, clk.now()
    attempts, sleeps, _ = _both(run)
    if (deadline, base, max_delay) == (10.0, 0.5, 4.0):
        assert attempts == [0, 1, 2, 3, 4]
        assert sleeps == [0.5, 1.0, 2.0, 4.0]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_seeded_jitter_is_the_reference_s_draw_for_draw(seed):
    def run(f):
        p = f.RetryPolicy(deadline=30.0, base=0.05, max_delay=2.0,
                          jitter=0.2, rng=random.Random(seed))
        delays = [p.delay(k) for k in range(10)]
        with f.use_virtual_time() as clk:
            q = f.RetryPolicy(deadline=5.0, base=0.05, max_delay=2.0,
                              jitter=0.5, rng=random.Random(seed))
            attempts = list(q)
        return delays, attempts, clk.sleeps
    delays, _, _ = _both(run)
    for k, d in enumerate(delays):
        base = min(0.05 * 2 ** k, 2.0)
        assert base <= d <= base * 1.2


def test_retry_policy_reads_the_same_env(monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_RETRY_DEADLINE", "3.5")
    monkeypatch.setenv("MX_KVSTORE_RETRY_BASE", "0.25")
    monkeypatch.setenv("MX_KVSTORE_RETRY_MAX", "1.5")
    monkeypatch.setenv("MX_KVSTORE_RETRY_JITTER", "0")
    got = _both(lambda f: (lambda p: (p.deadline, p.base, p.max_delay,
                                      p.jitter))(f.RetryPolicy.from_env()))
    assert got == (3.5, 0.25, 1.5, 0.0)
    for var in ("DEADLINE", "BASE", "MAX", "JITTER"):
        monkeypatch.delenv("MX_KVSTORE_RETRY_" + var)
    # the catalog defaults
    _both(lambda f: (lambda p: (p.deadline, p.base, p.max_delay,
                                p.jitter))(f.RetryPolicy.from_env()))


def test_deadline_survives_a_clock_regime_switch():
    def run(f):
        out = []
        with f.use_virtual_time() as clk:
            dl = f.Deadline(100.0)
            clk.advance(30.0)
            out.append(round(dl.remaining(), 6))
        out.append(round(dl.remaining(), 3))
        out.append(dl.expired())
        dl2 = f.Deadline(100.0)
        with f.use_virtual_time() as clk:
            out.append(dl2.expired())
            clk.advance(150.0)
            out.append(dl2.expired())
        return out
    assert _both(run) == [70.0, 70.0, False, False, True]


def _fire_pattern(f, site, n):
    """Which of ``n`` calls of ``site`` raised, and how."""
    out = []
    for _ in range(n):
        try:
            f.fire(site)
            out.append(None)
        except f.FaultError as e:
            out.append(("FaultError", e.site, e.action))
        except SystemExit as e:
            out.append(("SystemExit", str(e)))
    return out


@pytest.mark.parametrize("after,count,action", [
    (2, 2, "error"), (0, 1, "close"), (3, -1, "error"), (1, 3, "crash"),
    (0, 0, "error"), (5, 1, "error")])
def test_injection_fires_on_the_reference_s_ordinals(after, count, action):
    def run(f):
        f.inject("t.site", action=action, after=after, count=count)
        return _fire_pattern(f, "t.site", 8), f.site_calls("t.site")
    pattern, calls = _both(run)
    assert calls == 8
    if (after, count) == (2, 2):
        assert [p is not None for p in pattern] == \
            [False, False, True, True, False, False, False, False]


def test_rules_armed_after_calls_count_from_their_arming():
    def run(f):
        for _ in range(3):
            f.fire("t.late")
        f.inject("t.late", action="error", after=1, count=1)
        first = _fire_pattern(f, "t.late", 4)
        f.inject("t.late", action="error", after=0, count=2)
        return first, _fire_pattern(f, "t.late", 4)
    _both(run)


def test_close_runs_its_hook_and_is_a_connection_error():
    def run(f):
        closed = []
        f.inject("t.close", action="close")
        with pytest.raises(f.FaultError) as ei:
            f.fire("t.close", on_close=lambda: closed.append(True))
        return closed, isinstance(ei.value, ConnectionError), str(ei.value)
    assert _both(run)[:2] == ([True], True)


def test_delay_charges_the_virtual_clock_only():
    def run(f):
        f.inject("t.delay", action="delay", delay=7.5, count=2)
        with f.use_virtual_time() as clk:
            t0 = time.monotonic()
            for _ in range(3):
                f.fire("t.delay")
            elapsed = time.monotonic() - t0
        return clk.now(), clk.sleeps, elapsed < 1.0
    assert _both(run) == (15.0, [7.5, 7.5], True)


def test_disarm_and_clear():
    def run(f):
        rule = f.inject("t.d", action="error", count=-1)
        f.disarm(rule)
        a = _fire_pattern(f, "t.d", 2)
        f.inject("t.d", action="error", count=-1)
        b = _fire_pattern(f, "t.d", 1)
        f.clear("t.d")
        return a, b, _fire_pattern(f, "t.d", 2), f.site_calls("t.d")
    _both(run)


def _rules(f, spec):
    return [(r.site, r.action, r.after, r.count, r.delay)
            for r in f.arm_from_env(spec)]


@pytest.mark.parametrize("spec", [
    "a.site:error:after=1,count=3;b.site:delay:delay=0.5",
    "kvstore.send:close:after=3;server.handle:delay:delay=0.5,count=2",
    "worker.step:crash:after=5", " ; kvstore.recv:error ;", ""])
def test_arm_from_env_parses_the_reference_s_rules(spec):
    _both(lambda f: _rules(f, spec))


@pytest.mark.parametrize("bad", ["missing-action", "a:error:bogus=1",
                                 "a:explode", "a:error:after=x"])
def test_arm_from_env_refuses_what_the_reference_refuses(bad):
    for f in PACKAGES.values():
        with pytest.raises(ValueError):
            f.arm_from_env(bad)


def test_the_environment_spec_arms_at_import(tmp_path):
    import os
    import subprocess
    import sys
    code = ("import mxnet_tpu_torch.fault as f\n"
            "try:\n    f.fire('t.env')\nexcept f.FaultError as e:\n"
            "    print('FIRED', e.site)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=tmp_path,
                       env=dict(os.environ, MX_FAULT_INJECT="t.env:error",
                                PYTHONPATH=os.path.dirname(
                                    os.path.dirname(os.path.abspath(
                                        __file__)))))
    assert r.returncode == 0, r.stderr
    assert "FIRED t.env" in r.stdout
