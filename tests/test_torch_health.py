"""The port's ``health`` (NaN policy, step watchdog, heartbeat file,
``StepGuard``) against ``mxnet_tpu.health``, on the CPU.

The counterparts of ``tests/test_supervisor.py``'s health units: the same
inputs go through both packages and give the same answers.  Timing runs on
each package's ``fault`` clock under ``use_virtual_time()``, so no case
sleeps; the one real firing (``os._exit(86)``) runs in a subprocess.
"""
import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fault as jfault
from mxnet_tpu import health as jhealth
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.base import MXNetError as JMXNetError

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fault, health, nd, telemetry
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (health, fault, MXNetError),
            "reference": (jhealth, jfault, JMXNetError)}


@pytest.fixture(autouse=True)
def _clean_faults():
    fault.clear()
    jfault.clear()
    yield
    fault.clear()
    jfault.clear()
    # the guards note steps: leave the process-wide recorders as found
    telemetry.flight_recorder.clear()
    jtelemetry.flight_recorder.clear()


def _grads(pkg, **named):
    """(name, array) pairs in ``pkg``'s own array type."""
    out = []
    for k, v in named.items():
        if v is None:
            out.append((k, None))
        elif pkg == "port":
            out.append((k, torch.tensor(np.asarray(v, np.float32))))
        else:
            out.append((k, jmx.nd.array(np.asarray(v, np.float32))))
    return out


def test_the_catalog_holds_the_reference_s_health_knobs():
    from mxnet_tpu.base import ENV_CATALOG as J
    from mxnet_tpu_torch.base import ENV_CATALOG as T
    for name in ("MX_NAN_POLICY", "MX_STEP_TIMEOUT", "MX_HEARTBEAT_FILE"):
        assert T[name][0] == J[name][0], name
    assert health.WATCHDOG_EXIT_CODE == jhealth.WATCHDOG_EXIT_CODE == 86
    assert health.NAN_POLICIES == jhealth.NAN_POLICIES
    assert health.__all__ == jhealth.__all__


@pytest.mark.parametrize("named", [
    dict(a=[1.0, 2.0], b=[np.nan, 1.0], c=[np.inf], fixed=None),
    dict(a=[1.0], b=[-np.inf, np.nan]),
    dict(a=[1.0, 2.0], b=[3.0]),
    dict(fixed=None),
    dict(),
])
def test_nonfinite_grads_names_what_the_reference_names(named):
    got = health.nonfinite_grads(_grads("port", **named))
    want = jhealth.nonfinite_grads(_grads("reference", **named))
    assert got == want


def test_nonfinite_grads_takes_ndarrays_and_bf16():
    pairs = [("w", nd.array(np.array([1.0, np.nan], np.float32),
                            ctx=mx.cpu())),
             ("h", torch.tensor([1.0, float("inf")], dtype=torch.bfloat16)),
             ("ok", torch.ones(3, dtype=torch.bfloat16))]
    assert health.nonfinite_grads(pairs) == ["w", "h"]


def test_nonfinite_grads_syncs_once_for_finite_gradients(monkeypatch):
    """One host read for the whole set, not one a tensor: the reductions
    are stacked on the device and read once."""
    reads = []
    real = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda t: reads.append(1) or real(t))
    grads = [("g%d" % i, torch.randn(5)) for i in range(20)]
    assert health.nonfinite_grads(grads) == []
    assert len(reads) == 1


@pytest.mark.parametrize("policy", ["", "warn", "skip_batch", "raise"])
def test_the_four_nan_policies_act_as_the_reference_s(policy, tmp_path,
                                                      monkeypatch):
    outcome = {}
    for name, (h, _f, err) in PACKAGES.items():
        monkeypatch.setenv("MX_CRASH_DIR", str(tmp_path / name))
        g = h.GradientGuard(policy)
        ok = g.allow_update(_grads(name, w=[1.0]))
        try:
            bad = g.allow_update(_grads(name, w=[np.nan], v=[1.0]))
            msg = None
        except err as e:
            bad, msg = "raised", str(e)
        outcome[name] = (ok, bad, g.nan_events, g.skipped_batches, msg)
    assert outcome["port"] == outcome["reference"]
    if policy == "raise":
        assert "MX_NAN_POLICY" in outcome["port"][-1]
        reasons = set()
        for name in PACKAGES:         # each package's flight recorder
            (dump,) = os.listdir(tmp_path / name)
            reasons.add(json.load(open(tmp_path / name / dump))["reason"])
        assert reasons == {"nan_policy_raise: non-finite gradient(s) in w"}


def test_a_nan_event_counts_in_the_registry():
    before = telemetry.registry.value("health.nan_events") or 0
    health.GradientGuard("warn").allow_update(_grads("port", w=[np.nan]))
    assert telemetry.registry.value("health.nan_events") == before + 1


def test_a_bogus_policy_and_a_nonpositive_timeout_are_refused():
    for h in (health, jhealth):
        with pytest.raises(ValueError):
            h.GradientGuard("bogus")
        with pytest.raises(ValueError):
            h.Watchdog(0.0)


def _watchdog_trace(h, f):
    """Pet, advance, check on the package's virtual clock; returns what a
    reader sees at each point."""
    fired = []
    seen = []
    with f.use_virtual_time() as clk:
        wd = h.Watchdog(2.0, on_timeout=lambda: fired.append(True))
        seen.append(wd.expired())          # never petted: disarmed
        wd.pet()
        clk.advance(1.9)
        seen.append(wd.check())
        wd.pet()                           # progress resets the window
        clk.advance(1.9)
        seen.append(wd.expired())
        clk.advance(0.2)
        seen.append(wd.expired())
        wd.suspend()                       # a checkpoint: disarmed
        clk.advance(100.0)
        seen.append(wd.expired())
        wd.pet()
        clk.advance(2.5)
        seen.append(wd.check())            # fires
        seen.append(wd.check())            # latched: once
    return seen, fired, (wd.timeout, wd.poll)


def test_the_watchdog_expires_suspends_and_fires_once_as_the_reference(
        capsys):
    port = _watchdog_trace(health, fault)
    port_err = capsys.readouterr().err
    ref = _watchdog_trace(jhealth, jfault)
    assert port == ref
    seen, fired, (timeout, poll) = port
    assert seen == [False, False, False, True, False, True, False]
    assert fired == [True]
    assert poll <= timeout
    assert "MX_STEP_TIMEOUT" in port_err and "MainThread" in port_err


def test_a_watchdog_without_a_callback_exits_86_with_the_stacks(tmp_path):
    script = textwrap.dedent("""
        import time
        from mxnet_tpu_torch import health
        wd = health.Watchdog(0.2).start()
        wd.pet()
        time.sleep(30)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, MX_CRASH_DIR=str(tmp_path))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 86, r.stderr
    assert time.monotonic() - t0 < 25
    assert "exiting 86" in r.stderr and "MainThread" in r.stderr
    assert "mx-step-watchdog" in r.stderr
    (dump,) = os.listdir(tmp_path)
    assert "watchdog" in json.load(open(tmp_path / dump))["reason"]


def test_dump_all_stacks_names_live_threads():
    ready, release = threading.Event(), threading.Event()

    def parked():
        ready.set()
        release.wait(timeout=10)

    t = threading.Thread(target=parked, name="parked-thread")
    t.start()
    ready.wait(timeout=10)
    buf = io.StringIO()
    try:
        health.dump_all_stacks(buf)
    finally:
        release.set()
        t.join(timeout=10)
    assert not t.is_alive()
    out = buf.getvalue()
    assert "parked-thread" in out and "MainThread" in out
    assert "release.wait" in out


def test_a_heartbeat_parses_alike_under_both_packages(tmp_path):
    """Line 1 ``<time> <epoch> <batch>``, line 2 the telemetry payload: a
    beat written by either package parses to the same head and payload
    under both packages' ``parse_heartbeat``."""
    telemetry.note_step(epoch=3, batch=7, batch_size=8)
    jtelemetry.note_step(epoch=3, batch=7, batch_size=8)
    for writer in (health, jhealth):
        hb = writer.Heartbeat(str(tmp_path / writer.__name__ / "rank_0"))
        hb.beat(epoch=3, nbatch=7)
        with open(hb.path) as f:
            lines = f.read().splitlines()
        assert len(lines) == 2
        ts, epoch, nbatch = lines[0].split()
        assert abs(float(ts) - time.time()) < 60
        assert (epoch, nbatch) == ("3", "7")
        got = telemetry.parse_heartbeat(lines)
        assert got == jtelemetry.parse_heartbeat(lines)
        assert got[1]["schema"] == 1 and got[1]["epoch"] == 3
        hb.beat(epoch=3, nbatch=8)              # rewritten, not appended
        with open(hb.path) as f:
            assert len(f.read().splitlines()) == 2
        hb.done()
        with open(hb.path) as f:
            assert f.read().strip().endswith("done")
        hb.remove()
        assert not os.path.exists(hb.path)


def test_the_port_s_payload_has_the_reference_s_fields(tmp_path):
    telemetry.note_step(epoch=1, batch=2, batch_size=4)
    jtelemetry.note_step(epoch=1, batch=2, batch_size=4)
    got, want = telemetry.heartbeat_payload(), jtelemetry.heartbeat_payload()
    assert set(got) == set(want)
    for k in ("epoch", "batch", "schema"):
        assert got[k] == want[k]


@pytest.mark.parametrize("env", [
    {},
    {"MX_NAN_POLICY": "skip_batch", "MX_HEARTBEAT_FILE": "HB"},
    {"MX_STEP_TIMEOUT": "2.5"},
    {"MX_STEP_TIMEOUT": "0", "MX_NAN_POLICY": "raise"},
    {"MX_STEP_TIMEOUT": "-1", "MX_NAN_POLICY": "warn",
     "MX_HEARTBEAT_FILE": "HB"},
])
def test_step_guard_from_env_reads_what_the_reference_reads(
        env, monkeypatch, tmp_path):
    for var in ("MX_NAN_POLICY", "MX_STEP_TIMEOUT", "MX_HEARTBEAT_FILE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(tmp_path / v) if v == "HB" else v)
    seen = []
    for h in (health, jhealth):
        g = h.StepGuard.from_env(on_timeout=lambda: None)
        try:
            seen.append((g.armed,
                         g.grad_guard.policy if g.grad_guard else None,
                         g.watchdog.timeout if g.watchdog else None,
                         g.heartbeat.path if g.heartbeat else None))
            g.batch_end(0, 0)
            if g.heartbeat is not None:
                assert os.path.exists(g.heartbeat.path)
        finally:
            g.close()
    assert seen[0] == seen[1]


def _guard_trace(h, f):
    seen = []
    with f.use_virtual_time() as clk:
        g = h.StepGuard(step_timeout=1.0, on_timeout=lambda: None)
        try:
            g.batch_start()                # batch 0: loads, warms up
            clk.advance(100.0)
            seen.append(g.watchdog.expired())
            g.batch_end(0, 0)              # the first batch landed: armed
            g.batch_start()
            clk.advance(1.5)
            seen.append(g.watchdog.expired())
            g.batch_end(0, 1)
            g.epoch_end(0)                 # a checkpoint: disarmed
            clk.advance(50.0)
            seen.append(g.watchdog.expired())
            g.batch_start()                # the next epoch re-arms
            clk.advance(1.5)
            seen.append(g.watchdog.expired())
        finally:
            g.close()
    return seen


def test_step_guard_first_batch_grace_and_epoch_end_as_the_reference():
    assert _guard_trace(health, fault) == _guard_trace(jhealth, jfault) \
        == [False, True, False, True]


def test_the_guard_s_done_beat_ends_hang_enforcement(tmp_path):
    hb = tmp_path / "hb"
    guard = health.StepGuard(heartbeat_path=str(hb))
    guard.batch_end(0, 0)
    guard.epoch_end(0)
    with open(hb) as f:
        assert f.readline().split()[1:] == ["0", "-1"]
    guard.close()
    assert open(hb).read().strip().endswith("done")
