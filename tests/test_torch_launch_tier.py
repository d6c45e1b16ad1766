"""The launcher's serving tier against the reference's (tools/launch.py).

The autoscaler of both packages' ``Supervisor`` on their virtual clocks,
fed the same burn sequence by a stub collector: the same spawns and
retirements at the same rounds, with the same cooldowns.  Drain-not-kill
(the replicas file is rewritten before the DRAIN; a DRAIN that cannot be
delivered becomes a kill), the hysteresis band, the flags' error texts,
the new knobs' catalogue, and one command-line lane: the launcher with
``--serve-port-base``, ``--route`` and ``--compile-cache`` in front of two
``python -m mxnet_tpu_torch.serve --demo --ctx cpu`` replicas.
"""
import importlib.util
import os
import random
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mxnet_tpu import fault as jfault  # noqa: E402
from mxnet_tpu_torch import fault as tfault  # noqa: E402
from mxnet_tpu_torch.tools import launch as tlaunch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _load_reference_launch():
    spec = importlib.util.spec_from_file_location(
        "mx_launch_tier_reference", str(REPO / "tools" / "launch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jlaunch = _load_reference_launch()


class _FakeSLO:
    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


class _FakeFleet:
    """A collector's snapshot() with fabricated scrape rounds."""

    def __init__(self):
        self.snap = None
        self.round = 0
        self.added = []
        self.retired = []
        self.slo = _FakeSLO()

    def snapshot(self):
        return self.snap

    def add_member(self, m):
        self.added.append(m.key)

    def retire(self, key):
        self.retired.append(key)

    def next_round(self, burn):
        self.round += 1
        self.snap = {"scrape": self.round,
                     "slo": {"burn": {"serve_p99_ms": burn}}}


def _autoscaled(mod, fault_mod, tmp_path, monkeypatch, events, replicas=1,
                bounds=(1, 3), cooldown=10.0, rng_seed=7):
    """A supervisor of ``mod`` with ``replicas`` serve processes, a stub
    collector and spawn / DRAIN / kill recorded into ``events``."""
    logs = []
    sup = mod.Supervisor(restart="never", log=logs.append)
    if mod is jlaunch:
        sup._fault = fault_mod          # its clock: the virtual one
    sup.autoscale = bounds
    sup.replicas_file = str(tmp_path / ("replicas-%s" % mod.__name__))
    monkeypatch.setattr(mod.Supervisor, "_spawn",
                        lambda self, sp: events.append(("spawn", sp.name)))
    monkeypatch.setattr(mod.Supervisor, "_kill",
                        lambda self, sp: events.append(("kill", sp.name)))

    def factory(idx):
        return ("serve-%d" % idx, ["true"], {},
                "127.0.0.1:%d" % (9700 + idx), None)
    sup.serve_factory = factory
    sup.fleet = _FakeFleet()
    for i in range(replicas):
        sup.add("serve-%d" % i, ["true"], {}, role="serve",
                addr="127.0.0.1:%d" % (9700 + i))
    sup._as_next_index = replicas
    sup._write_replicas_file()
    # one jitter stream for both packages' cooldowns
    sup._as_policy = fault_mod.RetryPolicy(
        deadline=float("inf"), base=cooldown, max_delay=8.0 * cooldown,
        jitter=0.1, rng=random.Random(rng_seed))
    return sup, logs


def _drain_recorder(mod, monkeypatch, events, sup, fail=False):
    name = "send_drain" if mod is tlaunch else "_send_drain"

    def drain(addr, **kw):
        with open(sup.replicas_file) as f:
            listed = [ln.strip() for ln in f if ln.strip()]
        events.append(("drain", addr, addr in listed))
        if fail:
            raise OSError("connection refused")
    monkeypatch.setattr(mod, name, drain)


#: (burn, virtual seconds before the round): breach held, the cooldown,
#: the max bound, calm held, the band, calm to the min bound
BURNS = ([(2.0, 1.0)] * 4 + [(2.0, 20.0)] + [(2.0, 1.0)] * 6 +
         [(0.0, 30.0)] + [(0.0, 1.0)] * 3 + [(0.75, 1.0), (0.0, 1.0),
                                             (0.75, 1.0)] +
         [(0.0, 90.0)] + [(0.0, 1.0)] * 4 + [(0.0, 200.0)] * 3)


def _run_sequence(mod, fault_mod, clk, tmp_path, monkeypatch):
    events = []
    sup, logs = _autoscaled(mod, fault_mod, tmp_path, monkeypatch, events)
    _drain_recorder(mod, monkeypatch, events, sup)
    trace = []
    for r, (burn, dt) in enumerate(BURNS):
        clk.advance(dt)
        n0 = len(events)
        sup.fleet.next_round(burn)
        sup._check_autoscale()
        acted = events[n0:]
        trace.append((r, tuple(acted),
                      round(sup._as_cooldown_until - sup._now(), 9)
                      if acted else None,
                      len(sup._serve_procs())))
    return trace, sup


def test_both_supervisors_take_the_same_burn_sequence_alike(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("MX_AUTOSCALE_HOLD", "2")
    monkeypatch.setenv("MX_AUTOSCALE_COOLDOWN", "10")
    with jfault.use_virtual_time() as jclk:
        want, jsup = _run_sequence(jlaunch, jfault, jclk, tmp_path,
                                   monkeypatch)
    with tfault.use_virtual_time() as tclk:
        got, tsup = _run_sequence(tlaunch, tfault, tclk, tmp_path,
                                  monkeypatch)
    assert got == want
    acts = [a for _r, acted, _c, _n in got for a in acted]
    spawns = [a for a in acts if a[0] == "spawn"]
    drains = [a for a in acts if a[0] == "drain"]
    assert [a[1] for a in spawns] == ["serve-1", "serve-2"]
    assert [a[1] for a in drains] == ["127.0.0.1:9702", "127.0.0.1:9701"]
    # a drained replica had left the replicas file before its DRAIN
    assert not any(a[2] for a in drains)
    assert len(tsup._serve_procs()) == 1 == len(jsup._serve_procs())
    assert tsup.fleet.slo.resets == jsup.fleet.slo.resets == 2
    assert tsup.fleet.retired == jsup.fleet.retired


def test_a_failed_drain_becomes_a_kill_as_in_the_reference(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("MX_AUTOSCALE_HOLD", "2")
    out = {}
    for mod, fault_mod in ((jlaunch, jfault), (tlaunch, tfault)):
        with fault_mod.use_virtual_time():
            events = []
            sup, logs = _autoscaled(mod, fault_mod, tmp_path, monkeypatch,
                                    events, replicas=2)
            _drain_recorder(mod, monkeypatch, events, sup, fail=True)
            for _ in range(2):
                sup.fleet.next_round(0.0)
                sup._check_autoscale()
            out[mod] = events
            assert any("DRAIN failed" in m for m in logs)
            assert any("drain-not-kill" in m for m in logs)
            assert sup.procs[-1].draining
            with open(sup.replicas_file) as f:
                assert f.read().split() == ["127.0.0.1:9700"]
    assert out[tlaunch] == out[jlaunch] == [
        ("drain", "127.0.0.1:9701", False), ("kill", "serve-1")]


def test_the_hysteresis_band_holds_steady(tmp_path, monkeypatch):
    monkeypatch.setenv("MX_AUTOSCALE_HOLD", "2")
    for mod, fault_mod in ((jlaunch, jfault), (tlaunch, tfault)):
        with fault_mod.use_virtual_time():
            events = []
            sup, _ = _autoscaled(mod, fault_mod, tmp_path, monkeypatch,
                                 events, replicas=2)
            _drain_recorder(mod, monkeypatch, events, sup)
            # a band round resets both holds: breach-band-breach never
            # adds up to an action
            for burn in (2.0, 0.75, 2.0, 0.75, 0.0, 0.75, 0.0, 0.5001):
                sup.fleet.next_round(burn)
                sup._check_autoscale()
            assert events == [], mod
            # the same round read twice counts once
            sup.fleet.next_round(2.0)
            sup._check_autoscale()
            sup._check_autoscale()
            assert sup._as_up_hold == 1


class _Args:
    def __init__(self, **kw):
        base = dict(num_workers=2, num_servers=0, restart="never",
                    max_restarts=3, hang_timeout=None, status_interval=None,
                    elastic=False, resize_file=None, drain_timeout=None,
                    fault=None, ps_snapshot_dir=None, serve_port_base=None,
                    route=None, autoscale=None, compile_cache=None)
        base.update(kw)
        self.__dict__.update(base)


@pytest.mark.parametrize("kw", [
    dict(route=9100), dict(autoscale="1:2"),
    dict(serve_port_base=9000, autoscale="2"),
    dict(serve_port_base=9000, autoscale="a:b"),
    dict(serve_port_base=9000, autoscale="3:1"),
    dict(serve_port_base=9000, autoscale="0:2"),
])
def test_the_flag_errors_are_the_reference_s(kw, monkeypatch):
    """The texts after each launcher's own prefix agree."""
    texts = []
    for mod, prefix in ((jlaunch, "launch.py: "), (tlaunch, "launch: ")):
        monkeypatch.setattr(mod.Supervisor, "run", lambda self: 0)
        with pytest.raises(SystemExit) as e:
            mod.launch_local(_Args(**kw), ["true"])
        msg = str(e.value.code)
        assert msg.startswith(prefix), msg
        texts.append(msg[len(prefix):])
    assert texts[0] == texts[1]


def test_the_new_knobs_are_catalogued():
    from mxnet_tpu.base import ENV_CATALOG as J
    from mxnet_tpu_torch.base import ENV_CATALOG as T
    for name in ("MX_COMPILE_CACHE", "MX_COMPILE_CACHE_SALT",
                 "MX_AUTOSCALE_UP_BURN", "MX_AUTOSCALE_DOWN_BURN",
                 "MX_AUTOSCALE_HOLD", "MX_AUTOSCALE_COOLDOWN",
                 "MX_FLEET_INTERVAL", "MX_FLEET_SLO_P99_MS"):
        assert name in T and T[name][1], name
        assert T[name][0] == J[name][0], name


def test_the_launcher_contract_names_are_catalogued_as_the_reference():
    """F6: the launcher's environment contract (what
    parallel.init_process_group and a --port-base replica read) was read
    by the port but missing from its catalogue."""
    from mxnet_tpu.base import ENV_CATALOG as J
    from mxnet_tpu_torch.base import ENV_CATALOG as T
    env = tlaunch.worker_env(1, "127.0.0.1:9", 2)
    for name in sorted(k for k in env if k.startswith("MX_")):
        assert name in T and T[name][1], name
        assert T[name][0] == J[name][0], name


def test_the_launcher_wires_every_replica_and_the_router(tmp_path,
                                                         monkeypatch):
    """Replicas at base + rank (an autoscaled one past -n), the router a
    host process on the CPU with the replicas file and the FLEET port,
    and MX_COMPILE_CACHE in every process."""
    seen = {}

    def run(self):
        seen["sup"] = self
        with open(self.replicas_file) as f:
            seen["file"] = f.read().split()
        return 0
    monkeypatch.setattr(tlaunch.Supervisor, "run", run)
    cache = tmp_path / "cc"
    assert tlaunch.main(["-n", "2", "--serve-port-base", "9600", "--route",
                         "9650", "--autoscale", "2:3", "--compile-cache",
                         str(cache), "--", "python", "replica.py"]) == 0
    sup = seen["sup"]
    roles = [(sp.name, sp.role, sp.addr) for sp in sup.procs]
    assert roles == [("rank 0", "serve", "127.0.0.1:9600"),
                     ("rank 1", "serve", "127.0.0.1:9601"),
                     ("router", "router", "127.0.0.1:9650")]
    assert seen["file"] == ["127.0.0.1:9600", "127.0.0.1:9601"]
    router = sup.procs[2]
    assert router.env["CUDA_VISIBLE_DEVICES"] == "" and \
        router.env["MX_FORCE_CPU"] == "1"
    assert "--replicas-file" in router.argv and "--fleet" in router.argv
    assert all(sp.env["MX_COMPILE_CACHE"] == str(cache)
               for sp in sup.procs[:2])
    assert cache.is_dir()
    assert sup.autoscale == (2, 3)
    name, argv, env, addr, _hb = sup.serve_factory(sup._as_next_index)
    assert (name, addr, env["MX_PROCESS_ID"]) == ("rank 2",
                                                  "127.0.0.1:9602", "2")
    assert env["MX_COMPILE_CACHE"] == str(cache)


def _free_ports(n):
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        ok = True
        for p in range(base, base + n):
            t = socket.socket()
            try:
                t.bind(("127.0.0.1", p))
            except OSError:
                ok = False
            finally:
                t.close()
        if ok:
            return base


def _wait_port(port, proc, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return
        except OSError:
            if proc.poll() is not None:
                break
            time.sleep(0.05)
    raise RuntimeError("nothing came up on %d (launcher rc %r)"
                       % (port, proc.poll()))


def test_cli_routed_tier_drains_one_replica_mid_load_and_stops(tmp_path):
    """`launch --serve-port-base --route --compile-cache` in front of two
    demo replicas: 24 verified PREDICTs through the router while replica
    0 is DRAINed mid-load (it exits 0, nothing lost, no restart), then a
    STOP through the router ends the job with rc 0."""
    from mxnet_tpu_torch.serve import ServeClient
    from mxnet_tpu_torch.serve.demo import DEMO_IN, demo_block
    base = _free_ports(2)
    rport = _free_ports(1)
    cache = tmp_path / "cc"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", MX_SERVE_BUCKETS="1,2,4",
               MX_FLEET_INTERVAL="0.5")
    env.pop("MX_FAULT_INJECT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
         "--restart", "on-failure", "--serve-port-base", str(base),
         "--route", str(rport), "--compile-cache", str(cache), "--",
         sys.executable, "-m", "mxnet_tpu_torch.serve", "--demo", "--ctx",
         "cpu", "--port-base", str(base)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    try:
        for port in (base, base + 1, rport):
            _wait_port(port, proc, timeout=90)
        with torch.no_grad():
            net = demo_block("cpu")
        rng = np.random.RandomState(6)
        cli = ServeClient(["127.0.0.1:%d" % rport], timeout=30)
        drained = None
        for i in range(24):
            if i == 8:
                with ServeClient(["127.0.0.1:%d" % base],
                                 timeout=15) as dc:
                    drained = dc.drain(timeout=20.0)
            x = rng.randn(2, DEMO_IN).astype(np.float32)
            _version, outs = cli.predict([x])
            with torch.no_grad():
                want = net(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(outs[0], want, rtol=1e-5, atol=1e-6)
        assert drained["status"] == "draining", drained
        cli.stop()
        cli.close()
        rc = proc.wait(timeout=60)
    except Exception:
        proc.kill()
        raise
    reader.join(10)
    log = "".join(lines)
    assert rc == 0, log[-3000:]
    assert "restart" not in log.replace("--restart", ""), log[-3000:]
    # the replicas saw the cache (on), not the "off" banner
    assert log.count("compile-cache hits=0 misses=0") == 2, log[-3000:]
    assert "compile-cache off" not in log
    assert cache.is_dir()
