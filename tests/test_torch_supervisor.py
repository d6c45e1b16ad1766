"""The port launcher's supervisor and ssh mode against the reference's
``tools/launch.py``, on the CPU.

The reference ``Supervisor`` is loaded from ``tools/launch.py`` as
``tests/test_supervisor.py`` loads it; both supervisors run the same small
child scripts (plain Python, milliseconds each) and must reach the same
outcome: exit code, restarts, retirement, the backoff schedule with the
jitter off (read from their log lines, on each package's virtual clock),
the folded server codes, a LEAVE sent on a dead rank's behalf to the
port's parameter server running in a thread.  ``_make_supervisor``'s flag
parsing and ``launch_ssh``'s refusals must match, and ``launch_ssh``'s
remote command runs through a fake ``ssh`` on ``PATH``.

One difference is the port's on purpose: under ``restart="never"`` a
failure stops the job at once, where the reference waits for the other
processes (a rank that died leaves its peers blocked in a collective).
The cases below keep the healthy process alive past the failure, so the
outcome they compare does not depend on it.
"""
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from mxnet_tpu import fault as jfault
from mxnet_tpu import telemetry as jtelemetry

from mxnet_tpu_torch import fault, telemetry
from mxnet_tpu_torch.kvstore.server import recv_msg, send_msg, serve_forever
from mxnet_tpu_torch.tools import launch

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference_launch():
    spec = importlib.util.spec_from_file_location(
        "mx_launch_reference", os.path.join(REPO, "tools", "launch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jlaunch = _load_reference_launch()
#: name -> (the launcher module, its fault module)
BOTH = {"port": (launch, fault), "reference": (jlaunch, jfault)}


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


def _backoff(f, base=0.5):
    return f.RetryPolicy(deadline=float("inf"), base=base, max_delay=8.0,
                         jitter=0.0)


def _env(**extra):
    env = dict(os.environ)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _both(build, virtual=True):
    """Run ``build(launch_module, fault_module, log)`` -> supervisor for
    each package; returns {name: (rc, supervisor, log lines)}."""
    out = {}
    for name, (mod, f) in BOTH.items():
        lines = []
        sup = build(mod, f, lines.append)
        if virtual:
            with f.use_virtual_time():
                rc = sup.run()
        else:
            rc = sup.run()
        out[name] = (rc, sup, lines)
    return out


_COUNTER_SCRIPT = textwrap.dedent("""
    import os, sys
    m = os.environ["MX_TEST_MARKER"]
    n = len(open(m).read()) if os.path.exists(m) else 0
    open(m, "a").write("x")
    sys.exit(0 if n >= int(os.environ["MX_TEST_FAILS"]) else 9)
""")


def test_restarts_with_the_original_env_and_the_backoff_schedule(tmp_path):
    """A process that fails three times, then succeeds: three restarts
    after 0.5, 1 and 2 s of backoff (on the virtual clock), the same log
    lines, exit 0."""
    def build(mod, f, log):
        sup = mod.Supervisor(restart="on-failure", max_restarts=3,
                             backoff=_backoff(f), log=log)
        sup.add("rank 0", [sys.executable, "-c", _COUNTER_SCRIPT],
                _env(MX_TEST_MARKER=tmp_path / mod.__name__,
                     MX_TEST_FAILS=3))
        return sup

    t0 = time.monotonic()
    got = _both(build)
    assert time.monotonic() - t0 < 30
    (rc, sup, lines), (jrc, jsup, jlines) = got["port"], got["reference"]
    assert rc == jrc == 0
    assert [(p.restarts, p.rc) for p in sup.procs] == \
        [(p.restarts, p.rc) for p in jsup.procs] == [(3, 0)]
    assert lines == jlines
    assert [line.split(" in ")[1].split("s ")[0] for line in lines] == \
        ["0.5", "1", "2"]


def test_the_default_backoff_is_the_reference_s():
    sup, jsup = launch.Supervisor(), jlaunch.Supervisor()
    sup._backoff_delay(0)
    jsup._backoff_delay(0)
    for attr in ("deadline", "base", "max_delay", "jitter"):
        assert getattr(sup._backoff, attr) == getattr(jsup._backoff, attr)


def test_an_exhausted_budget_tears_the_job_down():
    def build(mod, f, log):
        sup = mod.Supervisor(restart="on-failure", max_restarts=1,
                             backoff=_backoff(f, 0.01), log=log)
        sup.add("rank 0", [sys.executable, "-c", "import sys; sys.exit(5)"],
                _env())
        sup.add("rank 1", [sys.executable, "-c",
                           "import time; time.sleep(60)"], _env())
        return sup

    t0 = time.monotonic()
    got = _both(build)
    assert time.monotonic() - t0 < 30
    for rc, sup, lines in got.values():
        bad, slow = sup.procs
        assert (rc, bad.restarts, bad.rc, slow.alive()) == (5, 1, 5, False)
    assert got["port"][2] == got["reference"][2]


def test_restart_never_fails_the_job_with_the_failing_code():
    def build(mod, f, log):
        sup = mod.Supervisor(restart="never", log=log)
        sup.add("rank 0", [sys.executable, "-c", "import sys; sys.exit(2)"],
                _env())
        sup.add("rank 1", [sys.executable, "-c",
                           "import time; time.sleep(1.5)"], _env())
        return sup

    got = _both(build, virtual=False)
    for rc, sup, _ in got.values():
        assert rc == 2 and sup.procs[0].restarts == 0
        assert all(p.done for p in sup.procs)
    # the port's on purpose: the healthy rank was stopped, not waited for
    assert got["port"][1].procs[1].we_killed
    assert got["reference"][1].procs[1].rc == 0


def test_a_stale_heartbeat_is_killed_and_restarted(tmp_path):
    script = textwrap.dedent("""
        import os, sys, time
        m = os.environ["MX_TEST_MARKER"]
        if os.path.exists(m):
            sys.exit(0)
        open(m, "w").close()
        open(os.environ["MX_HEARTBEAT_FILE"], "w").close()  # one beat
        time.sleep(60)                                      # then wedged
    """)

    def build(mod, f, log):
        hb = str(tmp_path / ("hb-" + mod.__name__))
        sup = mod.Supervisor(restart="on-failure", max_restarts=2,
                             hang_timeout=0.3, backoff=_backoff(f, 0.01),
                             log=log)
        sup.add("rank 0", [sys.executable, "-c", script],
                _env(MX_TEST_MARKER=tmp_path / mod.__name__,
                     MX_HEARTBEAT_FILE=hb), heartbeat=hb)
        return sup

    t0 = time.monotonic()
    got = _both(build)
    assert time.monotonic() - t0 < 40
    for rc, sup, lines in got.values():
        assert rc == 0 and sup.procs[0].restarts == 1
        assert "heartbeat stale" in lines[0] and "--hang-timeout" in lines[0]
        assert "signal 9" in lines[1]


def test_the_startup_grace_bounds_a_wedged_spawn(tmp_path):
    script = textwrap.dedent("""
        import os, sys, time
        m = os.environ["MX_TEST_MARKER"]
        if os.path.exists(m):
            sys.exit(0)
        open(m, "w").close()
        time.sleep(60)                     # wedged before any beat
    """)

    def build(mod, f, log):
        sup = mod.Supervisor(restart="on-failure", max_restarts=2,
                             hang_timeout=0.2, startup_grace=0.5,
                             backoff=_backoff(f, 0.01), log=log)
        sup.add("rank 0", [sys.executable, "-c", script],
                _env(MX_TEST_MARKER=tmp_path / mod.__name__),
                heartbeat=str(tmp_path / ("hb-" + mod.__name__)))
        return sup

    for rc, sup, lines in _both(build).values():
        assert rc == 0 and sup.procs[0].restarts == 1
        assert "startup grace" in lines[0]


def test_a_done_beat_ends_hang_enforcement(tmp_path):
    from mxnet_tpu_torch import health
    hb = tmp_path / "hb"
    guard = health.StepGuard(heartbeat_path=str(hb))
    guard.batch_end(0, 0)
    guard.close()
    for mod in (launch, jlaunch):
        sup = mod.Supervisor(restart="on-failure", max_restarts=1,
                             hang_timeout=0.1, startup_grace=0.1)
        sp = sup.add("rank 0", [sys.executable, "-c",
                                "import time; time.sleep(30)"], _env(),
                     heartbeat=str(hb))
        sp.spawned_wall = time.time() - 100
        sp.proc = subprocess.Popen(sp.argv, env=sp.env)
        try:
            os.utime(str(hb), (time.time() - 100, time.time() - 100))
            sup._check_hang(sp)                # stale, but 'done'
            assert sp.proc.poll() is None
        finally:
            sp.proc.kill()
            sp.proc.wait()


_FAKE_PS = textwrap.dedent("""
    import os, pickle, socket, struct, sys
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", int(os.environ["FAKE_PS_PORT"])))
    srv.listen(4)
    while True:
        c, _ = srv.accept()
        head = b""
        while len(head) < 8:
            chunk = c.recv(8 - len(head))
            if not chunk:
                break
            head += chunk
        if len(head) < 8:
            c.close()
            continue
        (n,) = struct.unpack("<Q", head)
        body = b""
        while len(body) < n:
            body += c.recv(n - len(body))
        msg = pickle.loads(body)
        payload = pickle.dumps((True, "stopping"))
        c.sendall(struct.pack("<Q", len(payload)) + payload)
        c.close()
        if msg[0] == "STOP":
            sys.exit(int(os.environ.get("FAKE_PS_RC", "0")))
""")


@pytest.mark.parametrize("server_rc", [0, 3])
def test_servers_get_the_wire_stop_and_their_codes_fold(server_rc):
    def build(mod, f, log):
        port = launch._free_port()
        sup = mod.Supervisor(restart="never", log=log)
        sup.add("server 0", [sys.executable, "-c", _FAKE_PS],
                _env(FAKE_PS_PORT=port, FAKE_PS_RC=server_rc),
                role="server", addr="127.0.0.1:%d" % port)
        sup.add("rank 0", [sys.executable, "-c",
                           "import time; time.sleep(1.0)"], _env())
        return sup

    for rc, sup, _ in _both(build, virtual=False).values():
        server = sup.procs[0]
        assert rc == server_rc
        assert server.rc == server_rc and not server.we_killed


def test_a_forgiven_server_crash_does_not_fail_the_job():
    def build(mod, f, log):
        huge = f.RetryPolicy(deadline=float("inf"), base=1e9, max_delay=1e9,
                             jitter=0.0)
        sup = mod.Supervisor(restart="on-failure", max_restarts=2,
                             backoff=huge, log=log)
        sup.add("server 0", [sys.executable, "-c",
                             "import sys; sys.exit(17)"], _env(),
                role="server")
        sup.add("rank 0", [sys.executable, "-c",
                           "import time; time.sleep(0.5)"], _env())
        return sup

    for rc, sup, _ in _both(build, virtual=False).values():
        assert rc == 0 and sup.procs[0].rc == 0


def test_a_server_crash_folds_into_the_job_s_code():
    def build(mod, f, log):
        sup = mod.Supervisor(restart="never", log=log)
        sup.add("server 0", [sys.executable, "-c",
                             "import sys; sys.exit(17)"], _env(),
                role="server")
        sup.add("rank 0", [sys.executable, "-c",
                           "import time; time.sleep(1.0)"], _env())
        return sup

    for rc, _sup, _ in _both(build, virtual=False).values():
        assert rc == 17


def test_an_elastic_job_shrinks_past_a_budget():
    def build(mod, f, log):
        sup = mod.Supervisor(restart="on-failure", max_restarts=0,
                             backoff=_backoff(f), elastic=True, log=log)
        sup.add("rank 0", [sys.executable, "-c", "import sys; sys.exit(5)"],
                _env(MX_PROCESS_ID=0))
        sup.add("rank 1", [sys.executable, "-c",
                           "import time; time.sleep(1.0)"],
                _env(MX_PROCESS_ID=1))
        return sup

    got = _both(build)
    for rc, sup, lines in got.values():
        bad, ok = sup.procs
        assert (rc, bad.rc, bad.done, ok.rc) == (0, 5, True, 0)
        assert "elastic shrink" in lines[0]
    assert got["port"][2] == got["reference"][2]


def test_an_elastic_rank_sigkilled_past_its_budget_shrinks():
    """The documented contract of the reference's racing case
    (test_elastic.py): rc 0, one restart spent, the rank's rc -9.  The
    survivor outlives the backoff here, so no interleaving decides it."""
    kill_me = "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"

    def build(mod, f, log):
        sup = mod.Supervisor(restart="on-failure", max_restarts=1,
                             backoff=_backoff(f, 0.01), elastic=True,
                             log=log)
        sup.add("rank 0", [sys.executable, "-c", kill_me],
                _env(MX_PROCESS_ID=0))
        sup.add("rank 1", [sys.executable, "-c",
                           "import time; time.sleep(1.5)"],
                _env(MX_PROCESS_ID=1))
        return sup

    for rc, sup, _ in _both(build).values():
        bad = sup.procs[0]
        assert (rc, bad.restarts, bad.rc) == (0, 1, -signal.SIGKILL)


def test_an_elastic_job_without_survivors_still_tears_down():
    def build(mod, f, log):
        sup = mod.Supervisor(restart="on-failure", max_restarts=0,
                             backoff=_backoff(f), elastic=True, log=log)
        sup.add("rank 0", [sys.executable, "-c", "import sys; sys.exit(5)"],
                _env(MX_PROCESS_ID=0))
        return sup

    for rc, _sup, _ in _both(build).values():
        assert rc == 5


def _start_server(num_workers):
    port = launch._free_port()
    t = threading.Thread(target=serve_forever,
                         kwargs=dict(port=port, num_workers=num_workers),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port),
                                     timeout=0.2).close()
            return port, t
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("server did not come up on %d" % port)


def _rpc(port, msg):
    raw = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        send_msg(raw, msg)
        return recv_msg(raw, timeout=5)
    finally:
        raw.close()


@pytest.mark.parametrize("which", ["port", "reference"])
def test_a_leave_on_a_dead_rank_s_behalf_reaches_the_port_s_server(which):
    mod, f = BOTH[which]
    port, thread = _start_server(num_workers=2)
    try:
        sup = mod.Supervisor(restart="on-failure", max_restarts=0,
                             backoff=_backoff(f), elastic=True,
                             log=lambda msg: None)
        sup.ps_addrs = ["127.0.0.1:%d" % port]
        sup.add("rank 1", [sys.executable, "-c", "import sys; sys.exit(3)"],
                _env(MX_PROCESS_ID=1))
        sup.add("rank 0", [sys.executable, "-c",
                           "import time; time.sleep(1.0)"],
                _env(MX_PROCESS_ID=0))
        assert sup.run() == 0
        ok, (epoch, members) = _rpc(port, ("MEMBERS", None))
        assert ok and members == ["r0"] and epoch == 1
    finally:
        _rpc(port, ("STOP", None))
        thread.join(timeout=10)
    assert not thread.is_alive()


_RESIZE_WORKER = textwrap.dedent("""
    import os, time
    open(os.environ["MX_DONE_DIR"] + "/done.%s.gen%s" % (
        os.environ["MX_PROCESS_ID"],
        os.environ.get("MX_ELASTIC_EPOCH", "?")), "w").close()
    time.sleep(float(os.environ.get("MX_LINGER", "0")))
""")


def _resize_factory(done_dir):
    def make_worker(rank, n, generation):
        env = _env(MX_PROCESS_ID=rank, MX_DONE_DIR=done_dir, MX_LINGER=0,
                   MX_ELASTIC=1, MX_ELASTIC_EPOCH=generation)
        return ("rank %d" % rank, [sys.executable, "-c", _RESIZE_WORKER],
                env, None)
    return make_worker


@pytest.mark.parametrize("which", ["port", "reference"])
def test_a_resize_file_grows_and_shrinks_the_worker_set(which, tmp_path):
    mod, f = BOTH[which]
    port, thread = _start_server(num_workers=2)
    try:
        for n0, n_new, done in [(1, 3, tmp_path / "grow"),
                                (2, 1, tmp_path / "shrink")]:
            os.makedirs(done)
            resize = done / "resize"
            resize.write_text(str(n_new))
            factory = _resize_factory(str(done))
            sup = mod.Supervisor(restart="never", elastic=True,
                                 resize_file=str(resize), drain_timeout=5.0,
                                 log=lambda msg: None)
            sup.worker_factory = factory
            sup.ps_addrs = ["127.0.0.1:%d" % port]
            sup._resize_applied = n0
            for rank in range(n0):
                name, argv, env, hb = factory(rank, n0, 0)
                env["MX_LINGER"] = "30"           # running at the tick
                sup.add(name, argv, env, heartbeat=hb)
            t0 = time.monotonic()
            assert sup.run() == 0
            assert time.monotonic() - t0 < 25
            assert sup.generation == 1
            assert sorted(e for e in os.listdir(done) if "gen1" in e) == \
                ["done.%d.gen1" % r for r in range(n_new)]
        ok, (_, members) = _rpc(port, ("MEMBERS", None))
        assert ok and "r1" not in members and "r2" not in members
    finally:
        _rpc(port, ("STOP", None))
        thread.join(timeout=10)


def test_a_stale_resize_target_is_never_reapplied(tmp_path):
    resize = tmp_path / "resize"

    def boom(rank, n, generation):
        raise AssertionError("a stale target was applied")

    for mod in (launch, jlaunch):
        resize.write_text("2")
        sup = mod.Supervisor(restart="never", elastic=True,
                             resize_file=str(resize), log=lambda msg: None)
        sup.worker_factory = boom
        sup._resize_applied = 2
        sup._check_resize()
        for bad in ("0", "banana", ""):
            resize.write_text(bad)
            sup._check_resize()
        assert sup.generation == 0


def test_the_status_table_and_crash_dump_read_the_heartbeat(tmp_path,
                                                            monkeypatch):
    hb = tmp_path / "hb"
    hb.write_text("1.0 2 3\n" + json.dumps(
        {"step": 7, "epoch": 2, "steps_per_sec": 1.5, "throughput": 96.0,
         "wire_bytes": 2048, "schema": 1, "ts": 0.0}) + "\n")
    monkeypatch.setenv("MX_CRASH_DIR", str(tmp_path / "crash"))
    tables, dumps = [], []
    for mod in (launch, jlaunch):
        sup = mod.Supervisor(restart="never", status_interval=0,
                             log=lambda msg: None)
        sp = sup.add("rank 0", ["true"], _env(), heartbeat=str(hb))
        tables.append([line.split()[:8]
                       for line in sup.status_table().splitlines()[2:4]])
        path = sup._crash_dump(sp, 86, sup._describe(86))
        blob = json.load(open(path))
        blob.pop("wall_time")
        blob.pop("heartbeat_age")
        blob.pop("fleet", None)
        dumps.append(blob)
        os.remove(path)
    assert tables[0] == tables[1]
    assert tables[0][1] == ["rank", "0", "spawning", "0", "7", "2", "1.5",
                            "96"]
    assert dumps[0] == dumps[1]
    assert dumps[0]["reason"] == \
        "exit 86 (MX_STEP_TIMEOUT watchdog: hung step)"


def test_a_torn_payload_is_tolerated_and_counted(tmp_path):
    hb = tmp_path / "hb"
    hb.write_text("1.0 0 0\n{\"step\": 1,\n")
    for mod in (launch, jlaunch):
        sup = mod.Supervisor()
        sp = sup.add("rank 0", ["true"], _env(), heartbeat=str(hb))
        before = mod.Supervisor.malformed_beats
        age, head, payload = sup._read_beat(sp)
        assert (head, payload) == ("1.0 0 0", {})
        assert age is not None
        assert mod.Supervisor.malformed_beats == before + 1


class _Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("kw", [
    dict(restart="2", max_restarts=3, hang_timeout=None),
    dict(restart="on-failure", max_restarts=3, hang_timeout=None),
    dict(restart="never", max_restarts=5, hang_timeout=4.0,
         status_interval=2.0),
    dict(restart="0", max_restarts=3, elastic=True, resize_file="f",
         drain_timeout=9.0),
    dict(restart="on-failure", max_restarts=1, drain_timeout=None),
    dict(),
])
def test_make_supervisor_parses_the_flags_as_the_reference(kw):
    sup, jsup = launch._make_supervisor(_Args(**kw)), \
        jlaunch._make_supervisor(_Args(**kw))
    for attr in ("restart", "max_restarts", "hang_timeout",
                 "status_interval", "elastic", "resize_file",
                 "drain_timeout", "startup_grace"):
        assert getattr(sup, attr) == getattr(jsup, attr), attr


@pytest.mark.parametrize("restart", ["sometimes", "-1"])
def test_make_supervisor_refuses_a_bad_policy_as_the_reference(restart):
    for mod in (launch, jlaunch):
        with pytest.raises(SystemExit):
            mod._make_supervisor(_Args(restart=restart, max_restarts=3))


@pytest.mark.parametrize("kw, flag", [
    (dict(hang_timeout=5.0), "hang-timeout"),
    (dict(restart="on-failure"), "restart"),
    (dict(elastic=True), "elastic"),
    (dict(resize_file="f"), "resize-file"),
    (dict(num_servers=1), "num-servers"),
    (dict(route=9100), "route"),
    (dict(serve_port_base=9000), "serve-port-base"),
    (dict(autoscale="1:2"), "autoscale"),
])
def test_launch_ssh_refuses_what_the_reference_refuses(kw, flag):
    base = dict(num_servers=0, num_workers=1, hostfile=None,
                restart="never", max_restarts=3, hang_timeout=None)
    base.update(kw)
    for mod in (launch, jlaunch):
        with pytest.raises(SystemExit, match=flag):
            mod.launch_ssh(_Args(**base), ["true"])


_FAKE_SSH = textwrap.dedent("""\
    #!/bin/sh
    # ssh -o StrictHostKeyChecking=no HOST COMMAND: run COMMAND here
    echo "$@" > "$FAKE_SSH_LOG.$3"
    exec sh -c "$4"
""")


def test_launch_ssh_runs_the_remote_command_through_ssh(tmp_path,
                                                        monkeypatch):
    """Rank r on hostfile line r: both launchers give the remote command
    the same contract (coordinator on the first host, rank, world)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "ssh").write_text(_FAKE_SSH)
    (bindir / "ssh").chmod(0o755)
    (tmp_path / "hosts").write_text("# the job\nhostA slots=1\nhostB\n")
    monkeypatch.setenv("PATH", "%s:%s" % (bindir, os.environ["PATH"]))
    report = ("import json, os, sys; json.dump({k: v for k, v in "
              "os.environ.items() if k.startswith(('MX_', 'DMLC_'))}, "
              "open(sys.argv[1] + os.environ['MX_PROCESS_ID'], 'w'))")
    seen = {}
    for name, (mod, _f) in BOTH.items():
        monkeypatch.setenv("FAKE_SSH_LOG", str(tmp_path / name))
        monkeypatch.chdir(tmp_path)
        args = _Args(num_servers=0, num_workers=2,
                     hostfile=str(tmp_path / "hosts"), restart="never",
                     max_restarts=3, hang_timeout=None)
        rc = mod.launch_ssh(args, [sys.executable, "-c", report,
                                   str(tmp_path / (name + ".env"))])
        assert rc == 0
        seen[name] = [json.load(open(tmp_path / ("%s.env%d" % (name, r))))
                      for r in range(2)]
        for r, host in enumerate(("hostA", "hostB")):
            argv = open(tmp_path / ("%s.%s" % (name, host))).read().split()
            assert argv[:3] == ["-o", "StrictHostKeyChecking=no", host]
    assert seen["port"] == seen["reference"]
    assert [e["MX_PROCESS_ID"] for e in seen["port"]] == ["0", "1"]
    assert {e["MX_COORDINATOR"] for e in seen["port"]} == {"hostA:43117"}
    assert {e["MX_NUM_PROCESSES"] for e in seen["port"]} == {"2"}


def test_a_short_hostfile_is_refused(tmp_path):
    (tmp_path / "hosts").write_text("hostA\n")
    args = _Args(num_servers=0, num_workers=2,
                 hostfile=str(tmp_path / "hosts"), restart="never",
                 max_restarts=3, hang_timeout=None)
    for mod in (launch, jlaunch):
        with pytest.raises(SystemExit, match="hostfile has 1 hosts"):
            mod.launch_ssh(args, ["true"])


def test_the_cli_takes_the_supervision_flags(tmp_path):
    """End to end through ``python -m mxnet_tpu_torch.tools.launch``: a
    rank that fails once is restarted (``--restart 2``) with its original
    environment and the job exits 0; the manual launcher refuses the
    supervision flags by name."""
    marker = tmp_path / "marker"
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "1",
         "--restart", "2", "--status-interval", "0", "--",
         sys.executable, "-c", _COUNTER_SCRIPT],
        cwd=REPO, env=_env(PYTHONPATH=REPO, MX_TEST_MARKER=marker,
                           MX_TEST_FAILS=1),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "rank 0 failed (exit 9) - restart 1/2" in r.stderr
    assert "fleet status:" in r.stderr
    with pytest.raises(SystemExit) as e:
        launch.main(["-n", "1", "--launcher", "manual", "--restart",
                     "on-failure", "--", "true"])
    assert e.value.code == 2
