"""The port's serving tier around the engines against the reference, on
the CPU: METRICS, DRAIN, SWAP, several models on one replica, the HBM
packer, and the command lines.

METRICS exposes the reference replica's metric names for the same
traffic; DRAIN answers the reference's status and keeps the first
deadline; PREDICT routes by model name; ``add_model`` under a budget
raises ``BudgetExceeded`` and keeps nothing, and ``packing_report`` has
the reference's keys; SWAP flips over the wire (with
``Servable.from_checkpoint`` patched to a ``from_block`` servable, since
``gluon.SymbolBlock`` is not ported), refuses in-band with "budget: ..."
when the packer says no, and unpatched answers "swap failed: ..." naming
what it waits for.  ``python -m mxnet_tpu_torch.serve --demo --decode
--ctx cpu`` and ``python -m mxnet_tpu_torch.serve.router`` run as
processes: PREDICT and GENERATE are right and both leave cleanly on STOP.
"""
import os
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu import fault as jfault
from mxnet_tpu.serve import (BucketTable as JBuckets, ModelHost as JHost,
                             Servable as JServable, ServeClient as JClient,
                             ServeServer as JServer,
                             serve_forever as j_serve_forever)
from mxnet_tpu.serve import decode as jdec
from mxnet_tpu.serve.demo import demo_block as j_demo_block

from mxnet_tpu_torch import fault, programs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import (BucketTable, BudgetExceeded, ModelHost,
                                   Servable, ServeClient, ServeServer,
                                   serve_forever)
from mxnet_tpu_torch.serve import servable as servable_mod
from mxnet_tpu_torch.serve.decode import (DecodeBatcher, DecodeConfig,
                                          DecodeServable)
from mxnet_tpu_torch.serve.demo import (DEMO_IN, demo_block, demo_example,
                                        demo_expected, demo_requests)

# six xdist workers share the host's cores: cap torch's intra-op threads
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _host(name="demo-mlp", budget=None, buckets=(1, 2)):
    host = ModelHost(hbm_budget=budget)
    host.deploy(Servable(demo_block("cpu"), name=name,
                         buckets=BucketTable(buckets), device="cpu"),
                example=demo_example())
    return host


def _serve(state, port, serve_fn=serve_forever, **kw):
    stop = threading.Event()
    t = threading.Thread(target=serve_fn, daemon=True,
                         kwargs=dict(port=port, state=state,
                                     stop_event=stop, **kw))
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            break
        except OSError:
            time.sleep(0.02)
    return stop, t


# ---------------------------------------------------------------------------
# METRICS
# ---------------------------------------------------------------------------

_SERVE_FAMILY = re.compile(
    r"^(mx_serve_(requests|rows|batches|bucket_hits|retraces|padding_rows|"
    r"queue_rows|batch_occupancy\w*|active_version|rejected|"
    r"server_replays|replay_evicted)|mx_program_\w+|"
    r"mx_step_phase_seconds\w*)(\{[^}]*\})?")


def _names(text, model):
    """The serving family's metric names (and the model's labelled
    series) of one exposition."""
    out = set()
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _SERVE_FAMILY.match(line)
        if not m:
            continue
        labels = m.group(3) or ""
        # another model's series: a process's registry also holds what
        # other tests of the same worker served
        if ("program=" in labels or "model=" in labels) and \
                model not in labels:
            continue
        if "phase=" in labels and not re.search(
                r'phase="(queue_wait|pad|serve_dispatch|scatter|retrace)"',
                labels):
            continue
        labels = re.sub(r',?le="[^"]*"', "", labels)
        out.add(m.group(1) + labels)
    return out


def test_metrics_exposes_the_reference_replica_s_names():
    rng = np.random.RandomState(0)
    xs = [rng.randn(r, DEMO_IN).astype(np.float32) for r in (1, 2, 1)]
    jhost = JHost()
    jhost.deploy(JServable(j_demo_block(), name="tiermlp",
                           buckets=JBuckets((1, 2))),
                 example=[np.zeros((1, DEMO_IN), np.float32)])
    thost = _host(name="tiermlp")
    texts = {}
    for key, state, fn, client in (
            ("jax", JServer(jhost, max_delay_us=0), j_serve_forever,
             JClient),
            ("torch", ServeServer(thost, max_delay_us=0), serve_forever,
             ServeClient)):
        port = _free_port()
        stop, t = _serve(state, port, fn)
        try:
            with client(["127.0.0.1:%d" % port], timeout=30) as cli:
                for x in xs:
                    cli.predict([x])
                texts[key] = cli.metrics()
                texts[key + "_json"] = cli.metrics(fmt="json")
        finally:
            stop.set()
            t.join(10)
    jn, tn = _names(texts["jax"], "tiermlp"), _names(texts["torch"],
                                                      "tiermlp")
    assert jn and jn <= tn, sorted(jn - tn)
    for want in ('mx_serve_active_version{model="tiermlp"}',
                 'mx_program_temp_bytes{program="serve.tiermlp.b2"}',
                 'mx_program_compile_seconds_count'
                 '{program="serve.tiermlp.b1"}',
                 'mx_serve_requests{model="tiermlp"}'):
        assert want in tn, want
    assert '"serve.active_version{model=tiermlp}"' in texts["torch_json"]


# ---------------------------------------------------------------------------
# DRAIN
# ---------------------------------------------------------------------------

def _drain_script(server_cls, host, decode, fl):
    with fl.use_virtual_time() as clk:
        state = server_cls(host, decode=decode, autostart=False)
        before = (state.draining, state.drain_expired())
        st = state.drain(5.0)
        clk.advance(4.0)
        again = state.drain(100.0)
        first = state.drain_expired()
        clk.advance(2.0)
        out = (before, sorted(st), st["status"], st["deadline_seconds"],
               again["deadline_seconds"], first, state.drain_expired(),
               state.drain_idle(), state.health()["status"],
               state.handle(("PREDICT", []))[1].split(":")[0])
        state.close()
    return out


def test_drain_s_status_and_first_deadline_equal_the_reference():
    jcfg = jdec.DecodeConfig(dim=16, heads=2, layers=2, slots=4,
                             max_tokens=4, prompt_buckets=(4,))
    jhost = JHost()
    jhost.deploy(JServable(j_demo_block(), name="d", buckets=JBuckets((1,))),
                 example=[np.zeros((1, DEMO_IN), np.float32)])
    j = _drain_script(JServer, jhost, jdec.DecodeBatcher(
        jdec.DecodeServable(config=jcfg), autostart=False), jfault)
    tcfg = DecodeConfig(dim=16, heads=2, layers=2, slots=4, max_tokens=4,
                        prompt_buckets=(4,))
    t = _drain_script(ServeServer, _host("d", buckets=(1,)), DecodeBatcher(
        DecodeServable(config=tcfg, device="cpu"), autostart=False), fault)
    assert t == j
    assert t[2] == "draining" and t[3] == 5.0 and t[4] == 1.0
    assert t[5] is False and t[6] is True and t[8] == "draining"


# ---------------------------------------------------------------------------
# several models, the packer, SWAP
# ---------------------------------------------------------------------------

def test_predict_routes_by_model_name():
    host = _host("mlp-a")
    state = ServeServer(host, max_delay_us=0)
    other = demo_block("cpu")
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(2.0)
    state.add_model(Servable(other, name="mlp-b",
                             buckets=BucketTable((1, 2)), device="cpu"),
                    example=demo_example(), max_delay_us=0)
    port = _free_port()
    stop, t = _serve(state, port)
    try:
        x = demo_requests(1, rows=2, seed=3)[0][0]
        with ServeClient(["127.0.0.1:%d" % port], timeout=30) as cli:
            _v, a = cli.predict([x])
            _v, a2 = cli.predict([x], model="mlp-a")
            _v, b = cli.predict([x], model="mlp-b")
            with pytest.raises(MXNetError, match="unknown model"):
                cli.predict([x], model="nope")
            h = cli.health()
        np.testing.assert_allclose(a[0], demo_expected(x, device="cpu"),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(a[0], a2[0])
        np.testing.assert_allclose(b[0], demo_expected(x, net=other),
                                   rtol=1e-5, atol=1e-6)
        assert sorted(h["packing"]["models"]) == ["mlp-a", "mlp-b"]
        assert host.models() == ["mlp-a", "mlp-b"]
        assert host.default_model == "mlp-a"
        assert host.version_of("mlp-b") == 1
        assert host.history() == [(1, "mlp-a"), (1, "mlp-b")]
    finally:
        stop.set()
        t.join(10)


def test_add_model_past_the_budget_raises_and_keeps_nothing():
    sv = Servable(demo_block("cpu"), name="pk-a",
                  buckets=BucketTable((1,)), device="cpu")
    foot = sv.live_bytes()
    host = ModelHost(hbm_budget=foot + 100)
    host.deploy(sv, example=demo_example())
    dec = DecodeBatcher(DecodeServable(config=DecodeConfig(
        dim=16, heads=2, layers=1, slots=2, max_tokens=4,
        prompt_buckets=(4,)), device="cpu"), autostart=False)
    state = ServeServer(host, decode=dec, autostart=False)
    rep = host.packing_report()
    jrep = JHost().packing_report()
    assert sorted(rep) == sorted(jrep)
    assert rep["hbm_budget_bytes"] == foot + 100
    # the decode model counts against the budget too: already over it
    assert rep["used_bytes"] == foot + dec.servable.footprint_bytes()
    models0, census0 = host.models(), programs.buffer_census()["serve"]
    with pytest.raises(BudgetExceeded, match="MX_SERVE_HBM_BUDGET"):
        state.add_model(Servable(demo_block("cpu"), name="pk-b",
                                 buckets=BucketTable((1,)), device="cpu"),
                        example=demo_example())
    import gc
    gc.collect()
    assert host.models() == models0 and "pk-b" not in host.engines
    assert programs.buffer_census()["serve"]["bytes"] <= census0["bytes"]
    state.close()


def _swap_state(budget=None):
    host = _host("sw", budget=budget, buckets=(1,))
    return ServeServer(host, max_delay_us=0), host


def test_swap_over_the_wire_flips_refuses_and_says_what_it_waits_for(
        monkeypatch):
    state, host = _swap_state()
    port = _free_port()
    stop, t = _serve(state, port)
    x = demo_requests(1, rows=1, seed=4)[0][0]
    doubled = demo_block("cpu")
    with torch.no_grad():
        for p in doubled.parameters():
            p.mul_(3.0)
    try:
        with ServeClient(["127.0.0.1:%d" % port], timeout=30) as cli:
            # unpatched: the loader needs gluon.SymbolBlock (item 8)
            ok, msg = cli._rpc("SWAP", "/nonexistent/model", 0, ("data",))
            assert not ok and msg.startswith("swap failed")
            assert "SymbolBlock" in msg and "item 8" in msg
            assert host.version == 1

            def fake(prefix, epoch=0, input_names=("data",), **kw):
                kw.pop("name", None)
                return Servable.from_block(doubled, name="sw", device="cpu",
                                           buckets=BucketTable((1,)), **kw)
            monkeypatch.setattr(servable_mod.Servable, "from_checkpoint",
                                staticmethod(fake))
            assert cli.swap("/any/prefix", 0) == [2]
            v, out = cli.predict([x])
            assert v == 2 and host.version == 2
            np.testing.assert_allclose(
                out[0], demo_expected(x, net=doubled), rtol=1e-5, atol=1e-6)
            host.hbm_budget = 1
            ok, msg = cli._rpc("SWAP", "/any/prefix", 0, ("data",))
            assert not ok and msg.startswith("budget:")
            assert host.version == 2 and host.models() == ["sw"]
    finally:
        stop.set()
        t.join(10)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def _spawn(args, ready, env):
    return subprocess.Popen([sys.executable] + args + ["--ready-file", ready],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait_ready(path, proc, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path) and open(path).read().strip():
            return int(open(path).read())
        if proc.poll() is not None:
            raise AssertionError(proc.stdout.read())
        time.sleep(0.05)
    raise AssertionError("%s never became ready" % path)


def test_the_replica_and_router_command_lines(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", MX_KVSTORE_RETRY_DEADLINE="20")
    rep_ready, rt_ready = str(tmp_path / "rep"), str(tmp_path / "rt")
    rep = _spawn(["-m", "mxnet_tpu_torch.serve", "--demo", "--decode",
                  "--ctx", "cpu", "--port", "0", "--buckets", "1,2"],
                 rep_ready, env)
    rt = None
    try:
        rport = _wait_ready(rep_ready, rep)
        rt = _spawn(["-m", "mxnet_tpu_torch.serve.router", "--port", "0",
                     "--replicas", "127.0.0.1:%d" % rport], rt_ready, env)
        port = _wait_ready(rt_ready, rt)
        x = demo_requests(1, rows=2, seed=7)[0][0]
        cfg = DecodeConfig()
        oracle = jdec.reference_generate(
            [3, 1, 4], 6, params=jdec.DecodeServable(
                config=jdec.DecodeConfig()).params,
            config=jdec.DecodeConfig())
        with ServeClient(["127.0.0.1:%d" % port], timeout=60) as cli:
            v, out = cli.predict([x])
            _gv, toks = cli.generate([3, 1, 4], max_tokens=6)
            h = cli.health()
            cli.stop()
        assert v == 1 and h["role"] == "router"
        np.testing.assert_allclose(out[0], demo_expected(x, device="cpu"),
                                   rtol=1e-5, atol=1e-6)
        assert toks == oracle and cfg.max_tokens >= 6
        assert rt.wait(30) == 0
        assert rep.wait(30) == 0
        log = rep.stdout.read()
        assert "compile-cache off" in log and "serve: stopped" in log
    finally:
        for p in (rep, rt):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(10)


def test_a_checkpoint_replica_says_what_it_waits_for():
    from mxnet_tpu_torch.serve.__main__ import main
    with pytest.raises(MXNetError, match="SymbolBlock.*item 8"):
        main(["--model", "/nonexistent/m", "--ctx", "cpu", "--port", "0"])
