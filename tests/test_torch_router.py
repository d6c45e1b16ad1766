"""The port's session router (``mxnet_tpu_torch/serve/router.py``) against
the reference's (``mxnet_tpu/serve/router.py``), on the CPU.

The routing state machine runs one scripted sequence of events on both
packages' ``ServeRouter``s (least-loaded then pinned, the LRU cap,
membership reconcile, ``mark_dead``, a drain admitting only pinned
sessions, the first deadline winning): the picks, pins, evictions and
states must be equal.  Over real sockets, on in-process port replicas
behind a port router: routed PREDICT of a small BERT (2 layers, width 64,
the reference's parameters copied in) matches the reference replica's
answers at 1e-4 (the attention
path included), a lost reply replays exactly once through the router, a
killed replica's pinned sessions fail over, a draining refusal spills and
re-pins, a DRAIN finishes in-flight GENERATEs with the JAX engine's
tokens, and one past its deadline severs its straggler, which the router
replays on the survivor.  The router's env knobs are catalogued.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fault as jfault
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.serve import (Batcher as JBatcher, BucketTable as JBuckets,
                             ModelHost as JHost, Servable as JServable)
from mxnet_tpu.serve import decode as jdec
from mxnet_tpu.serve.router import ServeRouter as JRouter
from mxnet_tpu.telemetry import registry as jreg

from mxnet_tpu_torch import fault
from mxnet_tpu_torch.base import ENV_CATALOG, MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.serve import (BucketTable, ModelHost, Servable,
                                   ServeClient, ServeServer, serve_forever)
from mxnet_tpu_torch.serve.decode import (DecodeBatcher, DecodeConfig,
                                          DecodeServable)
from mxnet_tpu_torch.serve.demo import DEMO_IN, demo_block, demo_expected
from mxnet_tpu_torch.serve.router import ServeRouter, serve_router_forever
from mxnet_tpu_torch.telemetry import registry

# six xdist workers share the host's cores: cap torch's intra-op threads
torch.set_num_threads(1)

TOL = 1e-4
BERT_CFG = dict(vocab_size=100, max_length=32, dropout=0.0,
                use_decoder=False)
T = 32
DCFG = dict(dim=16, heads=2, layers=2, slots=4, max_tokens=12,
            prompt_buckets=(4, 8))


@pytest.fixture(autouse=True)
def _clean_faults():
    fault.clear()
    yield
    fault.clear()


@pytest.fixture
def fast_retry(monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_RETRY_DEADLINE", "20")
    monkeypatch.setenv("MX_KVSTORE_RETRY_BASE", "0.05")
    monkeypatch.setenv("MX_KVSTORE_RETRY_MAX", "0.25")
    yield


# ---------------------------------------------------------------------------
# the routing state machine, on both packages
# ---------------------------------------------------------------------------

def _script(router_cls, reg, fl):
    """One scripted sequence of routing events; returns everything the
    router decided."""
    out = []
    rt = router_cls(replicas=["a:1", "b:2", "c:3"])
    rt._signals = {"a:1": {"queue_rows": 9.0},
                   "b:2": {"queue_rows": 1.0, "active_slots": 1.0},
                   "c:3": {"decode_queue": 3.0}}
    out.append([rt.route("s%d" % i) for i in range(4)])
    rt._signals = {"a:1": {"queue_rows": 0.0}, "b:2": {"queue_rows": 99.0}}
    out.append([rt.route("s%d" % i) for i in range(6)])   # pins stick
    out.append(rt.route(None))                            # unpinned pick
    out.append(rt.route("s0", avoid={rt._pins["s0"]}))
    u0 = reg.value("router.sessions_unpinned")
    rt.mark_dead("a:1")
    out.append((dict(rt._replicas), dict(rt._pins),
                reg.value("router.sessions_unpinned") - u0))
    rt.set_replicas(["b:2", "d:4"])       # c leaves (draining), a forgotten
    out.append((dict(rt._replicas), dict(rt._pins)))
    rt.mark_draining("b:2")
    out.append((dict(rt._replicas), [rt.route("s%d" % i) for i in range(3)]))
    rt.set_replicas(["b:2", "d:4", "a:1"])
    out.append((dict(rt._replicas), rt.live_replicas(),
                rt.live_replicas(include_draining=True)))
    rt.unpin("s1")
    out.append(sorted(rt._pins))
    with fl.use_virtual_time() as clk:
        rt2 = router_cls(replicas=["a:1"])
        rt2.route("old")
        out.append((rt2.admits("old"), rt2.admits("new"), rt2.admits(None)))
        st = rt2.drain(5.0)
        out.append((st["status"], st["sessions"], rt2.draining,
                    rt2.admits("old"), rt2.admits("new"),
                    rt2.admits(None)))
        clk.advance(4.0)
        out.append(rt2.drain_expired())
        rt2.drain(100.0)                  # a retried DRAIN keeps the first
        clk.advance(2.0)
        out.append(rt2.drain_expired())
        h = rt2.health()
        out.append((h["status"], h["role"], h["replicas"], h["up"],
                    h["sessions"]))
    return out


def _lru_script(router_cls, monkeypatch):
    monkeypatch.setenv("MX_ROUTER_PIN_CAP", "2")
    rt = router_cls(replicas=["a:1"])
    for s in ("s1", "s2", "s1", "s3", "s4", "s3"):
        rt.route(s)
    return list(rt._pins)


def test_the_routing_state_machine_equals_the_reference():
    j = _script(JRouter, jreg, jfault)
    t = _script(ServeRouter, registry, fault)
    assert t == j
    assert t[0][0] == "b:2" and t[1][:4] == t[0]


def test_the_pin_cap_evicts_as_the_reference_does(monkeypatch):
    j = _lru_script(JRouter, monkeypatch)
    t = _lru_script(ServeRouter, monkeypatch)
    assert t == j == ["s4", "s3"]


def test_the_router_env_knobs_are_catalogued():
    from mxnet_tpu.base import ENV_CATALOG as JCAT
    from mxnet_tpu.serve import router as jrouter
    from mxnet_tpu_torch.serve import router as trouter
    for name in ("MX_ROUTER_PORT", "MX_ROUTER_REPLICAS",
                 "MX_ROUTER_REPLICAS_FILE", "MX_ROUTER_REFRESH",
                 "MX_ROUTER_FLEET", "MX_ROUTER_PIN_CAP",
                 "MX_ROUTER_DRAIN_TIMEOUT", "MX_SERVE_ROOTS",
                 "MX_SERVE_DRAIN_TIMEOUT", "MX_SERVE_HBM_BUDGET"):
        default, doc = ENV_CATALOG[name]
        assert doc and default == JCAT[name][0], name
    assert dict(trouter.WIRE_VERBS) == dict(jrouter.WIRE_VERBS)
    assert sorted(trouter.__all__) == sorted(jrouter.__all__)


# ---------------------------------------------------------------------------
# the routed wire path
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_port(port, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            return
        except OSError:
            time.sleep(0.02)
    raise AssertionError("port %d never accepted" % port)


def _start(state, port, abort_event=None):
    stop_ev, ready = threading.Event(), threading.Event()
    t = threading.Thread(target=serve_forever, daemon=True,
                         kwargs=dict(port=port, state=state,
                                     stop_event=stop_ev, bind="127.0.0.1",
                                     ready_event=ready,
                                     abort_event=abort_event))
    t.start()
    assert ready.wait(30)
    return stop_ev, t


def _demo_replica(port, abort_event=None, buckets=(1, 2)):
    host = ModelHost()
    host.deploy(Servable(demo_block("cpu"), name="demo-mlp",
                         buckets=BucketTable(buckets), device="cpu"),
                example=[np.zeros((1, DEMO_IN), np.float32)])
    state = ServeServer(host, max_delay_us=0)
    stop_ev, t = _start(state, port, abort_event)
    return state, stop_ev, t


def _start_router(port, replicas, **kw):
    rt = ServeRouter(replicas=replicas, refresh=0.1, **kw)
    stop_ev = threading.Event()
    t = threading.Thread(target=serve_router_forever, daemon=True,
                         kwargs=dict(port=port, router=rt,
                                     stop_event=stop_ev))
    t.start()
    _wait_port(port)
    return rt, stop_ev, t


def _requests(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for rows in (1, 2, 3, 1, 2):
        tok = rng.randint(0, BERT_CFG["vocab_size"], (rows, T)) \
            .astype(np.int32)
        typ = (np.arange(T)[None, :] >= rng.randint(1, T, (rows, 1))) \
            .astype(np.int32)
        out.append([tok, typ])
    return out


@pytest.fixture(scope="module")
def bert_pair():
    jnet = jbert.get_bert(2, 64, 1, **BERT_CFG)
    jnet.initialize(jmx.init.Normal(0.02))
    tok, typ = _requests()[0]
    jnet(jnd.array(tok, dtype="int32"), jnd.array(typ, dtype="int32"))
    rng = np.random.RandomState(2)
    for name, p in jnet.collect_params().items():
        shape = p.data().shape
        val = (1.0 + 0.1 * rng.randn(*shape)) if name.endswith("gamma") \
            else 0.05 * rng.randn(*shape)
        p.set_data(jnd.array(val.astype(np.float32)))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    host = JHost()
    host.deploy(JServable(jnet, name="bert", buckets=JBuckets((1, 2, 4))),
                example=_requests()[0])
    b = JBatcher(host, max_batch=4, max_delay_us=0, queue_cap=64)
    try:
        answers = [b.submit(r).result(timeout=120) for r in _requests()]
    finally:
        b.close()
    return named, answers


def test_routed_predict_matches_the_reference_replica(bert_pair, fast_retry):
    named, answers = bert_pair
    ports = [_free_port(), _free_port()]
    reps = []
    for p in ports:
        tnet = tbert.get_bert(2, 64, 1, **BERT_CFG)
        params_from_mxnet_tpu(named, net=tnet, device="cpu")
        host = ModelHost()
        host.deploy(Servable(tnet, name="bert", buckets=BucketTable((1, 2, 4)),
                             device="cpu"), example=_requests()[0])
        reps.append(_start(ServeServer(host, max_batch=4, max_delay_us=0),
                           p))
    rp = _free_port()
    addrs = ["127.0.0.1:%d" % p for p in ports]
    rt, rev, trt = _start_router(rp, addrs)
    try:
        clients = [ServeClient(["127.0.0.1:%d" % rp], timeout=30)
                   for _ in range(2)]
        for i, (req, (jver, jouts)) in enumerate(zip(_requests(), answers)):
            version, outs = clients[i % 2].predict(req)
            assert version == jver == 1
            for o, j in zip(outs, jouts):
                np.testing.assert_allclose(o, np.asarray(j), rtol=TOL,
                                           atol=TOL)
        h = clients[0].health()
        assert h["role"] == "router" and h["status"] == "routing"
        assert h["replicas"] == {a: "up" for a in addrs}
        # each client's session pinned to one replica
        assert sorted(rt._pins) == sorted(c._client_id for c in clients)
        m = clients[0].metrics()
        assert "mx_router_requests" in m
        for c in clients:
            c.close()
    finally:
        rev.set()
        trt.join(10)
        for ev, t in reps:
            ev.set()
            t.join(10)


def test_a_replay_through_the_router_is_exactly_once(fast_retry):
    p1, rp = _free_port(), _free_port()
    _state, ev1, t1 = _demo_replica(p1)
    _rt, rev, trt = _start_router(rp, ["127.0.0.1:%d" % p1])
    try:
        cli = ServeClient(["127.0.0.1:%d" % rp], timeout=15)
        x = np.ones((1, DEMO_IN), np.float32)
        cli.predict([x])
        b0 = registry.value("serve.batches")
        r0 = registry.value("serve.server_replays")
        fault.inject("serve.client.recv", action="close", after=0, count=1)
        version, outs = cli.predict([x])
        assert version == 1
        np.testing.assert_allclose(outs[0], demo_expected(x, device="cpu"),
                                   rtol=1e-5, atol=1e-6)
        assert registry.value("serve.server_replays") == r0 + 1
        assert registry.value("serve.batches") == b0 + 1, \
            "the replay through the router dispatched again"
        cli.close()
    finally:
        rev.set()
        ev1.set()
        trt.join(10)
        t1.join(10)


def test_a_killed_replica_s_pinned_sessions_fail_over(fast_retry):
    p1, p2, rp = _free_port(), _free_port(), _free_port()
    ab1 = threading.Event()
    _s1, _ev1, t1 = _demo_replica(p1, abort_event=ab1)
    _s2, ev2, t2 = _demo_replica(p2)
    a1, a2 = "127.0.0.1:%d" % p1, "127.0.0.1:%d" % p2
    rt, rev, trt = _start_router(rp, [a1])
    try:
        cli = ServeClient(["127.0.0.1:%d" % rp], timeout=15)
        net = demo_block("cpu")
        rng = np.random.RandomState(4)
        cli.predict([rng.randn(2, DEMO_IN).astype(np.float32)])
        assert list(rt._pins.values()) == [a1]
        rt.set_replicas([a1, a2])
        f0 = registry.value("router.failovers")
        u0 = registry.value("router.sessions_unpinned")
        cf0 = registry.value("serve.client_failovers")
        ab1.set()
        for _ in range(3):
            x = rng.randn(2, DEMO_IN).astype(np.float32)
            _v, outs = cli.predict([x])
            np.testing.assert_allclose(outs[0], demo_expected(x, net=net),
                                       rtol=1e-5, atol=1e-6)
        assert registry.value("router.failovers") > f0
        assert registry.value("router.sessions_unpinned") > u0
        assert rt._replicas[a1] == "dead"
        assert list(rt._pins.values()) == [a2]
        assert registry.value("serve.client_failovers") == cf0
        cli.close()
    finally:
        ev2.set()
        rev.set()
        trt.join(10)
        t1.join(10)
        t2.join(10)


def test_a_draining_refusal_spills_and_repins(fast_retry):
    p1, p2, rp = _free_port(), _free_port(), _free_port()
    s1, ev1, t1 = _demo_replica(p1)
    _s2, ev2, t2 = _demo_replica(p2)
    a1, a2 = "127.0.0.1:%d" % p1, "127.0.0.1:%d" % p2
    rt, rev, trt = _start_router(rp, [a1])
    try:
        cli = ServeClient(["127.0.0.1:%d" % rp], timeout=15)
        x = np.random.RandomState(5).randn(2, DEMO_IN).astype(np.float32)
        cli.predict([x])
        rt.set_replicas([a1, a2])
        sp0 = registry.value("router.spills")
        # a long deadline, but an idle replica leaves at once: the refusal
        # must come from the draining flag before its loop retires
        s1._draining.set()
        _v, outs = cli.predict([x])
        np.testing.assert_allclose(outs[0], demo_expected(x, device="cpu"),
                                   rtol=1e-5, atol=1e-6)
        assert registry.value("router.spills") == sp0 + 1
        assert rt._replicas[a1] == "draining"
        assert list(rt._pins.values()) == [a2]
        cli.close()
    finally:
        rev.set()
        ev1.set()
        ev2.set()
        trt.join(10)
        t1.join(10)
        t2.join(10)


@pytest.fixture(scope="module")
def jax_oracle():
    jcfg = jdec.DecodeConfig(**DCFG)
    jsv = jdec.DecodeServable(config=jcfg)
    eng = jdec.DecodeBatcher(jsv, autostart=False)
    gens = {tuple(p): eng.submit(p, max_new=12)
            for p in ([6, 2, 8], [3, 1, 4], [5, 5])}
    eng.drain_sync()
    return {k: g.tokens_so_far() for k, g in gens.items()}


def test_a_drain_finishes_inflight_generations_with_the_jax_tokens(
        fast_retry, jax_oracle):
    """A DRAIN mid-generation through the router: the in-flight sequences
    finish with the JAX engine's tokens, new sessions go to the other
    replica, and the drained replica's serve loop leaves by itself."""
    p1, p2, rp = _free_port(), _free_port(), _free_port()
    states = []
    for p, tick in ((p1, lambda: time.sleep(0.02)), (p2, None)):
        sv = DecodeServable(config=DecodeConfig(**DCFG), device="cpu")
        st = ServeServer(decode=DecodeBatcher(sv, on_tick=tick))
        states.append((st,) + _start(st, p))
    a1, a2 = "127.0.0.1:%d" % p1, "127.0.0.1:%d" % p2
    rt, rev, trt = _start_router(rp, [a1])
    result = {}

    def call(prompt):
        with ServeClient(["127.0.0.1:%d" % rp], timeout=30) as cli:
            result[tuple(prompt)] = cli.generate(prompt, max_tokens=12)[1]

    gens = [threading.Thread(target=call, args=(p,), daemon=True)
            for p in ([6, 2, 8], [3, 1, 4])]
    try:
        for g in gens:
            g.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                states[0][0].decode.active_count() < 2:
            time.sleep(0.001)
        assert states[0][0].decode.active_count() > 0
        rt.set_replicas([a1, a2])
        with ServeClient([a1], timeout=15) as dc:
            st = dc.drain(timeout=30.0)
            assert st["status"] == "draining"
            with pytest.raises(MXNetError, match="draining"):
                dc.generate([1, 2], max_tokens=2)
        pinned_before = set(rt._pins)
        call([5, 5])                     # a new session lands on B
        (new_cid,) = set(rt._pins) - pinned_before
        assert rt._pins[new_cid] == a2
        for g in gens:
            g.join(60)
        for k, toks in result.items():
            assert toks == jax_oracle[k], k
        states[0][2].join(30)
        assert not states[0][2].is_alive(), "drained replica kept serving"
    finally:
        rev.set()
        states[1][1].set()
        trt.join(10)
        states[1][2].join(10)
        for st, _ev, _t in states:
            st.close()


def test_a_drain_past_its_deadline_fails_its_stragglers_over(
        fast_retry, jax_oracle):
    """A DRAIN deadline far shorter than the in-flight generation: the
    straggler's connection is severed with no reply, the router marks the
    replica dead and replays the envelope on the survivor, and the caller
    gets the JAX engine's tokens without seeing the failover."""
    p1, p2, rp = _free_port(), _free_port(), _free_port()
    states = []
    for p, tick in ((p1, lambda: time.sleep(0.05)), (p2, None)):
        sv = DecodeServable(config=DecodeConfig(**DCFG), device="cpu")
        st = ServeServer(decode=DecodeBatcher(sv, on_tick=tick))
        states.append((st,) + _start(st, p))
    a1, a2 = "127.0.0.1:%d" % p1, "127.0.0.1:%d" % p2
    rt, rev, trt = _start_router(rp, [a1])
    f0 = registry.value("router.failovers")
    cf0 = registry.value("serve.client_failovers")
    result = {}

    def call():
        with ServeClient(["127.0.0.1:%d" % rp], timeout=60) as cli:
            result["out"] = cli.generate([6, 2, 8], max_tokens=12)[1]

    gen = threading.Thread(target=call, daemon=True)
    gen.start()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                states[0][0].decode.active_count() == 0:
            time.sleep(0.001)
        assert states[0][0].decode.active_count() > 0
        rt.set_replicas([a1, a2])
        with ServeClient([a1], timeout=15) as dc:
            dc.drain(timeout=0.05)
        gen.join(60)
        assert result.get("out") == jax_oracle[(6, 2, 8)]
        assert registry.value("router.failovers") > f0
        assert registry.value("serve.client_failovers") == cf0
        states[0][2].join(15)
        assert not states[0][2].is_alive()
    finally:
        rev.set()
        states[1][1].set()
        trt.join(10)
        states[1][2].join(10)
        for st, _ev, _t in states:
            st.close()
