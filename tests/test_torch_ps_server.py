"""The port's parameter server and its client against the JAX package's,
on the CPU.

* The wire: ``WIRE_VERBS`` equals the reference's manifest,
  ``declare_verbs`` refuses what the reference refuses with the same text,
  and ``send_msg`` writes the same bytes.
* The server without sockets: one scripted ``handle_request`` sequence
  (INIT, accumulating PUSH, PULL, PULLQ, a replayed and a stale SEQ,
  JOIN/LEAVE/MEMBERS with their epochs, a one-worker BARRIER, PUSH under
  SGD with momentum, METRICS and a snapshot restart) goes through both
  ``KVStoreServer``s: the same replies, and stores bitwise equal while
  accumulating and within 1e-6 + 1e-5 |ref| under the optimizer.
* Cross-talk: the port's client against the reference's
  ``serve_forever`` in a thread, and the reference's client against the
  port's; INIT, PUSH (full width, 2-bit, int8), PULL, PULLQ and BARRIER
  give the values the same package gives on both ends.
* The store over sockets: two servers sharding keys and splitting a big
  array, the elastic salt, the hierarchical exchange's int8 bucket pulls
  on the pool's own connections, and the store's surface (JOIN, LEAVE,
  MEMBERS, METRICS, no overlap session, no traceable body).
* Virtual-time chaos, the counterparts of ``tests/test_fault.py``'s
  server and client cases: the replay cache applies a push once (across a
  snapshot restart too), a worker rides through a server restart and
  through injected connection drops, and the terminal error comes after
  the retry deadline.
"""
import pickle
import socket
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import fault as jfault
from mxnet_tpu.kvstore import server as jserver, wire_verbs as jverbs
from mxnet_tpu.kvstore import kvstore as jkvstore

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore import server as tserver, wire_verbs as tverbs
from mxnet_tpu_torch.kvstore import kvstore as tkvstore
from mxnet_tpu_torch.kvstore.wire_codec import encode_wire, pack_2bit

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

SERVERS = {"jax": jserver, "port": tserver}
CLIENTS = {"jax": (jmx, jkvstore), "port": (tmx, tkvstore)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for f in (jfault, tfault):
        f.clear()
    monkeypatch.setenv("MX_KVSTORE_HEARTBEAT", "0")
    for var in ("MX_PS_ROOTS", "MX_PS_SNAPSHOT", "MX_ELASTIC",
                "MX_ELASTIC_EPOCH", "MX_EXCHANGE_HIERARCHICAL"):
        monkeypatch.delenv(var, raising=False)
    with tmx.cpu():
        yield
    for f in (jfault, tfault):
        f.clear()


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def test_the_manifest_is_the_reference_s():
    assert tserver.WIRE_VERBS == jserver.WIRE_VERBS
    assert tverbs.STATE_CATEGORIES == jverbs.STATE_CATEGORIES
    assert tverbs.REPLAY_CLASSES == jverbs.REPLAY_CLASSES
    assert tverbs.SEMANTICS == jverbs.SEMANTICS
    assert tverbs.ROLES == jverbs.ROLES
    assert tserver.KVStoreServer._MUTATING == jserver.KVStoreServer._MUTATING


_ROW = {"semantics": "idempotent", "replay": "bypass", "codec": None}
BAD_MANIFESTS = [
    ("", {"A": _ROW}, {}),
    ("p", {"A": _ROW}, {"role": "client"}),
    ("p", {"A": _ROW}, {"durable": 1}),
    ("p", {"A": _ROW}, {"handler": 3}),
    ("p", {}, {}),
    ("p", {"lower": _ROW}, {}),
    ("p", {"A": [1]}, {}),
    ("p", {"A": dict(_ROW, bogus=1)}, {}),
    ("p", {"A": {"semantics": "idempotent", "codec": None}}, {}),
    ("p", {"A": {"semantics": "idempotent", "replay": "bypass"}}, {}),
    ("p", {"A": dict(_ROW, semantics="maybe")}, {}),
    ("p", {"A": dict(_ROW, replay="later")}, {}),
    ("p", {"A": dict(_ROW, replay="forward")}, {}),
    ("p", {"A": dict(_ROW, semantics="replayable")}, {}),
    ("p", {"A": dict(_ROW, codec=3)}, {}),
    ("p", {"A": dict(_ROW, mutates="kv")}, {}),
    ("p", {"A": dict(_ROW, mutates=("kv", "disk"))}, {}),
    ("p", {"A": dict(_ROW, handler=1)}, {}),
    ("p", {"A": dict(_ROW, stream=2)}, {}),
    ("p", {"A": dict(_ROW, stream="B")}, {}),
    ("p", {"A": dict(_ROW, stream="B"),
           "B": dict(_ROW, semantics="replayable", replay="cached")}, {}),
]


@pytest.mark.parametrize("case", range(len(BAD_MANIFESTS)))
def test_declare_verbs_refuses_with_the_reference_s_text(case):
    protocol, verbs, kw = BAD_MANIFESTS[case]
    msgs = []
    for mod in (jverbs, tverbs):
        with pytest.raises(ValueError) as e:
            mod.declare_verbs(protocol, verbs, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_declare_verbs_returns_the_reference_s_dict():
    verbs = {"A": dict(_ROW, mutates=["kv"], stream="B"), "B": dict(_ROW)}
    assert tverbs.declare_verbs("p", verbs, handler="h.x") == \
        jverbs.declare_verbs("p", verbs, handler="h.x")


MESSAGES = [("STOP", None), ("PUSH", "w", np.arange(5, dtype=np.float32)),
            ("SEQ", "r0:ab", 7, ("PULL", 3), ("t", "s")),
            (True, ("QGRAD", "int8", (2,), "float32", 2, b"\x01\x02",
                    np.ones(1, np.float32))), (False, "error text")]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_send_msg_writes_the_reference_s_bytes(i):
    frames = []
    for mod in (jserver, tserver):
        a, b = socket.socketpair()
        with a, b:
            mod.send_msg(a, MESSAGES[i])
            a.shutdown(socket.SHUT_WR)
            raw = b""
            while True:
                chunk = b.recv(1 << 16)
                if not chunk:
                    break
                raw += chunk
        frames.append(raw)
    assert frames[0] == frames[1]
    a, b = socket.socketpair()
    with a, b:
        tserver.send_msg(a, MESSAGES[i])
        got = jserver.recv_msg(b, timeout=5)
        jserver.send_msg(a, MESSAGES[i])
        got2 = tserver.recv_msg(b, timeout=5)
    assert pickle.dumps(got, protocol=4) == pickle.dumps(got2, protocol=4)


def test_recv_msg_times_out_on_a_stalled_peer(monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_RECV_TIMEOUT", "0.2")
    a, b = socket.socketpair()
    with a, b:
        a.sendall(b"\x05\x00")              # a header cut short
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="full header"):
            tserver.recv_msg(b)
        assert time.monotonic() - t0 < 3.0
    a, b = socket.socketpair()
    with a, b:
        with pytest.raises(TimeoutError, match="no data"):
            tserver.recv_msg(b, timeout=0.1)
        a.close()
        with pytest.raises(ConnectionError):
            tserver.recv_msg(b, timeout=0.1)


# ---------------------------------------------------------------------------
# the server without sockets
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(0)
W0 = RNG.randn(6, 4).astype(np.float32)
G1 = RNG.randn(6, 4).astype(np.float32)
G2 = RNG.randn(6, 4).astype(np.float32)
BIG = RNG.randn(600).astype(np.float32)
QG = RNG.randn(600).astype(np.float32)


def _norm(obj):
    """A reply as comparable plain data (arrays by dtype, shape, bytes)."""
    if isinstance(obj, np.ndarray):
        return ("nd", str(obj.dtype), obj.shape, obj.tobytes())
    if isinstance(obj, (tuple, list)):
        return tuple(_norm(x) for x in obj)
    return obj


def _int8_payload(x, block=64):
    """A compressed PUSH built from the reference's block rule."""
    from mxnet_tpu_torch.kvstore.wire_codec import quantize_int8_np
    q, scales = quantize_int8_np(x, block)
    return encode_wire("int8", x.shape, "float32", (q, scales))


ACCUMULATE = [
    ("SEQ", "r0:a", 1, ("INIT", "w", W0)),
    ("SEQ", "r0:a", 2, ("INIT", "w", W0 * 0)),          # INIT if absent
    ("SEQ", "r0:a", 3, ("PUSH", "w", G1)),
    ("SEQ", "r0:a", 3, ("PUSH", "w", G1)),              # replayed: once
    ("SEQ", "r0:a", 2, ("PUSH", "w", G1)),              # stale: refused
    ("SEQ", "r0:a", 4, ("PULL", "w")),
    ("SEQ", "r0:a", 5, ("PUSH", "w", G2.reshape(-1))),  # reshaped
    ("SEQ", "r0:a", 6, ("INIT", "q", BIG)),
    ("SEQ", "r0:a", 7, ("PUSH", "q", _int8_payload(QG))),
    ("SEQ", "r0:a", 8, ("PUSH", "q", encode_wire(
        "2bit", (600,), "float32", (pack_2bit(
            np.where(QG > 0.5, 0.5, np.where(QG < -0.5, -0.5, 0.0)), 0.5),
            0.5)))),
    ("SEQ", "r0:a", 9, ("PULLQ", "q", 64)),
    ("SEQ", "r0:a", 10, ("PULLQ", "q")),
    ("SEQ", "r0:a", 11, ("INIT", "i", np.arange(4, dtype=np.int32))),
    ("SEQ", "r0:a", 12, ("PULLQ", "i")),
    ("SEQ", "r0:a", 13, ("PUSH", "missing", G1)),
    ("SEQ", "r0:a", 14, ("PULL", "missing")),
    ("PING", "r0:a"),
    ("SEQ", "r0:a", 15, ("JOIN", "r0:a")),              # a member: no bump
    ("SEQ", "r2:b", 1, ("JOIN", "r2:b")),               # epoch 1
    ("SEQ", "r2:b", 2, ("JOIN", None)),                 # the sender again
    ("SEQ", "r0:a", 16, ("MEMBERS",)),
    ("SEQ", "r2:b", 3, ("LEAVE", "r2:b")),              # epoch 2
    ("SEQ", "r2:b", 4, ("LEAVE", "r2:b")),              # absent: no bump
    ("MEMBERS",),
    ("SEQ", "r0:a", 17, ("BARRIER", None)),             # one worker
    ("SEQ", "r0:a", 18, ("BOGUS",)),
    ("SEQ", "r0:a", 19, ("PULL", "w")),
]


def _run_script(mod, script, snapshot=None):
    srv = mod.KVStoreServer(num_workers=1, snapshot_path=snapshot)
    return srv, [_norm(srv.handle_request(msg)) for msg in script]


def test_a_scripted_sequence_gives_the_reference_s_replies_and_store():
    stores, replies = {}, {}
    for name, mod in SERVERS.items():
        srv, replies[name] = _run_script(mod, ACCUMULATE)
        stores[name] = srv._store
        assert srv._membership_epoch == 2
    assert replies["port"] == replies["jax"]
    assert sorted(stores["port"]) == sorted(stores["jax"])
    for k in stores["jax"]:
        a, b = stores["jax"][k], stores["port"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    np.testing.assert_array_equal(stores["port"]["w"], W0 + G1 + G2)


def _sgd_blob(name, momentum):
    opt = (jmx if name == "jax" else tmx).optimizer.SGD(
        learning_rate=0.1, momentum=momentum, wd=0.01)
    return pickle.dumps(opt)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_pushes_under_the_server_s_optimizer_match_the_reference(momentum):
    stores = {}
    for name, mod in SERVERS.items():
        srv = mod.KVStoreServer(num_workers=1)
        srv.handle_request(("SEQ", "r0:a", 1, ("INIT", 0, W0)))
        srv.handle_request(("SEQ", "r0:a", 2, ("INIT", "b", BIG)))
        assert srv.handle_request(
            ("SEQ", "r0:a", 3, ("SET_OPT", _sgd_blob(name, momentum)))) == \
            (True, None)
        # a second installation keeps the first
        assert srv.handle_request(
            ("SEQ", "r1:b", 1, ("SET_OPT", _sgd_blob(name, 0.5)))) == \
            (True, "already installed")
        for seq, g in enumerate((G1, G2, G1 * 2), start=4):
            assert srv.handle_request(("SEQ", "r0:a", seq,
                                       ("PUSH", 0, g)))[0]
        assert srv.handle_request(("SEQ", "r0:a", 9,
                                   ("PUSH", "b", _int8_payload(QG))))[0]
        stores[name] = {k: srv.handle(("PULL", k))[1] for k in (0, "b")}
    for k, ref in stores["jax"].items():
        np.testing.assert_allclose(stores["port"][k], ref, rtol=1e-5,
                                   atol=1e-6)


def test_a_snapshot_restart_resumes_store_replay_cache_and_membership(
        tmp_path):
    out = {}
    for name, mod in SERVERS.items():
        snap = str(tmp_path / ("%s.pkl" % name))
        srv = mod.KVStoreServer(num_workers=1, snapshot_path=snap)
        srv.handle_request(("SEQ", "r0:a", 1, ("INIT", "w", W0)))
        srv.handle_request(("SEQ", "r0:a", 2, ("SET_OPT",
                                               _sgd_blob(name, 0.9))))
        srv.handle_request(("SEQ", "r0:a", 3, ("PUSH", "w", G1)))
        srv.handle_request(("SEQ", "r3:c", 1, ("JOIN", "r3:c")))
        # crash after the snapshot, before the reply reached the worker
        srv2 = mod.KVStoreServer(num_workers=1, snapshot_path=snap)
        replay = srv2.handle_request(("SEQ", "r0:a", 3, ("PUSH", "w", G1)))
        after = srv2.handle_request(("SEQ", "r0:a", 4, ("PUSH", "w", G2)))
        out[name] = (replay, after, srv2.handle(("MEMBERS",)),
                     srv2.handle(("PULL", "w"))[1])
    (jr, ja, jm, jw), (tr, ta, tm, tw) = out["jax"], out["port"]
    assert (tr, ta, tm) == (jr, ja, jm) == ((True, None), (True, None),
                                            (True, (1, ["r0", "r3"])))
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)


def test_metrics_answers_the_port_s_registry_as_text():
    from mxnet_tpu_torch.kvstore.wire_codec import decode_text
    srv = tserver.KVStoreServer(num_workers=1)
    srv.handle_request(("SEQ", "r0:a", 1, ("INIT", "w", W0)))
    srv.handle_request(("SEQ", "r0:a", 1, ("INIT", "w", W0)))   # replay
    ok, payload = srv.handle_request(("SEQ", "r0:a", 2, ("METRICS",)))
    assert ok and "mx_kvstore_server_replays" in decode_text(payload)
    ok, payload = srv.handle(("METRICS", "json"))
    import json
    assert "kvstore.server_replays" in json.loads(decode_text(payload))


def test_the_server_updater_runs_on_the_host_only(monkeypatch):
    """The server's role is the host: its updater's NDArrays are on an
    explicit mx.cpu(), whatever the current context says."""
    seen = []
    srv = tserver.KVStoreServer(num_workers=1)
    srv.handle_request(("SEQ", "r0:a", 1, ("INIT", "w", W0)))
    srv.handle_request(("SEQ", "r0:a", 2, ("SET_OPT", _sgd_blob("port",
                                                                0.9))))
    inner = srv._updater.inner

    def spy(key, g, w):
        seen.append((g.data.device.type, w.data.device.type))
        return inner(key, g, w)
    monkeypatch.setattr(srv._updater, "inner", spy)
    with tmx.gpu(0):                 # the current context is the card
        assert srv.handle_request(("SEQ", "r0:a", 3, ("PUSH", "w", G1)))[0]
    assert seen == [("cpu", "cpu")]


# ---------------------------------------------------------------------------
# sockets: both packages' servers in threads
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_server(mod, port, snapshot=None, num_workers=1):
    t = threading.Thread(target=mod.serve_forever,
                         kwargs=dict(port=port, num_workers=num_workers,
                                     snapshot_path=snapshot), daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return t
        except OSError:
            time.sleep(0.05)
    raise RuntimeError("server did not come up on %d" % port)


def _stop_server(port, thread):
    raw = socket.create_connection(("127.0.0.1", port), timeout=5)
    tserver.send_msg(raw, ("STOP", None))
    assert tserver.recv_msg(raw, timeout=5)[0]
    raw.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture
def _fast_retries(monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_RETRY_DEADLINE", "20")
    monkeypatch.setenv("MX_KVSTORE_RETRY_BASE", "0.05")
    monkeypatch.setenv("MX_KVSTORE_RETRY_MAX", "0.25")


def _client(name, monkeypatch, port, n_servers=1, ports=None):
    mx, kvmod = CLIENTS[name]
    addrs = ["127.0.0.1:%d" % p for p in (ports or [port])]
    monkeypatch.setenv("MX_PS_ROOT", addrs[0])
    if len(addrs) > 1:
        monkeypatch.setenv("MX_PS_ROOTS", ",".join(addrs))
    return kvmod.KVStoreDistAsync()


def _crosstalk_sequence(client_name, kv):
    """INIT, PUSH (full width, then 2-bit, then int8 on fresh keys),
    PULL, PULLQ and BARRIER; returns every pulled value."""
    mx, _ = CLIENTS[client_name]
    nd = mx.nd
    ctx = mx.cpu()
    out = {}
    kv.init("w", nd.array(W0, ctx=ctx))
    kv.init(["a", "b"], [nd.array(BIG, ctx=ctx), nd.array(BIG * 2, ctx=ctx)])
    kv.push("w", nd.array(G1, ctx=ctx))
    kv.push(["a", "b"], [nd.array(QG, ctx=ctx), nd.array(QG, ctx=ctx)])
    o = nd.zeros(W0.shape, ctx=ctx)
    kv.pull("w", out=o)
    out["full"] = o.asnumpy()
    ab = [nd.zeros(BIG.shape, ctx=ctx) for _ in range(2)]
    kv.pull(["a", "b"], out=ab)
    out["bucket"] = [x.asnumpy() for x in ab]
    for mode in ("2bit", "int8"):
        kv.set_gradient_compression({"type": mode, "threshold": 0.5})
        key = "c_" + mode
        kv.init(key, nd.array(W0, ctx=ctx))
        for g in (G1, G2):
            kv.push(key, nd.array(g, ctx=ctx))
        kv.pull(key, out=o)
        out[mode] = o.asnumpy()
    kv._barrier()
    out["pullq"] = np.asarray(kv._pull_hier("a"))
    return out


def _crosstalk(client_name, server_name, monkeypatch):
    port = _free_port()
    t = _start_server(SERVERS[server_name], port)
    kv = _client(client_name, monkeypatch, port)
    try:
        return _crosstalk_sequence(client_name, kv)
    finally:
        kv.close()
        _stop_server(port, t)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_a_client_of_one_package_talks_to_the_other_s_server(
        client, monkeypatch, _fast_retries):
    other = "jax" if client == "port" else "port"
    same = _crosstalk(client, client, monkeypatch)
    cross = _crosstalk(client, other, monkeypatch)
    assert sorted(same) == sorted(cross)
    for k in same:
        np.testing.assert_array_equal(np.asarray(cross[k]),
                                      np.asarray(same[k]), err_msg=k)
    np.testing.assert_array_equal(same["full"], W0 + G1)


def test_both_packages_on_both_ends_give_the_same_values(monkeypatch,
                                                         _fast_retries):
    jj = _crosstalk("jax", "jax", monkeypatch)
    tt = _crosstalk("port", "port", monkeypatch)
    for k in jj:
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jj[k]),
                                      err_msg=k)


def test_two_servers_shard_keys_and_split_big_arrays(monkeypatch,
                                                     _fast_retries):
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "10")
    ports = [_free_port(), _free_port()]
    threads = [_start_server(tserver, p) for p in ports]
    kv = _client("port", monkeypatch, None, ports=ports)
    try:
        assert len(kv._socks) == 2 and kv._bigarray_bound == 10
        servers = {k: kv._server_of(k) for k in range(8)}
        assert set(servers.values()) == {0, 1}
        assert servers == {k: jkvstore.KVStoreDistAsync._server_of(kv, k)
                           for k in range(8)}
        kv.init("big", tmx.nd.array(np.arange(24, dtype=np.float32)
                                    .reshape(4, 6)))
        p0 = np.asarray(kv._rpc_on(0, "PULL", "big::part0")).ravel()
        p1 = np.asarray(kv._rpc_on(1, "PULL", "big::part1")).ravel()
        np.testing.assert_array_equal(p0, np.arange(12))
        np.testing.assert_array_equal(p1, np.arange(12, 24))
        kv.push("big", tmx.nd.ones((4, 6)))
        out = tmx.nd.zeros((4, 6))
        kv.pull("big", out=out)
        np.testing.assert_array_equal(out.asnumpy().ravel(),
                                      np.arange(24) + 1)
    finally:
        kv.stop_server()
        for p, t in zip(ports, threads):
            try:
                _stop_server(p, t)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# chaos under virtual time
# ---------------------------------------------------------------------------

def test_the_replay_cache_applies_a_push_exactly_once():
    srv = tserver.KVStoreServer(num_workers=1)
    srv.handle_request(("SEQ", "r0:x", 1, ("INIT", "w", np.ones(3))))
    assert srv.handle_request(("SEQ", "r0:x", 2,
                               ("PUSH", "w", np.ones(3))))[0]
    assert srv.handle_request(("SEQ", "r0:x", 2,
                               ("PUSH", "w", np.ones(3))))[0]
    np.testing.assert_allclose(srv.handle(("PULL", "w"))[1], 2.0)
    ok, msg = srv.handle_request(("SEQ", "r0:x", 1,
                                  ("PUSH", "w", np.ones(3))))
    assert not ok and "stale" in str(msg)


def test_the_replay_cache_resolves_when_the_handler_faults():
    srv = tserver.KVStoreServer(num_workers=1)
    with pytest.raises(Exception):
        srv.handle_request(("SEQ", "r0:x", 5, ("PUSH",)))
    t0 = time.monotonic()
    ok, payload = srv.handle_request(("SEQ", "r0:x", 5, ("PUSH",)))
    assert time.monotonic() - t0 < 1.0
    assert not ok and "server error" in str(payload)


def test_the_barrier_times_out_on_the_virtual_clock(monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_BARRIER_TIMEOUT", "30")
    monkeypatch.setenv("MX_KVSTORE_STALE_TIMEOUT", "300")
    srv = tserver.KVStoreServer(num_workers=2)
    with tfault.use_virtual_time() as clk:
        t0 = time.monotonic()
        ok, payload = srv.handle(("BARRIER", None))
        assert time.monotonic() - t0 < 10.0
    assert not ok and "timed out" in str(payload)
    assert clk.now() >= 30.0


def test_a_stale_worker_leaves_the_barrier_quorum(monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_STALE_TIMEOUT", "5")
    monkeypatch.setenv("MX_KVSTORE_BARRIER_TIMEOUT", "60")
    srv = tserver.KVStoreServer(num_workers=2)
    with tfault.use_virtual_time() as clk:
        srv.touch("r1:wedged")
        clk.advance(10.0)
        ok, _ = srv.handle_request(("SEQ", "r0:live", 1, ("BARRIER", None)))
    assert ok


def test_a_worker_rides_through_a_server_restart(_fast_retries, monkeypatch,
                                                 tmp_path):
    port = _free_port()
    snap = str(tmp_path / "ps.pkl")
    t = _start_server(tserver, port, snapshot=snap)
    kv = _client("port", monkeypatch, port)
    try:
        kv.init("w", tmx.nd.ones((4,)))
        kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5))
        kv.push("w", tmx.nd.ones((4,)))
        out = tmx.nd.zeros((4,))
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), 0.5)
        _stop_server(port, t)

        def restart():
            time.sleep(0.4)
            _start_server(tserver, port, snapshot=snap)
        restarter = threading.Thread(target=restart, daemon=True)
        restarter.start()
        out2 = tmx.nd.zeros((4,))
        t0 = time.monotonic()
        kv.pull("w", out=out2)
        assert time.monotonic() - t0 < 20
        np.testing.assert_allclose(out2.asnumpy(), 0.5)
        kv.push("w", tmx.nd.ones((4,)))     # the optimizer came back too
        kv.pull("w", out=out2)
        np.testing.assert_allclose(out2.asnumpy(), 0.0)
        restarter.join()
    finally:
        kv.stop_server()


def test_a_client_rides_through_injected_connection_drops(_fast_retries,
                                                          monkeypatch):
    from mxnet_tpu_torch import telemetry
    port = _free_port()
    t = _start_server(tserver, port)
    kv = _client("port", monkeypatch, port)
    retries = telemetry.registry.counter("kvstore.client_retries")
    try:
        kv.init("w", tmx.nd.ones((2,)))
        before = retries.value
        tfault.inject("kvstore.send", action="close", count=2)
        out = tmx.nd.zeros((2,))
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), 1.0)
        assert tfault.site_calls("kvstore.send") >= 3
        assert retries.value - before == 2
        tfault.inject("kvstore.recv", action="close", count=1)
        kv.push("w", tmx.nd.ones((2,)))    # replayed, applied once
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), 2.0)
    finally:
        tfault.clear()
        kv.stop_server()
        t.join(timeout=10)


def test_the_terminal_error_comes_after_the_retry_deadline(_fast_retries,
                                                           monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_RETRY_DEADLINE", "0.6")
    port = _free_port()
    t = _start_server(tserver, port)
    kv = _client("port", monkeypatch, port)
    kv.init("w", tmx.nd.ones((2,)))
    _stop_server(port, t)
    t0 = time.monotonic()
    with pytest.raises(MXNetError) as ei:
        kv.pull("w", out=tmx.nd.zeros((2,)))
    assert time.monotonic() - t0 < 10
    assert "MX_KVSTORE_RETRY_DEADLINE" in str(ei.value)
    kv.close()


def test_an_unreachable_server_fails_the_connect_on_the_virtual_clock(
        monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_RETRY_DEADLINE", "30")
    monkeypatch.setenv("MX_PS_ROOT", "127.0.0.1:%d" % _free_port())
    with tfault.use_virtual_time() as clk:
        t0 = time.monotonic()
        with pytest.raises(OSError):
            tkvstore.KVStoreDistAsync()
        assert time.monotonic() - t0 < 10
    assert clk.now() >= 30.0


def test_the_heartbeat_keeps_a_quiet_worker_live(monkeypatch):
    monkeypatch.setenv("MX_KVSTORE_RETRY_DEADLINE", "10")
    monkeypatch.setenv("MX_KVSTORE_HEARTBEAT", "0.1")
    port = _free_port()
    srv = tserver.KVStoreServer(num_workers=1)
    stop = threading.Event()

    def serve():
        import socketserver

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                while not stop.is_set():
                    try:
                        msg = tserver.recv_msg(self.request, timeout=1.0)
                    except TimeoutError:
                        continue
                    except (ConnectionError, OSError):
                        return
                    tserver.send_msg(self.request,
                                     srv.handle_request(msg))

        class S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        with S(("127.0.0.1", port), H) as s:
            threading.Thread(target=s.serve_forever, daemon=True).start()
            stop.wait()
            s.shutdown()

    threading.Thread(target=serve, daemon=True).start()
    kv = _client("port", monkeypatch, port)
    try:
        time.sleep(0.45)
        assert "r0" in srv._last_seen
        assert time.monotonic() - srv._last_seen["r0"] < 0.4
    finally:
        kv.close()
        stop.set()


def test_the_store_s_surface(monkeypatch, _fast_retries):
    port = _free_port()
    t = _start_server(tserver, port)
    kv = _client("port", monkeypatch, port)
    try:
        assert (kv.type, kv.rank, kv.num_workers) == ("dist_async", 0, 1)
        assert kv.begin_exchange([0], [[tmx.nd.ones((2,))]]) is None
        assert kv.build_exchange_body([0], [tmx.nd.ones((2,))]) is None
        with pytest.raises(MXNetError, match="item 8"):
            kv.row_sparse_pull(0, out=tmx.nd.zeros((2,)), row_ids=[0])
        assert kv.join() == (0, ["r0"])
        assert kv.members() == (0, ["r0"])
        assert kv.membership_epoch == 0
        text = kv.metrics(fmt="prometheus")[0]
        assert "mx_kvstore" in text or "mx_engine" in text
        assert kv.leave()[0] == 1 and kv.membership_epoch == 1
    finally:
        kv.stop_server()
        t.join(timeout=10)


def test_the_elastic_epoch_salts_the_bucket_names(monkeypatch,
                                                  _fast_retries):
    monkeypatch.setenv("MX_ELASTIC_EPOCH", "3")
    port = _free_port()
    t = _start_server(tserver, port)
    kv = _client("port", monkeypatch, port)
    try:
        arrs = [tmx.nd.ones((3,)), tmx.nd.ones((4,))]
        salted, _ = kv._bucket_plans([0, 1], arrs)
        monkeypatch.setenv("MX_ELASTIC_EPOCH", "0")
        plain = tkvstore.KVStoreLocal()._bucket_plans([0, 1], arrs)[0]
        assert kv._bucket_salt == 3
        assert salted[0].name != plain[0].name
        kv.init([0, 1], arrs)
        kv.push([0, 1], arrs)               # the salted bucket's INIT+PUSH
        outs = [tmx.nd.zeros((3,)), tmx.nd.zeros((4,))]
        kv.pull([0, 1], out=outs)
        np.testing.assert_array_equal(outs[0].asnumpy(), 1.0)
        assert np.asarray(kv._rpc("PULL", salted[0].name)).sum() == 7.0
    finally:
        kv.stop_server()
        t.join(timeout=10)


def test_the_hierarchical_pull_comes_back_int8_bucket_by_bucket(
        monkeypatch, _fast_retries):
    """MX_EXCHANGE_HIERARCHICAL=1: every bucket's PULLQ on its own pool
    connection, about a quarter of the fp32 bytes, each value within its
    block's int8 step of the accumulated sum."""
    from mxnet_tpu_torch import telemetry
    monkeypatch.setenv("MX_EXCHANGE_HIERARCHICAL", "1")
    monkeypatch.setenv("MX_KVSTORE_BUCKET_KB", "4")      # several buckets
    port = _free_port()
    t = _start_server(tserver, port)
    kv = _client("port", monkeypatch, port)
    pulled = telemetry.registry.counter("kvstore.pull_wire_bytes")
    try:
        rng = np.random.RandomState(5)
        vals = [rng.randn(300).astype(np.float32) for _ in range(6)]
        keys = list(range(6))
        kv.init(keys, [tmx.nd.zeros((300,)) for _ in keys])
        kv.push(keys, [tmx.nd.array(v) for v in vals])
        buckets, solo = kv._bucket_plans(keys, [tmx.nd.zeros((300,))
                                                for _ in keys])
        assert len(buckets) > 1
        outs = [tmx.nd.zeros((300,)) for _ in keys]
        before = pulled.value
        kv.pull(keys, out=outs)
        assert 0 < pulled.value - before < 0.3 * 6 * 300 * 4
        for v, o in zip(vals, outs):
            step = np.abs(v).max() / 127.0
            np.testing.assert_allclose(o.asnumpy(), v, atol=step)
        assert kv._hier_pool is not None
    finally:
        kv.stop_server()
        t.join(timeout=10)
