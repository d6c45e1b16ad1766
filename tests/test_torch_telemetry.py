"""``telemetry``, ``engine`` and ``profiler`` of the port against the JAX
package on the CPU.

* Telemetry: the same instrument operations on a fresh ``Registry`` of
  each package give the same Prometheus text and JSON snapshot; the same
  phases give the same ``phase_snapshot`` keys and counts; flight-recorder
  records, the heartbeat payload and its parser, crash dumps and trace
  events have the reference's fields (timestamps and ids masked).
* Engine: the same kvstore sequence (``local``, ``device`` and ``ici`` at
  world size 1, in each wire mode) gives equal deltas of
  ``engine.wire_bytes`` and ``engine.dispatch_count``, and so do eager
  ops, a fused optimizer apply and a metric update.
* Profiler: spans of telemetry and of ``nd`` ops land in ``dumps()`` as
  in the reference, and a device-trace interval on the CPU writes a chrome
  trace of the CPU activity.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import profiler as jprof, telemetry as jtel
from mxnet_tpu.engine import engine as jeng

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import profiler as tprof, telemetry as ttel
from mxnet_tpu_torch.engine import engine as teng

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

PACKAGES = {"jax": (jmx, jtel, jprof, jeng), "port": (tmx, ttel, tprof, teng)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _both(fn):
    out = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def _instrument_ops(tel):
    reg = tel.Registry()
    c = reg.counter("engine.dispatch_count", doc="device dispatches")
    c.inc(3)
    c.inc()
    reg.counter("kvstore.server_replays", doc="replays\nsecond \\ line")
    g = reg.gauge("serve.queue_depth", labels={"model": 'bert "base"\n'})
    g.inc(5)
    g.dec(2)
    h = reg.histogram("step_phase_seconds", doc="phases",
                      labels={"phase": "forward"})
    for v in (1e-5, 3e-4, 0.02, 0.02, 7.0, 100.0):
        h.observe(v)
    h2 = reg.histogram("lat", buckets=(0.1, 1.0))
    h2.observe(0.5)
    reg.counter("a.b-c").set(12)
    return reg


def test_the_same_instrument_operations_give_the_same_prometheus_text():
    text = _both(lambda mx, tel, prof, eng: _instrument_ops(tel)
                 .to_prometheus())
    assert "# TYPE mx_step_phase_seconds histogram" in text
    assert 'le="+Inf"' in text


def test_the_same_instrument_operations_give_the_same_snapshot():
    _both(lambda mx, tel, prof, eng: _instrument_ops(tel).to_json(indent=1))
    _both(lambda mx, tel, prof, eng: (
        _instrument_ops(tel).value("engine.dispatch_count"),
        _instrument_ops(tel).value("missing", default=-1)))


def test_an_instrument_of_another_kind_under_one_name_raises():
    for _, tel, _, _ in PACKAGES.values():
        reg = tel.Registry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.histogram("x")


def test_phases_give_the_same_snapshot_keys_and_counts(monkeypatch):
    monkeypatch.setenv("MX_TELEMETRY", "1")

    def run(mx, tel, prof, eng):
        for _ in range(3):
            with tel.phase("torch_parity_forward"):
                pass
        with tel.phase("torch_parity_backward"):
            with tel.phase("torch_parity_backward"):   # nested: once
                pass
        tel.observe_phase("torch_parity_queue_wait", 0.25)
        tel.note_step()
        snap = tel.phase_snapshot()
        mine = {k: v for k, v in snap.items() if k.startswith("torch_")}
        return sorted(mine), {k: v["count"] for k, v in mine.items()}, \
            {k: sorted(v) for k, v in mine.items()}

    keys, counts, fields = _both(run)
    assert counts == {"torch_parity_forward": 3, "torch_parity_backward": 1,
                      "torch_parity_queue_wait": 1}
    assert fields["torch_parity_forward"] == ["avg_ms", "count", "max_ms",
                                              "total_ms"]


_EAGER_PHASES = ("backward", "exchange", "optimizer_apply", "metric_update",
                 "metric_drain", "data_wait")


def test_the_eager_loop_records_the_reference_s_phases(monkeypatch):
    """Two steps of a Dense net over ``[cpu(0), cpu(1)]`` (so the Trainer
    exchanges through a store) with the batches from a
    ``DevicePrefetcher``, ``autograd.backward``, ``Trainer.step`` and an
    accuracy metric: each phase and the flight records grow by the
    reference's counts."""
    monkeypatch.setenv("MX_TELEMETRY", "1")

    def run(mx, tel, prof, eng):
        ctxs = [mx.cpu(0), mx.cpu(1)]
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=ctxs)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        metric = mx.metric.Accuracy()
        rng = np.random.RandomState(0)
        batches = [(rng.randn(2, 4).astype(np.float32),
                    np.array([0, 2], np.float32)) for _ in range(2)]
        before = tel.phase_snapshot()
        steps = (tel.flight_recorder.last() or {}).get("step", 0)
        with mx.cpu():
            for x, y in mx.io.DevicePrefetcher(iter(batches)):
                outs = []
                with mx.autograd.record():
                    for c in ctxs:
                        out = net(mx.nd.array(np.asarray(x), ctx=c))
                        outs.append(out)
                        loss = (out * out).sum()
                        mx.autograd.backward(loss)
                trainer.step(2)
                metric.update([mx.nd.array(np.asarray(y), ctx=c)
                               for c in ctxs], outs)
            metric.get()
        after = tel.phase_snapshot()
        grown = {k: after.get(k, {}).get("count", 0)
                 - before.get(k, {}).get("count", 0) for k in _EAGER_PHASES}
        return grown, tel.flight_recorder.last()["step"] - steps

    grown, steps = _both(run)
    assert all(grown.values()), grown
    assert steps == 2


def test_telemetry_off_gives_the_shared_no_op(monkeypatch):
    monkeypatch.setenv("MX_TELEMETRY", "0")
    monkeypatch.delenv("MX_TELEMETRY_TRACE", raising=False)
    _both(lambda mx, tel, prof, eng: (
        type(tel.phase("x")).__name__, tel.note_step(),
        type(tel.rpc_span("kv.client.PUSH")).__name__))


_MASKED = ("ts", "wall_time", "steps_per_sec", "throughput")


def test_flight_records_and_the_heartbeat_have_the_reference_s_fields(
        monkeypatch):
    monkeypatch.setenv("MX_TELEMETRY", "1")

    def run(mx, tel, prof, eng):
        fr = tel.FlightRecorder(capacity=2)
        recs = [fr.record(phases={"phase.forward": 0.5, "backward": 0.25},
                          steps=2, epoch=1, batch=b, batch_size=8,
                          extra={"note": b}) for b in range(3)]
        masked = [{k: v for k, v in r.items() if k not in _MASKED}
                  for r in fr.records()]
        # the heartbeat reads the process's recorder: start it afresh
        tel.flight_recorder.clear()
        for _ in range(2):
            tel.note_step(batch_size=8)
        hb_keys = sorted(tel.heartbeat_payload())
        tel.flight_recorder.clear()
        parsed = [tel.parse_heartbeat(lines) for lines in (
            ["1 2 3"], ["1 2 3", '{"step": 4, "schema": 1}'],
            ["1 2 3", "not json"], ["1 2 3", "7"],
            ["1 2 3", '{"schema": 99}'], [])]
        fr.clear()
        return masked, len(recs), hb_keys, parsed, fr.last()

    masked, n, hb_keys, parsed, last = _both(run)
    assert n == 3 and len(masked) == 2 and masked[-1]["step"] == 6
    assert "throughput" in hb_keys and "schema" in hb_keys
    assert parsed[2] == ("1 2 3", {}, 1) and last is None


def test_crash_dumps_have_the_reference_s_fields(tmp_path):
    # the sections other modules register (the reference's programs.py,
    # not ported yet) are theirs, not telemetry's
    sections = {name for name, _ in jtel._crash_sections}

    def run(mx, tel, prof, eng):
        d = tmp_path / mx.__name__
        path = tel.dump_crash("watchdog", directory=str(d),
                              extra={"why": "test"})
        with open(path) as f:
            payload = json.load(f)
        none = tel.dump_crash("x", directory="")
        return sorted(set(payload) - sections), payload["reason"], \
            payload["extra"], none

    _both(run)


def test_trace_events_and_rpc_spans_carry_the_reference_s_context(
        tmp_path):
    def run(mx, tel, prof, eng):
        tel.start_tracing()
        tel.clear_trace()
        try:
            with tel.rpc_span("kv.client.PUSH") as outer:
                ctx = outer.wire_context()
                outer.event("retry", server=0, seq=1)
                with tel.rpc_span("kv.server.PUSH", trace_id=ctx[0],
                                  parent_id=ctx[1]) as inner:
                    same_trace = inner.trace_id == outer.trace_id
                    child = inner.parent_id == outer.span_id
            events = tel.trace_events()
            path = tel.dump_trace(path=str(tmp_path / (mx.__name__ +
                                                       ".json")))
        finally:
            tel.stop_tracing()
            tel.clear_trace()
        shape = [(e["name"], e["cat"], e["ph"], sorted(e["args"]))
                 for e in events]
        with open(path) as f:
            dumped = json.load(f)
        return same_trace, child, shape, sorted(dumped), \
            sorted(dumped["metadata"])

    same_trace, child, shape, _, _ = _both(run)
    assert same_trace and child
    assert [s[0] for s in shape] == ["kv.server.PUSH", "kv.client.PUSH",
                                     "retry"]


# ---------------------------------------------------------------------------
# engine counters
# ---------------------------------------------------------------------------

SHAPES = [(4, 3), (5,), (2, 2, 2), (7,)]


def _kv_sequence(mx, eng, store, mode):
    """The deltas of (dispatch_count, wire_bytes) after each call of one
    kvstore sequence, and the pulled values."""
    nd = mx.nd
    ctx = mx.cpu()
    rng = np.random.RandomState(0)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    kv = mx.kvstore.create(store)
    if mode:
        kv.set_gradient_compression({"type": mode})
    arrs = [nd.array(v, ctx=ctx) for v in vals]
    arrs2 = [nd.array(v * 2, ctx=ctx) for v in vals]
    outs = [nd.zeros(v.shape, ctx=ctx) for v in vals]
    ints = nd.array(np.arange(6, dtype=np.int32), ctx=ctx, dtype="int32")
    iout = nd.zeros((6,), ctx=ctx, dtype="int32")
    d0, w0 = eng.dispatch_count, eng.wire_bytes
    deltas = []
    calls = [lambda: kv.init(list(range(4)), arrs),
             lambda: kv.init("i", ints),
             lambda: kv.push(0, arrs[0]),
             lambda: kv.push(1, [arrs[1], arrs2[1]]),
             lambda: kv.push(list(range(4)), arrs),
             lambda: kv.push(list(range(4)),
                             [[a, b] for a, b in zip(arrs, arrs2)]),
             lambda: kv.push("i", ints),
             lambda: kv.pushpull(2, arrs[2], out=outs[2]),
             lambda: kv.pull(list(range(4)), out=outs),
             lambda: kv.pull("i", out=iout)]
    for call in calls:
        call()
        deltas.append((eng.dispatch_count - d0, eng.wire_bytes - w0))
    return deltas, [o.asnumpy().tolist() for o in outs]


@pytest.mark.parametrize("mode", [None, "2bit", "int8", "bf16"])
@pytest.mark.parametrize("store", ["local", "device", "ici"])
def test_a_kvstore_sequence_counts_the_reference_s_deltas(store, mode):
    deltas, _ = _both(lambda mx, tel, prof, eng: _kv_sequence(mx, eng,
                                                              store, mode))
    assert deltas[-1][0] > 0 and deltas[-1][1] > 0


def test_the_counters_live_in_the_registry_and_snapshot_together():
    for _, tel, _, eng in PACKAGES.values():
        d = eng.dispatch_count
        eng.count_dispatch(2)
        eng.count_wire_bytes(40)
        eng.count_step_window(steps=4, dispatches=3)
        assert tel.registry.value("engine.dispatch_count") == d + 5
        snap = eng.snapshot()
        assert snap["dispatches"] == eng.dispatch_count
        assert snap["wire_bytes"] == eng.wire_bytes
        assert snap["compiled_steps"] == eng.compiled_steps
    assert sorted(teng.snapshot()) == sorted(k for k in jeng.snapshot()
                                             if k != "programs")


def test_the_counters_reset_by_assignment():
    for _, _, _, eng in PACKAGES.values():
        eng.wire_bytes = 0
        eng.compiled_steps = 0
        assert eng.snapshot()["wire_bytes"] == 0
        assert eng.compiled_steps == 0


A = np.random.RandomState(0).randn(3, 4).astype(np.float32)


def _eager_deltas(mx, eng):
    nd = mx.nd
    a = nd.array(A)
    b = nd.array(A.T.copy())
    d0 = eng.dispatch_count
    out = []
    for fn in (lambda: nd.dot(a, b), lambda: a + a, lambda: a * 2.0,
               lambda: nd.relu(a), lambda: a.sum(), lambda: nd.softmax(a),
               lambda: a.astype("float16"), lambda: nd.concatenate([a, a]),
               lambda: nd.zeros((2, 2)), lambda: nd.ones((2,)),
               lambda: nd.full((2,), 3.0), lambda: nd.arange(4),
               lambda: nd.eye(3)):
        fn()
        out.append(eng.dispatch_count - d0)
    return out


def test_eager_ops_count_as_the_reference_s():
    _both(lambda mx, tel, prof, eng: _eager_deltas(mx, eng))


def test_a_fused_apply_and_a_metric_update_count_as_the_reference_s():
    def run(mx, tel, prof, eng):
        nd = mx.nd
        rng = np.random.RandomState(1)
        ws = [nd.array(rng.randn(3, 4).astype(np.float32)) for _ in range(3)]
        gs = [nd.array(rng.randn(3, 4).astype(np.float32)) for _ in range(3)]
        upd = mx.optimizer.get_updater(mx.optimizer.SGD(learning_rate=0.1,
                                                        momentum=0.9))
        m = mx.metric.Accuracy()
        lab = nd.array(np.array([0, 1, 2], np.float32))
        pred = nd.array(rng.randn(3, 3).astype(np.float32))
        d0 = eng.dispatch_count
        out = []
        for fn in (lambda: upd([0, 1, 2], gs, ws), lambda: upd(0, gs[0],
                                                               ws[0]),
                   lambda: m.update([lab], [pred]),
                   lambda: m.update([lab], [pred]), lambda: m.get()):
            fn()
            out.append(eng.dispatch_count - d0)
        return out
    assert _both(run) == [1, 2, 3, 4, 4]


def test_the_naive_engine_synchronises_after_each_op(monkeypatch):
    seen = []
    monkeypatch.setattr(teng, "wait_for_var", lambda v: seen.append(v))
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert teng.is_naive() and jeng.is_naive()
    a = tmx.nd.array(A)
    b = a + a
    a[0] = 1.0
    assert len(seen) == 2 and seen[0] is b
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
    assert not teng.is_naive() and not jeng.is_naive()
    _ = a + a
    assert len(seen) == 2
    assert teng.kind == jeng.kind == "ThreadedEnginePerDevice"


def test_the_bulk_calls_are_no_ops():
    from mxnet_tpu import engine as jengine
    from mxnet_tpu_torch import engine as tengine
    for mod in (jengine, tengine):
        assert mod.set_bulk_size(16) == 0
        assert mod.engine.start_bulk() is None
        assert mod.engine.stop_bulk() is None
        mod.wait_all()
        mod.engine.wait_for_var(None)
    tengine.engine.wait_for_var(tmx.nd.array(A))
    assert sorted(tengine.__all__) == sorted(jengine.__all__)


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------

def test_spans_land_in_dumps_as_in_the_reference(monkeypatch):
    monkeypatch.delenv("MX_TELEMETRY_TRACE", raising=False)

    def run(mx, tel, prof, eng):
        prof.reset()
        prof.set_config(profile_all=True, aggregate_stats=True)
        prof.set_state("run")
        try:
            with tel.rpc_span("kv.client.PUSH"):
                pass
            with tel.phase("torch_parity_exchange"):
                pass
            a = mx.nd.array(A)
            _ = mx.nd.relu(a)
            with prof.Task(prof.Domain("d"), "task1"):
                pass
            prof.Marker(prof.Domain("d"), "m").mark()
            c = prof.Counter(prof.Domain("d"), "ctr", 1)
            c += 2
        finally:
            prof.set_state("stop")
            prof.set_config(profile_all=False)
        names = sorted(json.loads(prof.dumps(format="json")))
        table = prof.dumps()
        prof.reset()
        return names, table.splitlines()[0], prof.state()

    names, head, state = _both(run)
    assert {"kv.client.PUSH", "phase.torch_parity_exchange", "relu",
            "task1", "m"} <= set(names)
    assert head == "Profile Statistics:" and state == "stop"


def test_dump_writes_the_reference_s_chrome_trace(tmp_path):
    def run(mx, tel, prof, eng):
        prof.reset()
        fname = str(tmp_path / (mx.__name__ + ".json"))
        prof.set_config(filename=fname)
        prof.start()
        with prof.Event("ev"):
            pass
        prof.Counter("ctr", value=3)
        prof.stop()
        prof.dump()
        with open(fname) as f:
            payload = json.load(f)
        prof.set_config(filename="profile.json")
        prof.reset()
        return sorted(payload), [(e["name"], e["ph"], e["cat"])
                                 for e in payload["traceEvents"]]
    _both(run)


def test_set_config_refuses_an_unknown_option_and_state():
    for _, _, prof, _ in PACKAGES.values():
        with pytest.raises(ValueError):
            prof.set_config(bogus=1)
        with pytest.raises(ValueError):
            prof.set_state("pause")


def test_a_device_trace_on_the_cpu_records_the_cpu_activity(tmp_path):
    tprof.set_config(profile_all=True, device_trace_dir=str(tmp_path))
    tprof.set_state("run")
    try:
        assert tprof._torch_prof is not None
        a = tmx.nd.array(A)
        with tprof.scope("my_scope"):
            _ = tmx.nd.dot(a, tmx.nd.array(A.T.copy()))
    finally:
        tprof.set_state("stop")
        tprof.set_config(profile_all=False, device_trace_dir=None)
    assert tprof._torch_prof is None
    path = tprof.device_trace_path()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "my_scope" in names and "dot" in names
    assert any(n and n.startswith("aten::") for n in names)
    tprof.reset()
