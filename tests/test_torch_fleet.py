"""The port's fleet plane (``mxnet_tpu_torch/fleet.py``) against the
reference's (``mxnet_tpu/fleet.py``), on the CPU.

Each scenario runs the same script on both packages (their own
``telemetry.Registry`` snapshots, detectors and collectors over the same
heartbeat payloads) and the outputs must be equal: the merge algebra
(counters, gauges, bucket-wise histograms, quantiles, mismatched
boundaries), counter-restart rebasing, the straggler detector, the SLO
tracker and ``replica_signals``.  Then a port ``FleetCollector`` scrapes
two in-process port replicas over METRICS and serves FLEET and the
federation exposition.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu.fleet as jfleet
import mxnet_tpu.telemetry as jtel
import mxnet_tpu_torch.fleet as tfleet
import mxnet_tpu_torch.telemetry as ttel
from mxnet_tpu_torch.serve import (BucketTable, ModelHost, Servable,
                                   ServeClient, ServeServer, serve_forever)
from mxnet_tpu_torch.serve.demo import demo_block, demo_example

# six xdist workers share the host's cores: cap torch's intra-op threads
torch.set_num_threads(1)

PACKAGES = {"jax": (jfleet, jtel), "torch": (tfleet, ttel)}


def _no_stamps(obj):
    """``obj`` without its clock stamps (``ts`` keys)."""
    if isinstance(obj, dict):
        return {k: _no_stamps(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_no_stamps(v) for v in obj)
    return obj


def _both(fn):
    """fn(fleet, telemetry) on both packages; their outputs, clock stamps
    aside, must be equal.  Returns the port's."""
    outs = {k: _no_stamps(fn(*mods)) for k, mods in PACKAGES.items()}
    assert outs["torch"] == outs["jax"]
    return outs["torch"]


def _beat(path, payload, head="0 0"):
    with open(path, "w") as f:
        f.write("%f %s\n" % (time.time(), head))
        f.write(json.dumps(payload) + "\n")


# ---------------------------------------------------------------------------
# merge algebra and quantiles
# ---------------------------------------------------------------------------

def _counters_gauges(fl, tel):
    r1, r2 = tel.Registry(), tel.Registry()
    r1.counter("serve.requests").inc(5)
    r2.counter("serve.requests").inc(7)
    r1.gauge("serve.queue_rows").set(4)
    r2.gauge("serve.queue_rows").set(10)
    r1.counter("serve.requests", labels={"model": "a"}).inc(3)
    return fl.merge_snapshots({"serve:0": r1.snapshot(),
                               "serve:1": r2.snapshot()})


def _histograms(fl, tel):
    rng = np.random.RandomState(3)
    buckets = (0.001, 0.01, 0.1, 1.0)
    regs = [tel.Registry() for _ in range(3)]
    for r in regs:
        h = r.histogram("lat", buckets=buckets)
        for v in rng.exponential(0.05, size=int(rng.randint(3, 20))):
            h.observe(float(v))
    merged = fl.merge_snapshots({"m%d" % i: r.snapshot()
                                 for i, r in enumerate(regs)})
    mh = merged["histograms"]["lat"]
    return merged, [fl.quantile_from_buckets(mh["buckets"], q)
                    for q in (0.25, 0.5, 0.9, 0.99, 1.0)]


def _quantile_conventions(fl, tel):
    return [fl.quantile_from_buckets(b, q)
            for b in ({}, {"0.01": 1, "0.1": 3, "1": 4, "+Inf": 4},
                      {"0.01": 0, "+Inf": 2})
            for q in (0.25, 0.5, 0.99, 1.0)]


def _bucket_maps(fl, tel):
    a = {"0.1": 1, "+Inf": 2}
    b = {"0.1": 3, "+Inf": 4}
    out = [fl.merge_bucket_maps([a, b]), fl.merge_bucket_maps([a, {}])]
    try:
        fl.merge_bucket_maps([a, {"0.2": 1, "+Inf": 1}], name="x")
    except fl.FleetMergeError as e:
        out.append(("FleetMergeError", str(e)))
    return out


def _mismatched(fl, tel):
    ra, rb = tel.Registry(), tel.Registry()
    ra.histogram("lat", buckets=(0.01, 0.1)).observe(0.05)
    rb.histogram("lat", buckets=(0.02, 0.2)).observe(0.05)
    try:
        fl.merge_snapshots({"a": ra.snapshot(), "b": rb.snapshot()})
    except fl.FleetMergeError as e:
        return str(e)
    return None


@pytest.mark.parametrize("scenario", [_counters_gauges, _histograms,
                                      _quantile_conventions, _bucket_maps,
                                      _mismatched],
                         ids=lambda f: f.__name__.strip("_"))
def test_merge_algebra_equals_the_reference(scenario):
    out = _both(scenario)
    if scenario is _mismatched:
        assert out is not None and "lat" in out and "boundaries" in out
    if scenario is _bucket_maps:
        assert out[2][0] == "FleetMergeError"


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------

def _stragglers(fl, tel):
    rng = np.random.RandomState(5)
    det = fl.StragglerDetector(factor=2.0, window=4)
    found = []
    for r in range(9):
        stats = {}
        for w in range(4):
            if r == 6 and w == 3:
                continue            # one missed round
            base = 0.1 * (3.0 if w == 3 else 1.0)
            step = float(base * (1 + 0.1 * rng.rand()))
            stats["worker:%d" % w] = {
                "step_seconds": step,
                "phases": {"forward": step * 0.5,
                           "data_wait": step * (0.4 if w == 3 else 0.1)}}
        found.append(det.update(stats))
    det.retire("worker:3")
    found.append(det.update({"worker:0": {"step_seconds": 0.1,
                                          "phases": {"forward": 0.1}}}))
    return found


def _slo(fl, tel):
    tr = fl.SLOTracker(window=3, targets={"rejection_rate": 0.05,
                                          "p99_latency": 50.0,
                                          "p50_latency": 20.0,
                                          "queue_depth": 4.0})
    rounds = [({"0.01": 10, "0.1": 10, "+Inf": 10}, 0, 100, 1.0),
              ({"0.01": 0, "0.1": 20, "+Inf": 20}, 40, 100, 9.0),
              ({}, 0, 0, 0.0), ({}, 0, 100, 0.0), ({}, 0, 100, 0.0),
              ({"0.01": 5, "0.1": 5, "+Inf": 5}, 1, 100, 2.0)]
    out = [tr.update(*r) for r in rounds]
    out.append(sorted(tr.breached))
    tr.reset()
    out.append(tr.update({}, 0, 100, 0.0))
    return out


def _signals(fl, tel):
    regs = []
    for i in range(2):
        r = tel.Registry()
        r.gauge("serve.queue_rows").set(3 * i + 1)
        r.gauge("serve.decode.queue").set(i)
        r.gauge("serve.decode.active_slots").set(2 - i)
        r.gauge("serve.decode.slot_occupancy").set(0.25 * (i + 1))
        r.gauge("serve.decode.kv_headroom_bytes").set(1000 * (i + 1))
        r.counter("serve.rejected").inc(i)
        r.counter("serve.decode.rejected").inc(2)
        regs.append(r)
    merged = fl.merge_snapshots({"serve:%d" % i: r.snapshot()
                                 for i, r in enumerate(regs)})
    merged["members"] = {
        "serve:0": {"role": "serve", "present": True, "addr": "h:1"},
        "serve:1": {"role": "serve", "present": False, "addr": "h:2"},
        "serve:2": {"role": "serve", "present": True},
        "worker:0": {"role": "worker", "present": True, "addr": "h:3"}}
    return fl.replica_signals(merged), fl.replica_signals(None), \
        fl.replica_signals(merged, role="worker")


@pytest.mark.parametrize("scenario", [_stragglers, _slo, _signals],
                         ids=lambda f: f.__name__.strip("_"))
def test_detectors_and_signals_equal_the_reference(scenario):
    out = _both(scenario)
    if scenario is _stragglers:
        assert [f["member"] for f in out[2]] == ["worker:3"]
        assert out[2][0]["dominant_phase"] in ("forward", "data_wait")
    if scenario is _signals:
        assert sorted(out[0]) == ["h:1", "h:2"]


def test_heartbeat_counters_rebase_across_a_restart(tmp_path):
    """Both packages' collectors over the same heartbeat files: the
    worker step total rebases over a restart, never backwards."""
    def run(fl, tel):
        hb = str(tmp_path / ("rank_0_%s" % fl.__name__))
        c = fl.FleetCollector([fl.FleetMember("worker", 0, heartbeat=hb)],
                              interval=0.01, stale_after=60)
        totals = []
        for step in (100, 130, 20, 25):
            _beat(hb, {"schema": 1, "step": step, "steps_per_sec": 10.0})
            totals.append(c.scrape_once()["counters"]["worker.steps"]
                          ["total"])
        return totals
    assert _both(run) == [100, 130, 150, 155]


def test_schema_and_wire_verbs_match():
    assert tfleet.SCHEMA == jfleet.SCHEMA
    assert sorted(tfleet.WIRE_VERBS) == sorted(jfleet.WIRE_VERBS)
    assert sorted(tfleet.__all__) == sorted(jfleet.__all__)
    from mxnet_tpu.base import ENV_CATALOG as JCAT
    from mxnet_tpu_torch.base import ENV_CATALOG as TCAT
    knobs = [k for k in JCAT if k.startswith("MX_FLEET_")]
    assert knobs and all(k in TCAT and TCAT[k][1] for k in knobs)
    assert all(TCAT[k][0] == JCAT[k][0] for k in knobs)


# ---------------------------------------------------------------------------
# a collector over two in-process port replicas
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def two_replicas():
    reps = []
    for _ in range(2):
        host = ModelHost()
        host.deploy(Servable(demo_block("cpu"), name="demo-mlp",
                             buckets=BucketTable((1, 2)), device="cpu"),
                    example=demo_example())
        state = ServeServer(host, max_delay_us=0)
        port = _free_port()
        stop, ready = threading.Event(), threading.Event()
        t = threading.Thread(target=serve_forever, daemon=True,
                             kwargs=dict(port=port, state=state,
                                         stop_event=stop, bind="127.0.0.1",
                                         ready_event=ready))
        t.start()
        assert ready.wait(10)
        reps.append(("127.0.0.1:%d" % port, stop, t))
    yield [r[0] for r in reps]
    for _addr, stop, t in reps:
        stop.set()
        t.join(10)


def test_a_collector_merges_two_port_replicas_exactly(two_replicas):
    a, b = two_replicas
    x = np.random.RandomState(0).randn(2, 16).astype(np.float32)
    for addr in (a, b):
        with ServeClient([addr], timeout=20) as cli:
            cli.predict([x])
    c = tfleet.FleetCollector(
        [tfleet.FleetMember("serve", i, addr=addr)
         for i, addr in enumerate((a, b))], interval=0.05)
    merged = c.scrape_once()
    per = {k: tfleet.fetch_metrics(addr, fmt="json")
           for k, addr in (("serve:0", a), ("serve:1", b))}
    for name in ("serve.requests", "serve.batches", "serve.rows"):
        row = merged["counters"][name]
        assert row["total"] == sum(row["per_member"].values())
        # in one process both replicas answer from one registry: each
        # member reads the same value, and the fleet sums them
        assert row["per_member"]["serve:0"] == per["serve:0"][name]["value"]
        assert row["per_member"]["serve:1"] == row["per_member"]["serve:0"]
        assert row["total"] == 2 * row["per_member"]["serve:0"] >= 2
    key = "step_phase_seconds{phase=serve_dispatch}"
    assert merged["histograms"][key]["count"] >= 2
    assert merged["members"]["serve:0"]["model"] == "demo-mlp"
    sig = tfleet.replica_signals(merged)
    assert sorted(sig) == sorted((a, b))
    srv = tfleet.serve_fleet(c, 0)
    try:
        faddr = "127.0.0.1:%d" % srv.server_address[1]
        snap = tfleet.fetch_fleet(faddr)
        assert snap["schema"] == tfleet.SCHEMA
        assert snap["members"]["serve:1"]["present"]
        fed = tfleet.fetch_metrics(faddr, fmt="prometheus")
        assert 'role="serve"' in fed and 'model="demo-mlp"' in fed
    finally:
        srv.shutdown()
        srv.server_close()
