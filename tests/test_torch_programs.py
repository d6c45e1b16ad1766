"""The port's program registry and buffer census
(``mxnet_tpu_torch/programs.py``) against the reference's
(``mxnet_tpu/programs.py``), on the CPU.

The same sequences of calls go through both packages' registries: the
compile, retrace, specialization and executable counts must be equal, and
the retrace explainer must name the same argument, the same change and
the same before/after (numpy dtype names, the same ``PyTreeDef`` text).
The census attributes a small model's parameters, gradients and
optimizer state exactly (the same bytes in both packages), the leak
detector trips and keeps its streak on the same byte sequences, and the
engine snapshot, the step observer and the crash dump carry what the
reference's do.  ``CompiledStep`` registers ``step.step`` and explains a
batch-shape retrace and a plan invalidation; the serve bucket table
registers ``serve.<model>.b<bucket>``.
"""
import gc
import json
import uuid

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu.programs as jprog
import mxnet_tpu.telemetry as jtel
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.programs as tprog
import mxnet_tpu_torch.telemetry as ttel

# six xdist workers share the host's cores: cap torch's intra-op threads
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "int32": (jnp.int32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _name(tag):
    return "test.%s.%s" % (tag, uuid.uuid4().hex[:8])


def _arr(pkg, shape, dtype="float32"):
    if pkg == "jax":
        return jnp.ones(shape, DTYPES[dtype][0])
    return torch.ones(shape, dtype=DTYPES[dtype][1])


def _reduce(t):
    """Sum of every leaf of a tuple/list/dict tree (works on both
    packages' arrays)."""
    if isinstance(t, dict):
        return sum(_reduce(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return sum(_reduce(v) for v in t)
    return t.sum()


def _run_sequence(pkg, calls, specializing=False):
    progs = jprog if pkg == "jax" else tprog
    name = _name("seq")
    prog = progs.register_program(name, lambda *a: _reduce(a),
                                  specializing=specializing)
    for call in calls:
        prog(*[_arr(pkg, s, d) for s, d in call])
    rec = progs.find_record(name).snapshot()
    counts = {k: rec[k] for k in ("compiles", "retraces",
                                  "specializations")}
    counts["executables"] = prog.executables
    return counts


SEQUENCES = {
    "one_shape": [[((2, 3), "float32")]] * 4,
    "shapes": [[((2, 3), "float32")], [((4, 3), "float32")],
               [((2, 3), "float32")], [((4, 3), "float32")],
               [((8, 3), "float32")]],
    "dtypes": [[((4,), "float32")], [((4,), "int32")],
               [((4,), "float32")], [((4,), "bfloat16")]],
    "two_args": [[((2,), "float32"), ((3,), "float32")],
                 [((2,), "float32"), ((5,), "float32")],
                 [((2,), "float32"), ((3,), "float32")]],
}


@pytest.mark.parametrize("specializing", [False, True])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_compile_retrace_and_hit_counts_equal_the_reference(seq,
                                                            specializing):
    calls = SEQUENCES[seq]
    j = _run_sequence("jax", calls, specializing)
    t = _run_sequence("torch", calls, specializing)
    assert t == j
    assert t["compiles"] == len({tuple(c) for c in calls})


def test_records_time_memory_cost_and_a_telemetry_row():
    name = _name("rec")
    prog = tprog.register_program(name, lambda x: x + 1)
    assert tprog.find_record(name) is None   # no dispatch, no row
    prog(torch.ones(3))
    prog(torch.ones(3))
    prog(torch.ones(5))
    snap = tprog.program_table()[name]
    assert snap["compiles"] == 2 and snap["retraces"] == 1
    assert snap["compile_seconds"]["total"] > 0
    # on the CPU nothing measures memory or counts operations
    assert snap["memory"] is None and snap["cost"] is None
    assert snap["temp_bytes_peak"] is None
    assert sorted(snap) == sorted(jprog.ProgramRecord("x", "aot")
                                  .snapshot())
    c = ttel.registry.find("program_retraces", {"program": name})
    assert c is not None and c.value == 1
    prom = ttel.registry.to_prometheus()
    assert "mx_program_compile_seconds" in prom
    assert "mx_program_temp_bytes" in prom
    summary = tprog.program_summary()
    assert sorted(summary) == sorted(jprog.program_summary())
    assert summary["programs"] == tprog.program_count() >= 1
    mem = tprog.program_memory_bytes(name)
    assert mem == {"programs": 1, "temp_bytes_peak": 0,
                   "argument_bytes_max": 0, "output_bytes_max": 0}


def test_census_disabled_returns_the_plain_callable(monkeypatch):
    monkeypatch.setenv("MX_PROGRAM_CENSUS", "0")
    fn = lambda x: x      # noqa: E731
    assert tprog.register_program(_name("off"), fn) is fn


# ---------------------------------------------------------------------------
# the retrace explainer
# ---------------------------------------------------------------------------

def _explain(pkg, before, after):
    progs = jprog if pkg == "jax" else tprog
    return progs.diff_signatures(progs.signature_of(before(pkg)),
                                 progs.signature_of(after(pkg)))


def _view(diff):
    """What both packages must agree on: the kind, and per changed leaf
    the argument path, the change and the shapes and dtypes."""
    if diff is None or diff["kind"] == "tree_structure":
        return diff
    return [(c["arg"], c["change"],
             {k: v for k, v in c["before"].items() if k != "device"},
             {k: v for k, v in c["after"].items() if k != "device"})
            for c in diff["changed"]]


CHANGES = {
    "shape": (lambda p: (_arr(p, (4, 4)),), lambda p: (_arr(p, (8, 4)),)),
    "dtype": (lambda p: (_arr(p, (4,)),),
              lambda p: (_arr(p, (4,), "bfloat16"),)),
    "nested": (lambda p: ({"w": _arr(p, (2, 3)), "b": _arr(p, (3,))},
                          _arr(p, (4,)), 3),
               lambda p: ({"w": _arr(p, (2, 4)), "b": _arr(p, (3,))},
                          _arr(p, (4,), "int32"), 3)),
    "second_arg": (lambda p: (_arr(p, (2,)), _arr(p, (3,))),
                   lambda p: (_arr(p, (2,)), _arr(p, (5,)))),
    "tree": (lambda p: ((_arr(p, (2,)), _arr(p, (2,))),),
             lambda p: ({"x": _arr(p, (2,)), "y": _arr(p, (2,))},)),
    "tree_none": (lambda p: ([_arr(p, (2,))], None, 1.5),
                  lambda p: ([_arr(p, (2,)), _arr(p, (2,))], None, 1.5)),
    "scalar": (lambda p: (_arr(p, (2,)), 3), lambda p: (_arr(p, (2,)), 4)),
    "same": (lambda p: (_arr(p, (2, 2)),), lambda p: (_arr(p, (2, 2)),)),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_the_explainer_names_what_the_reference_names(change):
    before, after = CHANGES[change]
    j = _view(_explain("jax", before, after))
    t = _view(_explain("torch", before, after))
    assert t == j
    if change == "same":
        assert t is None
    elif change.startswith("tree"):
        assert t["kind"] == "tree_structure" and t["before"] != t["after"]
    else:
        assert t


def test_a_device_move_is_named_a_device_change():
    old = tprog.signature_of((torch.ones(2, device="cpu"),))
    assert tprog.diff_signatures(old, old) is None
    moved = (old[0], (("tensor", (2,), "float32", "cuda:0"),))
    (chg,) = tprog.diff_signatures(old, moved)["changed"]
    assert chg["change"] == "device" and chg["arg"] == "[0][0]"
    assert chg["before"]["device"] == "cpu"


def test_a_retrace_is_logged_and_kept_on_the_record():
    name = _name("retrace")
    prog = tprog.register_program(name, lambda x, y: x + y.sum())
    a = torch.ones(2)
    prog(a, torch.ones(3))
    prog(a, torch.ones(5))
    rec = tprog.find_record(name)
    assert rec.retraces == 1
    (chg,) = rec.last_retrace["diff"]["changed"]
    assert chg["arg"] == "[0][1]" and chg["change"] == "shape"


# ---------------------------------------------------------------------------
# the buffer census and the leak detector
# ---------------------------------------------------------------------------

def _train_one_step(pkg):
    """A small Dense net, one Adam step; returns (its parameter bytes,
    the census before and after)."""
    gc.collect()
    if pkg == "jax":
        mx, progs = jmx, jprog
        before = progs.buffer_census()
        from mxnet_tpu import autograd, gluon, nd
        net = gluon.nn.Dense(4, in_units=8)
        net.initialize(mx.init.Xavier())
        params = list(net.collect_params().values())
        tr = gluon.Trainer(params, "adam", {"learning_rate": 0.1})
        x = nd.array(np.random.RandomState(0).randn(4, 8)
                     .astype(np.float32))
        y = nd.array(np.random.RandomState(1).randn(4, 4)
                     .astype(np.float32))
        with autograd.record():
            loss = gluon.loss.L2Loss()(net(x), y)
        loss.backward()
        tr.step(batch_size=4)
        nbytes = sum(int(p.data().asnumpy().nbytes) for p in params)
    else:
        mx, progs = tmx, tprog
        before = progs.buffer_census()
        from mxnet_tpu_torch import autograd, gluon, nd
        with mx.cpu():
            net = gluon.nn.Dense(4, in_units=8)
            net.initialize(mx.init.Xavier(), device="cpu")
            params = list(net.collect_params().values())
            tr = gluon.Trainer(params, "adam", {"learning_rate": 0.1})
            x = nd.array(np.random.RandomState(0).randn(4, 8)
                         .astype(np.float32))
            y = nd.array(np.random.RandomState(1).randn(4, 4)
                         .astype(np.float32))
            with autograd.record():
                loss = gluon.loss.L2Loss()(net(x), y)
            loss.backward()
            tr.step(batch_size=4)
        nbytes = sum(int(p.data().asnumpy().nbytes) for p in params)
    gc.collect()
    after = progs.buffer_census()
    keep = (net, tr)
    return nbytes, before, after, keep


def test_the_census_attributes_params_and_optimizer_state_exactly():
    out = {}
    for pkg in ("jax", "torch"):
        nbytes, before, after, _keep = _train_one_step(pkg)
        out[pkg] = {k: after[k]["bytes"] - before[k]["bytes"]
                    for k in ("params", "optimizer_state", "serve")}
        # weight and bias with their gradients; Adam's mean and variance
        assert out[pkg]["params"] == 2 * nbytes, pkg
        assert out[pkg]["optimizer_state"] == 2 * nbytes, pkg
        assert out[pkg]["serve"] == 0
    assert out["torch"] == out["jax"]
    census = tprog.buffer_census()
    assert sorted(census) == sorted(jprog.buffer_census())
    assert census["other"]["bytes"] is None          # no CUDA here
    assert census["total_bytes"] == sum(
        v["bytes"] for v in census.values()
        if isinstance(v, dict) and v["bytes"] is not None)


def test_a_storage_claimed_twice_counts_once_for_the_first_owner():
    class Owner:
        def __init__(self, tensors):
            self.tensors = tensors
    base = torch.zeros(1000)
    a, b = Owner([base, base[:10]]), Owner([base[5:]])
    gc.collect()
    before = tprog.buffer_census()
    tprog.track_buffers("optimizer_state", a, lambda o: o.tensors)
    tprog.track_buffers("params", b, lambda o: o.tensors)
    after = tprog.buffer_census()
    assert after["optimizer_state"]["bytes"] - \
        before["optimizer_state"]["bytes"] == 4000
    assert after["params"]["bytes"] == before["params"]["bytes"]
    del a
    gc.collect()           # held weakly: the owner's claim goes with it
    later = tprog.buffer_census()
    assert later["optimizer_state"]["bytes"] == \
        before["optimizer_state"]["bytes"]
    # the storage lives on through b's view, now b's to claim
    assert later["params"]["bytes"] - before["params"]["bytes"] == 4000
    del b


def _leak_run(pkg, monkeypatch, totals, warn):
    progs = jprog if pkg == "jax" else tprog
    monkeypatch.setenv("MX_LEAK_WARN_BYTES", str(warn))
    it = iter(totals)

    def fake():
        t = next(it)
        return {"params": {"count": 1, "bytes": t, "bytes_per_chip": t},
                "other": {"count": 0, "bytes": 0, "bytes_per_chip": 0},
                "total_bytes": t, "total_bytes_per_chip": t,
                "n_arrays": 1}
    monkeypatch.setattr(progs, "buffer_census", fake)
    det = progs.LeakDetector()
    return [(c["growth_bytes"], c["tripped"])
            for c in (det.check() for _ in totals)]


@pytest.mark.parametrize("totals,warn", [
    ([0, 2000, 5000, 5000, 9000, 100, 200], 4096),     # trip, plateau
    ([0, 300, 300, 600], 450),                          # streak survives
    ([0, 1 << 20, 2 << 20], 0),                         # 0: never trips
    ([10, 5, 4, 3], 1),                                 # only shrinks
])
def test_the_leak_detector_trips_as_the_reference_does(monkeypatch, totals,
                                                      warn):
    j = _leak_run("jax", monkeypatch, totals, warn)
    t = _leak_run("torch", monkeypatch, totals, warn)
    assert t == j


def test_snapshot_observer_and_crash_sections(tmp_path, monkeypatch):
    from mxnet_tpu_torch.engine import engine
    name = _name("crash")
    prog = tprog.register_program(name, lambda x: x * 3)
    prog(torch.ones(2))
    snap = engine.snapshot()
    assert snap["programs"] == tprog.program_count() >= 1
    monkeypatch.setenv("MX_TELEMETRY", "1")
    ttel.flight_recorder.clear()
    for _ in range(17):                      # the census rides every 16th
        ttel.note_step(steps=1)
    assert any("live_bytes" in r for r in ttel.flight_recorder.records())
    ttel.flight_recorder.clear()
    path = ttel.dump_crash("test", directory=str(tmp_path))
    blob = json.load(open(path))
    assert "total_bytes" in blob["buffer_census"]
    assert blob["programs"][name]["compile_seconds"]["total"] > 0


# ---------------------------------------------------------------------------
# the registration sites
# ---------------------------------------------------------------------------

def test_compiled_step_registers_its_program_and_explains_retraces():
    from mxnet_tpu_torch import gluon, nd
    with tmx.cpu():
        net = gluon.nn.Dense(4, in_units=8)
        net.initialize(tmx.init.Xavier(), device="cpu")
        tr = gluon.Trainer(list(net.collect_params().values()), "sgd",
                           {"learning_rate": 0.1})
        cstep = tr.make_compiled_step(net, gluon.loss.L2Loss())
        rng = np.random.RandomState(0)
        x = nd.array(rng.randn(4, 8).astype(np.float32))
        y = nd.array(rng.randn(4, 4).astype(np.float32))
        cstep.step(x, y)
        cstep.step(x, y)
        rec = tprog.find_record("step.step")
        assert rec is not None
        before = rec.compiles
        cstep.step(x, y)
        assert rec.compiles == before            # a hit
        x2 = nd.array(rng.randn(6, 8).astype(np.float32))
        y2 = nd.array(rng.randn(6, 4).astype(np.float32))
        cstep.step(x2, y2)
        assert rec.compiles == before + 1
        diff = rec.last_retrace["diff"]
        assert diff["kind"] == "leaves"
        assert any(c["change"] == "shape" and c["arg"].startswith("[0][1]")
                   for c in diff["changed"])
        # a configuration change drops the plan, and the step names it
        tr._optimizer = type(tr._optimizer)(learning_rate=0.1)
        cstep.step(x, y)
        inv = cstep.last_invalidation
        assert inv is not None and inv["kind"] == "leaves"


def test_the_serve_bucket_table_registers_its_programs():
    from mxnet_tpu_torch.serve import BucketTable, ModelHost, Servable
    from mxnet_tpu_torch.serve.demo import demo_block, demo_example
    model = "b%s" % uuid.uuid4().hex[:6]
    sv = Servable(demo_block("cpu"), name=model,
                  buckets=BucketTable((1, 2, 4)), device="cpu")
    ModelHost().deploy(sv, example=demo_example())
    table = tprog.program_table()
    names = sorted(n for n in table if n.startswith("serve.%s." % model))
    assert names == ["serve.%s.b%d" % (model, b) for b in (1, 2, 4)]
    assert all(table[n]["compiles"] == 1 and table[n]["retraces"] == 0
               for n in names)
    assert sv.retraces == 3 and sv.bucket_hits == 0
    assert sv.program_prefix() == "serve.%s." % model
    census = tprog.buffer_census()
    assert census["serve"]["bytes"] >= sv.live_bytes() == sum(
        p.nbytes for p in sv.block.parameters())
    assert sv.footprint_bytes() == sv.live_bytes()   # no temp on the CPU


def test_the_train_step_registers_its_programs():
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import TrainStep
    net = nn.Dense(2, in_units=3)
    net.initialize(device="cpu")
    step = TrainStep(net, lambda out, y: ((out - y) ** 2).mean(),
                     device="cpu")
    x, y = np.ones((4, 3), np.float32), np.zeros((4, 2), np.float32)
    c0 = (tprog.find_record("mesh.train_step").compiles
          if tprog.find_record("mesh.train_step") else 0)
    step(x, y)
    step(x, y)
    assert tprog.find_record("mesh.train_step").compiles == c0 + 1
    step.run_steps(2, x, y)
    assert tprog.find_record("mesh.train_window") is not None
