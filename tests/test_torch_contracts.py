"""The port's program contracts and their verifier against the reference's.

``mxnet_tpu_torch.programs`` declares the reference's 18 contracts under
their names; ``python -m mxnet_tpu_torch.tools.contracts`` dispatches each
case once and proves its donated tensors are written in place, its
temp bytes within budget on the card (unmeasured on the CPU), and its
workload's signatures closed.  Here: the names and closure shapes against
the reference's manifest, the donated-argument mapping, a clean CPU run,
four planted faults, the manifest file, the CLI, and isolation.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from mxnet_tpu_torch import programs as tprog  # noqa: E402
from mxnet_tpu_torch.tools import contracts as tcon  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

#: the reference's declaring modules (its verifier's list, and the decode
#: engine, whose contracts the serving package imports)
REF_MODULES = ("mxnet_tpu.step", "mxnet_tpu.serve.servable",
               "mxnet_tpu.serve.decode", "mxnet_tpu.ops.optimizer",
               "mxnet_tpu.ops.quantization", "mxnet_tpu.kvstore.kvstore")


@pytest.fixture(scope="module")
def ref_manifest():
    import importlib
    for mod in REF_MODULES:
        importlib.import_module(mod)
    from mxnet_tpu import programs as jprog
    return {c["name"]: c for c in jprog.contract_manifest()["contracts"]}


@pytest.fixture(scope="module")
def port_contracts():
    return {c.name: c for c in tcon.load_contracts()}


@pytest.fixture(scope="module")
def cpu_run():
    return tcon.verify(device="cpu")


def test_the_18_names_and_closure_shapes_are_the_reference_s(
        ref_manifest, port_contracts):
    port = {c["name"]: c for c in tprog.contract_manifest()["contracts"]}
    assert len(ref_manifest) == 18
    assert sorted(port) == sorted(ref_manifest)
    for name, ref in ref_manifest.items():
        got = port[name]["closure_points"]
        want = ref["closure_points"]
        assert (got is None) == (want is None), name
        assert got == want, name            # None or "deferred" alike
        assert port_contracts[name].origin is not None


def test_each_donated_argument_stands_for_the_reference_s(
        ref_manifest, port_contracts):
    """The port's donate_argnums index its own argument tuple; where the
    order differs, reference_argnums names the reference's arguments each
    one (or the state the body reaches through its site) stands for, and
    together they are the reference's donated set."""
    for name, ref in ref_manifest.items():
        c = port_contracts[name]
        want = set(ref["donate_argnums"])
        if c.reference_argnums is None:
            assert set(c.donate_argnums) == want, name
            continue
        mapped = set()
        for k, v in c.reference_argnums.items():
            if k != "state":
                assert k in c.donate_argnums, (name, k)
            mapped |= set(v)
        assert mapped == want, name
    # the decode tables bind their parameters: the state dict is argument
    # 0 and stands for the reference's k, v, tok, len (1-4)
    assert port_contracts["serve.decode"].reference_argnums == {
        0: (1, 2, 3, 4)}
    assert port_contracts["serve.spec.verify"].reference_argnums == {
        0: (1, 2, 3, 4), 1: (5, 6)}
    assert port_contracts["step.train"].reference_argnums == {
        0: (0,), "state": (1, 2, 3, 4, 5)}


def test_each_mapped_state_dict_holds_the_reference_s_leaves(
        port_contracts):
    """A mapped state dict has at least as many tensors as the reference
    arguments it stands for (the draft's extra leaves are noted, not
    written)."""
    with tprog.contract_scope("cpu"):
        for name in ("serve.decode", "serve.prefill", "serve.paged.decode",
                     "serve.paged.prefill", "serve.spec.draft",
                     "serve.spec.draft.prefill", "serve.spec.verify"):
            c = port_contracts[name]
            case = c.build()[0]
            for k, v in c.reference_argnums.items():
                leaves = tprog._tensor_leaves(case.args[k])
                assert len(leaves) >= len(v), (name, k)
            assert set(case.args[0]) >= {"k", "v", "tok", "len"}, name


def test_the_cpu_run_is_clean_and_every_budget_unmeasured(cpu_run):
    diags, results, verified = cpu_run
    assert diags == [], [repr(d) for d in diags]
    assert {r.contract for r in results} == {
        c.name for c in tprog.contracts()}
    assert len({r.contract for r in results}) == 18
    assert all(r.budget_status == "unmeasured" for r in results)
    assert all(r.temp_bytes is None for r in results)
    assert all(r.dropped == 0 for r in results)
    # every case with a donated tensor writes at least one in place
    assert all(r.aliased > 0 for r in results if r.donated_expected)
    table = tcon.budget_table(results)
    assert "unmeasured" in table and "held" not in table


def _sgd_case(fn, label="planted"):
    n = 3

    def col():
        return tuple(torch.empty((64,), device="meta") for _ in range(n))
    return tprog.ContractCase(
        "optimizer.fused_sgd", (col(), col(), None,
                                torch.empty((n,), device="meta")),
        label=label, fn=fn)


def _planted(cases, donate=(0, 2), budget=1 << 20, closure=None,
             name="planted.sgd"):
    return tprog.ProgramContract(name, lambda: cases, donate_argnums=donate,
                                 temp_budget_bytes=budget, closure=closure,
                                 origin=(__file__, 1))


def test_a_reinjected_dropped_donation_trips():
    """A fused SGD body that rebinds its weights instead of writing them:
    the weights stay unwritten while new tensors of their shape come
    back."""
    def rebinding_sgd(weights, grads, masters, lrs):
        return [w - lr * g for w, g, lr in zip(weights, grads,
                                                lrs.tolist())]
    diags, results, _ = tcon.verify(
        device="cpu", contracts=[_planted([_sgd_case(rebinding_sgd)])])
    assert [d.rule for d in diags] == [tcon.RULE_DONATION]
    assert "3 of 3" in diags[0].message
    assert results[0].dropped == 3 and results[0].aliased == 0
    # a body that swaps in a new tensor where the state lived trips too
    st = {"w": torch.zeros(4)}

    def swapping(state):
        state["w"] = state["w"] + 1.0
    case = tprog.ContractCase("planted.swap", (st,), fn=swapping)
    diags, results, _ = tcon.verify(
        device="cpu", contracts=[_planted([case], donate=(0,))])
    assert [d.rule for d in diags] == [tcon.RULE_DONATION]
    assert "rebound to new storage" in diags[0].message


def test_a_pruned_donation_is_noted_not_flagged():
    """The weights written in place, the masters column declared donated
    but never touched (and nothing of its shape returned): noted."""
    def sgd_in_place(weights, grads, masters, lrs):
        for w, g, lr in zip(weights, grads, lrs.tolist()):
            w.sub_(lr * g)
    case = _sgd_case(sgd_in_place)
    spare = tuple(torch.empty((5,), device="meta") for _ in range(2))
    case.args = case.args[:2] + (spare,) + case.args[3:]
    diags, results, _ = tcon.verify(
        device="cpu", contracts=[_planted([case])])
    assert diags == []
    assert (results[0].aliased, results[0].pruned,
            results[0].dropped) == (3, 2, 0)


def test_a_reinjected_budget_overrun_trips(monkeypatch):
    """A measured temp byte count above the budget (injected: the CPU
    measures none) is a finding, and the table says over."""
    orig = tprog.Program._first_dispatch

    def measured(self, sig, args, kwargs):
        out = orig(self, sig, args, kwargs)
        self.record.memory = {"argument_bytes": 0, "output_bytes": 0,
                              "temp_bytes": 5000, "alias_bytes": 0,
                              "generated_code_bytes": None}
        return out
    monkeypatch.setattr(tprog.Program, "_first_dispatch", measured)

    def sgd_in_place(weights, grads, masters, lrs):
        torch._foreach_sub_(list(weights), list(grads))
    diags, results, _ = tcon.verify(
        device="cpu", contracts=[_planted([_sgd_case(sgd_in_place)],
                                          budget=4096)])
    assert [d.rule for d in diags] == [tcon.RULE_BUDGET]
    assert "5000" in diags[0].message and "4096" in diags[0].message
    assert results[0].budget_status == "over"
    diags, results, _ = tcon.verify(
        device="cpu", contracts=[_planted([_sgd_case(sgd_in_place)],
                                          budget=8192)])
    assert diags == [] and results[0].budget_status == "held"


def test_an_unbucketed_shape_trips_with_the_explainer_s_text():
    """A workload point whose batch pads to no declared bucket: the
    closure names the argument and the shape change."""
    from mxnet_tpu_torch.serve import servable
    with tprog.contract_scope("cpu"):
        cases, closure = servable._demo_contract_built(
            "cpu", servable.BucketTable.from_env().sizes)

    def resolve(rows):
        return ([np.empty((int(rows), 16), np.float32)],)
    planted = tprog.ProgramContract(
        "planted.demo", lambda: cases,
        closure=tprog.ContractClosure([3], resolve), origin=(__file__, 1))
    diags, _, _ = tcon.verify(device="cpu", contracts=[planted])
    assert [d.rule for d in diags] == [tcon.RULE_CLOSURE]
    msg = diags[0].message
    assert "workload point 3" in msg and "[0][0][0] shape" in msg, msg
    assert "(1, 16)" in msg and "(3, 16)" in msg, msg    # vs case b1
    # the step's window set: a configured scan window outside it
    from mxnet_tpu_torch import step
    # built (its first step primes the updater states) in a registry scope
    with tprog.contract_scope("cpu"), tprog.isolated():
        _c, wclosure = step._step_contract_built("cpu", 3)
    assert 3 in wclosure.points
    diags, _, _ = tcon.verify(
        device="cpu", contracts=[tprog.ProgramContract(
            "planted.window", lambda: _c, closure=wclosure,
            origin=(__file__, 1))])
    assert [d.rule for d in diags] == [tcon.RULE_CLOSURE]
    assert "[0][1][0] shape" in diags[0].message


def test_the_demo_cases_follow_mx_serve_buckets(monkeypatch):
    """The demo's built cases are cached by the bucket table as well as
    the device: a changed ``MX_SERVE_BUCKETS`` gives cases and a closure
    over the new table."""
    from mxnet_tpu_torch.serve import servable
    got = {}
    with tprog.contract_scope("cpu"):
        for raw in ("1,2", "1,2,4", "1,2"):
            monkeypatch.setenv("MX_SERVE_BUCKETS", raw)
            got[raw] = ([c.label for c in servable._demo_contract(0)],
                        max(servable._demo_contract(1).points))
    assert got == {"1,2": (["b1", "b2"], 4),
                   "1,2,4": (["b1", "b2", "b4"], 6)}


def test_a_broken_build_is_a_finding_not_a_crash():
    def broken():
        raise RuntimeError("no such model")
    bad = tprog.ProgramContract("planted.broken", broken,
                                origin=(__file__, 7))
    case = tprog.ContractCase("planted.raise", (torch.zeros(2),),
                              fn=lambda x: 1 / 0)
    worse = _planted([case], donate=(), name="planted.raise")
    diags, results, _ = tcon.verify(device="cpu", contracts=[bad, worse])
    assert [d.rule for d in diags] == [tcon.RULE_ERROR, tcon.RULE_ERROR]
    assert "no such model" in diags[0].message
    assert "ZeroDivisionError" in diags[1].message
    assert diags[0].line == 7 and results == []


def test_the_manifest_round_trips_and_the_checked_in_file_is_current(
        tmp_path, port_contracts):
    doc = tprog.contract_manifest()
    assert json.loads(json.dumps(doc)) == doc
    assert doc["schema"] == tprog.CONTRACT_SCHEMA
    out = tmp_path / "m.json"
    assert tcon.write_manifest_file(str(out)) == doc
    assert json.loads(out.read_text()) == doc
    assert json.loads(Path(tcon.DEFAULT_MANIFEST).read_text()) == doc, \
        "contracts.json is stale: python -m " \
        "mxnet_tpu_torch.tools.contracts --device cpu --write-manifest"


def test_the_cli_exit_codes_and_json(capsys, monkeypatch):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m",
                        "mxnet_tpu_torch.tools.contracts", "--device", "cpu",
                        "--format", "json"], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout)
    assert doc["violations"] == [] and doc["device"] == "cpu"
    assert len(doc["contracts"]) == 18
    assert doc["budgets"]["unmeasured"] == sum(
        len(p["cases"]) for p in doc["programs"].values())
    assert doc["budgets"]["held"] == 0
    assert "unmeasured" in doc["budget_table"]
    # a finding: a scan window outside the contracted set
    monkeypatch.setenv("MX_STEP_SCAN", "3")
    assert tcon.main(["--device", "cpu", "--select", "step.train"]) == 1
    out = capsys.readouterr()
    assert tcon.RULE_CLOSURE in out.out
    monkeypatch.delenv("MX_STEP_SCAN")
    # usage and internal errors
    assert tcon.main(["--device", "cpu", "--select", "no.such"]) == 2
    assert tcon.main(["--device", "cpu", "--select", "serve.demo",
                      "--write-manifest", "x.json"]) == 2
    if not torch.cuda.is_available():
        assert tcon.main(["--select", "serve.demo"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


def test_a_verifier_run_leaves_the_registry_and_the_census_as_they_were(
        cpu_run):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import Servable
    from mxnet_tpu_torch.serve.demo import demo_block, demo_example
    sv = Servable(demo_block("cpu"), name="live", device="cpu")
    sv.warm(demo_example())

    def census():
        return {k: v for k, v in tprog.buffer_census().items()}
    table0, census0 = tprog.program_table(), census()
    tel0 = telemetry.registry.snapshot()
    diags, results, _ = tcon.verify(device="cpu")
    assert diags == [] and results
    assert tprog.program_table() == table0
    assert census() == census0
    assert telemetry.registry.snapshot() == tel0
    assert not any(k.startswith("serve.demo.") or k.startswith("step.")
                   for k in tprog.program_table())
    assert sv.live_bytes() > 0


def test_the_scope_refuses_to_open_while_serve_forever_answers():
    """isolated() takes back whatever the process records while it is
    open, so it refuses where a replica answers METRICS: a verifier run
    belongs in a process of its own.  After STOP the scope opens again."""
    import socket
    import threading
    from mxnet_tpu_torch.serve import (ModelHost, Servable, ServeClient,
                                       ServeServer, serve_forever)
    from mxnet_tpu_torch.serve import server as tserver
    from mxnet_tpu_torch.serve.demo import demo_block, demo_example
    host = ModelHost()
    host.deploy(Servable(demo_block("cpu"), name="iso", device="cpu"),
                example=demo_example())
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, daemon=True,
                         kwargs=dict(port=port, state=ServeServer(host),
                                     bind="127.0.0.1", ready_event=ready))
    t.start()
    try:
        assert ready.wait(10)
        assert tserver.serving() == 1
        with pytest.raises(RuntimeError, match="process of its own"):
            with tprog.isolated():
                pass
    finally:
        cli = ServeClient(["127.0.0.1:%d" % port], timeout=30)
        cli.stop()
        cli.close()
        t.join(10)
    assert not t.is_alive() and tserver.serving() == 0
    with tprog.isolated():
        pass
