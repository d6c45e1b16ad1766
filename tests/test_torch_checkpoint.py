"""The port's ``checkpoint`` and ``TrainStep.save`` / ``restore`` against
``mxnet_tpu.checkpoint`` (orbax), on the CPU.

A checkpoint of one package is not readable by the other, so the two are
held to each other by what they do: a step saved, restored into a fresh
step and trained on continues as the reference's does (at the repo's fp32
bound, and bitwise against the port's own uninterrupted run); one sequence
of saves leaves the same sidecar JSON, the same retained steps and the
same resume step in both; a kill inside a save heals as the reference's
does (``tests/test_fault.py``'s checkpoint cases).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jck
from mxnet_tpu import fault as jfault
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu.parallel import make_mesh as jmake_mesh

from mxnet_tpu_torch import checkpoint as ck
from mxnet_tpu_torch import fault
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.parallel import Mesh, TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
LR, MOM = 0.1, 0.9
IN, HID, OUT, B = 6, 16, 3, 8


@pytest.fixture(autouse=True)
def _clean_faults():
    fault.clear()
    jfault.clear()
    yield
    fault.clear()
    jfault.clear()


def _batch(i):
    rng = np.random.RandomState(100 + i)
    return (rng.randn(B, IN).astype(np.float32),
            rng.randn(B, OUT).astype(np.float32))


def _jax_mlp(seed):
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(HID, in_units=IN, activation="tanh"),
            jmx.gluon.nn.Dense(OUT, in_units=HID))
    net.initialize()
    rng = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(jmx.nd.array(
            (0.3 * rng.randn(*p.data().shape)).astype(np.float32)))
    return net


def _torch_mlp(named):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(HID, in_units=IN, activation="tanh"),
            tnn.Dense(OUT, in_units=HID))
    params_from_mxnet_tpu(named, net=net, device="cpu")
    return net


def _named(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _jstep(seed):
    mesh = jmake_mesh(axes=("dp",), devices=jax.devices("cpu")[:1])
    return JTrainStep(_jax_mlp(seed), _mse, mesh, learning_rate=LR,
                      momentum=MOM)


def _tstep(seed):
    return TrainStep(_torch_mlp(_named(_jax_mlp(seed))), _mse, device="cpu",
                     learning_rate=LR, momentum=MOM)


def _close(got, want, what):
    for part in ("params", "opt_state"):
        assert sorted(got[part]) == sorted(want[part])
        for n in want[part]:
            np.testing.assert_allclose(
                got[part][n].numpy(), np.asarray(want[part][n]), rtol=RTOL,
                atol=ATOL, err_msg="%s %s %s" % (what, part, n))


def _state(step):
    return {"params": step.params, "opt_state": step.opt_state}


def test_a_restored_step_continues_as_the_reference_s(tmp_path):
    """2 steps, save, a fresh step (other weights) restores, 2 more steps:
    the port's equals the reference's at 1e-4, and its own uninterrupted 4
    steps bitwise (parameters and momenta)."""
    j1, t1 = _jstep(0), _tstep(0)
    for i in range(2):
        j1(*[jnp.asarray(a) for a in _batch(i)])
        t1(*_batch(i))
    j1.save(str(tmp_path / "j"))
    t1.save(str(tmp_path / "t"))
    j2, t2 = _jstep(7), _tstep(7)
    j2.restore(str(tmp_path / "j"))
    ids = [id(v) for v in t2.params.values()]
    t2.restore(str(tmp_path / "t"))
    assert [id(v) for v in t2.params.values()] == ids     # in place
    _close(_state(t2), _state(j2), "restored")
    for i in range(2, 4):
        j2(*[jnp.asarray(a) for a in _batch(i)])
        t2(*_batch(i))
        t1(*_batch(i))
    _close(_state(t2), _state(j2), "after 2 more steps")
    for part in ("params", "opt_state"):
        for n, v in _state(t1)[part].items():
            assert torch.equal(v, _state(t2)[part][n]), (part, n)
    # the sidecar: the same document from both packages' steps
    assert open(tmp_path / "t.speclayout.json").read() == \
        open(tmp_path / "j.speclayout.json").read()
    assert ck.saved_world_size(str(tmp_path / "t")) == \
        jck.saved_world_size(str(tmp_path / "j")) == 1


def test_restore_keeps_the_step_s_device_and_dtype(tmp_path):
    def bf16_step(seed):
        net = _torch_mlp(_named(_jax_mlp(seed)))
        net.cast("bfloat16")
        return TrainStep(net, _mse, device="cpu", learning_rate=LR,
                         momentum=MOM)

    x, y = (torch.from_numpy(v).to(torch.bfloat16) for v in _batch(0))
    a = bf16_step(0)
    a(x, y)
    a.save(str(tmp_path / "bf16"))
    b = bf16_step(3)
    b.restore(str(tmp_path / "bf16"))
    for part in ("params", "opt_state"):
        for n, v in _state(b)[part].items():
            assert v.dtype == torch.bfloat16 and v.device.type == "cpu"
            assert torch.equal(v, _state(a)[part][n])


def _jtree(v):
    return {"w": jnp.full((3,), float(v)), "b": {"x": jnp.zeros((2,))}}


def _ttree(v):
    return {"w": torch.full((3,), float(v)), "b": {"x": torch.zeros(2)}}


def test_a_sequence_of_saves_leaves_what_the_reference_leaves(tmp_path):
    steps = [0, 1, 2, 1, 5, 3, 7]      # 1 and 3 come after a later step
    jm = jck.CheckpointManager(str(tmp_path / "j"), max_to_keep=2)
    tm = ck.CheckpointManager(str(tmp_path / "t"), max_to_keep=2)
    try:
        for s in steps:
            jm.save(s, _jtree(s))
            tm.save(s, _ttree(s))
            assert tm.all_steps() == jm.all_steps(), s
            assert tm.latest_step() == jm.latest_step(), s
        assert tm.all_steps() == [5, 7]
        assert sorted(os.listdir(tmp_path / "t")) == \
            sorted(os.listdir(tmp_path / "j"))
        assert open(tmp_path / "t" / "speclayout.json").read() == \
            open(tmp_path / "j" / "speclayout.json").read()
        got = tm.restore(template=_ttree(0))
        want = jm.restore(template=_jtree(0))
        np.testing.assert_array_equal(got["w"].numpy(),
                                      np.asarray(want["w"]))
    finally:
        jm.close()
    _, jstart, jmgr = jck.resume_or_init(str(tmp_path / "j"),
                                         lambda: _jtree(0))
    jmgr.close()
    state, start, _ = ck.resume_or_init(str(tmp_path / "t"),
                                        lambda: _ttree(0))
    assert start == jstart == 8
    assert state["w"].tolist() == [7.0] * 3
    _, start, _ = ck.resume_or_init(str(tmp_path / "cold"),
                                    lambda: _ttree(0))
    _, jstart, jmgr = jck.resume_or_init(str(tmp_path / "jcold"),
                                         lambda: _jtree(0))
    jmgr.close()
    assert start == jstart == 0


def test_save_sharded_writes_the_reference_s_sidecar(tmp_path):
    jck.save_sharded(str(tmp_path / "j"), _jtree(1))
    ck.save_sharded(str(tmp_path / "t"), _ttree(1))
    assert open(tmp_path / "t.speclayout.json").read() == \
        open(tmp_path / "j.speclayout.json").read()
    assert ck.saved_specs(str(tmp_path / "t")) == \
        jck.saved_specs(str(tmp_path / "j"))
    assert ck.saved_specs(str(tmp_path / "none")) is None
    assert ck.saved_world_size(str(tmp_path / "none")) is None


@pytest.mark.parametrize("entries, shape", [
    (None, (8, 4)), ([], (8, 4)), (["dp"], (8, 4)), (["fsdp"], (8, 4)),
    ([None, "fsdp"], (8, 4)), ([["dp", "fsdp"]], (8, 4)),
    (["fsdp"], (3, 4)), (["tp"], (8, 4)),
])
def test_a_saved_spec_lands_on_a_mesh_as_the_reference_s(entries, shape):
    """The elastic-restore rule: axes by name, an axis the mesh lacks or
    that does not divide the dimension drops out."""
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:4])
                              .reshape(2, 2), ("dp", "fsdp"))
    tmesh = Mesh(np.arange(4).reshape(2, 2), ("dp", "fsdp"))
    want = jck._spec_onto_mesh(entries, shape, jmesh)
    got = ck._spec_onto_mesh(entries, shape, tmesh)
    assert got.spec == tuple(want) and got.mesh is tmesh


def test_shardings_from_saved_replicate_on_the_port_s_mesh(tmp_path):
    step = _tstep(0)
    step.save(str(tmp_path / "s"))
    mesh = Mesh(np.asarray([0]), ("dp",))
    sh = ck.shardings_from_saved(str(tmp_path / "s"), _state(step), mesh)
    assert all(s.spec == () and s.mesh is mesh
               for part in sh.values() for s in part.values())
    assert ck.shardings_from_saved(str(tmp_path / "s"), _state(step),
                                   None) is None


def test_save_sharded_survives_a_kill_mid_save(tmp_path):
    """A kill between the write and the commit leaves the last checkpoint
    whole; the victim's temporary directory is swept by the next save."""
    p = str(tmp_path / "ck")
    ck.save_sharded(p, {"w": torch.ones(4)})
    fault.inject("checkpoint.commit", action="crash")
    with pytest.raises(SystemExit):
        ck.save_sharded(p, {"w": torch.zeros(4)})
    fault.clear()
    out = ck.restore_sharded(p, template={"w": torch.zeros(4)})
    assert out["w"].tolist() == [1.0] * 4
    assert [e for e in os.listdir(tmp_path) if ".saving-" in e]
    ck.save_sharded(p, {"w": torch.full((4,), 7.0)})
    out = ck.restore_sharded(p, template={"w": torch.zeros(4)})
    assert out["w"].tolist() == [7.0] * 4
    assert not [e for e in os.listdir(tmp_path) if ".saving-" in e]


def test_save_sharded_heals_a_kill_inside_the_commit(tmp_path):
    p = str(tmp_path / "ck")
    ck.save_sharded(p, {"w": torch.ones(4)})
    os.rename(p, p + ".replaced")              # the state between renames
    out = ck.restore_sharded(p, template={"w": torch.zeros(4)})
    assert out["w"].tolist() == [1.0] * 4
    assert os.path.exists(p) and not os.path.exists(p + ".replaced")
    mgr = ck.CheckpointManager(str(tmp_path / "m"))
    mgr.save(3, {"w": torch.ones(2)})
    os.rename(str(tmp_path / "m" / "3"), str(tmp_path / "m" / "3.replaced"))
    assert mgr.all_steps() == [3]              # healed, not lost


def test_resume_or_init_continues_after_an_injected_crash(tmp_path):
    steps_run = []

    def run(total):
        state, start, mgr = ck.resume_or_init(
            str(tmp_path / "run"), lambda: {"w": torch.zeros(3)})
        for step in range(start, total):
            fault.fire("train.step")
            state = {"w": state["w"] + 1.0}
            mgr.save(step, state)
            steps_run.append(step)
        return state

    fault.inject("train.step", action="crash", after=3)
    with pytest.raises(SystemExit):
        run(6)
    fault.clear()
    state = run(6)
    assert steps_run == [0, 1, 2, 3, 4, 5]
    assert state["w"].tolist() == [6.0] * 3


def test_a_checkpoint_that_cannot_be_read_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore_sharded(str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError):
        ck.CheckpointManager(str(tmp_path / "empty")).restore()
    p = str(tmp_path / "ck")
    ck.save_sharded(p, {"w": torch.ones(4)})
    with pytest.raises(FileExistsError):
        ck.save_sharded(p, {"w": torch.ones(4)}, force=False)
    for f in os.listdir(p):
        if f.endswith(".distcp"):
            os.remove(os.path.join(p, f))
    with pytest.raises(MXNetError, match="load failed"):
        ck.restore_sharded(p, template={"w": torch.zeros(4)})
    with pytest.raises(MXNetError, match="load failed"):
        ck.restore_sharded(p)
    with pytest.raises(TypeError):
        ck.save_sharded(str(tmp_path / "bad"), {"w": np.ones(3)})


def test_a_template_free_restore_builds_the_tree(tmp_path):
    tree = {"params": {"enc.w": torch.randn(3, 4),
                       "b": torch.arange(5.0).to(torch.bfloat16)},
            "opt_state": {"enc.w": torch.zeros(3, 4)}}
    ck.save_sharded(str(tmp_path / "ck"), tree)
    out = ck.restore_sharded(str(tmp_path / "ck"))
    assert sorted(out) == ["opt_state", "params"]
    assert sorted(out["params"]) == ["b", "enc.w"]
    assert out["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["enc.w"], tree["params"]["enc.w"])
    assert torch.equal(out["params"]["b"], tree["params"]["b"])


_DP_SAVE = textwrap.dedent("""
    import os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import TrainStep, init_process_group, \\
        make_mesh
    init_process_group(device="cpu")
    rank, out = dist.get_rank(), sys.argv[1]

    def step(seed):
        net = nn.Dense(3, in_units=4)
        net.initialize(device="cpu", seed=seed)
        return TrainStep(net, lambda o, y: ((o - y) ** 2).mean(),
                         mesh=make_mesh(), device="cpu", learning_rate=0.1)

    rng = np.random.RandomState(rank)
    x, y = rng.randn(2, 4).astype(np.float32), rng.randn(2, 3) \\
        .astype(np.float32)
    a = step(0)
    a(x, y)
    a.save(os.path.join(out, "dp"))
    b = step(5)
    b.restore(os.path.join(out, "dp"))
    for part in ("params", "opt_state"):
        for n, v in getattr(a, part).items():
            assert torch.equal(v, getattr(b, part)[n]), (part, n)
    a(x, y)
    b(x, y)
    assert all(torch.equal(v, b.params[n]) for n, v in a.params.items())
    dist.barrier()
    print("DP_CKPT_OK", rank, flush=True)
    dist.destroy_process_group()
""")


def test_a_dp_step_saves_and_restores_collectively(tmp_path):
    """Two gloo ranks: every rank calls save and restore; rank 0 commits;
    the sidecar says the world was 2 and the mesh dp = 2."""
    script = tmp_path / "dp.py"
    script.write_text(_DP_SAVE)
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
         "--", sys.executable, str(script), str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    assert r.stdout.count("DP_CKPT_OK") == 2
    doc = json.load(open(tmp_path / "dp.speclayout.json"))
    assert doc == {"schema": 1, "mesh_axes": {"dp": 2},
                   "leaf_specs": [[]] * 4, "world_size": 2}
    assert ck.saved_world_size(str(tmp_path / "dp")) == 2
    assert not [e for e in os.listdir(tmp_path) if ".saving-" in e]
