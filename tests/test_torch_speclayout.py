"""SpecLayout, the partition specs and the one-process compiled step of
the port against the reference, in one process on the CPU.

Specs are compared by name, axis for axis, with the reference's
``mxnet_tpu.parallel.SpecLayout`` on the fake 8-device CPU mesh (the
port's mesh of ranks needs no process group for its specs); placements
(this rank's shard) against the device slices of the reference's
``NamedSharding``.  ``Trainer.make_compiled_step`` without a layout runs
against the reference's, with the same numpy inputs and the parameters
copied by name; tolerances are the reference's rtol 2e-4 on losses and
1e-4 x max|ref| on parameters.  The multi-rank cases (the sharded step,
``TrainStep`` over tp) are in ``tests/test_torch_tensor_parallel.py``.
"""
import os

import numpy as np
import pytest
import torch
import jax
from jax.sharding import NamedSharding, PartitionSpec as JP

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon, nd as jnd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.parallel import (SpecLayout as JSpecLayout,
                                make_mesh as jmake_mesh,
                                tp_alternation_specs as jtp_specs)

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon, nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.parallel import (SpecLayout, make_mesh, shard_params,
                                      shard_params_tp, tp_alternation_specs)
from mxnet_tpu_torch.parallel.speclayout import (P, layout_from_env,
                                                 parse_mesh_axes,
                                                 place_value, shard_slices)

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RNG = np.random.RandomState(7)
X = RNG.randn(16, 8).astype(np.float32)
Y = RNG.randn(16, 4).astype(np.float32)
MESHES = [(("data",), (8,)), (("data", "fsdp"), (4, 2)),
          (("data", "fsdp", "tp"), (2, 2, 2))]


def _pair(axes=("data", "fsdp", "tp"), shape=(2, 2, 2), rules=None,
          jrules=None):
    """The port's layout and the reference's on meshes of one shape."""
    n = int(np.prod(shape))
    port = SpecLayout.infer(make_mesh(axes, shape, devices=list(range(n))),
                            rules=rules)
    ref = JSpecLayout.infer(jmake_mesh(axes=axes, shape=shape,
                                       devices=jax.devices("cpu")[:n]),
                            rules=jrules if jrules is not None else rules)
    return port, ref


def _t(spec):
    return tuple(spec)


# -- resolution order ---------------------------------------------------------

@pytest.mark.parametrize("axes,shape", MESHES)
def test_spec_defaults_linear_embedding_sheet(axes, shape):
    lay, ref = _pair(axes, shape)
    for s in [(16, 8), (7, 8), (16,), (32, 6), (7,), (3, 4, 8), ()]:
        assert _t(lay.linear_spec(s)) == _t(ref.linear_spec(s)), s
        assert _t(lay.embedding_spec(s)) == _t(ref.embedding_spec(s)), s
        assert _t(lay.sheet_spec(s)) == _t(ref.sheet_spec(s)), s
        assert _t(lay.batch_spec_for(s)) == _t(ref.batch_spec_for(s)), s
        if len(s) > 1:
            assert _t(lay.batch_spec_for(s, 1)) == \
                _t(ref.batch_spec_for(s, 1)), s
    assert _t(lay.batch_spec()) == _t(ref.batch_spec())
    for spec in [("tp", "fsdp"), (("fsdp", "tp"),), ("fsdp",), (None, "tp"),
                 ()]:
        assert _t(lay.compute_spec(P(*spec))) == \
            _t(ref.compute_spec(JP(*spec))), spec
        for s in [(16, 8), (16,), (3,)]:
            assert _t(lay.state_spec(P(*spec), s)) == \
                _t(ref.state_spec(JP(*spec), s)), (spec, s)
    assert (lay.fsdp, lay.tp) == (ref.fsdp, ref.tp)
    assert lay.axis_size("nope") == 1


def test_spec_defaults_are_the_reference_s_literals():
    lay, _ = _pair()
    assert _t(lay.linear_spec((16, 8))) == ("tp", "fsdp")
    assert _t(lay.embedding_spec((32, 6))) == (("fsdp", "tp"),)
    assert _t(lay.sheet_spec((16,))) == ("fsdp",)
    assert _t(lay.sheet_spec((7,))) == ()
    assert _t(lay.batch_spec()) == (("data", "fsdp"),)
    assert _t(lay.compute_spec(P("tp", "fsdp"))) == ("tp",)
    assert _t(lay.compute_spec(P(("fsdp", "tp")))) == ("tp",)


def test_spec_degrades_on_missing_axes():
    lay, ref = _pair(("data",), (8,))
    assert _t(lay.linear_spec((16, 8))) == () == _t(ref.linear_spec((16, 8)))
    assert _t(lay.sheet_spec((16,))) == ()
    assert _t(lay.batch_spec()) == ("data",) == _t(ref.batch_spec())


def _nets(pinned=False):
    """An Embedding and a Dense in each package (the Dense pins its weight
    row-parallel through the block hook when ``pinned``)."""
    jmx.random.seed(0)

    class JPinned(jnn.Dense):
        def sharding_spec(self, layout):
            return {"weight": JP(None, "tp")}

    class TPinned(tnn.Dense):
        def sharding_spec(self, layout):
            return {"weight": P(None, "tp")}

    jnet, tnet = jnn.Sequential(), tnn.Sequential()
    if pinned:
        jnet.add(JPinned(16, in_units=8))
        tnet.add(TPinned(16, in_units=8))
    else:
        jnet.add(jnn.Embedding(32, 16))
        jnet.add(jnn.Dense(16, in_units=16))
        tnet.add(tnn.Embedding(32, 16))
        tnet.add(tnn.Dense(16, in_units=16))
    jnet.initialize(jmx.init.Xavier())
    return jnet, tnet


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("axes,shape", MESHES)
def test_resolve_kind_defaults_and_hook_from_block_tree(pinned, axes, shape):
    lay, ref = _pair(axes, shape)
    jnet, tnet = _nets(pinned)
    got = {k: _t(v) for k, v in lay.resolve(tnet).items()}
    want = {k: _t(v) for k, v in ref.resolve(jnet).items()}
    assert got == want
    if axes == ("data", "fsdp", "tp") and not pinned:
        assert got == {"0.weight": (("fsdp", "tp"),),
                       "1.weight": ("tp", "fsdp"), "1.bias": ("fsdp",)}
    if axes == ("data", "fsdp", "tp") and pinned:
        assert got["0.weight"] == (None, "tp") and \
            got["0.bias"] == ("fsdp",)


def test_rules_beat_hook_and_defaults():
    lay, ref = _pair(rules={"0.weight": P("fsdp", None)},
                     jrules={"0.weight": JP("fsdp", None)})
    jnet, tnet = _nets(pinned=True)
    got = {k: _t(v) for k, v in lay.resolve(tnet).items()}
    assert got == {k: _t(v) for k, v in ref.resolve(jnet).items()}
    assert got["0.weight"] == ("fsdp",)


@pytest.mark.parametrize("axes,shape", MESHES)
def test_bert_base_specs_are_the_reference_s_by_name(axes, shape):
    from mxnet_tpu.gluon.model_zoo.bert import bert_12_768_12 as jbert
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12 as tbert
    kw = dict(vocab_size=30522, max_length=512, dropout=0.0,
              use_classifier=False)
    lay, ref = _pair(axes, shape)
    got = {k: _t(v) for k, v in lay.resolve(tbert(**kw)).items()}
    want = {k: _t(v) for k, v in ref.resolve(jbert(**kw)).items()}
    assert len(got) == 157 and got == want


def test_shard_params_tp_alias_is_speclayout():
    from mxnet_tpu_torch.parallel import mesh as mesh_mod
    mesh = make_mesh(("dp", "tp"), (4, 2), devices=list(range(8)))
    jmesh = jmake_mesh(axes=("dp", "tp"), shape=(4, 2),
                       devices=jax.devices("cpu")[:8])
    params = {"0.weight": np.zeros((8, 4), np.float32),
              "0.bias": np.zeros((8,), np.float32),
              "1.weight": np.zeros((4, 8), np.float32)}
    specs = tp_alternation_specs(params, mesh)
    assert {k: _t(v) for k, v in specs.items()} == \
        {k: _t(v) for k, v in jtp_specs(params, jmesh).items()}
    assert _t(specs["0.weight"]) == ("tp", None)
    assert _t(specs["1.weight"]) == (None, "tp")
    assert _t(specs["0.bias"]) == ()
    out = mesh_mod.shard_params_tp(params, mesh)
    assert tuple(out["0.weight"].shape) == (4, 4)       # rank 0's rows
    assert tuple(out["1.weight"].shape) == (4, 4)       # rank 0's columns
    assert "Deprecated" in (mesh_mod.shard_params_tp.__doc__ or "")
    rules = {"a.weight": P("tp", None)}
    specs = tp_alternation_specs({"a.weight": params["0.weight"],
                                  "emb.weight": params["1.weight"]}, mesh,
                                 rules=rules)
    assert _t(specs["a.weight"]) == ("tp", None) and \
        _t(specs["emb.weight"]) == ()
    assert tuple(shard_params_tp({"a.weight": params["0.weight"]}, mesh,
                                 rules=rules)["a.weight"].shape) == (4, 4)


def test_shard_params_places_resolved_specs():
    lay, ref = _pair(("data", "fsdp"), (4, 2))
    params = {"emb.weight": np.arange(32 * 8, dtype=np.float32)
              .reshape(32, 8), "b": np.zeros((7,), np.float32)}
    out = shard_params(params, lay)
    assert tuple(out["emb.weight"].shape) == (16, 8)
    np.testing.assert_array_equal(out["emb.weight"].numpy(),
                                  params["emb.weight"][:16])
    assert tuple(out["b"].shape) == (7,)
    want = {k: _t(v) for k, v in ref.resolve(params=params).items()}
    assert {k: _t(v) for k, v in lay.resolve(params=params).items()} == want


@pytest.mark.parametrize("spec", [(("fsdp", "tp"),), ("tp", "fsdp"),
                                  (None, ("data", "fsdp")), ("data",),
                                  (("tp", "fsdp", "data"),)])
def test_each_rank_s_shard_is_the_reference_s_device_slice(spec):
    """``shard_slices`` (the port's placement) gives rank r the slice that
    the reference's NamedSharding puts on device r, for split axes alone
    and combined (major first)."""
    mesh = make_mesh(("data", "fsdp", "tp"), (2, 2, 2),
                     devices=list(range(8)))
    jmesh = jmake_mesh(axes=("data", "fsdp", "tp"), shape=(2, 2, 2),
                       devices=jax.devices("cpu")[:8])
    shape = (16, 8)
    want = NamedSharding(jmesh, JP(*spec)).devices_indices_map(shape)
    whole = np.arange(np.prod(shape)).reshape(shape)
    for dev, idx in want.items():
        r = int(np.argwhere(np.asarray(jmesh.devices) == dev)[0].sum() * 0
                + list(np.asarray(jmesh.devices).flat).index(dev))
        got = shard_slices(shape, P(*spec), mesh, mesh.coords(r))
        np.testing.assert_array_equal(whole[got], whole[idx])
    local = place_value(torch.tensor(whole), lay_sharding(mesh, spec))
    np.testing.assert_array_equal(local.numpy(),
                                  whole[shard_slices(shape, P(*spec), mesh)])


def lay_sharding(mesh, spec):
    from mxnet_tpu_torch.parallel import Sharding
    return Sharding(mesh, P(*spec))


# -- the env knobs ---------------------------------------------------------

def test_parse_mesh_axes_and_layout_from_env(monkeypatch):
    from mxnet_tpu.parallel.speclayout import parse_mesh_axes as jparse
    for text, fsdp in [("data,fsdp=2,tp=2", None), ("data,fsdp", 4),
                       ("dp,tp", None), ("data,fsdp=0", None),
                       (" batch , fsdp=3 ", 2)]:
        assert parse_mesh_axes(text, fsdp) == jparse(text, fsdp)
    assert parse_mesh_axes("data,fsdp=2,tp=2") == \
        (("data", "fsdp", "tp"), (-1, 2, 2))
    with pytest.raises(ValueError):
        parse_mesh_axes("")
    monkeypatch.delenv("MX_MESH_AXES", raising=False)
    monkeypatch.delenv("MX_FSDP", raising=False)
    assert layout_from_env() is None
    monkeypatch.setenv("MX_FSDP", "2")
    lay = layout_from_env(devices=list(range(8)))
    assert lay.fsdp == 2 and dict(lay.mesh.shape) == {"data": 4, "fsdp": 2}
    monkeypatch.setenv("MX_MESH_AXES", "data,fsdp=2,tp=2")
    lay = layout_from_env(devices=list(range(8)))
    assert lay.tp == 2 and lay.fsdp == 2


def test_env_catalog_has_mesh_knobs():
    from mxnet_tpu.base import ENV_CATALOG as JCAT
    from mxnet_tpu_torch.base import ENV_CATALOG
    for k in ("MX_MESH_AXES", "MX_FSDP", "MX_STEP_COMPILE", "MX_STEP_SCAN"):
        assert k in ENV_CATALOG and ENV_CATALOG[k][0] == JCAT[k][0], k


def test_mesh_for_world_is_the_reference_s(monkeypatch):
    from mxnet_tpu.parallel import mesh_for_world as jmfw
    from mxnet_tpu_torch.parallel import mesh_for_world
    monkeypatch.delenv("MX_MESH_AXES", raising=False)
    for fsdp, world in [(None, 4), ("2", 4), ("2", 8), ("4", 3)]:
        if fsdp is None:
            monkeypatch.delenv("MX_FSDP", raising=False)
        else:
            monkeypatch.setenv("MX_FSDP", fsdp)
        want = jmfw(world, devices=jax.devices("cpu")[:8])
        got = mesh_for_world(world, devices=list(range(8)))
        assert dict(got.shape) == dict(want.shape), (fsdp, world)
    with pytest.raises(ValueError):
        mesh_for_world(0, devices=list(range(8)))


# -- the one-process compiled step -------------------------------------------

OPTS = {"sgd": {"learning_rate": 0.05, "momentum": 0.9},
        "adam": {"learning_rate": 0.01}}


def _build(opt="sgd", **kw):
    jmx.random.seed(0)
    jnet = jnn.Sequential()
    jnet.add(jnn.Dense(16, in_units=8, activation="relu"))
    jnet.add(jnn.Dense(4, in_units=16))
    jnet.initialize(jmx.init.Xavier())
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(OPTS[opt]),
                         kvstore="ici")
    tnet = tnn.Sequential()
    tnet.add(tnn.Dense(16, in_units=8, activation="relu"))
    tnet.add(tnn.Dense(4, in_units=16))
    tnet.load_dict({k: torch.tensor(p.data().asnumpy()) for k, p in
                    jnet.collect_params().items()}, device="cpu")
    ttr = tgluon.Trainer(tnet.collect_params(), opt, dict(OPTS[opt]), **kw)
    return jnet, jtr, tnet, ttr


def _close(got, want, tol=1e-4):
    assert float(np.abs(got - want).max()) <= \
        tol * float(np.abs(want).max())


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_compiled_step_matches_the_reference_s(opt):
    jnet, jtr, tnet, ttr = _build(opt)
    js = jtr.make_compiled_step(jnet, jgluon.loss.L2Loss())
    ts = ttr.make_compiled_step(tnet, tgluon.loss.L2Loss())
    for _ in range(4):
        a = js.step(jnd.array(X), jnd.array(Y), batch_size=16).asnumpy()
        b = ts.step(tnd.array(X, ctx=tmx.cpu()), tnd.array(Y, ctx=tmx.cpu()),
                    batch_size=16).asnumpy()
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-7)
    assert ts.compiled and ts.fallback_reason is None
    for k, p in tnet.collect_params().items():
        _close(p.data().asnumpy(), jnet.collect_params()[k].data().asnumpy())


@pytest.mark.parametrize("accum", [1, 2])
def test_compiled_window_matches_the_reference_s(accum):
    jnet, jtr, tnet, ttr = _build("adam")
    Xw, Yw = np.stack([X] * 4), np.stack([Y] * 4)
    a = jtr.make_compiled_step(jnet, jgluon.loss.L2Loss()).run_window(
        jnd.array(Xw), jnd.array(Yw), accum=accum).asnumpy()
    b = ttr.make_compiled_step(tnet, tgluon.loss.L2Loss()).run_window(
        tnd.array(Xw, ctx=tmx.cpu()), tnd.array(Yw, ctx=tmx.cpu()),
        accum=accum).asnumpy()
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-7)
    for k, p in tnet.collect_params().items():
        _close(p.data().asnumpy(), jnet.collect_params()[k].data().asnumpy())


def test_compiled_and_eager_steps_interoperate_mid_run(tmp_path):
    """A compiled step, an eager Trainer.step, a save_states / load_states
    round trip, then a compiled step again: the reference's trajectory."""
    jnet, jtr, tnet, ttr = _build("adam")
    js = jtr.make_compiled_step(jnet, jgluon.loss.L2Loss())
    ts = ttr.make_compiled_step(tnet, tgluon.loss.L2Loss())
    jx, jy = jnd.array(X), jnd.array(Y)
    tx, ty = tnd.array(X, ctx=tmx.cpu()), tnd.array(Y, ctx=tmx.cpu())
    js.step(jx, jy)
    ts.step(tx, ty)
    with jmx.autograd.record():
        loss = jgluon.loss.L2Loss()(jnet(jx), jy)
    loss.backward()
    jtr.step(16)
    with tmx.autograd.record():
        loss = tgluon.loss.L2Loss()(tnet(tx), ty)
    loss.backward()
    ttr.step(16)
    fname = str(tmp_path / "states")
    ttr.save_states(fname)
    ttr.load_states(fname)
    a = js.step(jx, jy).asnumpy()
    b = ts.step(tx, ty).asnumpy()
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-7)
    for k, p in tnet.collect_params().items():
        _close(p.data().asnumpy(), jnet.collect_params()[k].data().asnumpy())


def _fallback_cases():
    """The reasons one process can reach; a server-side optimizer and a
    multi-process store without a layout need a process group
    (``tests/test_torch_tensor_parallel.py``)."""
    def lamb(ttr, tnet):
        return tgluon.Trainer(tnet.collect_params(), "lamb",
                              {"learning_rate": 0.01})

    def add(ttr, tnet):
        tnet[0].weight.grad_req = "add"
        return ttr
    return [("no_tree_kernel", lamb, "no pure tree kernel"),
            ("grad_req_add", add, "grad_req='add'")]


@pytest.mark.parametrize("name,make,reason", _fallback_cases(),
                         ids=[c[0] for c in _fallback_cases()])
def test_compiled_step_falls_back_with_the_reference_s_reason(name, make,
                                                              reason):
    _, _, tnet, ttr = _build("sgd")
    tr = make(ttr, tnet)
    ts = tr.make_compiled_step(tnet, tgluon.loss.L2Loss())
    with pytest.warns(UserWarning, match="falling back"):
        loss = ts.step(tnd.array(X, ctx=tmx.cpu()),
                       tnd.array(Y, ctx=tmx.cpu()))
    assert not ts.compiled and reason in ts.fallback_reason
    assert np.isfinite(loss.asnumpy()).all()
    if name == "grad_req_add":
        with pytest.raises(MXNetError, match="no eager fallback"):
            ts.run_window(tnd.array(np.stack([X] * 2), ctx=tmx.cpu()),
                          tnd.array(np.stack([Y] * 2), ctx=tmx.cpu()),
                          accum=2)


def test_a_layout_the_step_cannot_honour_raises():
    """A mesh of several ranks outside a process group, and a batch that
    does not split over data x fsdp, raise and name why; nothing falls
    back to a replicated step."""
    _, _, tnet, ttr = _build("sgd")
    lay = SpecLayout.infer(make_mesh(("data", "fsdp"), (1, 2),
                                     devices=[0, 1]))
    ts = ttr.make_compiled_step(tnet, tgluon.loss.L2Loss(), layout=lay)
    with pytest.raises(MXNetError, match="process groups"):
        ts.step(tnd.array(X, ctx=tmx.cpu()), tnd.array(Y, ctx=tmx.cpu()))
    _, _, tnet, ttr = _build("sgd")
    lay = SpecLayout.infer(make_mesh(("data", "fsdp"), (1, 1),
                                     devices=[0]))
    ts = ttr.make_compiled_step(tnet, tgluon.loss.L2Loss(), layout=lay)
    ts.step(tnd.array(X, ctx=tmx.cpu()), tnd.array(Y, ctx=tmx.cpu()))
    assert ts.compiled


def test_step_env_helpers(monkeypatch):
    from mxnet_tpu_torch.step import (metric_cache_key, metric_trace_kernel,
                                      scan_window, step_compile_enabled)
    from mxnet_tpu.step import scan_window as jscan
    for v in ("0", "4", "x", "-3"):
        monkeypatch.setenv("MX_STEP_SCAN", v)
        assert scan_window() == jscan()
    monkeypatch.setenv("MX_STEP_COMPILE", "1")
    assert step_compile_enabled()
    assert metric_trace_kernel(None) is None
    assert metric_cache_key(None, None) is None
    assert metric_trace_kernel(tmx.metric.MSE()) is None
