"""Tensor and FSDP parallelism of the port against the reference, on the
CPU, across four ranks.

The port's side is one launcher job: ``python -m
mxnet_tpu_torch.tools.launch -n 4`` over a worker script, four gloo ranks
with one intra-op thread each, started by a module fixture.  Each rank
runs every case on its own shard - ``TrainStep`` over (dp, tp) meshes and
``Trainer.make_compiled_step`` over (data, fsdp) and (data, fsdp, tp)
SpecLayouts, the int8 reduce-scatter exchange, windows, metrics,
checkpoints across layouts - and writes what it got to ``.npz``.  The
reference runs in the pytest process on the fake 8-device CPU mesh, on
meshes of the same shapes, with the same numpy inputs and the parameters
copied by name from the reference's own initialisation.  Tolerances are
the reference's: rtol 2e-4 on losses; parameters within 1e-4 x
max|ref|.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import gluon, nd
from mxnet_tpu.gluon import nn
from mxnet_tpu.parallel import (SpecLayout as JSpecLayout, TrainStep as
                                JTrainStep, make_mesh as jmake_mesh,
                                tp_alternation_specs as jtp_specs)

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 300
RNG = np.random.RandomState(7)
X = RNG.randn(16, 8).astype(np.float32)
Y = RNG.randn(16, 4).astype(np.float32)
LOSS = gluon.loss.L2Loss()
OPTS = {"sgd": {"learning_rate": 0.05, "momentum": 0.9},
        "adam": {"learning_rate": 0.01}}
LAYOUTS = {"dp_fsdp": (("data", "fsdp"), (2, 2)),
           "dp_fsdp_tp": (("data", "fsdp", "tp"), (1, 2, 2))}

_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import (SpecLayout, TrainStep,
                                      end_process_group, init_process_group,
                                      layout_from_env, make_mesh,
                                      mesh_for_world, tp_alternation_specs)
from mxnet_tpu_torch.parallel.speclayout import P, place_value

init_process_group(device="cpu")
RANK, OUT = dist.get_rank(), sys.argv[1]
W = dict(np.load(os.path.join(OUT, "weights.npz")))
res = {}
mx.cpu().__enter__()


def put(name, x):
    res[name] = x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def weights(prefix):
    return {k[len(prefix):]: torch.tensor(v) for k, v in W.items()
            if k.startswith(prefix)}


RNG = np.random.RandomState(7)
X = RNG.randn(16, 8).astype(np.float32)
Y = RNG.randn(16, 4).astype(np.float32)
OPTS = %(opts)s
LAYOUTS = %(layouts)s


# -- TrainStep over (dp, tp) --------------------------------------------------
def make_net(conv):
    net = nn.HybridSequential()
    if conv == "bn":
        net.add(nn.Conv2D(4, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten())
    elif conv:
        net.add(nn.Conv2D(4, 3, padding=1, activation="relu"),
                nn.MaxPool2D(), nn.Flatten())
    net.add(nn.Dense(16, activation="relu"), nn.Dense(10))
    net.initialize(device="cpu")
    net(nd.zeros((1, 3, 8, 8) if conv else (1, 8)))
    net.load_dict(weights("bn." if conv == "bn" else "conv." if conv
                          else "mlp."), device="cpu")
    return net


def ce(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def tp_case(name, conv, dp, tp, rules=None):
    mesh = make_mesh(("dp", "tp"), (dp, tp))
    net = make_net(conv)
    step = TrainStep(net, ce, mesh, device="cpu", learning_rate=0.1,
                     momentum=0.9, tp_rules=rules)
    rng = np.random.RandomState(1)
    x = rng.randn(16, *((3, 8, 8) if conv else (8,))).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.int32)
    d = mesh.axis_index("dp")
    n = 16 // dp
    losses = [float(step(x[d * n:(d + 1) * n], y[d * n:(d + 1) * n]))
              for _ in range(3)]
    put(name + "_losses", losses)
    put(name + "_specs", json.dumps({k: list(v) for k, v in
                                     step.specs.items()}))
    for k, v in step.gathered().items():
        put(name + "_param_" + k, v)
    return step


step = tp_case("tp_dense", False, 2, 2)
# its checkpoint (split leaves saved as shards) restored by axis name
# into a dp-only step of four ranks and into a (dp, tp) step again
step.save(os.path.join(OUT, "ck_tp"))
want = step.gathered()
for name, shape in (("dp4", (4, 1)), ("tp2", (2, 2))):
    other = TrainStep(make_net(False), ce, make_mesh(("dp", "tp"), shape),
                      device="cpu")
    other.restore(os.path.join(OUT, "ck_tp"))
    got = other.gathered()
    put("tp_restore_" + name, all(torch.equal(got[k], want[k])
                                  for k in want))
tp_case("tp_conv", True, 1, 4)
tp_case("tp_rules", False, 2, 2, rules={"0.weight": ("tp", None)})
# a BatchNorm over (dp, tp): the statistics of the batch split over dp,
# which every tp rank of a line holds alike
tp_case("tp_bn", "bn", 2, 2)


# -- the sharded compiled step ------------------------------------------------
def build(seed=0, opt="sgd", compress=None, kvstore="device"):
    net = nn.Sequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"))
    net.add(nn.Dense(4, in_units=16))
    net.load_dict(weights("small%%d." %% seed), device="cpu")
    tr = gluon.Trainer(net.collect_params(), opt, dict(OPTS[opt]),
                       kvstore=kvstore, compression_params=compress)
    return net, tr


def layout(name):
    axes, shape = LAYOUTS[name]
    return SpecLayout.infer(make_mesh(axes, shape))


def traj(step, steps=4):
    out = [float(np.mean(step.step(nd.array(X), nd.array(Y),
                                   batch_size=16).asnumpy()))
           for _ in range(steps)]
    assert step.compiled, step.fallback_reason
    return out


for opt in OPTS:
    for lname in LAYOUTS:
        net, tr = build(opt=opt)
        step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                                     layout=layout(lname))
        put("sharded_%%s_%%s" %% (opt, lname), traj(step))
        plan = step._plan()
        put("sharded_%%s_%%s_specs" %% (opt, lname), json.dumps(
            {k: list(v) for k, v in plan["storage"].items()}))
        put("sharded_%%s_%%s_shapes" %% (opt, lname), json.dumps(
            {n: list(p.shape) for n, p in net.named_parameters()}))
        step.release()
        for n, p in net.named_parameters():
            put("sharded_%%s_%%s_param_%%s" %% (opt, lname, n), p)

# an Embedding (vocab split over fsdp x tp, used vocab-parallel) and a
# Dense on its rows
IDS = np.random.RandomState(3).randint(0, 32, (16, 3)).astype(np.float32)
Y3 = np.random.RandomState(4).randn(16, 3, 4).astype(np.float32)
for lname in LAYOUTS:
    net = nn.Sequential()
    net.add(nn.Embedding(32, 8), nn.Dense(4, in_units=8, flatten=False))
    net.load_dict(weights("emb."), device="cpu")
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPTS["sgd"]))
    step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                                 layout=layout(lname))
    put("emb_" + lname, [float(np.mean(step.step(
        nd.array(IDS), nd.array(Y3), batch_size=16).asnumpy()))
        for _ in range(4)])

# the collectives' transposes, over the tp lines of a (dp, tp) mesh
from mxnet_tpu_torch.parallel import collectives as C
mesh = make_mesh(("dp", "tp"), (2, 2))
t = mesh.axis_index("tp")
w = torch.arange(16.0).reshape(4, 4)
checks = []
for bwd, factor in (("slice", 1.0), ("reduce_scatter", 2.0)):
    x = torch.full((2, 4), float(RANK), requires_grad=True)
    y = C.all_gather(x, "tp", 0, mesh, backward=bwd)
    (y * w).sum().backward()
    line = mesh.line("tp")
    checks.append(torch.equal(y, torch.cat([torch.full((2, 4), float(r))
                                            for r in line])))
    checks.append(torch.equal(x.grad, factor * w[2 * t:2 * t + 2]))
x = torch.full((4, 4), float(RANK + 1), requires_grad=True)
y = C.reduce_scatter(x, "tp", 0, mesh)
(y * w[:2]).sum().backward()
checks.append(torch.equal(y, torch.full((2, 4), float(
    sum(r + 1 for r in mesh.line("tp"))))))
checks.append(torch.equal(x.grad, torch.cat([w[:2], w[:2]])))
x = w.clone().requires_grad_(True)
y = C.axis_slice(x, "tp", 1, mesh)
(y * 3).sum().backward()
checks.append(torch.equal(y, w[:, 2 * t:2 * t + 2]))
checks.append(torch.equal(x.grad, torch.full((4, 4), 3.0)))
put("collective_checks", checks)

# the int8 reduce-scatter exchange
net, tr = build(compress={"type": "int8"})
step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                             layout=layout("dp_fsdp"))
put("int8", traj(step, 5))
plan = step._plan()
ex = plan["exchange"]
wk, shp, _ = ex.residual_specs[0]
put("int8_residual", json.dumps({
    "shape": list(shp), "spec": list(ex.residual_shardings[0].spec),
    "local": list(plan["gc"].peek_residual(wk, ex.residual_local_shape(0))
                  .shape)}))

# a window against per-step
net, tr = build()
step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                             layout=layout("dp_fsdp"))
win = step.run_window(nd.array(np.stack([X] * 3)),
                      nd.array(np.stack([Y] * 3)))
put("window", win.asnumpy().reshape(3, -1).mean(axis=1))
net, tr = build()
step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                             layout=layout("dp_fsdp"))
first = traj(step, 1)
step.invalidate()                   # plans anew over the adopted shards
put("per_step", first + traj(step, 2))
net, tr = build()
step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                             layout=layout("dp_fsdp"))
put("accum", step.run_window(nd.array(np.stack([X] * 4)),
                             nd.array(np.stack([Y] * 4)), accum=2).asnumpy())

# the metric
net, tr = build()
metric = mx.metric.MSE()
step = tr.make_compiled_step(net, gluon.loss.L2Loss(), metric=metric,
                             layout=layout("dp_fsdp"))
traj(step, 3)
put("metric", metric.get()[1])

# external set_data between sharded steps
net, tr = build()
step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                             layout=layout("dp_fsdp"))
traj(step, 1)
step.release()
p0 = list(net.collect_params().values())[0]
p0.set_data(nd.zeros(p0.shape))
traj(step, 1)
step.release()
put("set_data", float(np.abs(p0.data().asnumpy()).sum()))

# per-rank bytes of parameters and optimizer state
net, tr = build(kvstore=None)
step = tr.make_compiled_step(net, gluon.loss.L2Loss())
traj(step, 1)
put("bytes_1", step.state_bytes())
for fsdp in (2, 4):
    net, tr = build()
    step = tr.make_compiled_step(net, gluon.loss.L2Loss(),
                                 layout=SpecLayout.infer(make_mesh(
                                     ("data", "fsdp"), (4 // fsdp, fsdp))))
    traj(step, 1)
    put("bytes_%%d" %% fsdp, step.state_bytes())

# checkpoints across layouts, both ways
for opt, first in [(o, f) for o in sorted(OPTS)
                   for f in ("sharded", "replicated")]:
    ck = os.path.join(OUT, "ck_%%s_%%s" %% (opt, first))
    net, tr = build(opt=opt,
                    kvstore=None if first == "replicated" else "device")
    step = tr.make_compiled_step(
        net, gluon.loss.L2Loss(),
        layout=layout("dp_fsdp") if first == "sharded" else None)
    traj(step, 2)
    step.save(ck)
    if first == "sharded":
        doc = json.load(open(ck + ".speclayout.json"))
        put("ck_doc", json.dumps(doc))
    net_b, tr_b = build(seed=1, opt=opt,
                        kvstore="device" if first == "replicated" else None)
    step_b = tr_b.make_compiled_step(
        net_b, gluon.loss.L2Loss(),
        layout=None if first == "sharded" else layout("dp_fsdp"))
    step_b.restore(ck)
    traj(step_b, 2)
    step_b.release()
    for n, p in net_b.named_parameters():
        put("ck_%%s_%%s_%%s" %% (opt, first, n), p)

# resume_or_init(mesh=)
from mxnet_tpu_torch.checkpoint import (CheckpointManager, resume_or_init,
                                        save_sharded)
lay = layout("dp_fsdp")
direct = os.path.join(OUT, "mgr")
state, start, mgr = resume_or_init(direct, lambda: {"w": torch.zeros(16)})
put("resume_start0", start)
mgr.save(0, {"w": place_value(torch.arange(16.0), lay.sharding(P("fsdp")))},
         mesh=lay.mesh, specs={"w": P("fsdp")})
state2, start2, _ = resume_or_init(direct, lambda: {"w": torch.zeros(16)},
                                   mesh=lay.mesh, manager=mgr)
put("resume_start1", start2)
put("resume_w", state2["w"])

# the sidecar's JSON
p = os.path.join(OUT, "ck_sidecar")
save_sharded(p, {"w": place_value(torch.zeros(16, 4),
                                  lay.sharding(P(None, "fsdp")))},
             mesh=lay.mesh, specs={"w": P(None, "fsdp")})
put("sidecar", open(p + ".speclayout.json").read())

# the exchange body's layout variant against the replicated one
from mxnet_tpu_torch import kvstore as kvs
shapes = [(32,), (32, 8), (4,), (4, 32)]
templates = [nd.zeros(s) for s in shapes]
kv = kvs.create("local")
kv.set_gradient_compression({"type": "int8"})
ex = kv.build_exchange_body(list(range(4)), templates, layout=lay)
mine = [torch.tensor(np.random.RandomState(100 + RANK).randn(*s)
                     .astype(np.float32)) for s in shapes]
res_local = [torch.zeros(ex.residual_local_shape(i))
             for i in range(len(ex.residual_specs))]
o1, _ = ex(mine, res_local)
kv2 = kvs.create("local")
kv2.set_gradient_compression({"type": "int8"})
ex2 = kv2.build_exchange_body(list(range(4)), templates)
whole = [sum(torch.tensor(np.random.RandomState(100 + r).randn(*s)
                          .astype(np.float32)) for r in range(4))
         for s in shapes]
o2, _ = ex2(whole, [torch.zeros(s) for _, s, _ in ex2.residual_specs])
put("ex_body_diff", max(float((a - b).abs().max()) for a, b in zip(o1, o2)))
put("ex_body_rs", json.dumps({"shape": list(ex.residual_specs[0][1]),
                              "spec": list(ex.residual_shardings[0].spec),
                              "n": len(ex.residual_specs)}))
for i, o in enumerate(o1):
    put("ex_body_out%%d" %% i, o)

# the fall-backs that need a process group
net, tr = build(opt="sgd")
tr_kv = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05},
                      update_on_kvstore=True)
for name, trainer in (("multi_process", tr), ("update_on_kvstore", tr_kv)):
    step = trainer.make_compiled_step(net, gluon.loss.L2Loss())
    # batch_size 1: a store that runs the optimizer keeps its first
    # rescale (1.0), as the reference's Trainer checks it
    loss = step.step(nd.array(X), nd.array(Y), batch_size=1)
    put("fallback_" + name, json.dumps([step.compiled,
                                        step.fallback_reason]))
    put("fallback_loss_" + name, loss.asnumpy())

# MX_MESH_AXES / MX_FSDP and mesh_for_world
os.environ.pop("MX_MESH_AXES", None)
os.environ["MX_FSDP"] = "2"
lay = layout_from_env()
put("env_fsdp", json.dumps(dict(lay.mesh.shape)))
os.environ["MX_MESH_AXES"] = "data,fsdp=2,tp=2"
lay = layout_from_env()
put("env_axes", json.dumps([dict(lay.mesh.shape), lay.tp, lay.fsdp]))
os.environ.pop("MX_MESH_AXES")
os.environ.pop("MX_FSDP")
put("world2", json.dumps(dict(mesh_for_world(2).shape)))

np.savez(os.path.join(OUT, "rank%%d.npz" %% RANK), **res)
bad = [m for m in sys.modules if m in ("jax", "mxnet_tpu")
       or m.startswith(("jax.", "mxnet_tpu."))]
assert not bad, bad
print("CLEAN rank", RANK, flush=True)
end_process_group(0)
''' % {"opts": repr(OPTS), "layouts": repr(LAYOUTS)}


def _devices(n=8):
    return jax.devices("cpu")[:n]


def _make_net(seed=0, conv=False):
    """tests/test_parallel.py's net (``conv="bn"``: a BatchNorm after its
    convolution, which has no bias: the BatchNorm would make its gradient
    0 up to rounding)."""
    mx.random.seed(seed)
    np.random.seed(seed)
    net = nn.HybridSequential()
    if conv == "bn":
        net.add(nn.Conv2D(4, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten())
    elif conv:
        net.add(nn.Conv2D(4, 3, padding=1, activation="relu"),
                nn.MaxPool2D(), nn.Flatten())
    net.add(nn.Dense(16, activation="relu"))
    net.add(nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net(nd.zeros((1,) + ((3, 8, 8) if conv else (8,))))
    return net


def _build(seed=0, opt="sgd", compress=None, ctxs=None, kvstore="ici"):
    """tests/test_speclayout.py's net and Trainer."""
    mx.random.seed(seed)
    net = nn.Sequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"))
    net.add(nn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier(), ctx=ctxs)
    tr = gluon.Trainer(net.collect_params(), opt, dict(OPTS[opt]),
                       kvstore=kvstore, compression_params=compress)
    return net, tr


IDS = np.random.RandomState(3).randint(0, 32, (16, 3)).astype(np.float32)
Y3 = np.random.RandomState(4).randn(16, 3, 4).astype(np.float32)


def _emb_net():
    mx.random.seed(0)
    net = nn.Sequential()
    net.add(nn.Embedding(32, 8))
    net.add(nn.Dense(4, in_units=8, flatten=False))
    net.initialize(mx.init.Xavier())
    return net


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _layout(name=None, axes=None, shape=None):
    if name is not None:
        axes, shape = LAYOUTS[name]
    n = int(np.prod(shape))
    return JSpecLayout.infer(jmake_mesh(axes=axes, shape=shape,
                                        devices=_devices(n)))


def _traj(step, steps=4):
    out = [float(np.mean(step.step(nd.array(X), nd.array(Y),
                                   batch_size=16).asnumpy()))
           for _ in range(steps)]
    assert step.compiled, step.fallback_reason
    return out


class _Job:
    def __init__(self, tmp):
        self.tmp = tmp
        w = {}
        for k, v in _params(_make_net(0)).items():
            w["mlp." + k] = v
        for k, v in _params(_make_net(0, conv=True)).items():
            w["conv." + k] = v
        for k, v in _params(_make_net(0, conv="bn")).items():
            w["bn." + k] = v
        for seed in (0, 1):
            for k, v in _params(_build(seed)[0]).items():
                w["small%d.%s" % (seed, k)] = v
        for k, v in _params(_emb_net()).items():
            w["emb." + k] = v
        np.savez(os.path.join(tmp, "weights.npz"), **w)
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        for k in ("MX_MESH_AXES", "MX_FSDP", "MX_GRAD_COMPRESS"):
            env.pop(k, None)
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
             str(WORLD), "--launcher", "local", "--", sys.executable,
             script, tmp], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.ranks = None

    def get(self):
        if self.ranks is None:
            try:
                out, err = self.proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, err = self.proc.communicate()
            assert self.proc.returncode == 0, (out[-3000:], err[-6000:])
            assert out.count("CLEAN rank") == WORLD, out
            self.ranks = [dict(np.load(os.path.join(self.tmp,
                                                    "rank%d.npz" % r)))
                          for r in range(WORLD)]
        return self.ranks

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    j = _Job(str(tmp_path_factory.mktemp("tensor_parallel")))
    yield j
    j.stop()


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()) / scale)


# -- TrainStep over (dp, tp): tests/test_parallel.py --------------------------

def _loss_fn(logits, labels):
    logp = jax.nn.log_softmax(logits, axis=-1)
    onehot = jax.nn.one_hot(labels, logits.shape[-1], dtype=logp.dtype)
    return -jnp.mean(jnp.sum(logp * onehot, axis=-1))


def _ref_tp(conv, mesh, tp_rules=None):
    net = _make_net(0, conv=conv)
    step = JTrainStep(net, _loss_fn, mesh, learning_rate=0.1, momentum=0.9,
                      tp_rules=tp_rules)
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(16, *((3, 8, 8) if conv else (8,)))
                    .astype(np.float32))
    y = jnp.asarray(rng.randint(0, 10, 16).astype(np.int32))
    losses = [float(step(x, y)) for _ in range(3)]
    return losses, {k: np.asarray(v) for k, v in step.params.items()}


@pytest.mark.parametrize("case,conv,shape,rules", [
    # dp x tp against dp only (test_dp_tp_matches_dp_only)
    ("tp_dense", False, (2, 2), None),
    # a conv, then the Denses, at tp = 4
    # (test_tp_non_alternating_architecture_correct)
    ("tp_conv", True, (1, 4), None),
    # explicit rules (test_shard_params_tp_explicit_rules)
    ("tp_rules", False, (2, 2), {"0.weight": JP("tp", None)}),
    # a BatchNorm on the global batch's statistics over dp x tp
    ("tp_bn", "bn", (2, 2), None),
])
def test_trainstep_dp_tp_matches_reference(job, case, conv, shape, rules):
    dp_only = jmake_mesh(axes=("dp",), devices=_devices(4))
    want, want_params = _ref_tp(conv, dp_only)
    sharded, _ = _ref_tp(conv, jmake_mesh(axes=("dp", "tp"), shape=shape,
                                          devices=_devices(4)),
                         tp_rules=rules)
    np.testing.assert_allclose(sharded, want, rtol=2e-4)
    for rank in job.get():
        np.testing.assert_allclose(rank[case + "_losses"], want, rtol=2e-4)
        for k, v in want_params.items():
            _close(rank[case + "_param_" + k], v)


def test_trainstep_checkpoint_reshards_by_axis_name(job):
    """A (dp, tp) step's checkpoint, its tp-split leaves saved as shards,
    restores bitwise into a dp-only step of four ranks (whole leaves) and
    into a (dp, tp) step."""
    for rank in job.get():
        assert bool(rank["tp_restore_dp4"]) and bool(rank["tp_restore_tp2"])


def test_trainstep_default_alternation_and_rules_specs_are_the_reference_s(
        job):
    """The step's parameter specs, by name, are the reference's
    ``tp_alternation_specs`` (test_shard_params_tp_default_alternation,
    the explicit-rules case): columns and rows in turn, the rest
    replicated; under rules, what no rule matches replicates."""
    for case, conv, shape, rules in (
            ("tp_dense", False, (2, 2), None),
            ("tp_conv", True, (1, 4), None),
            ("tp_rules", False, (2, 2), {"0.weight": JP("tp", None)})):
        net = _make_net(0, conv=conv)
        mesh = jmake_mesh(axes=("dp", "tp"), shape=shape,
                          devices=_devices(4))
        want = {k: list(tuple(v)) for k, v in
                jtp_specs(_params(net), mesh, rules=rules).items()}
        got = json.loads(str(job.get()[0][case + "_specs"]))
        assert got == want, (case, got, want)
    assert got["0.weight"] == ["tp", None] and got["0.bias"] == []


# -- the sharded compiled step: tests/test_speclayout.py ---------------------

_REF = {}


def _ref_traj(opt, steps=4):
    if opt not in _REF:
        net, tr = _build(opt=opt)
        _REF[opt] = _traj(tr.make_compiled_step(net, LOSS), steps)
    return _REF[opt]


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("lname", sorted(LAYOUTS))
def test_sharded_matches_replicated(job, opt, lname):
    ref = _ref_traj(opt)
    net, tr = _build(opt=opt)
    lay = _layout(lname)
    sharded = _traj(tr.make_compiled_step(net, LOSS, layout=lay))
    np.testing.assert_allclose(sharded, ref, rtol=2e-4)
    want_specs = {k: list(tuple(v)) for k, v in lay.resolve(net).items()}
    want_params = _params(net)
    for rank in job.get():
        key = "sharded_%s_%s" % (opt, lname)
        np.testing.assert_allclose(rank[key], sharded, rtol=2e-4)
        specs = json.loads(str(rank[key + "_specs"]))
        assert specs == {k: [list(e) if isinstance(e, tuple) else e
                             for e in v] for k, v in want_specs.items()}
        assert any("fsdp" in str(s) for s in specs.values()), specs
        for k, v in want_params.items():
            _close(rank[key + "_param_" + k], v)


@pytest.mark.parametrize("lname", sorted(LAYOUTS))
def test_sharded_embedding_matches_the_reference_s(job, lname):
    """An Embedding whose table is split over fsdp x tp (used
    vocab-parallel over tp, through the whole value from its storage
    spec) and a Dense on its rows: the reference's sharded trajectory."""
    net = _emb_net()
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPTS["sgd"]),
                       kvstore="ici")
    step = tr.make_compiled_step(net, LOSS, layout=_layout(lname))
    want = [float(np.mean(step.step(nd.array(IDS), nd.array(Y3),
                                    batch_size=16).asnumpy()))
            for _ in range(4)]
    for rank in job.get():
        np.testing.assert_allclose(rank["emb_" + lname], want, rtol=2e-4)


def test_collectives_have_jax_s_transposes(job):
    """all_gather's backward is a slice or a reduce-scatter as asked,
    reduce_scatter's an all-gather, axis_slice's an all-gather."""
    for rank in job.get():
        assert all(rank["collective_checks"]), rank["collective_checks"]


def test_sharded_int8_matches_replicated_quantized(job):
    """The reduce-scatter int8 exchange reproduces the reference's
    replicated two-copy quantized trajectory, and its residuals live split
    over fsdp at the padded grain."""
    net_r, tr_r = _build(compress={"type": "int8"},
                         ctxs=[mx.cpu(0), mx.cpu(1)])
    ref = _traj(tr_r.make_compiled_step(net_r, LOSS), steps=5)
    net_s, tr_s = _build(compress={"type": "int8"})
    step = tr_s.make_compiled_step(net_s, LOSS, layout=_layout("dp_fsdp"))
    np.testing.assert_allclose(_traj(step, 5), ref, rtol=2e-4)
    plan = step._plan()
    wk, shp, _dt = plan["exchange"].residual_specs[0]
    for rank in job.get():
        np.testing.assert_allclose(rank["int8"], ref, rtol=2e-4)
        res = json.loads(str(rank["int8_residual"]))
        assert res["shape"] == list(shp) and res["spec"] == ["fsdp"]
        assert res["shape"][0] % (256 * 2) == 0
        assert res["local"] == [res["shape"][0] // 2]


def test_sharded_window_matches_per_step(job):
    lay = _layout("dp_fsdp")
    net_p, tr_p = _build()
    per = _traj(tr_p.make_compiled_step(net_p, LOSS, layout=lay), steps=3)
    net_a, tr_a = _build()
    acc = tr_a.make_compiled_step(net_a, LOSS, layout=lay).run_window(
        nd.array(np.stack([X] * 4)), nd.array(np.stack([Y] * 4)), accum=2)
    for rank in job.get():
        np.testing.assert_allclose(rank["window"], per, rtol=2e-4)
        np.testing.assert_allclose(rank["per_step"], per, rtol=2e-4)
        np.testing.assert_allclose(rank["accum"], acc.asnumpy(), rtol=2e-4,
                                   atol=1e-6)


def test_metric_folds_into_sharded_step(job):
    net, tr = _build()
    metric = mx.metric.MSE()
    step = tr.make_compiled_step(net, LOSS, metric=metric,
                                 layout=_layout("dp_fsdp"))
    for _ in range(3):
        step.step(nd.array(X), nd.array(Y), batch_size=16)
    want = metric.get()[1]
    for rank in job.get():
        assert np.isfinite(rank["metric"]) and float(rank["metric"]) > 0
        np.testing.assert_allclose(rank["metric"], want, rtol=2e-4)


def test_external_mutation_picked_up_sharded(job):
    for rank in job.get():
        assert float(rank["set_data"]) > 0


def test_per_rank_bytes_drop_linearly_with_fsdp(job):
    """Parameters plus optimizer state a rank holds: within 15 % of the
    ideal 1/fsdp at fsdp = 2 and 4."""
    for rank in job.get():
        base = int(rank["bytes_1"])
        for fsdp in (2, 4):
            ratio = base / int(rank["bytes_%d" % fsdp])
            assert 0.85 * fsdp <= ratio <= 1.15 * fsdp, (fsdp, ratio)


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("first", ["sharded", "replicated"])
def test_checkpoint_portability_sharded_vs_replicated(job, first, opt):
    """Two steps on one layout, a checkpoint, two more on the other
    (restored from different initial weights): the parameters of the
    uninterrupted four-step replicated run (Adam's too: the checkpoint
    carries the update counts its bias correction reads)."""
    net_u, tr_u = _build(opt=opt)
    _traj(tr_u.make_compiled_step(net_u, LOSS), steps=4)
    want = _params(net_u)
    for rank in job.get():
        for k, v in want.items():
            np.testing.assert_allclose(rank["ck_%s_%s_%s" % (opt, first, k)],
                                       v, rtol=2e-4, atol=1e-5)
    doc = json.loads(str(job.get()[0]["ck_doc"]))
    assert doc["schema"] == 1 and doc["mesh_axes"] == {"data": 2, "fsdp": 2}
    assert any(s for s in doc["leaf_specs"]), doc


def test_resume_or_init_mesh_kwarg(job):
    for r, rank in enumerate(job.get()):
        assert int(rank["resume_start0"]) == 0
        assert int(rank["resume_start1"]) == 1
        f = r % 2                       # the rank's fsdp index
        np.testing.assert_array_equal(rank["resume_w"],
                                      np.arange(16.0)[f * 8:(f + 1) * 8])


def test_sharded_checkpoint_sidecar_json_shape(job):
    doc = json.loads(str(job.get()[0]["sidecar"]))
    assert doc["schema"] == 1
    assert doc["mesh_axes"] == {"data": 2, "fsdp": 2}
    assert doc["leaf_specs"] == [[None, "fsdp"]]


def test_ici_exchange_body_layout_variant(job):
    """Padded to the block x fsdp grain, residuals split over fsdp, and
    exact (atol 1e-6) against the replicated body on zero residuals - the
    port's and the reference's."""
    from mxnet_tpu import kvstore as kvs
    shapes = [(32,), (32, 8), (4,), (4, 32)]
    kv = kvs.create("ici")
    kv.set_gradient_compression({"type": "int8"})
    templates = [nd.array(np.zeros(s, np.float32)) for s in shapes]
    ex = kv.build_exchange_body(list(range(4)), templates)
    whole = [sum(np.random.RandomState(100 + r).randn(*s).astype(np.float32)
                 for r in range(WORLD)) for s in shapes]
    o2, _ = jax.jit(lambda g, r: ex(g, r))(
        [jnp.asarray(w) for w in whole],
        [jnp.zeros(s, d) for _, s, d in ex.residual_specs])
    total = sum(int(np.prod(s)) for s in shapes)
    for rank in job.get():
        assert float(rank["ex_body_diff"]) <= 1e-6
        rs = json.loads(str(rank["ex_body_rs"]))
        assert rs["shape"][0] >= total and rs["shape"][0] % (256 * 2) == 0
        assert rs["spec"] == ["fsdp"] and rs["n"] == 1
        for i, want in enumerate(o2):
            np.testing.assert_allclose(rank["ex_body_out%d" % i],
                                       np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name,reason", [
    ("multi_process", "multi-process exchange needs the SPMD mesh lane"),
    ("update_on_kvstore", "server-side optimizer (update_on_kvstore)")])
def test_compiled_step_falls_back_in_a_process_group(job, name, reason):
    """Without a layout, a Trainer whose store spans the ranks falls back
    to the eager pipeline, as does one whose store runs the optimizer,
    with the reference's reasons."""
    for rank in job.get():
        compiled, why = json.loads(str(rank["fallback_" + name]))
        assert not compiled and reason in why
        assert np.isfinite(rank["fallback_loss_" + name]).all()


def test_parse_mesh_axes_and_layout_from_env_on_four_ranks(job):
    from mxnet_tpu.parallel.speclayout import parse_mesh_axes
    assert parse_mesh_axes("data,fsdp=2,tp=2") == \
        (("data", "fsdp", "tp"), (-1, 2, 2))
    rank = job.get()[0]
    assert json.loads(str(rank["env_fsdp"])) == {"data": 2, "fsdp": 2}
    shape, tp, fsdp = json.loads(str(rank["env_axes"]))
    assert shape == {"data": 1, "fsdp": 2, "tp": 2} and tp == 2 and \
        fsdp == 2
    assert json.loads(str(rank["world2"])) == {"data": 2}
