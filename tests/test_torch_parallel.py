"""Sequence, pipeline and expert parallelism of the port against the
reference, on the CPU.

The port's side is one launcher job: ``python -m
mxnet_tpu_torch.tools.launch -n 4`` over a worker script, four gloo ranks
with one thread each, started by a module fixture.  Each rank computes
every case on its own shard (meshes (dp=2, sp=2), sp=4, pp=4, ep=4) and
writes what it got to ``.npz``; the tests wait for the job only once they
have computed their reference, so the two sides run together.  The
reference runs in the pytest process on the fake 8-device CPU mesh, with
``mxnet_tpu.parallel`` (as ``tests/test_parallel.py`` calls it) or, for
the long-context LM, ``examples/train_long_context.py`` itself.  Inputs
come from numpy seeds.  Tolerances: 1e-4 fp32 (relative to the largest
reference entry where stated), attention 2e-3; where a case mirrors a
reference test the reference test's own tolerance is kept when tighter.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mxnet_tpu.parallel import (context_parallel_attention as jcpa,
                                make_mesh as jmake_mesh,
                                moe_parallel as jmoe_parallel,
                                pipeline_parallel as jpipeline_parallel,
                                top1_dispatch as jtop1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

WORLD = 4
TIMEOUT = 300

_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
import chip_smoke
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as att
from mxnet_tpu_torch.parallel import (TrainStep, collectives as C,
                                      context_parallel_attention,
                                      end_process_group,
                                      init_process_group, make_mesh,
                                      moe_parallel, pipeline_parallel)

init_process_group(device="cpu")
RANK, OUT = dist.get_rank(), sys.argv[1]
res, seqs = {}, {}


def put(name, x):
    res[name] = x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def shard(x, coords, b_axis=None, s_axis=None, mesh=None):
    """This rank's (batch, sequence) shard of a (B, L, ...) array."""
    if b_axis:
        n, i = mesh.axis_size(b_axis), coords[b_axis]
        x = x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
    n, i = mesh.axis_size(s_axis), coords[s_axis]
    return x[:, i * (x.shape[1] // n):(i + 1) * (x.shape[1] // n)]


dpsp = make_mesh(("dp", "sp"), (2, 2))
sp4 = make_mesh(("sp",), (4,))
pp4 = make_mesh(("pp",), (4,))
ep4 = make_mesh(("ep",), (4,))
c22 = dpsp.coords()
put("coords", [c22["dp"], c22["sp"]])
for axis in ("dp", "sp"):
    put("line_" + axis, dpsp.line(axis))
    total = torch.tensor([float(RANK)])
    dist.all_reduce(total, group=dpsp.group(axis))
    put("group_sum_" + axis, total)

# -- context parallelism (tests/test_parallel.py:190, :205, :235, :248) ----
np.random.seed(0)
q, k, v = (np.random.randn(2, 32, 8, 16).astype(np.float32)
           for _ in range(3))
for method in ("ring", "ulysses"):
    for causal in (False, True):
        with C.record() as ops:
            out = context_parallel_attention(
                *(t(shard(a, c22, "dp", "sp", dpsp)) for a in (q, k, v)),
                dpsp, causal=causal, method=method)
        put("cpa_%s_%s" % (method, causal), out)
        seqs["cpa_%s_%s" % (method, causal)] = ops

np.random.seed(1)
q, k, v = (t(np.random.randn(1, 16, 4, 8)) for _ in range(3))
c4 = sp4.coords()
leaves = [shard(a, c4, None, "sp", sp4).clone().requires_grad_(True)
          for a in (q, k, v)]
with C.record() as ops:
    context_parallel_attention(*leaves, sp4, causal=True).sum().backward()
seqs["ring_grad"] = ops
for name, leaf in zip("qkv", leaves):
    put("ring_grad_d" + name, leaf.grad)

np.random.seed(2)
q = np.random.randn(4, 64, 2, 8).astype(np.float32)
put("long_sp2", context_parallel_attention(
    *(t(shard(q, c22, "dp", "sp", dpsp)) for _ in range(3)), dpsp,
    causal=True))

try:
    z = torch.zeros(1, 4, 6, 4)
    context_parallel_attention(z, z, z, sp4, method="ulysses")
    put("ulysses_heads", "")
except ValueError as e:
    put("ulysses_heads", str(e))

# -- the kernel route at D = 64 (tests/test_parallel.py:442, :601) ---------
calls = {"fwd": 0, "bwd": 0}
real_fwd, real_bwd = att._flash_fwd, att._flash_bwd


def count_fwd(*a):
    calls["fwd"] += 1
    return real_fwd(*a)


def count_bwd(*a):
    calls["bwd"] += 1
    return real_bwd(*a)


att._flash_fwd, att._flash_bwd = count_fwd, count_bwd
rng = np.random.RandomState(0)
q, k, v, g = (t(rng.randn(1, 1024, 2, 64) * 0.1) for _ in range(4))
for causal in (False, True):
    calls.update(fwd=0, bwd=0)
    leaves = [shard(a, c4, None, "sp", sp4).clone().requires_grad_(True)
              for a in (q, k, v)]
    with C.record() as ops:
        out = context_parallel_attention(*leaves, sp4, causal=causal,
                                         scale=1.0 / np.sqrt(64))
        out.backward(shard(g, c4, None, "sp", sp4))
    seqs["flash_%s" % causal] = ops
    put("flash_out_%s" % causal, out)
    for name, leaf in zip("qkv", leaves):
        put("flash_d%s_%s" % (name, causal), leaf.grad)
    put("flash_calls_%s" % causal, [calls["fwd"], calls["bwd"]])
att._flash_fwd, att._flash_bwd = real_fwd, real_bwd
np.random.seed(3)
q, k, v = (np.random.randn(2, 512, 1, 64).astype(np.float32)
           for _ in range(3))
put("flash_aligned", context_parallel_attention(
    *(t(shard(a, c22, "dp", "sp", dpsp)) for a in (q, k, v)), dpsp,
    causal=True))

# -- pipeline parallelism (tests/test_parallel.py:270, :288, :315, :422) ---
def stage(p, x):
    w, b = p
    return torch.tanh(x @ w + b)


def stages(n, d, seed):
    r = np.random.RandomState(seed)
    return (t(r.randn(n, d, d) * 0.5), t(r.randn(n, d) * 0.1))


apply = pipeline_parallel(stage, pp4, n_microbatches=4)
put("pipe_out", apply(stages(4, 6, 0),
                      t(np.random.RandomState(1).randn(16, 6))))
params = [p.requires_grad_(True) for p in stages(4, 4, 2)]
apply = pipeline_parallel(stage, pp4, n_microbatches=2)
with C.record() as ops:
    (apply(tuple(params), t(np.random.RandomState(3).randn(8, 4))) ** 2
     ).mean().backward()
seqs["pipe_grad"] = ops
put("pipe_grad_w", params[0].grad)
put("pipe_grad_b", params[1].grad)
params = list(stages(4, 4, 4))
apply = pipeline_parallel(stage, pp4, n_microbatches=4)
r = np.random.RandomState(5)
x, y = t(r.randn(16, 4)), t(r.randn(16, 4))
losses = []
for _ in range(2):
    leaves = [p.detach().requires_grad_(True) for p in params]
    loss = ((apply(tuple(leaves), x) - y) ** 2).mean()
    grads = torch.autograd.grad(loss, leaves)
    params = [p - 0.2 * gi for p, gi in zip(leaves, grads)]
    losses.append(float(loss.detach()))
put("pipe_steps", losses)
try:
    pipeline_parallel(stage, pp4, n_microbatches=4)(
        stages(8, 4, 0), torch.zeros(8, 4))
    put("pipe_mismatch", "")
except ValueError as e:
    put("pipe_mismatch", str(e))

# -- expert parallelism (tests/test_parallel.py:344, :373, :394, :431) -----
def expert(p, x):
    w1, w2 = p
    return torch.relu(x @ w1) @ w2


ie = ep4.coords()["ep"]
r = np.random.RandomState(0)
w1, w2 = t(r.randn(8, 8, 16) * 0.3), t(r.randn(8, 16, 8) * 0.3)
gate_w, x = t(r.randn(8, 8)), t(r.randn(64, 8))
y, aux = moe_parallel(expert, ep4, capacity_factor=8.0)(
    x[ie * 16:(ie + 1) * 16], gate_w, (w1, w2))
put("moe_y", y)
put("moe_aux", aux)
r = np.random.RandomState(1)
w1, w2 = t(r.randn(8, 4, 4)), t(r.randn(8, 4, 4))
gate_w = t(np.concatenate([np.full((4, 1), 5.0), np.zeros((4, 7))], 1))
x = t(np.abs(r.randn(32, 4)))
y, _ = moe_parallel(expert, ep4, capacity_factor=1.0)(
    x[ie * 8:(ie + 1) * 8], gate_w, (w1, w2))
put("moe_drop_y", y)
r = np.random.RandomState(2)
params = [t(r.randn(8, 4, 4) * 0.3), t(r.randn(8, 4, 4) * 0.3)]
gate_w = t(r.randn(4, 8) * 0.3)
x, tgt = t(r.randn(32, 4)), t(r.randn(32, 4))
apply = moe_parallel(expert, ep4, capacity_factor=4.0)
mine = slice(ie * 8, (ie + 1) * 8)
losses = []
for step in range(2):
    leaves = [p.detach().requires_grad_(True) for p in params + [gate_w]]
    with C.record() as ops:
        y, aux = apply(x[mine], leaves[2], tuple(leaves[:2]))
        # this rank's share: its tokens' part of the mean, the aux once
        local = ((y - tgt[mine]) ** 2).mean() / 4
        grads = torch.autograd.grad(local + 0.01 * aux, leaves)
    seqs["moe_step%d" % step] = ops
    total = local.detach().clone()
    dist.all_reduce(total)
    losses.append(float(total + 0.01 * aux.detach()))
    if step == 0:
        for name, gi in zip(("w1", "w2", "gate"), grads):
            put("moe_grad_" + name, gi)
    params = [p - 0.1 * gi for p, gi in zip(leaves[:2], grads[:2])]
    gate_w = leaves[2] - 0.1 * grads[2]
put("moe_steps", losses)
try:
    moe_parallel(expert, ep4)(torch.zeros(4, 4), torch.zeros(4, 8),
                              (torch.zeros(4, 4, 4), torch.zeros(4, 4, 4)))
    put("moe_mismatch", "")
except ValueError as e:
    put("moe_mismatch", str(e))

# -- TrainStep refuses a second axis; the long-context LM ------------------
try:
    TrainStep(torch.nn.Linear(2, 2), lambda o, y: o.mean(), mesh=dpsp,
              device="cpu")
    put("trainstep_axes", "")
except MXNetError as e:
    put("trainstep_axes", str(e))
lm = chip_smoke.long_context_train(chip_smoke.LC_TINY, dpsp,
                                   torch.device("cpu"), 3)
put("lm_losses", lm["losses"])
for n, gi in lm["grads"].items():
    put("lm_grad_" + n, gi)
for n, p in lm["params"].items():
    put("lm_param_" + n, p)
chip_smoke.long_context_worker([
    "--seq-len", "64", "--d-model", "128", "--heads", "2", "--layers", "2",
    "--batch", "4", "--steps", "3", "--sp", "2", "--device", "cpu"])

put("sequences", json.dumps({k: [list(map(str, op)) for op in v]
                             for k, v in seqs.items()}))
np.savez(os.path.join(OUT, "rank%d.npz" % RANK), **res)
bad = [m for m in sys.modules if m in ("jax", "mxnet_tpu")
       or m.startswith(("jax.", "mxnet_tpu."))]
assert not bad, bad
print("CLEAN rank", RANK, flush=True)
end_process_group(0)
'''


class _Job:
    """The port's launcher job, started at once and read when first
    needed."""

    def __init__(self, tmp):
        self.tmp = tmp
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
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
            self.stdout = out
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
    j = _Job(str(tmp_path_factory.mktemp("parallel")))
    yield j
    j.stop()


def _coords22():
    """Each rank's (dp, sp) index, as the reference lays ranks out."""
    devices = np.arange(WORLD).reshape(2, 2)
    return {int(devices[i, j]): (i, j) for i in range(2) for j in range(2)}


def _gather22(ranks, key, B, L):
    """The global (B, L, ...) array from the (dp=2, sp=2) ranks' shards."""
    parts = {}
    for r, (i, j) in _coords22().items():
        parts[(i, j)] = ranks[r][key]
    return np.concatenate([np.concatenate([parts[(i, j)] for j in range(2)],
                                          axis=1) for i in range(2)], axis=0)


def _gather_sp(ranks, key):
    return np.concatenate([ranks[r][key] for r in range(WORLD)], axis=1)


def _ref_attention(q, k, v, causal):
    scale = q.shape[-1] ** -0.5
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        L = q.shape[1]
        s = np.where(np.tril(np.ones((L, L), bool))[None, None], s, -np.inf)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _cpu(n):
    return jax.devices("cpu")[:n]


# -- meshes ------------------------------------------------------------------

def test_a_mesh_without_a_process_group_has_coordinates_only():
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import Mesh, make_mesh
    mesh = make_mesh(("dp", "sp", "pp"), (1, 2, 2), devices=list(range(4)))
    assert dict(mesh.shape) == {"dp": 1, "sp": 2, "pp": 2}
    assert mesh.coords(3) == {"dp": 0, "sp": 1, "pp": 1}
    assert mesh.groups is None and mesh.group("dp") is None
    with pytest.raises(MXNetError, match="no process groups"):
        mesh.group("sp")
    assert Mesh(np.asarray([0]), ("dp",)).axis_index("dp") == 0


def test_top1_dispatch_matches_reference():
    from mxnet_tpu_torch.parallel import top1_dispatch
    import torch
    logits = np.random.RandomState(7).randn(40, 8).astype(np.float32)
    logits[:12, 3] += 4.0                     # expert 3 overflows
    for cap in (1, 3, 6):
        want = jtop1(jnp.asarray(logits), 8, cap)
        got = top1_dispatch(torch.tensor(logits), 8, cap)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


# -- sequence (context) parallelism -----------------------------------------

@pytest.mark.parametrize("method", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_context_parallel_attention_matches_reference(job, method, causal):
    np.random.seed(0)
    q, k, v = (np.random.randn(2, 32, 8, 16).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jcpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jmake_mesh(axes=("sp",)), causal=causal,
                           method=method))
    np.testing.assert_allclose(want, _ref_attention(q, k, v, causal),
                               rtol=2e-4, atol=2e-5)
    got = _gather22(job.get(), "cpa_%s_%s" % (method, causal), 2, 32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_ring_attention_gradients_match_local(job):
    np.random.seed(1)
    q, k, v = (jnp.asarray(np.random.randn(1, 16, 4, 8).astype(np.float32))
               for _ in range(3))
    mesh = jmake_mesh(axes=("sp",))
    want = jax.jit(jax.grad(lambda *a: jcpa(*a, mesh, causal=True).sum(),
                            argnums=(0, 1, 2)))(q, k, v)
    ranks = job.get()
    for name, w in zip("qkv", want):
        np.testing.assert_allclose(_gather_sp(ranks, "ring_grad_d" + name),
                                   np.asarray(w), rtol=5e-4, atol=5e-5)


def test_ring_attention_long_sequence_sp2(job):
    np.random.seed(2)
    q = np.random.randn(4, 64, 2, 8).astype(np.float32)
    want = np.asarray(jcpa(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                           jmake_mesh(axes=("dp", "sp"), shape=(4, 2)),
                           causal=True))
    got = _gather22(job.get(), "long_sp2", 4, 64)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, _ref_attention(q, q, q, True),
                               rtol=2e-4, atol=2e-5)


def test_make_mesh_lays_ranks_out_as_the_reference_devices(job):
    """Two axes: each rank's coordinates, its lines and their groups are
    those of the reference's ``Mesh.devices`` over the same four
    devices."""
    jmesh = jmake_mesh(axes=("dp", "sp"), shape=(2, 2), devices=_cpu(4))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    ranks = job.get()
    for r in range(WORLD):
        (i,), (j,) = np.nonzero(ids == r)
        got = ranks[r]
        assert tuple(got["coords"]) == (i, j)
        assert tuple(got["line_dp"]) == tuple(ids[:, j])
        assert tuple(got["line_sp"]) == tuple(ids[i, :])
        assert float(got["group_sum_dp"][0]) == ids[:, j].sum()
        assert float(got["group_sum_sp"][0]) == ids[i, :].sum()


def test_trainstep_trains_over_dp_only(job):
    """Of the mesh axes, TrainStep trains over dp (and tp): an sp axis
    raises, naming where sequence parallelism runs."""
    msg = str(job.get()[0]["trainstep_axes"])
    assert "'sp': 2" in msg and "parallel.ring" in msg


def test_ulysses_rejects_indivisible_heads(job):
    q = jnp.zeros((1, 16, 6, 4), jnp.float32)
    with pytest.raises(Exception, match="heads") as e:
        jcpa(q, q, q, jmake_mesh(axes=("sp",)), method="ulysses")
    got = str(job.get()[0]["ulysses_heads"])
    assert "heads (6) must divide by the 'sp' axis size (4)" in got
    assert "heads (6) must divide by the 'sp' axis size (8)" in str(e.value)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_kernel_route_matches_single_device(job, causal):
    """D = 64: the port's ring takes its kernel route (K1 per hop, K2 and
    K3 per hop backward; their plain versions on the CPU), a causal hop
    past the rank's own launching nothing; outputs and gradients against
    the reference's dense attention, and the output against the
    reference's ring forced to ``pallas``."""
    from mxnet_tpu.ops import attention as jatt
    from mxnet_tpu.ops.attention import _attention_jnp
    rng = np.random.RandomState(0)
    q, k, v, g = (jnp.asarray(rng.randn(1, 1024, 2, 64), jnp.float32) * 0.1
                  for _ in range(4))
    scale = 1.0 / np.sqrt(64)

    def ref(q, k, v):
        return _attention_jnp(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                              v.transpose(0, 2, 1, 3), scale,
                              causal).transpose(0, 2, 1, 3)

    want, vjp = jax.vjp(ref, q, k, v)
    prev = jatt.set_attention_impl("pallas")
    try:
        ring = jcpa(q, k, v, jmake_mesh(axes=("sp",), devices=_cpu(4)),
                    causal=causal, scale=scale)
    finally:
        jatt.set_attention_impl(prev)
    ranks = job.get()
    for r in range(WORLD):
        hops = r + 1 if causal else WORLD
        assert tuple(ranks[r]["flash_calls_%s" % causal]) == (hops, hops)
    got = _gather_sp(ranks, "flash_out_%s" % causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(ring), rtol=2e-3, atol=2e-4)
    for name, w in zip("qkv", vjp(g)):
        err = np.abs(_gather_sp(ranks, "flash_d%s_%s" % (name, causal))
                     - np.asarray(w)).max()
        assert err / np.abs(np.asarray(w)).max() < 2e-3, (name, err)


def test_ring_attention_kernel_route_aligned_shards(job):
    np.random.seed(3)
    q, k, v = (np.random.randn(2, 512, 1, 64).astype(np.float32)
               for _ in range(3))
    got = _gather22(job.get(), "flash_aligned", 2, 512)
    np.testing.assert_allclose(got, _ref_attention(q, k, v, True),
                               rtol=2e-3, atol=2e-4)


# -- pipeline parallelism ----------------------------------------------------

def _stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _stages(n, d, seed):
    rng = np.random.RandomState(seed)
    return (jnp.asarray(rng.randn(n, d, d).astype(np.float32) * 0.5),
            jnp.asarray(rng.randn(n, d).astype(np.float32) * 0.1))


def _pp4():
    return jmake_mesh(axes=("pp",), shape=(4,), devices=_cpu(4))


def test_pipeline_matches_sequential(job):
    stacked = _stages(4, 6, 0)
    x = jnp.asarray(np.random.RandomState(1).randn(16, 6).astype(np.float32))
    want = np.asarray(jpipeline_parallel(_stage, _pp4(), n_microbatches=4)(
        stacked, x))
    ref = x
    for s in range(4):
        ref = _stage((stacked[0][s], stacked[1][s]), ref)
    np.testing.assert_allclose(want, np.asarray(ref), rtol=1e-5, atol=1e-6)
    for rank in job.get():     # alike on every stage
        np.testing.assert_allclose(rank["pipe_out"], want, rtol=1e-5,
                                   atol=1e-6)


def test_pipeline_gradients_match_sequential(job):
    stacked = _stages(4, 4, 2)
    x = jnp.asarray(np.random.RandomState(3).randn(8, 4).astype(np.float32))
    apply = jpipeline_parallel(_stage, _pp4(), n_microbatches=2)
    gw, gb = jax.jit(jax.grad(lambda p: (apply(p, x) ** 2).mean()))(
        stacked)
    for r, rank in enumerate(job.get()):
        # each rank's gradient is its own stage's row, zero elsewhere
        for key, want in (("pipe_grad_w", gw), ("pipe_grad_b", gb)):
            got = rank[key]
            np.testing.assert_allclose(got[r], np.asarray(want)[r],
                                       rtol=2e-4, atol=1e-5)
            assert not np.delete(got, r, axis=0).any()


def test_pipeline_training_step_descends(job):
    params = _stages(4, 4, 4)
    apply = jpipeline_parallel(_stage, _pp4(), n_microbatches=4)
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(16, 4).astype(np.float32))
    y = jnp.asarray(rng.randn(16, 4).astype(np.float32))
    losses = []
    step = jax.jit(jax.value_and_grad(
        lambda p: ((apply(p, x) - y) ** 2).mean()))
    for _ in range(2):
        loss, g = step(params)
        params = tuple(p - 0.2 * gi for p, gi in zip(params, g))
        losses.append(float(loss))
    for rank in job.get():
        got = rank["pipe_steps"]
        np.testing.assert_allclose(got, losses, rtol=1e-4)
        assert got[1] < got[0]


def test_pipeline_rejects_stage_count_mismatch(job):
    with pytest.raises(ValueError, match="stacked stages"):
        jpipeline_parallel(_stage, _pp4(), n_microbatches=4)(
            _stages(8, 4, 0), jnp.zeros((8, 4), jnp.float32))
    assert "8 stacked stages but the 'pp' mesh axis has 4 devices" in \
        str(job.get()[0]["pipe_mismatch"])


# -- expert parallelism ------------------------------------------------------

def _expert(params, x):
    w1, w2 = params
    return jnp.maximum(x @ w1, 0) @ w2


def _ep4():
    return jmake_mesh(axes=("ep",), devices=_cpu(4))


def test_moe_matches_per_token_reference(job):
    rng = np.random.RandomState(0)
    w1 = rng.randn(8, 8, 16).astype(np.float32) * 0.3
    w2 = rng.randn(8, 16, 8).astype(np.float32) * 0.3
    gate_w = rng.randn(8, 8).astype(np.float32)
    x = rng.randn(64, 8).astype(np.float32)
    want_y, want_aux = jmoe_parallel(_expert, _ep4(), capacity_factor=8.0)(
        jnp.asarray(x), jnp.asarray(gate_w), (jnp.asarray(w1),
                                              jnp.asarray(w2)))
    logits = x @ gate_w
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    ref = np.zeros_like(x)
    for t in range(64):
        e = probs[t].argmax()
        ref[t] = probs[t, e] * (np.maximum(x[t] @ w1[e], 0) @ w2[e])
    ranks = job.get()
    got = np.concatenate([rank["moe_y"] for rank in ranks])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_y), rtol=2e-4, atol=2e-5)
    for rank in ranks:
        np.testing.assert_allclose(rank["moe_aux"], float(want_aux),
                                   rtol=1e-5)


def test_moe_capacity_drops_tokens_to_zero(job):
    rng = np.random.RandomState(1)
    w1 = rng.randn(8, 4, 4).astype(np.float32)
    w2 = rng.randn(8, 4, 4).astype(np.float32)
    gate_w = np.concatenate([np.full((4, 1), 5.0), np.zeros((4, 7))],
                            axis=1).astype(np.float32)
    x = np.abs(rng.randn(32, 4)).astype(np.float32)
    want, _ = jmoe_parallel(_expert, _ep4(), capacity_factor=1.0)(
        jnp.asarray(x), jnp.asarray(gate_w), (jnp.asarray(w1),
                                              jnp.asarray(w2)))
    got = np.concatenate([rank["moe_drop_y"] for rank in job.get()])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    zero_rows = (np.abs(got).sum(axis=1) == 0).sum()
    assert 0 < zero_rows < 32


def test_moe_trains_with_gradients(job):
    rng = np.random.RandomState(2)
    params = (jnp.asarray(rng.randn(8, 4, 4).astype(np.float32) * 0.3),
              jnp.asarray(rng.randn(8, 4, 4).astype(np.float32) * 0.3))
    gate_w = jnp.asarray(rng.randn(4, 8).astype(np.float32) * 0.3)
    x = jnp.asarray(rng.randn(32, 4).astype(np.float32))
    tgt = jnp.asarray(rng.randn(32, 4).astype(np.float32))
    apply = jmoe_parallel(_expert, _ep4(), capacity_factor=4.0)

    def loss_fn(p, g):
        y, aux = apply(x, g, p)
        return ((y - tgt) ** 2).mean() + 0.01 * aux

    losses, first = [], None
    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
    for _ in range(2):
        loss, (gp, gg) = step(params, gate_w)
        first = first or (gp, gg)
        params = tuple(a - 0.1 * b for a, b in zip(params, gp))
        gate_w = gate_w - 0.1 * gg
        losses.append(float(loss))
    (gw1, gw2), gg = first
    for r, rank in enumerate(job.get()):
        got = rank["moe_steps"]
        np.testing.assert_allclose(got, losses, rtol=1e-4)
        assert got[1] < got[0]
        # the gate's gradient is whole on every rank, each expert's on its
        # own rank (experts 2r and 2r + 1), zero elsewhere
        np.testing.assert_allclose(rank["moe_grad_gate"], np.asarray(gg),
                                   rtol=1e-4, atol=1e-6)
        rows = slice(2 * r, 2 * r + 2)
        for key, want in (("moe_grad_w1", gw1), ("moe_grad_w2", gw2)):
            np.testing.assert_allclose(rank[key][rows],
                                       np.asarray(want)[rows], rtol=1e-4,
                                       atol=1e-6)
            assert not np.delete(rank[key], [2 * r, 2 * r + 1], 0).any()


def test_moe_rejects_gate_expert_mismatch(job):
    with pytest.raises(ValueError, match="gate_w"):
        jmoe_parallel(_expert, jmake_mesh(axes=("ep",), devices=_cpu(8)))(
            jnp.zeros((16, 4), jnp.float32), jnp.zeros((4, 16), jnp.float32),
            (jnp.zeros((8, 4, 4), jnp.float32),
             jnp.zeros((8, 4, 4), jnp.float32)))
    assert "gate_w routes to 8 experts but 4 are stacked (4 devices x 1 " \
        "local)" in str(job.get()[0]["moe_mismatch"])


# -- the collectives ---------------------------------------------------------

@pytest.mark.parametrize("case", [
    "cpa_ring_True", "cpa_ulysses_True", "ring_grad", "flash_True",
    "pipe_grad", "moe_step0"])
def test_every_rank_issues_the_same_collectives(job, case):
    """Forward and backward, every rank of a line issued the same
    collectives in the same order (the composition ring and the pipeline
    through autograd, the kernel ring as one Function, with causal
    skips)."""
    seqs = [json.loads(str(rank["sequences"]))[case] for rank in job.get()]
    assert seqs[0], case
    for s in seqs[1:]:
        assert s == seqs[0]


# -- the long-context LM (examples/train_long_context.py) --------------------

def _run_the_example(argv):
    """examples/train_long_context.py's main() in this process, with each
    call of its jitted step recorded: [(params, opt_m, opt_v, t, loss)].
    Three steps are too few for its closing check (loss below 0.7 of the
    first), so that check's AssertionError is expected."""
    spec = importlib.util.spec_from_file_location(
        "train_long_context",
        os.path.join(REPO, "examples", "train_long_context.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls, real_jit = [], jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "step":
            return jitted

        def step(*args):
            out = jitted(*args)
            calls.append(out)
            return out
        return step

    old_argv = sys.argv
    sys.argv = ["train_long_context.py"] + argv
    jax.jit = recording_jit
    try:
        mod.main()
    except AssertionError:
        pass
    finally:
        jax.jit, sys.argv = real_jit, old_argv
    return calls


def _flat(tree):
    out = {"emb": tree["emb"], "lnf": tree["lnf"]}
    for i, layer in enumerate(tree["layers"]):
        for n, v in layer.items():
            out["layers.%d.%s" % (i, n)] = v
    return {n: np.asarray(v) for n, v in out.items()}


def test_long_context_worker_matches_the_example(job):
    """The port's copy of the example (chip_smoke.long_context_train) at a
    tiny size with D = 64, on (dp=2, sp=2) through the ring's kernel
    route, against the example itself on the 8-device mesh (dp=4, sp=2):
    the losses of 3 Adam steps (rtol 1e-4), the first step's gradients
    (the example's first Adam moment over 1 - b1; 1e-4 x max|ref| per
    tensor) and the parameters after the last (rtol 1e-4 and an absolute
    1 % of the 3 steps' largest move, 3 x lr: Adam moves an entry by up to
    lr a step whatever its gradient's size, so the rounding of a gradient
    near zero can move its entry by that much); the port's command line
    prints the example's lines."""
    cfg = chip_smoke.LC_TINY
    argv = ["--seq-len", str(cfg["seq_len"]), "--d-model",
            str(cfg["d_model"]), "--heads", str(cfg["heads"]), "--layers",
            str(cfg["layers"]), "--vocab", str(cfg["vocab"]), "--batch",
            str(cfg["batch"]), "--steps", "3", "--sp", "2"]
    calls = _run_the_example(argv)
    assert len(calls) == 3
    losses = [float(c[4]) for c in calls]
    grads = {n: m / 0.1 for n, m in _flat(calls[0][1]).items()}
    final = _flat(calls[-1][0])
    ranks = job.get()
    for rank in ranks:
        np.testing.assert_allclose(rank["lm_losses"], losses, rtol=1e-4)
        for n, want in grads.items():
            err = np.abs(rank["lm_grad_" + n] - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (n, err)
        for n, want in final.items():
            np.testing.assert_allclose(rank["lm_param_" + n], want,
                                       rtol=1e-4,
                                       atol=0.01 * 3 * chip_smoke.LC_LR)
    assert "step   0  loss %.4f" % losses[0] in job.stdout
    assert "final loss %.4f (from %.4f) over L=64 with sp=2" % (
        losses[-1], losses[0]) in job.stdout
