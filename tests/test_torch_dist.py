"""Data-parallel training across two processes, on the CPU over gloo.

The port's counterparts of the collective cases of
``tests/test_dist_kvstore.py``: every test starts
``python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local`` on a
worker script (with a time limit, so a hang fails the test), and every
worker ends by checking that neither ``jax`` nor ``mxnet_tpu`` is in its
``sys.modules``.  The workers write what they computed to ``.npz`` files;
the test process holds them against the JAX reference run in one process
on both ranks' halves of the batch: the reference's ``Trainer`` (rtol
1e-5, atol 1e-6; also with a copy on ``cpu(0)`` and ``cpu(1)`` in each
process), its ``TrainStep`` on the global batch (1e-5; a conv +
BatchNorm net's dp step on the global batch's statistics against the
reference's step over a 2-device mesh), and, with compression, the
reference's 2-bit and int8 arithmetic on the ranks' own gradients (the
sum and the residuals).  The ranks' weights are bitwise equal.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon, nd as jnd
from mxnet_tpu.kvstore import bucketing as jb
from mxnet_tpu.ops import quantization as jq
from mxnet_tpu.parallel import TrainStep as JTrainStep, make_mesh

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
IN, HID, OUT, HALF, STEPS = 5, 8, 3, 4, 3
RTOL, ATOL = 1e-5, 1e-6

_PRELUDE = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, kvstore, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import (TrainStep, end_process_group,
                                      init_process_group, make_mesh)

init_process_group(device="cpu")
mx.cpu().__enter__()
RANK = dist.get_rank()
OUT_DIR = %r
IN, HID, OUT, HALF, STEPS = %d, %d, %d, %d, %d


def weights0():
    rng = np.random.RandomState(0)
    return [rng.randn(HID, IN).astype(np.float32) * 0.5,
            rng.randn(HID).astype(np.float32) * 0.1,
            rng.randn(OUT, HID).astype(np.float32) * 0.5,
            rng.randn(OUT).astype(np.float32) * 0.1]


def batch(step, rank):
    rng = np.random.RandomState(100 + 10 * step + rank)
    return (rng.randn(HALF, IN).astype(np.float32),
            rng.randn(HALF, OUT).astype(np.float32))


def mlp(weights=None):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(HID, in_units=IN, activation="tanh"),
            gluon.nn.Dense(OUT, in_units=HID))
    net.initialize(mx.init.Xavier(), seed=RANK)      # differs by rank
    for i, w in enumerate(weights or []):
        net[i // 2].weight.set_data(w) if i %% 2 == 0 else \\
            net[i // 2].bias.set_data(w)
    return net


def weights_of(net):
    return [p.data().asnumpy() for layer in net for p in
            (layer.weight, layer.bias)]


def save(name, **arrays):
    np.savez(os.path.join(OUT_DIR, "%%s_rank%%d.npz" %% (name, RANK)),
             **arrays)


def done():
    bad = [m for m in sys.modules if m in ("jax", "mxnet_tpu")
           or m.startswith(("jax.", "mxnet_tpu."))]
    assert not bad, bad
    print("CLEAN rank", RANK, flush=True)
    end_process_group(0)
"""


def _launch(tmp_path, body, n=2, env=None, expect_rc=0):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(_PRELUDE % (
        str(tmp_path), IN, HID, OUT, HALF, STEPS)) + textwrap.dedent(body)
        + "\ndone()\n")
    full_env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                    **(env or {}))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
                        "-n", str(n), "--launcher", "local", "--",
                        sys.executable, str(script)],
                       cwd=REPO, env=full_env, capture_output=True,
                       text=True, timeout=TIMEOUT)
    if expect_rc == 0:
        assert r.returncode == 0, (r.stdout, r.stderr[-6000:])
        assert r.stdout.count("CLEAN rank") == n, r.stdout
    return r, time.monotonic() - t0


def _load(tmp_path, name, n=2):
    return [dict(np.load(tmp_path / ("%s_rank%d.npz" % (name, r))))
            for r in range(n)]


def _weights0():
    rng = np.random.RandomState(0)
    return [rng.randn(HID, IN).astype(np.float32) * 0.5,
            rng.randn(HID).astype(np.float32) * 0.1,
            rng.randn(OUT, HID).astype(np.float32) * 0.5,
            rng.randn(OUT).astype(np.float32) * 0.1]


def _batch(step, rank):
    rng = np.random.RandomState(100 + 10 * step + rank)
    return (rng.randn(HALF, IN).astype(np.float32),
            rng.randn(HALF, OUT).astype(np.float32))


def _ref_mlp():
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(HID, in_units=IN, activation="tanh"),
            jgluon.nn.Dense(OUT, in_units=HID))
    net.initialize(jmx.init.Xavier())
    for i, w in enumerate(_weights0()):
        layer = net[i // 2]
        (layer.weight if i % 2 == 0 else layer.bias).set_data(jnd.array(w))
    return net


def _ref_weights(net):
    return [p.data().asnumpy() for layer in net
            for p in (layer.weight, layer.bias)]


def _ref_trainer_run(opt_args):
    """The reference's one-process Trainer on both halves: the loss is the
    sum of the two halves' means, and ``step(2)``."""
    net = _ref_mlp()
    trainer = jgluon.Trainer(net.collect_params(), "sgd", opt_args)
    for s in range(STEPS):
        with jag.record():
            loss = None
            for r in range(2):
                x, y = (jnd.array(a) for a in _batch(s, r))
                part = ((net(x) - y) ** 2).mean()
                loss = part if loss is None else loss + part
        loss.backward()
        trainer.step(2)
    return _ref_weights(net)


def _assert_ranks_bitwise(results, key_prefix="w"):
    keys = sorted(k for k in results[0] if k.startswith(key_prefix))
    assert keys
    for k in keys:
        np.testing.assert_array_equal(results[1][k], results[0][k])


def test_pushpull_is_the_exact_sum_and_init_takes_rank_0(tmp_path):
    _launch(tmp_path, """
        kv = kvstore.create("ici")
        assert kv.type == "ici" and kv.num_workers == 2 and kv.rank == RANK
        kv.init("i", nd.zeros((3,), dtype="int32"))
        kv.push("i", nd.array(np.full(3, RANK + 10, np.int32)))
        oi = nd.zeros((3,), dtype="int32")
        kv.pull("i", out=oi)
        # integers: the sum is exact, no averaging
        assert (oi.asnumpy() == 21).all() and oi.dtype == np.int32, oi
        keys = [0, 1, "big"]
        vals = [np.arange(6, dtype=np.int32).reshape(2, 3) * (RANK + 1),
                np.full(4, 7 - RANK, np.int32),
                np.arange(2000, dtype=np.int32) + RANK]
        kv.init(keys, [nd.zeros(v.shape, dtype="int32") for v in vals])
        outs = [nd.zeros(v.shape, dtype="int32") for v in vals]
        kv.pushpull(keys, [nd.array(v) for v in vals], out=outs)
        want = [np.arange(6).reshape(2, 3) * 3, np.full(4, 13),
                2 * np.arange(2000) + 1]
        for o, w in zip(outs, want):
            assert (o.asnumpy() == w).all(), (o.asnumpy(), w)
        kv.init("f", nd.array(np.full(4, RANK + 5.0, np.float32)))
        of = nd.zeros((4,))
        kv.pull("f", out=of)
        assert (of.asnumpy() == 5.0).all(), of          # rank 0's value
        # a Trainer starts every rank from rank 0's weights
        net = mlp()
        w_before = weights_of(net)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.0}, kvstore="device")
        x, y = batch(0, RANK)
        with autograd.record():
            loss = ((net(nd.array(x)) - nd.array(y)) ** 2).mean()
        loss.backward()
        trainer.step(2)
        assert trainer._kvstore.type == "ici"
        save("init", **{"w%d" % i: w for i, w in enumerate(weights_of(net))},
             **{"before%d" % i: w for i, w in enumerate(w_before)})
    """)
    r0, r1 = _load(tmp_path, "init")
    _assert_ranks_bitwise([r0, r1])
    for i in range(4):
        np.testing.assert_array_equal(r1["w%d" % i], r0["before%d" % i])
    assert not all(np.array_equal(r0["before%d" % i], r1["before%d" % i])
                   for i in range(4))


_TRAINER_BODY = """
    net = mlp(weights0())
    trainer = gluon.Trainer(net.collect_params(), "sgd", %r,
                            kvstore="ici", update_on_kvstore=%r)
    for s in range(STEPS):
        x, y = batch(s, RANK)
        with autograd.record():
            loss = ((net(nd.array(x)) - nd.array(y)) ** 2).mean()
        loss.backward()
        trainer.step(2)
    assert trainer._update_on_kvstore is %r
    save("trainer", **{"w%%d" %% i: w for i, w in enumerate(weights_of(net))})
    # the optimizer states (the store's, under update_on_kvstore) go
    # through save_states / load_states
    path = os.path.join(OUT_DIR, "states%%d" %% RANK)
    trainer.save_states(path)
    other = gluon.Trainer(net.collect_params(), "sgd", %r, kvstore="ici",
                          update_on_kvstore=%r)
    other.load_states(path)
    pick = ((lambda t: t._kvstore._updater) if %r else
            (lambda t: t._updaters[0]))
    saved, loaded = pick(trainer).states, pick(other).states
    assert sorted(saved) == sorted(loaded) == [0, 1, 2, 3], sorted(loaded)
    for k in saved:
        assert torch.equal(loaded[k].data, saved[k].data), k
    # a copy on cpu(0) and cpu(1) in each process: the store sums the
    # copies, then the ranks; each copy's loss is its quarter's mean over
    # two, so that the two copies' sum is the half's mean
    net = mlp(weights0())
    ctxs = [mx.cpu(0), mx.cpu(1)]
    net.collect_params().reset_ctx(ctxs)
    trainer = gluon.Trainer(net.collect_params(), "sgd", %r,
                            kvstore="ici", update_on_kvstore=%r)
    for s in range(STEPS):
        x, y = batch(s, RANK)
        with autograd.record():
            losses = [((net(nd.array(x[sl], ctx=c)) - nd.array(y[sl], ctx=c))
                       ** 2).mean() * 0.5
                      for c, sl in zip(ctxs, (slice(0, HALF // 2),
                                              slice(HALF // 2, HALF)))]
        autograd.backward(losses)
        trainer.step(2)
    params = [p for layer in net for p in (layer.weight, layer.bias)]
    save("trainer_copies", **{"w%%d_%%d" %% (i, d): p.list_data()[d].asnumpy()
                              for i, p in enumerate(params)
                              for d in range(2)})
"""


@pytest.mark.parametrize("update_on_kvstore", (False, True))
def test_trainer_step_matches_the_reference_on_both_halves(
        tmp_path, update_on_kvstore):
    opt_args = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    _launch(tmp_path, _TRAINER_BODY % (
        opt_args, update_on_kvstore, update_on_kvstore, opt_args,
        update_on_kvstore, update_on_kvstore, opt_args, update_on_kvstore))
    results = _load(tmp_path, "trainer")
    copies = _load(tmp_path, "trainer_copies")
    _assert_ranks_bitwise(results)
    _assert_ranks_bitwise(copies)
    for i, w in enumerate(_ref_trainer_run(opt_args)):
        np.testing.assert_allclose(results[0]["w%d" % i], w, rtol=RTOL,
                                   atol=ATOL)
        for d in range(2):
            np.testing.assert_allclose(copies[0]["w%d_%d" % (i, d)], w,
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ("2bit", "int8"))
def test_compressed_sum_and_residuals_follow_the_reference(tmp_path, mode):
    """Plain SGD; each rank saves its own gradients before the exchange,
    the exchanged sum and its residuals.  The test recomputes the exchange
    from both ranks' gradients with the reference's kernels: 2-bit
    quantizes each key and sums the levels; int8 quantizes the fusion
    bucket (the reference's plan) and merges by dequant-sum-requant."""
    lr, thr, block = 0.5, 0.05, 16
    _launch(tmp_path, """
        net = mlp(weights0())
        params = {"type": %r, "threshold": %r, "block": %d}
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": %r}, kvstore="ici",
                                compression_params=params)
        out = {}
        for s in range(STEPS):
            x, y = batch(s, RANK)
            with autograd.record():
                loss = ((net(nd.array(x)) - nd.array(y)) ** 2).mean()
            loss.backward()
            for i, p in enumerate(trainer._params):
                out["g%%d_%%d" %% (s, i)] = p.grad().asnumpy()
            trainer.allreduce_grads()
            for i, p in enumerate(trainer._params):
                out["sum%%d_%%d" %% (s, i)] = p.grad().asnumpy()
            trainer.update(2)
            for k, res in trainer._kvstore._gc._residuals.items():
                out["res%%d_%%s" %% (s, k)] = res.numpy()
        out.update({"w%%d" %% i: w for i, w in enumerate(weights_of(net))})
        out["names"] = np.array([p.name for p in trainer._params])
        save("compressed", **out)
    """ % (mode, thr, block, lr))
    ranks = _load(tmp_path, "compressed")
    _assert_ranks_bitwise(ranks)
    n = len(ranks[0]["names"])
    shapes = [ranks[0]["g0_%d" % i].shape for i in range(n)]
    res = [{}, {}]
    for s in range(STEPS):
        grads = [[ranks[r]["g%d_%d" % (s, i)] for i in range(n)]
                 for r in range(2)]
        if mode == "2bit":
            want = []
            for i in range(n):
                total = None
                for r in range(2):
                    lv, res[r][str(i)] = jq.quantize_2bit_ef(
                        jnp.asarray(grads[r][i]),
                        res[r].get(str(i), jnp.zeros(shapes[i])), thr,
                        donate=False)
                    total = lv if total is None else total + lv
                want.append(np.asarray(total))
        else:
            buckets, solo = jb.plan_buckets(
                list(range(n)), shapes, ["float32"] * n, [4] * n,
                ["default"] * n, jb.bucket_bytes())
            assert len(buckets) == 1 and not solo
            b = buckets[0]
            qs, ss = [], []
            for r in range(2):
                flat = np.concatenate([grads[r][p].ravel()
                                       for p in b.positions])
                q, sc, res[r][b.name] = jq.quantize_int8_blocks(
                    jnp.asarray(flat),
                    res[r].get(b.name, jnp.zeros(flat.size)), block,
                    donate=False)
                qs.append(q)
                ss.append(sc)
            qo, so = jq.dequant_sum_requant_int8(jnp.stack(qs),
                                                 jnp.stack(ss))
            out = np.asarray(jq.dequantize_int8_blocks(qo, so, b.total))
            want = [None] * n
            for p, off, size, shape in b.slices():
                want[p] = out[off:off + size].reshape(shape)
        for i in range(n):
            np.testing.assert_allclose(ranks[0]["sum%d_%d" % (s, i)],
                                       want[i], rtol=1e-6, atol=0)
        for r in range(2):
            for k, v in res[r].items():
                np.testing.assert_array_equal(
                    ranks[r]["res%d_%s" % (s, k)], np.asarray(v))


def test_overlap_on_and_off_give_bitwise_equal_weights(tmp_path):
    """MX_EXCHANGE_OVERLAP=1 launches the buckets from the gradient hooks
    during backward (checked: units launched before the step); the
    weights equal the serialized exchange's bit for bit, plain and under
    2-bit compression."""
    _launch(tmp_path, """
        out = {}
        for comp in (None, {"type": "2bit", "threshold": 0.05}):
            tag = "2bit" if comp else "plain"
            for overlap in ("0", "1"):
                os.environ["MX_EXCHANGE_OVERLAP"] = overlap
                net = mlp(weights0())
                trainer = gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1,
                                         "momentum": 0.9}, kvstore="ici",
                                        compression_params=comp)
                launched = []
                for s in range(STEPS):
                    x, y = batch(s, RANK)
                    with autograd.record():
                        loss = ((net(nd.array(x)) - nd.array(y)) ** 2).mean()
                    loss.backward()
                    sess = trainer._exchange_session
                    launched.append(0 if sess is None else
                                    len(sess._launched))
                    trainer.step(2)
                assert trainer._overlap is (overlap == "1")
                if overlap == "1":
                    assert launched[0] == 0 and all(launched[1:]), launched
                else:
                    assert not any(launched), launched
                for i, w in enumerate(weights_of(net)):
                    out["%s%s_%d" % (tag, overlap, i)] = w
        save("overlap", **out)
    """)
    ranks = _load(tmp_path, "overlap")
    for r in ranks:
        for tag in ("plain", "2bit"):
            for i in range(4):
                np.testing.assert_array_equal(r["%s1_%d" % (tag, i)],
                                              r["%s0_%d" % (tag, i)])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])


def test_dp_trainstep_matches_the_reference_on_the_global_batch(tmp_path):
    """Each rank passes its half; the dp step's parameters and losses
    (``run_steps`` too) are the reference ``TrainStep``'s on the whole
    batch within 1e-5.  A conv + BatchNorm net trains on the global
    batch's statistics: its losses, parameters and running statistics are
    the reference ``TrainStep``'s over a 2-device mesh on the whole batch
    within 1e-5, and its first step's batch statistics are the whole
    batch's.  A mesh with an sp axis of two is refused (sequence
    parallelism runs through parallel.ring; dp and tp are the step's
    axes)."""
    lr, mom = 0.1, 0.9
    _launch(tmp_path, """
        mesh = make_mesh()
        assert mesh.size == 2 and tuple(mesh.axis_names) == ("dp",)
        step = TrainStep(mlp(weights0()), lambda o, y: ((o - y) ** 2).mean(),
                         mesh=mesh, device="cpu", learning_rate=%r,
                         momentum=%r)
        losses = []
        for s in range(STEPS):
            x, y = batch(s, RANK)
            losses.append(float(step(x, y)))
        losses.append(float(step.run_steps(2, *batch(STEPS, RANK))))
        out = {"w_" + n: v.numpy() for n, v in step.params.items()}
        save("trainstep", losses=np.array(losses), **out)
        bn = gluon.nn.HybridSequential()
        bn.add(gluon.nn.Conv2D(4, 3, padding=1, in_channels=2),
               gluon.nn.BatchNorm(in_channels=4),
               gluon.nn.Activation("relu"), gluon.nn.Dense(OUT, in_units=64))
        bn.initialize(device="cpu")
        rng = np.random.RandomState(7)
        for n, p in sorted(bn.collect_params().items()):
            p.set_data(rng.randn(*p.shape).astype(np.float32) * 0.3
                       + (1.0 if n.endswith(("gamma", "running_var"))
                          else 0.0))
        bstep = TrainStep(bn, lambda o, y: ((o - y) ** 2).mean(), mesh=mesh,
                          device="cpu", learning_rate=%r, momentum=%r)
        blosses = []
        for s in range(STEPS):
            rng = np.random.RandomState(300 + 10 * s + RANK)
            blosses.append(float(bstep(
                rng.randn(HALF, 2, 4, 4).astype(np.float32),
                rng.randn(HALF, OUT).astype(np.float32))))
            if s == 0:
                stats0 = [t.numpy() for t in bstep.batch_stats[0]]
        out = {"w_" + n: v.numpy() for n, v in bstep.params.items()}
        save("trainstep_bn", losses=np.array(blosses), mean0=stats0[0],
             var0=stats0[1], **out)
        try:
            TrainStep(mlp(weights0()), lambda o, y: o.mean(),
                      mesh=make_mesh(axes=("dp", "sp"), shape=(1, 2)),
                      device="cpu")
        except MXNetError as e:
            assert "parallel.ring" in str(e), e
        else:
            raise AssertionError("TrainStep took an sp axis of size 2")
    """ % (lr, mom, lr, mom))
    ranks = _load(tmp_path, "trainstep")
    _assert_ranks_bitwise(ranks)
    np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])

    def loss_fn(out, y):
        return jnp.mean((out - y) ** 2)

    jstep = JTrainStep(_ref_mlp(), loss_fn,
                       make_mesh(axes=("dp",), devices=jax.devices("cpu")[:1]),
                       learning_rate=lr, momentum=mom)
    losses = []
    for s in range(STEPS):
        halves = [_batch(s, r) for r in range(2)]
        x = np.concatenate([h[0] for h in halves])
        y = np.concatenate([h[1] for h in halves])
        losses.append(float(jstep(jnp.asarray(x), jnp.asarray(y))))
    halves = [_batch(STEPS, r) for r in range(2)]
    losses.append(float(jstep.run_steps(
        2, jnp.asarray(np.concatenate([h[0] for h in halves])),
        jnp.asarray(np.concatenate([h[1] for h in halves])))))
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5,
                               atol=1e-5)
    assert sorted("w_" + n for n in jstep.params) == \
        sorted(k for k in ranks[0] if k.startswith("w_"))
    for n, w in jstep.params.items():
        np.testing.assert_allclose(ranks[0]["w_" + n], np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    # the BatchNorm net over two ranks against the reference's step over a
    # 2-device mesh on the whole batch (XLA's psum makes its statistics
    # the global batch's)
    franks = _load(tmp_path, "trainstep_bn")
    _assert_ranks_bitwise(franks)
    jbn = jgluon.nn.HybridSequential()
    jbn.add(jgluon.nn.Conv2D(4, 3, padding=1, in_channels=2),
            jgluon.nn.BatchNorm(in_channels=4),
            jgluon.nn.Activation("relu"), jgluon.nn.Dense(OUT, in_units=64))
    jbn.initialize()
    rng = np.random.RandomState(7)
    for n, p in sorted(jbn.collect_params().items()):
        p.set_data(jnd.array(rng.randn(*p.shape).astype(np.float32) * 0.3
                             + (1.0 if n.endswith(("gamma", "running_var"))
                                else 0.0)))
    xs = []
    for s in range(STEPS):
        halves = [np.random.RandomState(300 + 10 * s + r) for r in range(2)]
        halves = [(g.randn(HALF, 2, 4, 4).astype(np.float32),
                   g.randn(HALF, OUT).astype(np.float32)) for g in halves]
        xs.append((np.concatenate([h[0] for h in halves]),
                   np.concatenate([h[1] for h in halves])))
    # the first step's global statistics: the conv's output on the whole
    # batch, before any update
    h = np.asarray(jbn[0](jnd.array(xs[0][0])).asnumpy(), np.float64)
    np.testing.assert_allclose(franks[0]["mean0"], h.mean(axis=(0, 2, 3)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(franks[0]["var0"], h.var(axis=(0, 2, 3)),
                               rtol=1e-5, atol=1e-6)
    jbstep = JTrainStep(jbn, loss_fn,
                        make_mesh(axes=("dp",), devices=jax.devices("cpu")[:2]),
                        learning_rate=lr, momentum=mom)
    blosses = [float(jbstep(jnp.asarray(x), jnp.asarray(y))) for x, y in xs]
    np.testing.assert_allclose(franks[0]["losses"], blosses, rtol=1e-5,
                               atol=1e-5)
    assert sorted("w_" + n for n in jbstep.params) == \
        sorted(k for k in franks[0] if k.startswith("w_"))
    for n, w in jbstep.params.items():
        np.testing.assert_allclose(franks[0]["w_" + n], np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_dp_trainstep_starts_every_rank_from_rank_0s_weights(tmp_path):
    """Blocks initialised apart (``mlp()`` seeds by rank) train one model:
    the step takes rank 0's parameters, so after a step on each rank's
    own half the parameters are bitwise equal across the ranks."""
    _launch(tmp_path, """
        net = mlp()
        before = {n: p.detach().numpy().copy()
                  for n, p in net.named_parameters()}
        step = TrainStep(net, lambda o, y: ((o - y) ** 2).mean(),
                         mesh=make_mesh(), device="cpu", learning_rate=0.1)
        step(*batch(0, RANK))
        save("start", **{"before_" + n: v for n, v in before.items()},
             **{"w_" + n: v.numpy() for n, v in step.params.items()})
    """)
    ranks = _load(tmp_path, "start")
    assert not all(np.array_equal(ranks[0][k], ranks[1][k])
                   for k in ranks[0] if k.startswith("before_"))
    _assert_ranks_bitwise(ranks, key_prefix="w_")


def _case(argv, outcome, old_id):
    return pytest.param(argv, outcome, id=old_id)


@pytest.mark.parametrize("argv, outcome", [
    # the supervision flags and the ssh mode are ported: each is honoured
    # (its value reaches the local launcher) or, where it cannot act with
    # the other flags given, refused by name
    _case(["--launcher", "ssh"], "--launcher ssh needs -H hostfile",
          "argv0---launcher ssh: not ported-part (b)"),
    _case(["-H", "hosts"], "-H: the hostfile is read by --launcher ssh",
          "argv1--H: not ported-part (b)"),
    _case(["--restart", "on-failure"], ("restart", "on-failure"),
          "argv2---restart: not ported-part (b)"),
    _case(["--max-restarts", "5"],
          "--max-restarts: restarts need --restart on-failure",
          "argv3---max-restarts: not ported-part (b)"),
    _case(["--hang-timeout=30"], ("hang_timeout", 30.0),
          "argv4---hang-timeout: not ported-part (b)"),
    _case(["--status-interval", "5"], ("status_interval", 5.0),
          "argv5---status-interval: not ported-part (b)"),
    _case(["--elastic"], ("elastic", True),
          "argv6---elastic: not ported-part (b)"),
    _case(["--resize-file", "f"], "--resize-file requires --elastic",
          "argv7---resize-file: not ported-part (b)"),
    _case(["--drain-timeout", "9"],
          "--drain-timeout: only a --resize-file resize drains",
          "argv8---drain-timeout: not ported-part (b)"),
    _case(["--serve-port-base", "9000"],
          "--serve-port-base: not ported yet (the serving fleet, ROADMAP "
          "Queue 1 item 6)", "argv9---serve-port-base: not ported-item 6"),
    _case(["--route", "9100"], "--route: not ported yet (the serving "
          "fleet, ROADMAP Queue 1 item 6)",
          "argv10---route: not ported-item 6"),
    _case(["--autoscale", "1:4"], "--autoscale: not ported yet (the "
          "serving fleet, ROADMAP Queue 1 item 6)",
          "argv11---autoscale: not ported-item 6"),
    _case(["--compile-cache", "d"], "--compile-cache: not ported yet (the "
          "serving fleet, ROADMAP Queue 1 item 6)",
          "argv12---compile-cache: not ported-item 6"),
    _case(["--bogus"], "unrecognized arguments: --bogus",
          "argv13-unrecognized arguments: --bogus-"),
])
def test_the_launcher_refuses_what_is_not_ported(capsys, monkeypatch, argv,
                                                 outcome):
    from mxnet_tpu_torch.tools import launch
    seen = []
    monkeypatch.setattr(launch, "launch_local",
                        lambda args, command: seen.append(args) or 0)
    argv = ["-n", "2", "-s", "1"] + argv + ["--", sys.executable, "-c", ""]
    if isinstance(outcome, tuple):
        assert launch.main(argv) == 0
        attr, value = outcome
        assert getattr(seen[0], attr) == value
        return
    with pytest.raises(SystemExit) as e:
        launch.main(argv)
    assert e.value.code == 2 and not seen
    err = capsys.readouterr().err
    assert outcome in err, err


def test_the_launcher_gives_servers_and_workers_the_reference_s_env():
    from mxnet_tpu_torch.tools import launch
    assert launch.server_env(9601, 3) == {
        "DMLC_ROLE": "server", "DMLC_NUM_WORKER": "3",
        "MX_PS_PORT": "9601", "MX_FORCE_CPU": "1"}
    assert launch.ps_worker_env(["127.0.0.1:9601", "127.0.0.1:9602"]) == {
        "MX_PS_ROOT": "127.0.0.1:9601",
        "MX_PS_ROOTS": "127.0.0.1:9601,127.0.0.1:9602",
        "DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": "9601",
        "DMLC_NUM_SERVER": "2"}


def test_a_failing_rank_stops_the_job(tmp_path):
    r, secs = _launch(tmp_path, """
        if RANK == 1:
            sys.exit(3)
        import time
        time.sleep(100)
    """, expect_rc=3)
    assert r.returncode == 3, (r.stdout, r.stderr)
    assert "rank 1 exited with 3" in r.stderr
    assert secs < 60, secs
    assert "CLEAN" not in r.stdout
