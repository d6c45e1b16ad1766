"""The port's ``gluon.Trainer`` loop, metrics and gluon utilities against
the JAX reference, on the CPU.

A small conv net built with deferred sizes (Conv2D -> BatchNorm -> ReLU
-> Dense) is resolved in the reference, its parameters are drawn from
numpy and carried into the port (whose net takes its sizes from them),
and both packages train it 3 steps on one batch, as ``bench.py --eager``
does, through the canonical loop::

    with autograd.record(): loss = loss_fn(net(x), y)
    loss.backward(); trainer.step(batch)

with SGD (momentum, as ``bench.py --eager``) and with Adam: losses within
rtol 1e-5, every parameter (the BatchNorm running statistics the training
forward writes included) within rtol 1e-4, atol 1e-5.  Also: a trainer
started mid-trajectory from the reference's optimizer state
(``convert.trainer_states_from_mxnet_tpu``), ``save_states`` /
``load_states`` resuming the same trajectory, the port's ``Trainer`` step
against its ``TrainStep`` step, and the metrics, ``clip_global_norm`` and
``split_and_load`` on the same inputs as the reference.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd, gluon as jgluon
from mxnet_tpu import metric as jmetric
from mxnet_tpu.gluon import nn as jgnn, utils as jutils

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, autograd as tag, gluon as tgluon
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.convert import (params_from_mxnet_tpu,
                                     params_to_numpy,
                                     trainer_states_from_mxnet_tpu)
from mxnet_tpu_torch.gluon import nn as tgnn, utils as tutils
from mxnet_tpu_torch.parallel import TrainStep

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

B, C, HW, CLASSES, STEPS = 4, 3, 6, 5, 3
LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
OPTIMIZERS = {"sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
              "adam": ("adam", {"learning_rate": 0.01, "wd": 0.01})}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _build(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), nn.Dense(CLASSES))
    return net


def _batch():
    rng = np.random.RandomState(100)
    return (rng.randn(B, C, HW, HW).astype(np.float32),
            rng.randint(0, CLASSES, B).astype(np.float32))


def _pair(seed=1):
    """The reference net resolved and drawn from numpy; the port's net,
    built deferred, loaded from the same arrays."""
    jnet, tnet = _build(jgnn), _build(tgnn)
    jnet.initialize()
    jnet(jnd.array(_batch()[0]))
    rng = np.random.RandomState(seed)
    named = {}
    for name, p in jnet.collect_params().items():
        val = 0.3 * rng.randn(*p.data().shape).astype(np.float32)
        if name.endswith(("gamma", "running_var")):
            val = 1.0 + np.abs(val)
        p.set_data(jnd.array(val))
        named[name] = val
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    return jnet, tnet


def _step(pkg, net, trainer, loss_fn):
    x, y = _batch()
    with pkg.autograd.record():
        loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
    loss.backward()
    trainer.step(B)
    return float(loss.mean().asscalar())


def _train(pkg, net, trainer, steps):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    return [_step(pkg, net, trainer, loss_fn) for _ in range(steps)]


def _values(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _assert_params_close(tnet, jnet):
    want = _values(jnet)
    got = _values(tnet)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_trainer_trajectory_matches_reference(opt):
    name, kw = OPTIMIZERS[opt]
    jnet, tnet = _pair()
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(kw))
    ttr = tgluon.Trainer(tnet.collect_params(), name, dict(kw))
    assert [p.name for p in ttr._params] == [p.name for p in jtr._params]
    want = _train(jmx, jnet, jtr, STEPS)
    got = _train(tmx, tnet, ttr, STEPS)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    _assert_params_close(tnet, jnet)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == STEPS


def _export(jtrainer):
    """The reference trainer's optimizer state as numpy."""
    def tonp(s):
        if s is None:
            return None
        if isinstance(s, tuple):
            return tuple(tonp(x) for x in s)
        return np.asarray(s.asnumpy(), np.float32)

    upd = jtrainer._updaters[0]
    return {"states": {i: tonp(s) for i, s in upd.states.items()},
            "index_update_count": dict(upd.optimizer._index_update_count),
            "num_update": upd.optimizer.num_update}


def test_trainer_resumes_from_the_reference_state():
    name, kw = OPTIMIZERS["adam"]
    jnet, _ = _pair()
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(kw))
    _train(jmx, jnet, jtr, 2)
    tnet = _build(tgnn)
    params_from_mxnet_tpu(_values(jnet), net=tnet, device="cpu")
    ttr = tgluon.Trainer(tnet.collect_params(), name, dict(kw))
    trainer_states_from_mxnet_tpu(_export(jtr), ttr)
    want = _train(jmx, jnet, jtr, 2)
    got = _train(tmx, tnet, ttr, 2)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
    assert ttr.optimizer._index_update_count == \
        jtr.optimizer._index_update_count


def test_save_and_load_states_resume_the_same_trajectory(tmp_path):
    name, kw = OPTIMIZERS["sgd"]
    _, tnet = _pair()
    ttr = tgluon.Trainer(tnet.collect_params(), name, dict(kw))
    _train(tmx, tnet, ttr, 2)
    fname = str(tmp_path / "trainer.states")
    ttr.save_states(fname)
    snapshot = params_to_numpy(tnet)
    first = _train(tmx, tnet, ttr, 2)
    after = params_to_numpy(tnet)

    tnet.load_dict(snapshot, device="cpu")
    fresh = tgluon.Trainer(tnet.collect_params(), name,
                           {"learning_rate": 0.5})
    fresh.load_states(fname)
    assert fresh.learning_rate == 0.1 and fresh.optimizer.num_update == 2
    assert fresh.optimizer.param_dict[0] is fresh._params[0]
    again = _train(tmx, tnet, fresh, 2)
    assert again == first
    for n, v in params_to_numpy(tnet).items():
        np.testing.assert_array_equal(v, after[n], err_msg=n)


def test_trainer_step_matches_train_step():
    """One SGD-momentum step of the eager loop against ``TrainStep`` from
    the same parameters and batch (the running statistics, which only the
    eager loop writes, left out)."""
    _, tnet = _pair()
    twin = _build(tgnn)
    twin.load_dict(params_to_numpy(tnet), device="cpu")
    ce = tgluon.loss.SoftmaxCrossEntropyLoss()
    step = TrainStep(twin, lambda out, y: ce(out, y).mean(), device="cpu",
                     learning_rate=0.1, momentum=0.9)
    x, y = _batch()
    want = float(step(torch.from_numpy(x), torch.from_numpy(y)))
    trainer = tgluon.Trainer(tnet.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
    got = _step(tmx, tnet, trainer, ce)
    assert abs(got - want) <= 1e-6 * abs(want)
    for name, p in tnet.collect_params().items():
        if p.grad_req == "null":
            continue
        a, b = p.data().data.detach(), step.params[name]
        assert float((a - b).norm()) <= 1e-6 * float(b.norm()), name


def test_trainer_api():
    _, tnet = _pair()
    params = tnet.collect_params()
    tr = tgluon.Trainer(params, "sgd", {"learning_rate": 0.2})
    assert [p.name for p in tr._params] == sorted(params)
    assert "1.running_mean" in [p.name for p in tr._params]
    assert tr.learning_rate == 0.2
    tr.set_learning_rate(0.05)
    assert tr.optimizer.lr == 0.05
    from mxnet_tpu_torch.step import CompiledStep
    compiled = tr.make_compiled_step(tnet, None)
    assert isinstance(compiled, CompiledStep) and compiled.compiled
    with pytest.raises(ValueError, match="Parameters"):
        tgluon.Trainer([torch.zeros(2)], "sgd")
    with pytest.raises(ValueError, match="list or dict"):
        tgluon.Trainer(3, "sgd")
    listed = tgluon.Trainer(list(params.values()), "sgd")
    assert [p.name for p in listed._params] == list(params)
    # allreduce_grads + update is step; grad_req 'null' is not updated
    stats = params["1.running_mean"].data().asnumpy()
    x, y = _batch()
    ce = tgluon.loss.SoftmaxCrossEntropyLoss()
    with tag.record():
        loss = ce(tnet(tnd.array(x)), tnd.array(y))
    loss.backward()
    written = params["1.running_mean"].data().asnumpy()
    assert not np.array_equal(written, stats)
    w = params["3.weight"].data().asnumpy()
    g = params["3.weight"].grad().asnumpy()
    tr.allreduce_grads()
    tr.update(B)
    np.testing.assert_allclose(params["3.weight"].data().asnumpy(),
                               w - 0.05 * g / B, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(params["1.running_mean"].data().asnumpy(),
                                  written)
    opt = tmx.optimizer.SGD(learning_rate=0.3)
    assert tgluon.Trainer(params, opt).optimizer is opt
    with pytest.raises(AssertionError):
        tgluon.Trainer(params, opt, {"learning_rate": 0.1})


def test_trainer_before_any_backward_sees_zero_gradients():
    net = tgnn.Dense(3, in_units=2)
    net.initialize(device="cpu", seed=0)
    w = net.weight.data().data.clone()
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0})
    tr.step(1)
    assert torch.equal(net.weight.data().data, w)


# ---------------------------------------------------------------------------
# metrics and utilities
# ---------------------------------------------------------------------------

def _preds(seed=7, n=12, k=4):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, k).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rng.randint(0, k, n).astype(np.float32)
    return probs.astype(np.float32), labels


METRICS = {
    "acc": lambda m: m.Accuracy(),
    "top_k_acc": lambda m: m.TopKAccuracy(top_k=2),
    "f1_macro": lambda m: m.F1(),
    "f1_micro": lambda m: m.F1(average="micro"),
    "mcc": lambda m: m.MCC(),
    "perplexity": lambda m: m.Perplexity(ignore_label=1),
    "mae": lambda m: m.MAE(),
    "mse": lambda m: m.MSE(),
    "rmse": lambda m: m.RMSE(),
    "ce": lambda m: m.CrossEntropy(),
    "nll": lambda m: m.NegativeLogLikelihood(),
    "pearson": lambda m: m.PearsonCorrelation(),
    "loss": lambda m: m.Loss(),
    "custom": lambda m: m.np(lambda l, p: float(np.abs(l - p).sum())),
    "composite": lambda m: m.create(["acc", "ce"]),
}
BINARY = ("f1_macro", "f1_micro", "mcc")
REGRESSION = ("mae", "mse", "rmse", "pearson", "custom")


def _metric_inputs(key, seed):
    probs, labels = _preds(seed)
    if key in BINARY:
        probs, labels = probs[:, :2] / probs[:, :2].sum(1, keepdims=True), \
            (labels > 1).astype(np.float32)
    if key in REGRESSION:
        probs = probs[:, 0] * 3.0
        labels = labels + 0.1
    return labels, probs


@pytest.mark.parametrize("key", sorted(METRICS))
def test_metric_matches_reference(key):
    jm, tm = METRICS[key](jmetric), METRICS[key](tmetric)
    for seed in (7, 8):
        labels, preds = _metric_inputs(key, seed)
        jm.update([jnd.array(labels)], [jnd.array(preds)])
        tm.update([tnd.array(labels)], [tnd.array(preds)])
    # the device sums stay on the device until get()
    if key in ("acc", "perplexity", "mae", "ce", "loss"):
        assert isinstance(tm._dev_sum, torch.Tensor)
    jname, jval = jm.get()
    tname, tval = tm.get()
    assert tname == jname
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    labels, preds = _metric_inputs(key, 9)
    tm.reset()
    tm.update([labels], [preds])
    jm.reset()
    jm.update([labels], [preds])
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-5)


def test_metric_create_and_checks():
    assert isinstance(tmetric.create("acc"), tmetric.Accuracy)
    assert isinstance(tmetric.create("top_k_accuracy", top_k=3),
                      tmetric.TopKAccuracy)
    assert tmetric.create("rmse").get()[0] == "rmse"
    assert np.isnan(tmetric.create("mse").get()[1])
    with pytest.raises(ValueError):
        tmetric.create("no_such_metric")
    with pytest.raises(ValueError, match="does not match"):
        tmetric.Accuracy().update([tnd.array(np.zeros(3, np.float32))],
                                  [tnd.array(np.zeros((4, 2), np.float32))])
    assert tmetric.Accuracy().get_config()["metric"] == "Accuracy"


def test_clip_global_norm_matches_reference():
    rng = np.random.RandomState(3)
    arrays = [rng.randn(4, 5).astype(np.float32) * 3,
              rng.randn(7).astype(np.float32)]
    for max_norm in (1.0, 100.0):
        ja = [jnd.array(a) for a in arrays]
        ta = [tnd.array(a) for a in arrays]
        jn = jutils.clip_global_norm(ja, max_norm)
        tn = tutils.clip_global_norm(ta, max_norm)
        np.testing.assert_allclose(tn, jn, rtol=1e-6)
        for a, b in zip(ta, ja):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                       atol=1e-7)


def test_split_and_load_match_reference():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    for n, even in ((2, True), (3, False), (1, True)):
        jparts = jutils.split_data(jnd.array(x), n, even_split=even)
        tparts = tutils.split_data(tnd.array(x), n, even_split=even)
        assert [p.shape for p in tparts] == [p.shape for p in jparts]
        for a, b in zip(tparts, jparts):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    with pytest.raises(ValueError, match="evenly"):
        tutils.split_data(tnd.array(x), 3)
    (loaded,) = tutils.split_and_load(x, [tmx.cpu()])
    assert loaded.context == tmx.cpu()
    np.testing.assert_array_equal(loaded.asnumpy(), x)
    parts = tutils.split_and_load(tnd.array(x), [tmx.cpu(0), tmx.cpu(1)])
    jparts = jutils.split_and_load(jnd.array(x), [jmx.cpu(0), jmx.cpu(1)])
    assert [p.shape for p in parts] == [(5, 3), (5, 3)]
    assert [str(p.context) for p in parts] == \
        [str(p.context) for p in jparts] == ["cpu(0)", "cpu(1)"]


def test_several_contexts_in_one_process_train_as_the_reference():
    """The conv net moved onto copies on cpu(0) and cpu(1)
    (``Block.reset_ctx``) trains through the classic loop, each copy on
    half the batch, as the reference's does: every copy's parameters (each
    BatchNorm copy's statistics included) within rtol 1e-4, atol 1e-5."""
    jnet, tnet = _pair()
    x, y = _batch()
    got = []
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        ctxs = [pkg.cpu(0), pkg.cpu(1)]
        net.collect_params().reset_ctx(ctxs)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(STEPS):
            xs = pkg.gluon.utils.split_and_load(x, ctxs)
            ys = pkg.gluon.utils.split_and_load(y, ctxs)
            with pkg.autograd.record():
                losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
            pkg.autograd.backward(losses)
            trainer.step(B)
        got.append({n: [d.asnumpy() for d in p.list_data()]
                    for n, p in net.collect_params().items()})
    assert list(got[1]) == list(got[0])
    for name, copies in got[0].items():
        assert len(got[1][name]) == len(copies) == 2
        for a, b in zip(got[1][name], copies):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
