"""Every loss of ``gluon.loss`` and the ``CTCLoss`` op against the JAX
reference on the CPU.

Each loss class is built with the same arguments in both packages and
called on NDArrays made from the same seeded numpy inputs, with a number
``weight``, a ``sample_weight`` and the class's own options: the values
and the gradients of ``sum(loss * cotangent)`` with respect to every
floating input agree within 1e-4.  The cases of the reference's
``tests/test_loss.py`` run on the port too, against their numpy answers;
CTC is held with the blank first and last, with explicit lengths, in both
layouts, and on an alignment that cannot exist (the reference's loss is
near 1e30 there, not inf).
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as jautograd, nd as jnd
from mxnet_tpu.gluon import loss as jloss

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd, gluon, nd as tnd
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import registry

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
PACKAGES = {"jax": (jnd, jautograd, jloss), "port": (tnd, tautograd, tloss)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def rnd(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def run(name, ctor, inputs, call=None, grad_of=None, seed=0):
    """Loss class ``name(**ctor)`` of both packages on ``inputs`` (numpy;
    ``call`` holds keyword inputs, numpy or numbers); returns {package:
    (value, [gradients of the inputs in grad_of])} for ``sum(loss *
    cotangent)``.  ``grad_of`` defaults to every floating positional
    input."""
    call = call or {}
    if grad_of is None:
        grad_of = [i for i, a in enumerate(inputs)
                   if np.issubdtype(a.dtype, np.floating)]
    res = {}
    for pkg, (nd, autograd, mod) in PACKAGES.items():
        loss = getattr(mod, name)(**ctor)
        arrs = [nd.array(a, dtype=a.dtype) for a in inputs]
        kw = {k: nd.array(v, dtype=v.dtype) if isinstance(v, np.ndarray)
              else v for k, v in call.items()}
        for i in grad_of:
            arrs[i].attach_grad()
        with autograd.record():
            out = loss(*arrs, **kw)
            cot = nd.array(np.asarray(np.random.RandomState(seed + 9)
                                      .randn(*out.shape), np.float32))
            head = (out * cot).sum()
        head.backward()
        res[pkg] = (out.asnumpy(), [arrs[i].grad.asnumpy() for i in grad_of])
    return res


def assert_same(res, tol=TOL):
    (jv, jg), (tv, tg) = res["jax"], res["port"]
    assert jv.shape == tv.shape and jv.dtype == tv.dtype, \
        (jv.shape, tv.shape, jv.dtype, tv.dtype)
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def test_every_reference_loss_is_ported():
    assert sorted(tloss.__all__) == sorted(jloss.__all__)


PRED = rnd(4, 3)
LABEL = rnd(4, 3, seed=1)
SIGNS = np.sign(rnd(4, 3, seed=2)).astype(np.float32)
BINARY = (rnd(4, 3, seed=3) > 0).astype(np.float32)
PROBS = rnd(4, 3, seed=4, lo=0.05, hi=0.95)
SW = rnd(4, 1, seed=5, lo=0.1, hi=2.0)
DIST = np.abs(rnd(4, 5, seed=6)) + 0.1
DIST = (DIST / DIST.sum(-1, keepdims=True)).astype(np.float32)

CASES = [
    ("L1Loss", {}, [PRED, LABEL], {}),
    ("L1Loss", {"weight": 2.0, "batch_axis": 1}, [PRED, LABEL], {}),
    ("L1Loss", {}, [PRED, LABEL], {"sample_weight": SW}),
    ("L2Loss", {"weight": 0.5}, [PRED, LABEL], {"sample_weight": SW}),
    ("SigmoidBinaryCrossEntropyLoss", {}, [PRED * 3, BINARY], {}),
    ("SigmoidBCELoss", {"weight": 1.5}, [PRED * 3, BINARY],
     {"sample_weight": SW}),
    ("SigmoidBCELoss", {}, [PRED * 3, BINARY],
     {"pos_weight": rnd(1, 3, seed=7, lo=0.5, hi=3.0)}),
    ("SigmoidBCELoss", {"from_sigmoid": True}, [PROBS, BINARY], {}),
    ("SigmoidBCELoss", {"from_sigmoid": True}, [PROBS, BINARY],
     {"pos_weight": rnd(1, 3, seed=7, lo=0.5, hi=3.0)}),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False},
     [rnd(4, 5), DIST], {"sample_weight": SW}),
    ("KLDivLoss", {}, [np.log(DIST[::-1]).astype(np.float32), DIST], {}),
    ("KLDivLoss", {"from_logits": False, "weight": 0.7}, [rnd(4, 5), DIST],
     {"sample_weight": SW}),
    ("KLDivLoss", {"from_logits": False, "axis": 0}, [rnd(4, 5), DIST], {}),
    ("HuberLoss", {}, [PRED, LABEL], {}),
    ("HuberLoss", {"rho": 0.5, "weight": 2.0}, [PRED, LABEL],
     {"sample_weight": SW}),
    ("HingeLoss", {}, [PRED, SIGNS], {}),
    ("HingeLoss", {"margin": 2.0, "weight": 0.5}, [PRED, SIGNS],
     {"sample_weight": SW}),
    ("SquaredHingeLoss", {}, [PRED, SIGNS], {}),
    ("SquaredHingeLoss", {"margin": 0.5}, [PRED, SIGNS],
     {"sample_weight": SW}),
    ("LogisticLoss", {}, [PRED * 2, SIGNS], {}),
    ("LogisticLoss", {"label_format": "binary", "weight": 3.0},
     [PRED * 2, BINARY], {"sample_weight": SW}),
    ("TripletLoss", {}, [PRED, LABEL, rnd(4, 3, seed=8)], {}),
    ("TripletLoss", {"margin": 3.0, "weight": 0.5},
     [rnd(4, 2, 3), rnd(4, 2, 3, seed=1), rnd(4, 2, 3, seed=2)],
     {"sample_weight": SW[:, 0]}),
    ("PoissonNLLLoss", {}, [PRED, np.abs(LABEL) * 3], {}),
    ("PoissonNLLLoss", {"from_logits": False},
     [PROBS * 4, np.abs(LABEL) * 3], {}),
    ("PoissonNLLLoss", {"compute_full": True, "weight": 0.5},
     [PRED, np.abs(LABEL) * 3 + 0.1], {"sample_weight": SW}),
    ("CosineEmbeddingLoss", {}, [PRED, LABEL,
                                 np.array([1, -1, 1, -1], np.float32)], {}),
    ("CosineEmbeddingLoss", {"margin": 0.3, "weight": 2.0},
     [rnd(4, 6), rnd(4, 6, seed=1), np.array([-1, -1, 1, -1], np.float32)],
     {"sample_weight": SW[:, 0]}),
    ("SDMLLoss", {}, [rnd(6, 4), rnd(6, 4, seed=1)], {}),
    ("SDMLLoss", {"smoothing_parameter": 0.1},
     [rnd(5, 3), rnd(5, 3, seed=2)], {}),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_loss_answers_as_the_reference(case):
    name, ctor, inputs, call = CASES[case]
    grad_of = [i for i in range(len(inputs))
               if not (name == "CosineEmbeddingLoss" and i == 2)]
    assert_same(run(name, ctor, inputs, call, grad_of=grad_of))


# -- CTC ----------------------------------------------------------------------

def ctc_case(t, n, c, lengths, seed, blank="first"):
    """pred (T, N, C) logits and labels padded as ``blank`` asks."""
    rng = np.random.RandomState(seed)
    pred = rng.randn(t, n, c).astype(np.float32)
    width = max(lengths)
    label = np.zeros((n, width), np.float32) if blank == "first" \
        else np.full((n, width), -1.0, np.float32)
    for i, k in enumerate(lengths):
        lo = 1 if blank == "first" else 0
        hi = c if blank == "first" else c - 1
        label[i, :k] = rng.randint(lo, hi, k)
    return pred, label


def run_ctc(pred, label, **params):
    res = {}
    for pkg, (nd, autograd, _) in PACKAGES.items():
        p = nd.array(pred)
        p.attach_grad()
        extra = {k: nd.array(v) for k, v in params.items()
                 if isinstance(v, np.ndarray)}
        plain = {k: v for k, v in params.items()
                 if not isinstance(v, np.ndarray)}
        with autograd.record():
            out = nd.CTCLoss(p, nd.array(label), extra.get("data_lengths"),
                             extra.get("label_lengths"), **plain)
            cot = nd.array(np.linspace(0.5, 1.5, out.shape[0])
                           .astype(np.float32))
            head = (out * cot).sum()
        head.backward()
        res[pkg] = (out.asnumpy(), [p.grad.asnumpy()])
    return res


@pytest.mark.parametrize("alias", ["CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                                   "_contrib_ctc_loss"])
def test_ctc_op_and_its_aliases(alias):
    assert registry.get_op(alias) is registry.get_op("CTCLoss")
    pred, label = ctc_case(6, 3, 5, [2, 3, 1], 1)
    out = {k: nd.invoke(alias, nd.array(pred), nd.array(label)).asnumpy()
           for k, (nd, _, _) in PACKAGES.items()}
    np.testing.assert_allclose(out["port"], out["jax"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_blank_first_and_last(blank):
    pred, label = ctc_case(7, 3, 5, [2, 3, 1], 2, blank=blank)
    assert_same(run_ctc(pred, label, blank_label=blank))


def test_ctc_with_explicit_lengths():
    pred, label = ctc_case(8, 3, 6, [3, 4, 2], 3)
    assert_same(run_ctc(pred, label,
                        data_lengths=np.array([8, 6, 5], np.float32),
                        label_lengths=np.array([3, 2, 2], np.float32)))
    pred, label = ctc_case(8, 2, 6, [3, 4], 4, blank="last")
    assert_same(run_ctc(pred, label, blank_label="last",
                        data_lengths=np.array([7, 8], np.float32),
                        label_lengths=np.array([3, 3], np.float32)))


def test_ctc_with_repeated_labels_and_an_empty_label():
    pred, _ = ctc_case(6, 3, 4, [1], 5)
    label = np.array([[2, 2, 3], [1, 0, 0], [0, 0, 0]], np.float32)
    assert_same(run_ctc(pred, label))


def test_ctc_of_an_alignment_that_cannot_exist():
    # three 1s need five frames (1, blank, 1, blank, 1); there are three
    pred, _ = ctc_case(3, 2, 3, [1], 6)
    label = np.array([[1, 1, 1], [2, 1, 0]], np.float32)
    res = run_ctc(pred, label)
    assert_same(res)
    loss = res["port"][0]
    assert 1e29 < loss[0] < 1e31 and loss[1] < 100 and np.isfinite(loss).all()


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "NT"),
                                                 ("NTC", "TN")])
def test_ctc_loss_block_layouts(layout, label_layout):
    pred, label = ctc_case(6, 3, 5, [2, 3, 1], 7)
    if layout == "NTC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    assert_same(run("CTCLoss", {"layout": layout,
                                "label_layout": label_layout},
                    [pred, label], grad_of=[0]))
    assert_same(run("CTCLoss", {"layout": layout,
                                "label_layout": label_layout, "weight": 2.0},
                    [pred, label],
                    {"pred_lengths": np.array([6, 5, 4], np.float32),
                     "label_lengths": np.array([2, 2, 1], np.float32),
                     "sample_weight": np.array([1.0, 0.5, 2.0],
                                               np.float32)},
                    grad_of=[0]))


# -- the cases of tests/test_loss.py, on the port -----------------------------

def test_l2_loss():
    pred = tnd.array(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    label = tnd.array(np.array([[1.5, 1.5], [3.0, 5.0]], np.float32))
    expect = 0.5 * ((np.array([[1, 2], [3, 4.]]) -
                     np.array([[1.5, 1.5], [3, 5.]])) ** 2).mean(axis=1)
    np.testing.assert_allclose(gluon.loss.L2Loss()(pred, label).asnumpy(),
                               expect, atol=1e-6)


def test_l1_loss():
    out = gluon.loss.L1Loss()(tnd.array([[1.0, -2.0]]),
                              tnd.array([[0.0, 0.0]])).asnumpy()
    np.testing.assert_allclose(out, [1.5])


def test_softmax_ce_sparse_vs_dense():
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 4).astype(np.float32)
    labels = rng.randint(0, 4, 6)
    onehot = np.eye(4, dtype=np.float32)[labels]
    sparse = gluon.loss.SoftmaxCrossEntropyLoss()(
        tnd.array(logits), tnd.array(labels.astype(np.float32))).asnumpy()
    dense = gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False)(
        tnd.array(logits), tnd.array(onehot)).asnumpy()
    logp = logits - logits.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    expect = -logp[np.arange(6), labels]
    np.testing.assert_allclose(sparse, expect, atol=1e-5)
    np.testing.assert_allclose(dense, expect, atol=1e-5)


def test_sigmoid_bce():
    rng = np.random.RandomState(0)
    pred = rng.randn(4, 3).astype(np.float32)
    label = (rng.rand(4, 3) > 0.5).astype(np.float32)
    out = gluon.loss.SigmoidBCELoss()(tnd.array(pred),
                                      tnd.array(label)).asnumpy()
    p = 1 / (1 + np.exp(-pred))
    expect = -(label * np.log(p) + (1 - label) * np.log(1 - p)).mean(axis=1)
    np.testing.assert_allclose(out, expect, atol=1e-5)


def test_kl_div():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 5).astype(np.float32)
    target = rng.rand(3, 5).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    logp = logits - logits.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    out = gluon.loss.KLDivLoss(from_logits=False)(
        tnd.array(logits), tnd.array(target)).asnumpy()
    expect = (target * (np.log(target + 1e-12) - logp)).mean(axis=-1)
    np.testing.assert_allclose(out, expect, atol=1e-5)


def test_huber_loss():
    out = gluon.loss.HuberLoss(rho=1.0)(tnd.array([0.0, 2.0]),
                                        tnd.array([0.5, 0.0])).asnumpy()
    np.testing.assert_allclose(out, [0.125, 1.5], atol=1e-6)


def test_hinge_loss():
    out = gluon.loss.HingeLoss()(tnd.array([[0.3], [-2.0]]),
                                 tnd.array([[1.0], [-1.0]])).asnumpy()
    np.testing.assert_allclose(out, [0.7, 0.0], atol=1e-6)


def test_loss_backward_flows():
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    pred = tnd.array(x)
    pred.attach_grad()
    with tautograd.record():
        out = gluon.loss.SoftmaxCrossEntropyLoss()(
            pred, tnd.array([0.0, 1.0, 2.0, 0.0])).sum()
    out.backward()
    p = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    onehot = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    np.testing.assert_allclose(pred.grad.asnumpy(), p - onehot, atol=1e-5)


def test_ctc_loss_simple():
    logits = np.full((3, 1, 3), -5.0, np.float32)
    logits[:, 0, 1] = 5.0
    out = gluon.loss.CTCLoss(layout="TNC")(
        tnd.array(logits), tnd.array(np.array([[1.0]], np.float32)))
    out = out.asnumpy()
    assert out.shape == (1,) and np.isfinite(out).all() and out[0] < 1.0


def test_ctc_loss_grad():
    logits = tnd.array(np.random.RandomState(0).randn(5, 2, 4)
                       .astype(np.float32))
    logits.attach_grad()
    with tautograd.record():
        out = gluon.loss.CTCLoss(layout="TNC")(
            logits, tnd.array(np.array([[1, 2], [3, 0]], np.float32))).sum()
    out.backward()
    assert np.isfinite(logits.grad.asnumpy()).all()


def test_ctc_blank_last_matches_first():
    rng = np.random.RandomState(1)
    first = rng.randn(6, 2, 5).astype(np.float32)
    labels = np.array([[1, 2, 0], [3, 1, 4]], np.float32)
    l_first = tnd.ctc_loss(tnd.array(first), tnd.array(labels)).asnumpy()
    last = np.concatenate([first[..., 1:], first[..., :1]], axis=-1)
    l_last = tnd.ctc_loss(tnd.array(last),
                          tnd.array(np.where(labels > 0, labels - 1, -1)),
                          blank_label="last").asnumpy()
    np.testing.assert_allclose(l_first, l_last, atol=1e-4)


def test_triplet_loss():
    a = tnd.array(np.zeros((2, 3), np.float32))
    n = tnd.array(np.ones((2, 3), np.float32))
    np.testing.assert_allclose(
        gluon.loss.TripletLoss(margin=1.0)(a, a, n).asnumpy(), 0.0)
    np.testing.assert_allclose(
        gluon.loss.TripletLoss(margin=5.0)(a, a, n).asnumpy(), 2.0)


def test_metrics_accuracy_create_and_perplexity():
    from mxnet_tpu_torch import metric
    acc = metric.Accuracy()
    acc.update([tnd.array([0.0, 1.0, 1.0])],
               [tnd.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]])])
    assert acc.get()[0] == "accuracy"
    assert abs(acc.get()[1] - 2.0 / 3) < 1e-6
    assert isinstance(metric.create(["accuracy", "mse"]),
                      metric.CompositeEvalMetric)
    assert isinstance(metric.create("top_k_accuracy", top_k=3),
                      metric.TopKAccuracy)
    ppl = metric.Perplexity(ignore_label=None)
    ppl.update([tnd.array([0.0, 0.0])], [tnd.array([[0.5, 0.5],
                                                    [0.9, 0.1]])])
    expect = np.exp(-(np.log(0.5) + np.log(0.9)) / 2)
    assert abs(ppl.get()[1] - expect) < 1e-5


def test_sdml_loss_prefers_aligned_pairs_and_trains():
    rng = np.random.RandomState(0)
    x = tnd.array(rng.randn(8, 16).astype(np.float32))
    loss_fn = gluon.loss.SDMLLoss(smoothing_parameter=0.3)
    aligned = float(loss_fn(x, x).mean().asscalar())
    shuffled = float(loss_fn(x, tnd.array(x.asnumpy()[::-1].copy()))
                     .mean().asscalar())
    assert aligned < shuffled
    net = gluon.nn.Dense(16)
    net.initialize(tmx.init.Xavier(), device="cpu")
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-2})
    x1 = tnd.array(rng.randn(16, 32).astype(np.float32))
    x2 = x1 + 0.1 * tnd.array(rng.randn(16, 32).astype(np.float32))
    losses = []
    for _ in range(25):
        with tautograd.record():
            out = loss_fn(net(x1), net(x2)).mean()
        out.backward()
        trainer.step(16)
        losses.append(float(out.asscalar()))
    assert losses[-1] < losses[0]


def test_losses_reach_the_registered_ops(monkeypatch):
    seen = []
    real = registry.dispatch

    def spy(name, *args, **params):
        seen.append(name)
        return real(name, *args, **params)

    monkeypatch.setattr(tloss, "dispatch", spy)
    x = tnd.array(PRED)
    tloss.HuberLoss()(x, tnd.array(LABEL))
    tloss.SDMLLoss()(x, x)
    tloss.CTCLoss()(tnd.array(rnd(2, 4, 3)), tnd.array(np.ones((2, 1),
                                                                np.float32)))
    assert {"where", "dot", "log_softmax", "_eye", "CTCLoss"} <= set(seen)
