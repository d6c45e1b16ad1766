"""The ops the port's layers compute, as registered ops, against the JAX
reference on the CPU.

``FullyConnected``, ``LayerNorm``, ``Embedding``, ``multi_head_attention``,
``pick``, ``pad`` and ``softmax_cross_entropy`` are called as ``nd.<op>``
(or through ``invoke``) in both packages on the same seeded numpy inputs,
under the reference's names, aliases and parameters: values and the
gradients of ``sum(out * cotangent)`` with respect to every floating input
at 1e-4 (fp32).  Then the gluon layers, the BERT zoo and the losses are
shown to reach these ops through the one registered route
(``registry.dispatch``), on ``nd``, ``Block.__call__`` and
``functionalize`` alike.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, nd as jnd
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd, gluon, nd as tnd
from mxnet_tpu_torch.gluon.block import functionalize
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from mxnet_tpu_torch.ops import registry

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
PACKAGES = {"jax": (jnd, jautograd, jinvoke),
            "port": (tnd, tautograd, tinvoke)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def run(fn, inputs, grad_of=(), seed=0):
    """``fn(nd, invoke, *arrays)`` in both packages; returns {package:
    (value, [gradients of the inputs in grad_of])}, the gradients of
    ``sum(out * cotangent)`` with one seeded cotangent."""
    res = {}
    for name, (nd, autograd, invoke) in PACKAGES.items():
        arrs = [nd.array(a, dtype=a.dtype) for a in inputs]
        for i in grad_of:
            arrs[i].attach_grad()
        with autograd.record():
            out = fn(nd, invoke, *arrs)
            cot = nd.array(np.asarray(np.random.RandomState(seed + 7)
                                      .randn(*out.shape), np.float32))
            head = (out * cot).sum()
        if grad_of:
            head.backward()
        res[name] = (out.asnumpy(), [arrs[i].grad.asnumpy()
                                     for i in grad_of])
    return res


def assert_close(res, tol=TOL):
    (jv, jg), (tv, tg) = res["jax"], res["port"]
    assert jv.shape == tv.shape and jv.dtype == tv.dtype, \
        (jv.shape, tv.shape, jv.dtype, tv.dtype)
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_fully_connected_answers_as_the_reference():
    ones = np.ones((1, 3), np.float32)
    out = {k: nd.FullyConnected(nd.array(ones), nd.array(np.ones((3, 3),
                                np.float32)), nd.array(np.zeros(3,
                                np.float32)), num_hidden=3).asnumpy()
           for k, (nd, _, _) in PACKAGES.items()}
    np.testing.assert_array_equal(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"], [[3.0, 3.0, 3.0]])


@pytest.mark.parametrize("case", ["flatten", "no_flatten", "no_bias",
                                  "alias"])
def test_fully_connected(case):
    x = rnd(4, 3, 5)
    if case == "flatten":
        ins = [x, rnd(6, 15, seed=1), rnd(6, seed=2)]
        fn = lambda nd, inv, *a: nd.FullyConnected(*a, num_hidden=6)
    elif case == "no_flatten":
        ins = [x, rnd(6, 5, seed=1), rnd(6, seed=2)]
        fn = lambda nd, inv, *a: nd.FullyConnected(*a, num_hidden=6,
                                                   flatten=False)
    elif case == "no_bias":
        ins = [x, rnd(6, 15, seed=1)]
        fn = lambda nd, inv, *a: nd.FullyConnected(*a, num_hidden=6,
                                                   no_bias=True)
    else:
        ins = [x, rnd(6, 15, seed=1), rnd(6, seed=2)]
        fn = lambda nd, inv, *a: inv("fully_connected", *a, num_hidden=6)
    assert_close(run(fn, ins, grad_of=range(len(ins))))


@pytest.mark.parametrize("shape,axis", [((4, 8), -1), ((2, 3, 4), 1)])
def test_layer_norm(shape, axis):
    n = shape[axis]
    ins = [rnd(*shape) * 3 + 1, rnd(n, seed=1), rnd(n, seed=2)]
    assert_close(run(lambda nd, inv, *a: nd.LayerNorm(*a, axis=axis,
                                                      eps=1e-5),
                     ins, grad_of=(0, 1, 2)))


def test_embedding_gathers_rows_and_their_gradient():
    idx = np.array([[0, 3, 9], [4, 4, 1]], np.float32)
    ins = [idx, rnd(10, 6)]
    assert_close(run(lambda nd, inv, *a: nd.Embedding(
        *a, input_dim=10, output_dim=6), ins, grad_of=(1,)))


def test_embedding_out_of_range_is_nan_as_in_the_reference():
    idx = np.array([0, 10, -1, 12], np.float32)
    w = rnd(10, 3)
    res = run(lambda nd, inv, *a: nd.Embedding(*a, input_dim=10,
                                               output_dim=3), [idx, w])
    np.testing.assert_array_equal(np.isnan(res["port"][0]),
                                  np.isnan(res["jax"][0]))
    assert_close(res)


@pytest.mark.parametrize("kind", ["plain", "causal", "mask", "unscaled"])
def test_multi_head_attention(kind):
    q, k, v = rnd(2, 5, 8), rnd(2, 5, 8, seed=1), rnd(2, 5, 8, seed=2)
    ins = [q, k, v]
    kw = {"num_heads": 2, "scaled": kind != "unscaled",
          "causal": kind == "causal"}
    if kind == "mask":
        ins.append((np.arange(5)[None, None, None, :] <
                    np.array([3, 5])[:, None, None, None])
                   .astype(np.float32))
    assert_close(run(lambda nd, inv, *a: inv("multi_head_attention", *a,
                                             **kw),
                     ins, grad_of=(0, 1, 2)))


@pytest.mark.parametrize("axis,keepdims", [(-1, False), (-1, True),
                                           (0, False)])
def test_pick(axis, keepdims):
    x = rnd(4, 5)
    n = x.shape[axis]
    other = x.shape[1 - (axis % 2)]
    index = np.array([0, n - 1, 2, 7, -3][:other], np.float32)
    assert_close(run(lambda nd, inv, *a: nd.pick(*a, axis=axis,
                                                 keepdims=keepdims),
                     [x, index], grad_of=(0,)))


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad(mode):
    x = rnd(1, 2, 4, 5)
    pw = (0, 0, 0, 0, 1, 2, 3, 1)
    assert_close(run(lambda nd, inv, *a: nd.pad(
        *a, mode=mode, pad_width=pw, constant_value=1.5), [x],
        grad_of=(0,)))


def test_pad_alias_and_leading_axes():
    x = rnd(3, 4)
    assert_close(run(lambda nd, inv, *a: nd.Pad(
        *a, mode="edge", pad_width=(1, 2, 0, 3)), [x], grad_of=(0,)))


def test_softmax_cross_entropy():
    data = rnd(4, 6)
    label = np.array([0, 5, 2, 9], np.float32)     # 9 is out of range
    assert_close(run(lambda nd, inv, *a: nd.softmax_cross_entropy(*a),
                     [data, label], grad_of=(0,)))


# ---------------------------------------------------------------------------
# the layers reach the registered ops
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """Counts of each registered op run through the registry, by name."""
    seen = {}
    for name in ("FullyConnected", "LayerNorm", "Embedding",
                 "multi_head_attention", "pick", "log_softmax", "LeakyReLU",
                 "Activation", "Convolution", "Pooling", "pad"):
        op = registry.get_op(name)

        def counted(*a, _fn=op.fn, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(op, "fn", counted)
    return seen


def _small_bert():
    net = tbert.BERTModel(num_layers=2, units=16, hidden_size=32,
                          num_heads=2, vocab_size=20, max_length=8,
                          dropout=0.0)
    net.initialize(device="cpu")
    return net


def test_bert_layers_reach_the_registered_ops(calls):
    net = _small_bert()
    tokens = torch.randint(0, 20, (2, 8))
    types = torch.zeros(2, 8, dtype=torch.long)
    net(tokens, types)
    assert calls["multi_head_attention"] == 2
    # qkv, proj, ffn_1, ffn_2 per layer; pooler, classifier, decoder x 2
    assert calls["FullyConnected"] == 2 * 4 + 4
    assert calls["LayerNorm"] == 1 + 2 * 2 + 1
    assert calls["Embedding"] == 3
    assert calls["LeakyReLU"] == 2 + 1              # the GELUs
    calls.clear()
    pure, params = functionalize(net)
    pure(params, tokens, types)
    assert calls["multi_head_attention"] == 2
    calls.clear()
    net(tnd.array(tokens.numpy(), dtype="int32"),
        tnd.array(types.numpy(), dtype="int32"))
    assert calls["multi_head_attention"] == 2


def test_conv_layers_and_losses_reach_the_registered_ops(calls):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(4, 3, in_channels=2, activation="relu"),
            gluon.nn.MaxPool2D(2), gluon.nn.ReflectionPad2D(1),
            gluon.nn.Dense(3))
    net.initialize(device="cpu")
    out = net(torch.randn(2, 2, 8, 8))
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, torch.tensor([0, 2]))
    assert loss.shape == (2,)
    assert (calls["Convolution"], calls["Activation"], calls["Pooling"],
            calls["pad"], calls["FullyConnected"], calls["log_softmax"],
            calls["pick"]) == (1, 1, 1, 1, 1, 1, 1)
