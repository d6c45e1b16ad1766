"""The normalisation and activation layers and ops that AMP's lists name,
against the JAX reference on the CPU.

``GroupNorm``, ``InstanceNorm``, ``LeakyReLU``, ``PReLU``, ``ELU``,
``SELU`` and ``GELU`` as gluon layers with deferred sizes (parameters
carried by name with ``convert.params_from_mxnet_tpu``), then ``Flatten``,
``Identity``, ``Lambda``, ``HybridLambda``, ``Concatenate``,
``HybridConcatenate`` and ``Swish`` (``SiLU``), and the ops
``LeakyReLU`` (every ``act_type``), ``GroupNorm``, ``InstanceNorm``,
``L2Normalization`` and ``norm`` through ``nd``: forward values and the
gradients of ``sum(out * cotangent)`` at 1e-4 in fp32.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, nd as jnd
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd, nd as tnd
from mxnet_tpu_torch.convert import params_from_mxnet_tpu, params_to_numpy
from mxnet_tpu_torch.gluon import nn as tnn

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def rnd(*shape, seed=0):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def grads_of(nd, autograd, fn, inputs, seed=5):
    arrs = [nd.array(a) for a in inputs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = fn(*arrs)
        cot = nd.array(rnd(*out.shape, seed=seed))
        head = (out * cot).sum()
    head.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in arrs]


def assert_same(j, t):
    np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)
    for a, b in zip(j[1], t[1]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["leaky", "prelu", "elu", "selu", "gelu",
                                 "gelu_tanh", "rrelu"])
def test_leaky_relu_op(act):
    x = rnd(2, 3, 4) * 2
    ins = [x, np.array([0.1, 0.3, -0.2], np.float32)] if act == "prelu" \
        else [x]

    def op(nd):
        return lambda *a: nd.LeakyReLU(*a, act_type=act, slope=0.3)
    assert_same(grads_of(jnd, jautograd, op(jnd), ins),
                grads_of(tnd, tautograd, op(tnd), ins))


@pytest.mark.parametrize("name,kw,shape", [
    ("GroupNorm", {"num_groups": 2, "eps": 1e-5}, (2, 4, 3, 5)),
    ("GroupNorm", {"num_groups": 1}, (3, 2, 6)),
    ("InstanceNorm", {"eps": 1e-3}, (2, 3, 4, 5)),
    ("InstanceNorm", {"eps": 1e-5}, (2, 3, 7))])
def test_norm_ops(name, kw, shape):
    c = shape[1]
    ins = [rnd(*shape) * 2 + 0.5, 1 + 0.1 * rnd(c, seed=1),
           0.1 * rnd(c, seed=2)]

    def op(nd):
        return lambda *a: getattr(nd, name)(*a, **kw)
    assert_same(grads_of(jnd, jautograd, op(jnd), ins),
                grads_of(tnd, tautograd, op(tnd), ins))


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    ins = [rnd(2, 3, 4, 5)]

    def op(nd):
        return lambda x: nd.L2Normalization(x, mode=mode, eps=1e-10)
    assert_same(grads_of(jnd, jautograd, op(jnd), ins),
                grads_of(tnd, tautograd, op(tnd), ins))


@pytest.mark.parametrize("ord,axis,keepdims", [(2, None, False),
                                               (1, 1, False),
                                               (2, (0, 2), True)])
def test_norm(ord, axis, keepdims):
    ins = [rnd(3, 4, 5)]

    def op(nd):
        return lambda x: nd.norm(x, ord=ord, axis=axis, keepdims=keepdims)
    assert_same(grads_of(jnd, jautograd, op(jnd), ins),
                grads_of(tnd, tautograd, op(tnd), ins))


def test_norm_of_bf16_accumulates_in_float32():
    x = rnd(64, 64)
    j = jnd.norm(jnd.array(x).astype("bfloat16"))
    t = tnd.norm(tnd.array(x).astype("bfloat16"))
    assert str(t.dtype).endswith("bfloat16") and \
        str(j.dtype).endswith("bfloat16")
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy().astype(np.float32),
                               rtol=1e-2)


# ---------------------------------------------------------------------------
# the layers, with deferred sizes
# ---------------------------------------------------------------------------

LAYERS = {
    "GroupNorm": lambda nn: nn.GroupNorm(num_groups=2),
    "GroupNorm_fixed": lambda nn: nn.GroupNorm(num_groups=4, epsilon=1e-3,
                                               in_channels=4),
    "InstanceNorm": lambda nn: nn.InstanceNorm(),
    "InstanceNorm_scaled": lambda nn: nn.InstanceNorm(scale=True,
                                                      epsilon=1e-3),
    "LeakyReLU": lambda nn: nn.LeakyReLU(0.2),
    "PReLU": lambda nn: nn.PReLU(in_channels=4),
    "ELU": lambda nn: nn.ELU(0.7),
    "SELU": lambda nn: nn.SELU(),
    "GELU": lambda nn: nn.GELU(),
    "Flatten": lambda nn: nn.Flatten(),
    "Identity": lambda nn: nn.Identity(),
    "Lambda": lambda nn: nn.Lambda("tanh"),
    "HybridLambda": lambda nn: nn.HybridLambda(lambda x: x.clip(-0.5, 0.5)),
    "Concatenate": lambda nn: _concat(nn.Concatenate(axis=1), nn),
    "HybridConcatenate": lambda nn: _concat(nn.HybridConcatenate(), nn),
    "Swish": lambda nn: nn.Swish(beta=1.5),
    "SiLU": lambda nn: nn.SiLU(),
}


def _concat(net, nn):
    net.add(nn.Activation("tanh"))
    net.add(nn.Conv2D(4, 3, padding=1))
    net.add(nn.Identity())
    return net


def run_layer(nn, nd, autograd, make, x, named=None):
    net = make(nn)
    if named is None:
        net.initialize()
    else:
        params_from_mxnet_tpu(named, net=net, device="cpu")
    xa = nd.array(x)
    xa.attach_grad()
    with autograd.record():
        out = net(xa)
        head = (out * nd.array(rnd(*out.shape, seed=9))).sum()
    head.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    return net, out.asnumpy(), xa.grad.asnumpy(), grads


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name):
    x = rnd(2, 4, 3, 5) * 2 + 0.3
    jnet, jout, jgx, jgrads = run_layer(jnn, jnd, jautograd, LAYERS[name], x)
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    if name.startswith(("GroupNorm", "InstanceNorm")):
        rng = np.random.RandomState(4)          # away from the init values
        named = {n: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
                 for n, v in named.items()}
        for n, p in jnet.collect_params().items():
            p.set_data(jnd.array(named[n]))
        jnet, jout, jgx, jgrads = run_layer(jnn, jnd, jautograd,
                                            lambda nn: jnet, x, None)
    tnet, tout, tgx, tgrads = run_layer(tnn, tnd, tautograd, LAYERS[name], x,
                                        named)
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tgx, jgx, rtol=TOL, atol=TOL)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["GroupNorm", "InstanceNorm", "PReLU"])
def test_layer_initial_values_and_deferred_shapes(name):
    make = LAYERS[name]
    jnet, tnet = make(jnn), make(tnn)
    jnet.initialize()
    tnet.initialize(device="cpu")
    x = rnd(2, 4, 6)
    jnet(jnd.array(x))
    tnet(tnd.array(x))
    want = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    got = params_to_numpy(tnet)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
        assert tnet.collect_params()[n].grad_req == \
            jnet.collect_params()[n].grad_req


def test_prelu_slope_is_learned():
    net = tnn.PReLU(in_channels=3)
    net.initialize(device="cpu")
    from mxnet_tpu_torch import gluon
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1.0})
    x = tnd.array(-np.ones((2, 3, 4), np.float32))
    with tautograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(1)
    np.testing.assert_allclose(net.alpha.data().asnumpy(), 0.25 + 8.0)


def test_the_new_layers_reach_the_registered_ops(monkeypatch):
    from mxnet_tpu_torch.ops import registry
    seen = {}
    for name in ("flatten", "concat", "sigmoid", "tanh"):
        op = registry.get_op(name)

        def counted(*a, _fn=op.fn, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(op, "fn", counted)
    net = tnn.HybridSequential()
    net.add(tnn.HybridConcatenate(axis=1).add(tnn.Swish(), tnn.Identity()),
            tnn.Lambda("tanh"), tnn.Flatten())
    assert net(tnd.array(rnd(2, 3, 4))).shape == (2, 24)
    assert seen == {"flatten": 1, "concat": 1, "sigmoid": 1, "tanh": 1}


def test_lambda_names_an_nd_function_or_takes_a_callable():
    x = rnd(2, 3)
    np.testing.assert_allclose(tnn.Lambda("relu")(tnd.array(x)).asnumpy(),
                               np.maximum(x, 0))
    with pytest.raises(KeyError):
        tnn.Lambda("no_such_op")
    net = tnn.Lambda(lambda a, b: a * b)
    np.testing.assert_allclose(net(tnd.array(x), tnd.array(x)).asnumpy(),
                               x * x, rtol=1e-6)
    assert tnn.SiLU is tnn.Swish


def test_gluon_nn_exports_are_the_reference_s():
    """The reference re-exports the base blocks (``class
    Net(gluon.nn.HybridBlock)``, upstream MXNet's tutorial idiom).  Less
    ``SymbolBlock`` (ROADMAP Queue 1 item 8); the port adds only
    ``set_dropout_generator``."""
    from mxnet_tpu_torch.gluon import block as tblock
    assert sorted(set(tnn.__all__) - {"set_dropout_generator"}) == \
        sorted(set(jnn.__all__) - {"SymbolBlock"})
    assert tnn.Block is tblock.Block and tnn.HybridBlock is tblock.HybridBlock
    assert tmx.gluon.nn.HybridBlock is tmx.gluon.HybridBlock

    class Net(tnn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = tnn.Dense(2, in_units=3)

        def forward(self, x):
            return self.dense(x)

    net = Net()
    net.initialize(device="cpu")
    assert net(tnd.ones((4, 3))).shape == (4, 2)
