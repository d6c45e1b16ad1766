"""The port's gluon ``Parameter``, ``ParameterDict`` and deferred init
against the JAX reference, on the CPU.

The layers ``Dense(10)``, ``Dense(10, flatten=False)``, ``Conv2D(8, 3)``,
``BatchNorm()`` and ``LayerNorm()`` are built without input sizes in both
packages and must infer the reference's shapes at the first forward;
``DeferredInitializationError`` comes before it.  A deferred net takes its
sizes from ``load_dict``.  ``collect_params()`` gives handles whose
``data()`` and ``grad()`` hold the reference's values after the same
``record()``/``backward()`` on the same seeded numpy inputs and
parameters, with ``grad_req`` 'write', 'add' and 'null' and
``zero_grad``.  Tolerance: rtol 1e-5, atol 1e-6 (fp32).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd, autograd as jag
from mxnet_tpu.gluon import nn as jgnn
from mxnet_tpu.gluon.parameter import \
    DeferredInitializationError as JDeferredInitializationError

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, autograd as tag, gluon as tgluon
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _carry(jnet, tnet, x, seed=3):
    """Resolve the reference net's shapes on ``x``, draw its parameters
    from numpy and load them into the port's net (deferred) by name."""
    jnet.initialize()
    jnet(jnd.array(x))
    rng = np.random.RandomState(seed)
    named = {}
    for name, p in jnet.collect_params().items():
        val = 0.3 * _rand(rng, *p.data().shape)
        if name.endswith(("gamma", "running_var")):
            val = 1.0 + np.abs(val)
        p.set_data(jnd.array(val))
        named[name] = val
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    return named


# ---------------------------------------------------------------------------
# Parameter and ParameterDict
# ---------------------------------------------------------------------------

def test_free_parameter_api():
    p = tgluon.Parameter("w", shape=(3, 4), lr_mult=0.5)
    assert p.name == "w" and p.shape == (3, 4) and p.grad_req == "write"
    assert str(p.dtype) == "float32" and p.lr_mult == 0.5
    with pytest.raises(RuntimeError, match="not been initialized"):
        p.data()
    p.initialize(init=tinit.One(), device="cpu")
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((3, 4)))
    np.testing.assert_array_equal(p.grad().asnumpy(), np.zeros((3, 4)))
    assert p.list_ctx() == [tmx.cpu()]
    p.initialize(init=tinit.Zero(), device="cpu")        # kept
    assert float(p.data().asnumpy().sum()) == 12.0
    p.initialize(init=tinit.Zero(), device="cpu", force_reinit=True)
    assert float(p.data().asnumpy().sum()) == 0.0
    p.set_data(np.arange(12, dtype=np.float32).reshape(3, 4))
    assert p.data().asnumpy()[2, 3] == 11.0
    with pytest.raises(AssertionError, match="incompatible"):
        p.set_data(np.zeros((4, 3), np.float32))
    p.grad().data.fill_(2.0)
    assert float(p.list_grad()[0].asnumpy().sum()) == 24.0
    p.zero_grad()
    assert float(p.grad().asnumpy().sum()) == 0.0
    p.reset_ctx(tmx.cpu())                  # a copy on the (same) device
    assert p.list_data()[0].asnumpy()[2, 3] == 11.0
    assert float(p.grad().asnumpy().sum()) == 0.0
    p.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        p.grad()
    assert not p.data().data.requires_grad
    p.grad_req = "add"
    assert p.data().data.requires_grad and p.grad().shape == (3, 4)
    p.cast("bfloat16")
    assert p.dtype == "bfloat16" and p.grad().data.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="grad_req"):
        p.grad_req = "sum"


def test_constant_and_deferred_free_parameter():
    c = tgluon.Constant(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32), "c")
    c.initialize(device="cpu")
    assert c.grad_req == "null"
    np.testing.assert_array_equal(c.data().asnumpy(), [[1, 2], [3, 4]])
    d = tgluon.Parameter("d", shape=(0, 3), allow_deferred_init=True)
    d.initialize(device="cpu")
    with pytest.raises(DeferredInitializationError):
        d.data()
    assert d.list_ctx() == [tmx.cpu()]
    d.set_data(np.ones((2, 3), np.float32))
    assert d.shape == (2, 3) and float(d.data().asnumpy().sum()) == 6.0
    e = tgluon.Parameter("e", shape=(0, 3))
    with pytest.raises(ValueError, match="deferred init is not allowed"):
        e.initialize(device="cpu")


def test_parameter_dict_api():
    pd = tgluon.ParameterDict("net_")
    w = pd.get("weight", shape=(2, 0), allow_deferred_init=True)
    b = pd.get("bias", shape=(2,), init=tinit.One())
    assert list(pd.keys()) == ["net_weight", "net_bias"]
    assert pd.get("weight", shape=(2, 5)) is w and w.shape == (2, 5)
    assert list(pd.values()) == [w, b] and "net_bias" in pd and len(pd) == 2
    other = tgluon.ParameterDict()
    other.update(pd)
    assert list(other.items()) == list(pd.items())
    with pytest.raises(ValueError, match="duplicate"):
        other.update({"net_bias": tgluon.Parameter("x", shape=(1,))})
    pd.initialize(tinit.Zero(), device="cpu")
    # its own initializer, under the reference's name rule: a "bias" is 0
    np.testing.assert_array_equal(b.data().asnumpy(), [0.0, 0.0])
    np.testing.assert_array_equal(w.data().asnumpy(), np.zeros((2, 5)))
    pd.setattr("lr_mult", 0.25)
    assert w.lr_mult == b.lr_mult == 0.25
    pd.setattr("grad_req", "null")
    assert not w.data().data.requires_grad
    pd.reset_ctx(tmx.cpu())
    np.testing.assert_array_equal(b.data().asnumpy(), [0.0, 0.0])
    deferred = tgluon.Parameter("d", shape=(0,), allow_deferred_init=True)
    deferred.initialize(device="cpu")
    deferred.reset_ctx([tmx.cpu()])
    assert deferred.list_ctx() == [tmx.cpu()]
    with pytest.raises(ValueError, match="uninitialized"):
        tgluon.Parameter("u", shape=(2,)).reset_ctx(tmx.cpu())


# ---------------------------------------------------------------------------
# deferred shapes against the reference
# ---------------------------------------------------------------------------

DEFERRED = {
    "Dense": (lambda m: m.Dense(10), (2, 3, 4)),
    "Dense_no_flatten": (lambda m: m.Dense(10, flatten=False), (2, 3, 4)),
    "Conv2D": (lambda m: m.Conv2D(8, 3), (2, 5, 7, 6)),
    "BatchNorm": (lambda m: m.BatchNorm(), (2, 6, 3, 3)),
    "LayerNorm": (lambda m: m.LayerNorm(), (2, 3, 7)),
}


@pytest.mark.parametrize("layer", sorted(DEFERRED))
def test_deferred_shapes_match_reference(layer):
    make, shape = DEFERRED[layer]
    x = _rand(np.random.RandomState(1), *shape)
    jblock, tblock = make(jgnn), make(tgnn)
    jblock.initialize()
    tblock.initialize(device="cpu", seed=0)
    tparams = tblock.collect_params()
    assert list(tparams) == list(jblock.collect_params())
    pending = [n for n, p in tparams.items() if 0 in p.shape]
    assert pending, "a size is left to infer"
    for name in pending:
        with pytest.raises(DeferredInitializationError):
            tparams[name].data()
        with pytest.raises(JDeferredInitializationError):
            jblock.collect_params()[name].data()
    jblock(jnd.array(x))
    with tag.record():
        out = tblock(tnd.array(x))
    assert out.shape == jblock(jnd.array(x)).shape
    for name, p in jblock.collect_params().items():
        assert tparams[name].shape == p.data().shape, name
        assert tparams[name].data().shape == p.data().shape, name
        assert not tparams[name].data().data.is_meta
    assert tparams[pending[0]].list_ctx() == [tmx.cpu()]


def test_deferred_init_draws_from_the_recorded_generator():
    def build(seed):
        net = tgnn.HybridSequential()
        net.add(tgnn.Dense(6), tgnn.Dense(3, in_units=6))
        net.initialize(tinit.Normal(0.5), device="cpu", seed=seed)
        net(torch.zeros(2, 4))
        return {n: p.data().asnumpy() for n, p in
                net.collect_params().items()}

    a, b, c = build(7), build(7), build(8)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
    assert not np.array_equal(a["0.weight"], c["0.weight"])
    assert a["0.weight"].shape == (6, 4) and a["0.weight"].std() > 0.2
    np.testing.assert_array_equal(a["0.bias"], np.zeros(6))


def test_a_deferred_net_refuses_functionalize_until_its_first_call():
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.block import functionalize
    net = tgnn.Dense(3)
    net.initialize(device="cpu")
    with pytest.raises(MXNetError, match="no storage"):
        functionalize(net)
    net(torch.zeros(1, 5))
    fn, params = functionalize(net)
    assert tuple(params["weight"].shape) == (3, 5)


def test_load_dict_into_a_deferred_net_takes_the_shapes():
    def build(m):
        net = m.HybridSequential()
        net.add(m.Conv2D(4, 3, padding=1), m.BatchNorm(),
                m.Activation("relu"), m.Dense(5))
        return net

    x = _rand(np.random.RandomState(2), 2, 3, 6, 6)
    jnet, tnet = build(jgnn), build(tgnn)
    named = _carry(jnet, tnet, x)
    for name, p in tnet.collect_params().items():
        assert p.shape == named[name].shape
    got = tnet(tnd.array(x)).asnumpy()
    np.testing.assert_allclose(got, jnet(jnd.array(x)).asnumpy(), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(RuntimeError, match="0.weight"):
        build(tgnn).load_dict({k: v for k, v in named.items()
                               if k != "0.weight"}, device="cpu")
    bad = dict(named, **{"3.weight": np.zeros((5, 7), np.float32)})
    with pytest.raises(RuntimeError, match="size mismatch"):
        tnet.load_dict(bad, device="cpu")


def test_initialize_twice_keeps_values_unless_force_reinit():
    net = tgnn.HybridSequential()
    net.add(tgnn.Dense(4, in_units=3), tgnn.Dense(2))
    net.initialize(device="cpu", seed=1)
    net(torch.zeros(1, 3))
    before = {n: p.data().asnumpy() for n, p in
              net.collect_params().items()}
    net.initialize(device="cpu", seed=2)
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), before[n])
    net.initialize(device="cpu", seed=2, force_reinit=True)
    assert not np.array_equal(
        net.collect_params()["0.weight"].data().asnumpy(),
        before["0.weight"])
    # the reference keeps them too
    jnet = jgnn.Dense(4, in_units=3)
    jnet.initialize()
    w = jnet.weight.data().asnumpy()
    jnet.initialize()
    np.testing.assert_array_equal(jnet.weight.data().asnumpy(), w)


# ---------------------------------------------------------------------------
# data(), grad() and grad_req against the reference
# ---------------------------------------------------------------------------

def _pair():
    def build(m):
        net = m.HybridSequential()
        net.add(m.Dense(6, activation="relu"), m.Dense(3))
        return net

    x = _rand(np.random.RandomState(4), 5, 4)
    jnet, tnet = build(jgnn), build(tgnn)
    _carry(jnet, tnet, x)
    return jnet, tnet, x


def _backward(pkg_nd, pkg_ag, net, x):
    with pkg_ag.record():
        out = net(pkg_nd.array(x))
        loss = (out * out).sum()
    loss.backward()


def test_collect_params_data_and_grad_match_reference():
    """``collect_params()`` gives gluon ``Parameter`` handles: were it to
    give raw tensors, ``p.data()`` would raise ``TypeError: 'Tensor' object
    is not callable``."""
    jnet, tnet, x = _pair()
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert isinstance(tp, tgluon.ParameterDict)
    for name in jp:
        assert isinstance(tp[name], tgluon.Parameter)
        assert isinstance(tp[name].data(), tnd.NDArray)
        np.testing.assert_array_equal(tp[name].data().asnumpy(),
                                      jp[name].data().asnumpy())
        np.testing.assert_array_equal(tp[name].grad().asnumpy(), 0.0)
    _backward(jnd, jag, jnet, x)
    _backward(tnd, tag, tnet, x)
    for name in jp:
        np.testing.assert_allclose(tp[name].grad().asnumpy(),
                                   jp[name].grad().asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # data() shares the slot's storage, and handles persist
    tp["1.bias"].data()[:] = 7.0
    assert float(tnet[1].bias.data().asnumpy()[0]) == 7.0
    tp["1.bias"].lr_mult = 0.5
    assert tnet.collect_params()["1.bias"].lr_mult == 0.5
    assert sorted(tnet.collect_params("bias")) == ["0.bias", "1.bias"]


# A block's parameter attribute (``net.weight``) is its gluon Parameter, as
# in the reference (``mxnet_tpu/gluon/nn/basic_layers.py`` ``Dense``); a
# raw ``torch.nn.Parameter`` there made ``data()`` raise and let
# ``lr_mult`` set on it be ignored by the trainer.
_ATTR_LAYERS = {
    "Dense": (lambda m: m.Dense(3, in_units=4), (2, 4), ("weight", "bias")),
    "Conv2D": (lambda m: m.Conv2D(2, 3, in_channels=3), (1, 3, 5, 5),
               ("weight", "bias")),
    "BatchNorm": (lambda m: m.BatchNorm(in_channels=3), (2, 3, 4),
                  ("gamma", "beta", "running_mean", "running_var")),
    "LayerNorm": (lambda m: m.LayerNorm(in_channels=4), (2, 4),
                  ("gamma", "beta")),
}


@pytest.mark.parametrize("layer", sorted(_ATTR_LAYERS))
def test_a_block_attribute_is_its_gluon_parameter(layer):
    build, shape, attrs = _ATTR_LAYERS[layer]
    x = _rand(np.random.RandomState(5), *shape)
    jnet, tnet = build(jgnn), build(tgnn)
    _carry(jnet, tnet, x)
    tp = tnet.collect_params()
    for attr in attrs:
        handle = getattr(tnet, attr)
        assert isinstance(handle, tgluon.Parameter)
        assert handle is tp[attr]
        np.testing.assert_array_equal(handle.data().asnumpy(),
                                      getattr(jnet, attr).data().asnumpy())
    for pkg_nd, pkg_ag, net in ((jnd, jag, jnet), (tnd, tag, tnet)):
        with pkg_ag.record():
            out = net(pkg_nd.array(x))
            loss = (out * out).sum()
        loss.backward()
    for attr in attrs:
        jpar, tpar = getattr(jnet, attr), getattr(tnet, attr)
        if jpar.grad_req == "null":
            assert tpar.grad_req == "null"
            continue
        np.testing.assert_allclose(tpar.grad().asnumpy(),
                                   jpar.grad().asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=attr)
    value = _rand(np.random.RandomState(6), *getattr(jnet, attrs[0]).shape)
    getattr(jnet, attrs[0]).set_data(jnd.array(value))
    getattr(tnet, attrs[0]).set_data(value)
    np.testing.assert_array_equal(getattr(tnet, attrs[0]).data().asnumpy(),
                                  getattr(jnet, attrs[0]).data().asnumpy())
    np.testing.assert_allclose(tnet(tnd.array(x)).asnumpy(),
                               jnet(jnd.array(x)).asnumpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("attr,knob", [("bias", "lr_mult"),
                                       ("weight", "lr_mult"),
                                       ("weight", "wd_mult")])
def test_a_multiplier_set_on_a_block_attribute_reaches_the_trainer(attr,
                                                                   knob):
    """The reproducer of the fault: ``net.bias.lr_mult = 0.0`` freezes
    the bias in the reference; the port's trainer used to train it."""
    from mxnet_tpu import gluon as jgluon, init as jinit
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, 3) if attr == "weight" else np.zeros((2, 3),
                                                         np.float32)
    after = []
    for m, pkg_nd, pkg_ag, gl, init in (
            (jgnn, jnd, jag, jgluon, jinit.One()),
            (tgnn, tnd, tag, tgluon, tinit.One())):
        net = m.Dense(2, in_units=3)
        net.initialize(init)
        setattr(getattr(net, attr), knob, 0.0)
        trainer = gl.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 1.0, "wd": 0.5})
        with pkg_ag.record():
            y = net(pkg_nd.array(x)).sum()
        y.backward()
        trainer.step(2)
        after.append({n: p.data().asnumpy()
                      for n, p in net.collect_params().items()})
    for name in after[0]:
        np.testing.assert_allclose(after[1][name], after[0][name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if knob == "lr_mult":
        np.testing.assert_array_equal(after[1][attr],
                                      np.ones_like(after[1][attr])
                                      if attr == "weight" else
                                      np.zeros_like(after[1][attr]))


def test_grad_req_add_null_and_zero_grad_match_reference():
    jnet, tnet, x = _pair()
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for params in (jp, tp):
        params["0.weight"].grad_req = "add"
        params["1.bias"].grad_req = "null"
    for _ in range(2):
        _backward(jnd, jag, jnet, x)
        _backward(tnd, tag, tnet, x)
    for name in ("0.weight", "0.bias", "1.weight"):
        np.testing.assert_allclose(tp[name].grad().asnumpy(),
                                   jp[name].grad().asnumpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for params in (jp, tp):
        with pytest.raises(RuntimeError, match="grad_req='null'"):
            params["1.bias"].grad()
    jnet.zero_grad()
    tnet.zero_grad()
    for name in ("0.weight", "0.bias", "1.weight"):
        np.testing.assert_array_equal(tp[name].grad().asnumpy(), 0.0)
        np.testing.assert_array_equal(jp[name].grad().asnumpy(), 0.0)
    _backward(jnd, jag, jnet, x)
    _backward(tnd, tag, tnet, x)
    np.testing.assert_allclose(tp["0.weight"].grad().asnumpy(),
                               jp["0.weight"].grad().asnumpy(), rtol=RTOL,
                               atol=ATOL)
    tnet.setattr("grad_req", "null")
    assert all(p.grad_req == "null" for p in tp.values())


def test_batchnorm_running_stats_are_grad_req_null():
    for m in (jgnn, tgnn):
        bn = m.BatchNorm(in_channels=3)
        got = {n: p.grad_req for n, p in bn.collect_params().items()}
        assert got == {"gamma": "write", "beta": "write",
                       "running_mean": "null", "running_var": "null"}
    ln = tgnn.LayerNorm(scale=False, in_channels=3)
    assert ln.collect_params()["gamma"].grad_req == "null"


def test_initialize_defaults_to_the_gpu_and_raises_without_one():
    from mxnet_tpu_torch.base import MXNetError
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with tmx.gpu(0):
        with pytest.raises(MXNetError, match="cuda"):
            tgluon.Parameter("w", shape=(2,)).initialize()
        with pytest.raises(MXNetError, match="cuda"):
            tgnn.Dense(3).initialize()
        with pytest.raises(MXNetError, match="cuda"):
            tgluon.ParameterDict().initialize()
