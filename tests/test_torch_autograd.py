"""The port's autograd (``mxnet_tpu_torch.autograd``, over torch autograd)
against the JAX reference's tape (``mxnet_tpu.autograd``), on the CPU.

The cases of ``tests/test_autograd.py`` are written once as functions of a
package's ``(mx, nd, autograd)`` and run on both from the same numpy
inputs; gradients are compared at rtol 1e-6, higher-order ones at 1e-5.
The port runs under ``with mx.cpu():`` (its default context is the GPU).

The slice as a whole: a small BERT (the bench CPU configuration: 2 layers,
128 units, 2 heads, T = 128, MLM decoder, dropout 0) with the same numpy
parameters on both sides, driven through ``autograd.record()``,
``net(...)``, the loss block, ``.mean()`` and ``backward()``; every
parameter's gradient is compared by name at 1e-4 of its largest entry.
The port's attention runs through the flash Functions (the plain versions
of K1-K3 on the CPU).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd, autograd as jag
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import bert as jbert

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, autograd as tag
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import attention as tatt

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RTOL, RTOL_HIGHER = 1e-6, 1e-5
PACKAGES = {"jax": (jmx, jnd, jag), "port": (tmx, tnd, tag)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def both(case, rtol=RTOL):
    """Run ``case(mx, nd, autograd)`` on each package, compare the lists of
    numpy arrays it returns, and give the port's."""
    got = {name: [np.asarray(v) for v in case(*pkg)]
           for name, pkg in PACKAGES.items()}
    assert len(got["jax"]) == len(got["port"])
    for j, t in zip(got["jax"], got["port"]):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-7)
    return got["port"]


# ---------------------------------------------------------------------------
# the cases of tests/test_autograd.py, both packages
# ---------------------------------------------------------------------------

def test_simple_backward():
    def case(mx, nd, ag):
        x = nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        y.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(both(case)[0], [2.0, 4.0, 6.0])


def test_chain_rule_through_ops():
    def case(mx, nd, ag):
        x = nd.array([[0.5, -1.0], [2.0, 0.0]])
        x.attach_grad()
        with ag.record():
            y = nd.relu(x)
            z = (y * 3.0).sum()
        z.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(both(case)[0], [[3.0, 0.0], [3.0, 0.0]])


@pytest.mark.parametrize("head", [None, [10.0, 100.0]])
def test_head_gradients(head):
    def case(mx, nd, ag):
        x = nd.array([1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = x * x if head else x * 2.0
        y.backward(None if head is None else nd.array(head))
        return [x.grad.asnumpy()]
    want = [2.0, 2.0] if head is None else [20.0, 400.0]
    np.testing.assert_allclose(both(case)[0], want)


def test_grad_req_add_and_null():
    def case(mx, nd, ag):
        x = nd.array([1.0, 2.0])
        x.attach_grad(grad_req="add")
        for _ in range(2):
            with ag.record():
                y = (x * x).sum()
            y.backward()
        z = nd.array([1.0])
        z.attach_grad(grad_req="null")
        with ag.record():
            w = z * 2
        w.backward()
        return [x.grad.asnumpy(), z.grad.asnumpy()]
    got = both(case)
    np.testing.assert_allclose(got[0], [4.0, 8.0])
    np.testing.assert_allclose(got[1], [0.0])


def test_grad_req_write_overwrites():
    """torch adds into .grad; the reference's 'write' overwrites: two
    backward passes give the gradient of one."""
    def case(mx, nd, ag):
        x = nd.array([1.0, 2.0])
        x.attach_grad()
        out = []
        for scale in (1.0, 1.0, 3.0):
            with ag.record():
                y = (x * x * scale).sum()
            y.backward()
            out.append(x.grad.asnumpy())
        return out
    got = both(case)
    np.testing.assert_allclose(got[1], [2.0, 4.0])
    np.testing.assert_allclose(got[2], [6.0, 12.0])


def test_unreached_variable_keeps_its_gradient():
    def case(mx, nd, ag):
        a, b = nd.array([1.0]), nd.array([2.0])
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            ya = a * 3.0
        ya.backward()
        with ag.record():
            yb = b * 5.0
        yb.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]
    np.testing.assert_allclose(both(case), [[3.0], [5.0]])


def test_pause_scope():
    def case(mx, nd, ag):
        x = nd.array([2.0])
        x.attach_grad()
        with ag.record():
            y = x * x
            with ag.pause():
                c = x * 10.0   # not recorded
            z = y + c.detach()
        z.backward()
        return [x.grad.asnumpy(), z.asnumpy()]
    np.testing.assert_allclose(both(case)[0], [4.0])


def test_training_flags():
    for ag in (jag, tag):
        assert not ag.is_training()
        assert not ag.is_recording()
        with ag.record():
            assert ag.is_recording()
            assert ag.is_training()
            with ag.predict_mode():
                assert not ag.is_training()
            with ag.pause():
                assert not ag.is_recording()
                assert not ag.is_training()
            assert ag.is_recording() and ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        with ag.record(train_mode=False):
            assert ag.is_recording() and not ag.is_training()
        assert not ag.is_training() and not ag.is_recording()


def test_dispatch_outside_record_builds_no_graph():
    x = tnd.array([1.0, 2.0])
    x.attach_grad()
    y = x * x
    assert not y.data.requires_grad
    with pytest.raises(MXNetError, match="not computed while autograd"):
        y.backward()
    with tag.record():
        z = x * x
    assert z.data.requires_grad


def test_autograd_grad_api():
    def case(mx, nd, ag):
        x = nd.array([3.0])
        x.attach_grad()
        with ag.record():
            y = x * x * x
        (g,) = ag.grad(y, [x])
        return [g.asnumpy(), x.grad.asnumpy()]
    got = both(case)
    np.testing.assert_allclose(got[0], [27.0])
    np.testing.assert_allclose(got[1], [0.0])    # .grad untouched by grad()


def test_grad_of_an_unreached_variable_raises():
    x, w = tnd.array([1.0]), tnd.array([2.0])
    x.attach_grad()
    w.attach_grad()
    with tag.record():
        y = x * 2.0
    with pytest.raises(MXNetError, match="unreachable"):
        tag.grad(y, [w])


def test_shared_subexpression():
    def case(mx, nd, ag):
        x = nd.array([2.0])
        x.attach_grad()
        with ag.record():
            y = x * x
            z = y + y
        z.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(both(case)[0], [8.0])


def test_multi_input_op():
    def case(mx, nd, ag):
        a, b = nd.array([1.0, 2.0]), nd.array([3.0, 4.0])
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            c = (a * b).sum()
        c.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]
    got = both(case)
    np.testing.assert_allclose(got[0], [3.0, 4.0])
    np.testing.assert_allclose(got[1], [1.0, 2.0])


def test_matmul_grads():
    av = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    wv = np.random.RandomState(1).rand(4, 2).astype(np.float32)

    def case(mx, nd, ag):
        a, w = nd.array(av), nd.array(wv)
        w.attach_grad()
        with ag.record():
            out = nd.dot(a, w).sum()
        out.backward()
        return [w.grad.asnumpy()]
    np.testing.assert_allclose(both(case)[0],
                               av.T @ np.ones((3, 2), np.float32), rtol=1e-5)


UNARY_GRADS = ["exp", "log", "sqrt", "sin", "tanh", "sigmoid", "relu",
               "abs", "negative"]


@pytest.mark.parametrize("op", UNARY_GRADS)
def test_unary_op_grads(op):
    xv = np.array([0.3, 1.7, 2.5, 0.9], np.float32)

    def case(mx, nd, ag):
        x = nd.array(xv)
        x.attach_grad()
        with ag.record():
            y = getattr(nd, op)(x)
        y.backward(nd.array(np.array([1.0, -2.0, 0.5, 3.0], np.float32)))
        return [y.asnumpy(), x.grad.asnumpy()]
    both(case)


BINARY_GRADS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b, "rsub": lambda a, b: 2.0 - a * b,
    "rdiv": lambda a, b: 1.0 / (a + b), "pow_scalar": lambda a, b: a ** 3,
    "rpow": lambda a, b: 2.0 ** a + b,
    "broadcast": lambda a, b: a * b[0:1],
    "dot": lambda a, b: a.reshape((2, 2)).dot(b.reshape((2, 2))),
    "softmax": lambda a, b: (a * b).softmax() * b,
    "log_softmax": lambda a, b: (a + b).log_softmax() * b,
    "mean": lambda a, b: (a * b).mean() * b,
    "max": lambda a, b: (a + b).max() * a,
    "clip": lambda a, b: (a * b).clip(1.0, 3.0),
    "cast": lambda a, b: (a * b).astype("float16").astype("float32"),
    "transpose": lambda a, b: a.reshape((2, 2)).T * b.reshape((2, 2)),
    "getitem": lambda a, b: a[1:3] * b[0:2],
    "concat": lambda a, b: tnd_or_jnd(a).concat(a, b * a, dim=0),
}


def tnd_or_jnd(x):
    return tnd if isinstance(x, tnd.NDArray) else jnd


@pytest.mark.parametrize("name", sorted(BINARY_GRADS))
def test_binary_op_grads(name):
    av = np.array([1.2, 0.7, 2.1, 1.5], np.float32)
    bv = np.array([0.5, 1.9, 0.8, 1.1], np.float32)

    def case(mx, nd, ag):
        a, b = nd.array(av), nd.array(bv)
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            y = BINARY_GRADS[name](a, b)
            s = (y * y).sum()
        s.backward()
        return [y.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()]
    both(case, rtol=1e-5)


def test_non_differentiable_op_gives_no_gradient():
    x = tnd.array([1.0, -1.0, 2.0])
    x.attach_grad()
    with tag.record():
        i = tnd.argmax(x)
        y = (x * 2.0).sum() + i
    assert not i.data.requires_grad
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 2.0, 2.0])


@pytest.mark.parametrize("preset", [None, 7.0])
def test_head_reached_only_through_non_differentiable_ops(preset):
    """A head recorded under ``record()`` whose only path to a variable
    runs through non-differentiable ops (the sum of ``topk``'s values, or
    of ``argmax``) reaches no leaf: backward writes nothing, as the
    reference's tape walk, and raises nothing; the gradient stays as
    attached (zeros) or as set."""
    def case(mx, nd, ag):
        x = nd.array([[1.0, 5.0, 3.0, 4.0]])
        x.attach_grad()
        if preset is not None:
            x.grad[:] = preset
        with ag.record():
            y = nd.topk(x, k=2, ret_typ="value").sum()
            z = nd.argmax(x, axis=1).sum()
            c = nd.ones((2,)) * 3.0
        y.backward()
        z.backward()
        c.backward()
        return [x.grad.asnumpy()]
    got = both(case)
    np.testing.assert_array_equal(got[0], np.full((1, 4), preset or 0.0))


def test_head_computed_outside_record_raises():
    """Outside ``record()``, and from a non-differentiable op itself (no
    tape node in the reference), a head still raises."""
    for nd, ag, err in ((jnd, jag, jmx.base.MXNetError),
                        (tnd, tag, MXNetError)):
        x = nd.array([1.0, 2.0])
        x.attach_grad()
        with pytest.raises(err, match="not computed while autograd"):
            (x * 2.0).sum().backward()
        with ag.record():
            i = nd.argmax(x, axis=0)
        with pytest.raises(err, match="not computed while autograd"):
            i.backward()


def test_a_live_head_beside_a_dead_one():
    """Heads that reach leaves and a recorded head that reaches none, in
    one backward: the live ones write their gradients."""
    def case(mx, nd, ag):
        x = nd.array([1.0, 5.0, 3.0])
        w = nd.array([2.0, -1.0, 0.5])
        for v in (x, w):
            v.attach_grad()
        with ag.record():
            dead = nd.topk(x, k=1, ret_typ="value").sum()
            live = (w * w * 3.0).sum()
        ag.backward([dead, live])
        return [x.grad.asnumpy(), w.grad.asnumpy()]
    got = both(case)
    np.testing.assert_allclose(got[1], [12.0, -6.0, 3.0])


def test_dropout_under_record():
    def case(mx, nd, ag):
        x = nd.ones((100, 100))
        x.attach_grad()
        with ag.record():
            y = nd.Dropout(x, p=0.5, training=True)
            s = y.sum()
        s.backward()
        g = x.grad.asnumpy()
        kept = float((g != 0).mean())
        return [np.round(np.unique(g), 3), np.array(0.4 < kept < 0.6)]
    got = both(case)    # the masks differ (two RNGs); their laws agree
    assert set(got[0]).issubset({0.0, 2.0}) and got[1]


def test_dropout_op_with_a_generator_repeats():
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        outs.append(tnd.Dropout(tnd.ones((8, 8)), p=0.5,
                                generator=gen).asnumpy())
    np.testing.assert_array_equal(*outs)
    np.testing.assert_array_equal(
        tnd.Dropout(tnd.ones((4,)), p=0.5, training=False).asnumpy(),
        np.ones(4))


def test_custom_function():
    def case(mx, nd, ag):
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        f = Sigmoid()
        x = nd.array([0.0, 1.0])
        x.attach_grad()
        with ag.record():
            y = f(x)
        y.backward()
        out_unrecorded = f(nd.array([2.0]))
        return [y.asnumpy(), x.grad.asnumpy(), out_unrecorded.asnumpy()]
    got = both(case, rtol=1e-5)
    s = 1 / (1 + np.exp(-np.array([0.0, 1.0])))
    np.testing.assert_allclose(got[1], s * (1 - s), rtol=1e-5)


def test_custom_function_with_two_inputs_and_outputs():
    def case(mx, nd, ag):
        class MulAdd(ag.Function):
            def forward(self, a, b):
                self.save_for_backward(a, b)
                return a * b, a + b

            def backward(self, d_prod, d_sum):
                a, b = self.saved_tensors
                return d_prod * b + d_sum, d_prod * a + d_sum

        a, b = nd.array([1.0, 2.0]), nd.array([3.0, 5.0])
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            p, s = MulAdd()(a, b)
            out = (p * 2.0 + s * s).sum()
        out.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]
    both(case)


def test_deep_chain_no_recursion_error():
    def case(mx, nd, ag):
        x = nd.array([1.0])
        x.attach_grad()
        with ag.record():
            y = x
            for _ in range(300):
                y = y + 0.01
            z = y * 1.0
        z.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(both(case)[0], [1.0])


def _numeric_grad_check(nd, ag, fn, inputs, eps=1e-2, rtol=1e-2):
    """Central differences of sum(fn) against its autograd gradient
    (the check of mxnet_tpu.test_utils.check_numeric_gradient), in
    float32 as the reference runs it."""
    xs = [nd.array(v) for v in inputs]
    for x in xs:
        x.attach_grad()
    with ag.record():
        out = fn(*xs).sum()
    out.backward()
    for i, v in enumerate(inputs):
        num = np.zeros_like(v)
        for j in range(v.size):
            plus, minus = v.copy(), v.copy()
            plus.flat[j] += eps
            minus.flat[j] -= eps
            args_p = [nd.array(plus if k == i else u)
                      for k, u in enumerate(inputs)]
            args_m = [nd.array(minus if k == i else u)
                      for k, u in enumerate(inputs)]
            num.flat[j] = (float(fn(*args_p).sum().asscalar())
                           - float(fn(*args_m).sum().asscalar())) / (2 * eps)
        np.testing.assert_allclose(xs[i].grad.asnumpy(), num, rtol=rtol,
                                   atol=1e-3)
    return [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("which", ["tanh", "mul_exp"])
def test_numeric_gradient_checker(which):
    from mxnet_tpu.test_utils import check_numeric_gradient
    if which == "tanh":
        inputs = [np.array([0.1, -0.3, 0.7], np.float32)]

        def fn(nd):
            return lambda x: nd.tanh(x)
    else:
        inputs = [np.array([0.5, 1.0], np.float32),
                  np.array([2.0, -1.0], np.float32)]

        def fn(nd):
            return lambda a, b: a * b + nd.exp(a)
    check_numeric_gradient(fn(jnd), [jnd.array(v) for v in inputs])
    both(lambda mx, nd, ag: _numeric_grad_check(nd, ag, fn(nd), inputs))


# ---------------------------------------------------------------------------
# higher-order autograd (create_graph)
# ---------------------------------------------------------------------------

def test_second_order_grad():
    def case(mx, nd, ag):
        x = nd.array(np.array([2.0], np.float32))
        x.attach_grad()
        with ag.record():
            y = (x ** 3).sum()
            gx = ag.grad(y, [x], create_graph=True)[0]   # 3x^2
            z = (gx ** 2).sum()                          # 9x^4
        z.backward()
        return [gx.asnumpy(), x.grad.asnumpy()]
    got = both(case, rtol=RTOL_HIGHER)
    np.testing.assert_allclose(got[0], [12.0], rtol=1e-5)
    np.testing.assert_allclose(got[1], [288.0], rtol=1e-5)   # 36x^3


def test_third_order_grad():
    def case(mx, nd, ag):
        x = nd.array(np.array([1.5], np.float32))
        x.attach_grad()
        with ag.record():
            f = (x ** 4).sum()
            g1 = ag.grad(f, [x], create_graph=True)[0]
            g2 = ag.grad(g1.sum(), [x], create_graph=True)[0]
            g3 = ag.grad(g2.sum(), [x])[0]
        return [g1.asnumpy(), g2.asnumpy(), g3.asnumpy()]
    got = both(case, rtol=RTOL_HIGHER)
    np.testing.assert_allclose(got[2], [36.0], rtol=1e-5)       # 24x


def test_gradient_norm_penalty():
    def case(mx, nd, ag):
        w = nd.array(np.array([[0.5, -0.3]], np.float32))
        w.attach_grad()
        x = nd.array(np.array([[1.0, 2.0]], np.float32))
        with ag.record():
            out = (nd.dot(w, x.T) ** 2).sum()
            gw = ag.grad(out, [w], create_graph=True)[0]
            gnorm = (gw ** 2).sum()
        gnorm.backward()
        return [w.grad.asnumpy()]
    got = both(case, rtol=RTOL_HIGHER)
    np.testing.assert_allclose(got[0][0], 8 * (-0.1) * 5 * np.array(
        [1.0, 2.0]), rtol=1e-4)


def test_second_order_mixed_ops():
    x0 = 0.7

    def case(mx, nd, ag):
        x = nd.array(np.array([x0], np.float32))
        x.attach_grad()
        with ag.record():
            y = nd.exp(nd.sin(x)).sum()
            g1 = ag.grad(y, [x], create_graph=True)[0]
        g1.backward()
        return [x.grad.asnumpy()]
    got = both(case, rtol=RTOL_HIGHER)
    expect = np.exp(np.sin(x0)) * (np.cos(x0) ** 2 - np.sin(x0))
    np.testing.assert_allclose(got[0][0], expect, rtol=1e-4)


def test_create_graph_outside_record_scope():
    def case(mx, nd, ag):
        x = nd.array(np.array([2.0], np.float32))
        x.attach_grad()
        with ag.record():
            y = (x * x + x * x).sum()
        g1 = ag.grad(y, [x], create_graph=True)[0]          # 4x
        with ag.record():
            s = g1.sum()
        gg = ag.grad(s, [x])[0]
        return [g1.asnumpy(), gg.asnumpy()]
    got = both(case, rtol=RTOL_HIGHER)
    np.testing.assert_allclose(got, [[8.0], [4.0]], rtol=1e-5)


def test_mark_variables():
    def case(mx, nd, ag):
        x = nd.array([1.0, 3.0])
        g = nd.zeros((2,))
        ag.mark_variables([x], [g])
        with ag.record():
            y = (x * x).sum()
        y.backward()
        return [g.asnumpy(), x.grad.asnumpy()]
    np.testing.assert_allclose(both(case), [[2.0, 6.0], [2.0, 6.0]])


# ---------------------------------------------------------------------------
# gluon blocks on NDArrays
# ---------------------------------------------------------------------------

def test_block_on_ndarrays_writes_parameter_grads():
    from mxnet_tpu_torch.gluon import nn as tgnn
    dense = tgnn.Dense(3, in_units=4)
    dense.initialize(device="cpu", seed=0)
    x = tnd.array(np.random.RandomState(0).randn(2, 4).astype(np.float32))
    assert not dense.training
    with tag.record():
        out = dense(x)
        loss = (out * out).mean()
    assert isinstance(out, tnd.NDArray) and out.data.requires_grad
    loss.backward()
    first = dense.weight.grad().data.clone()
    with tag.record():
        loss = (dense(x) * dense(x)).mean()
    loss.backward()
    torch.testing.assert_close(dense.weight.grad().data, first, rtol=0,
                               atol=0)
    dense.weight.grad_req = "add"
    with tag.record():
        loss = (dense(x) * dense(x)).mean()
    loss.backward()
    torch.testing.assert_close(dense.weight.grad().data, 2 * first)
    # outside record: no graph, and the block's own mode is restored
    y = dense(x)
    assert not y.data.requires_grad and not dense.training
    # tensors in, tensors out, as Servable and TrainStep call it
    assert isinstance(dense(x.data), torch.Tensor)


def test_parameter_grad_from_a_broadcast_then_added_to():
    """The gradient of a sum comes back as a broadcast (stride-0) view;
    the written .grad owns its memory, so 'add' can accumulate into it."""
    w = torch.nn.Parameter(torch.ones(3, 4))
    x = tnd.NDArray(w)
    with tag.record():
        loss = x.sum()
    loss.backward()
    assert w.grad.is_contiguous()
    w.grad_req = "add"
    with tag.record():
        loss = x.sum()
    loss.backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.full((3, 4), 2.0))


def test_block_mode_follows_is_training():
    from mxnet_tpu_torch.gluon import nn as tgnn
    seen = []

    class Probe(tmx.gluon.HybridBlock):
        def forward(self, x):
            seen.append(self.training)
            return x

    net = Probe()
    x = tnd.ones((2,))
    net(x)
    with tag.record():
        net(x)
    with tag.record(train_mode=False):
        net(x)
    with tag.train_mode():
        net(x)
    assert seen == [False, True, False, True] and not net.training
    drop = tgnn.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    with tag.record():
        y = drop(tnd.ones((50, 50)))
    assert set(np.unique(y.asnumpy())) == {0.0, 2.0}
    np.testing.assert_array_equal(drop(tnd.ones((3,))).asnumpy(),
                                  np.ones(3))


# ---------------------------------------------------------------------------
# the slice at small size: BERT through record/backward, both packages
# ---------------------------------------------------------------------------

VOCAB, T, B = 1000, 128, 2
CFG = dict(vocab_size=VOCAB, max_length=T, dropout=0.0, use_classifier=False)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (B, T)).astype(np.int32),
            (np.arange(T)[None, :] >= rng.randint(1, T, (B, 1)))
            .astype(np.int32),
            rng.randint(0, VOCAB, (B, T)).astype(np.int32))


@pytest.fixture(scope="module")
def bert_grads():
    tok, seg, lab = _batch()
    jnet = jbert.get_bert(2, 128, 2, **CFG)
    jnet.initialize(jmx.init.Normal(0.02))
    jnet(jnd.array(tok, dtype="int32"), jnd.array(seg, dtype="int32"))
    rng = np.random.RandomState(1)
    for name, p in jnet.collect_params().items():
        shape = p.data().shape
        val = 1.0 + 0.1 * rng.randn(*shape) if name.endswith("gamma") \
            else 0.05 * rng.randn(*shape)
        p.set_data(jnd.array(val.astype(np.float32)))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    with jag.record():
        out = jnet(jnd.array(tok, dtype="int32"),
                   jnd.array(seg, dtype="int32"))
        jl = jloss.SoftmaxCrossEntropyLoss()(
            out[-1], jnd.array(lab, dtype="int32")).mean()
    jl.backward()
    jgrads = {n: p.grad().asnumpy() for n, p in jnet.collect_params().items()}

    tnet = tbert.get_bert(2, 128, 2, **CFG)
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    calls = []
    real = tatt._flash_bwd
    with pytest.MonkeyPatch.context() as mp, tmx.cpu():
        mp.setattr(tatt, "_flash_bwd",
                   lambda *a: calls.append(a[0].shape) or real(*a))
        ce = tloss.SoftmaxCrossEntropyLoss()
        tok_nd, seg_nd, lab_nd = (tnd.array(a) for a in (tok, seg, lab))
        assert str(tok_nd.dtype) == "int32"
        with tag.record():
            tl = ce(tnet(tok_nd, seg_nd)[-1], lab_nd).mean()
        tl.backward()
    tgrads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
              .numpy().copy() for n, p in tnet.named_parameters()}
    unreached = sorted(n for n, p in tnet.named_parameters()
                       if p.grad is None)
    return dict(jloss=float(jl.asscalar()), tloss=float(tl.asscalar()),
                jgrads=jgrads, tgrads=tgrads, unreached=unreached,
                flash_bwd_calls=calls, tnet=tnet)


def test_bert_loss_matches_reference(bert_grads):
    np.testing.assert_allclose(bert_grads["tloss"], bert_grads["jloss"],
                               rtol=1e-5)


def test_bert_gradients_match_reference_by_name(bert_grads):
    j, t = bert_grads["jgrads"], bert_grads["tgrads"]
    assert sorted(t) == sorted(j)
    for name in j:
        top = np.abs(j[name]).max()
        err = np.abs(t[name] - j[name]).max()
        assert err <= 1e-4 * top + 1e-9, (name, err, top)
    # the pooler is not on the MLM loss's path: nothing reaches it
    assert bert_grads["unreached"] == ["pooler.bias", "pooler.weight"]
    assert np.abs(j["pooler.weight"]).max() == 0


def test_bert_backward_ran_the_flash_backward(bert_grads):
    # one K2/K3 pass per layer, at (B, H, T, D) = (2, 2, 128, 64)
    assert bert_grads["flash_bwd_calls"] == [(2, 2, 128, 64)] * 2


def test_bert_second_backward_overwrites(bert_grads):
    tnet = bert_grads["tnet"]
    tok, seg, lab = (tnd.array(a) for a in _batch())
    ce = tloss.SoftmaxCrossEntropyLoss()
    with tag.record():
        loss = ce(tnet(tok, seg)[-1], lab).mean()
    loss.backward()
    for n, p in tnet.named_parameters():
        if p.grad is not None:
            np.testing.assert_allclose(p.grad.numpy(),
                                       bert_grads["tgrads"][n], rtol=1e-6,
                                       atol=1e-9, err_msg=n)
