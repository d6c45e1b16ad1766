"""Contexts and parameters with a copy on each of several contexts in one
process: the port against the JAX reference, on the CPU.

Both packages run on ``cpu(0)`` / ``cpu(1)`` (the reference on its 8 host
devices, ``tests/conftest.py``).  Every case feeds the same seeded numpy
weights and batches through both:

* an NDArray keeps its context (``nd.array(x, ctx=cpu(1))``, an op's
  output, ``as_in_context``, creation ops, ``.grad``), and ``gpu(i)`` past
  the visible cards raises;
* ``Parameter`` copies: ``initialize``, ``list_*``, ``data(ctx)``,
  ``set_data``, ``reset_ctx``, ``cast``, deferred init with a list, and a
  forward on one context's copy writing that copy's gradient alone;
* the classic Gluon loop (``split_and_load``, one forward and backward a
  copy, ``Trainer.step``) over two copies with the ``local``, ``device``
  and ``ici`` stores, plain and with 2-bit and int8 compression,
  ``update_on_kvstore=True`` and the exchange overlap armed: every copy's
  parameters within rtol 1e-5 (atol 1e-6) of the reference's;
* ``save_states`` / ``load_states`` over two copies;
* ``make_compiled_step`` over two contexts against the eager loop (and
  the reference's), an eager <-> compiled switch, and the fallback of a
  layout with several contexts.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon, nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, gluon as tgluon, nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.device import resolve

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
IN, HID, OUT, N, STEPS = 5, 6, 3, 8, 3
OPT = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ctxs(pkg):
    return [pkg.cpu(0), pkg.cpu(1)]


# ---------------------------------------------------------------------------
# an NDArray's own context
# ---------------------------------------------------------------------------

def test_an_ndarray_keeps_the_context_it_was_made_on():
    """The table of the probe: the reference's contexts, in the port."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    rows = []
    for pkg in (jmx, tmx):
        a = pkg.nd.array(x, ctx=pkg.cpu(1))
        b = a.as_in_context(pkg.cpu(0))
        rows.append([str(c) for c in (
            a.context, (a + 1).context, b.context,
            pkg.nd.zeros((2,), ctx=pkg.cpu(1)).context,
            a.copyto(pkg.cpu(1)).context, (a * b.as_in_context(
                pkg.cpu(1))).context, a[0].context,
            a.reshape((3, 2)).context)])
    assert rows[1] == rows[0] == ["cpu(1)", "cpu(1)", "cpu(0)", "cpu(1)",
                                  "cpu(1)", "cpu(1)", "cpu(1)", "cpu(1)"]
    a = tnd.array(x, ctx=tmx.cpu(1))
    b = a.as_in_context(tmx.cpu(0))
    assert b is not a and a.as_in_context(tmx.cpu(1)) is a
    b[:] = 0                        # a copy, also on the one torch device
    np.testing.assert_array_equal(a.asnumpy(), x)
    a.attach_grad()
    with tag.record():
        y = (a * 2).sum()
    y.backward()
    assert a.grad.context == tmx.cpu(1) and y.context == tmx.cpu(1)
    with tag.record():
        z = (a * 3).sum()
    assert tag.grad(z, [a])[0].context == tmx.cpu(1)
    # a tensor wrapped without a context takes its device's
    assert tnd.NDArray(torch.zeros(2)).context == tmx.cpu(0)


def test_gpu_past_the_visible_cards_raises_naming_their_number(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve(tmx.gpu(0)) == torch.device("cuda", 0)
    with pytest.raises(MXNetError, match=r"out of range \(1 gpu"):
        resolve(tmx.gpu(1))


# ---------------------------------------------------------------------------
# Parameter copies
# ---------------------------------------------------------------------------

def _dense_pair(in_units=IN):
    """One Dense layer in each package, on both contexts, the same
    weights; with ``in_units`` 0 both are deferred (the weights are set
    after their first forward)."""
    rng = np.random.RandomState(3)
    w = rng.randn(HID, IN).astype(np.float32)
    b = rng.randn(HID).astype(np.float32)
    nets = []
    for pkg in (jmx, tmx):
        net = pkg.gluon.nn.Dense(HID, in_units=in_units)
        net.initialize(ctx=_ctxs(pkg))
        nets.append(net)
    if in_units:
        for net, pkg in zip(nets, (jnd, tnd)):
            net.weight.set_data(pkg.array(w))
            net.bias.set_data(pkg.array(b))
    return nets, w, b


def test_parameter_copies_initialize_list_set_and_reset():
    (jnet, tnet), w, _ = _dense_pair()
    for net, pkg in ((jnet, jmx), (tnet, tmx)):
        p = net.weight
        assert [str(c) for c in p.list_ctx()] == ["cpu(0)", "cpu(1)"]
        assert [str(d.context) for d in p.list_data()] == \
            ["cpu(0)", "cpu(1)"]
        assert [str(g.context) for g in p.list_grad()] == \
            ["cpu(0)", "cpu(1)"]
        assert str(p.data(pkg.cpu(1)).context) == "cpu(1)"
        for d in p.list_data():
            np.testing.assert_array_equal(d.asnumpy(), w)
        with pkg.cpu(1):            # several copies: the current context's
            assert str(p.data().context) == "cpu(1)"
        with pytest.raises(RuntimeError, match="not initialized on context"):
            p.data(pkg.cpu(2))
        p.set_data(pkg.nd.array(w * 2))
        for d in p.list_data():
            np.testing.assert_array_equal(d.asnumpy(), w * 2)
        p.reset_ctx([pkg.cpu(1), pkg.cpu(0)])
        assert [str(c) for c in p.list_ctx()] == ["cpu(1)", "cpu(0)"]
        for d in p.list_data():
            np.testing.assert_array_equal(d.asnumpy(), w * 2)
        p.cast("float16")
        assert all(d.dtype == np.float16 for d in p.list_data())
    # the block's own slot is the first context's copy
    t = tnet.weight
    assert t._tensor() is t.list_data()[0].data
    net = tgluon.nn.Dense(HID, in_units=IN)
    net.initialize(ctx=_ctxs(tmx))
    net.collect_params().reset_ctx(tmx.cpu(0))
    assert net.weight.list_ctx() == [tmx.cpu(0)]


def test_deferred_init_with_a_list_of_contexts():
    """Shapes unknown until the first forward, which runs on cpu(1)'s
    copy; every copy then holds the same value in both packages."""
    (jnet, tnet), _, _ = _dense_pair(in_units=0)
    for net, pkg in ((jnet, jmx), (tnet, tmx)):
        assert [str(c) for c in net.weight.list_ctx()] == ["cpu(0)", "cpu(1)"]
        x = pkg.nd.array(np.ones((2, IN), np.float32), ctx=pkg.cpu(1))
        out = net(x)
        assert str(out.context) == "cpu(1)" and out.shape == (2, HID)
        d0, d1 = (d.asnumpy() for d in net.weight.list_data())
        np.testing.assert_array_equal(d0, d1)
        assert d0.shape == (HID, IN)


def test_a_forward_writes_the_gradient_of_the_copy_it_ran_on():
    (jnet, tnet), w, b = _dense_pair()
    x = np.random.RandomState(4).randn(4, IN).astype(np.float32)
    got = []
    for net, pkg in ((jnet, jmx), (tnet, tmx)):
        net.weight.grad_req = "add"
        with pkg.autograd.record():
            heads = [(net(pkg.nd.array(x, ctx=pkg.cpu(0))) ** 2).sum()
                     for _ in range(2)]
        pkg.autograd.backward(heads)
        got.append([g.asnumpy() for g in net.weight.list_grad()])
    want = 2 * (2 * (x @ w.T + b)).T @ x
    for g0, g1 in got:
        np.testing.assert_allclose(g0, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g1, 0)


# ---------------------------------------------------------------------------
# the Gluon loop over two copies
# ---------------------------------------------------------------------------

def _weights():
    rng = np.random.RandomState(0)
    return {"0.weight": rng.randn(HID, IN).astype(np.float32) * 0.5,
            "1.gamma": 1 + 0.2 * rng.randn(HID).astype(np.float32),
            "1.beta": 0.1 * rng.randn(HID).astype(np.float32),
            "1.running_mean": np.zeros(HID, np.float32),
            "1.running_var": np.ones(HID, np.float32),
            "3.weight": rng.randn(OUT, HID).astype(np.float32) * 0.5,
            "3.bias": rng.randn(OUT).astype(np.float32) * 0.1}


def _data(steps=STEPS):
    rng = np.random.RandomState(11)
    return [(rng.randn(N, IN).astype(np.float32),
             rng.randn(N, OUT).astype(np.float32)) for _ in range(steps)]


def _net(pkg):
    """Dense -> BatchNorm -> tanh -> Dense on both contexts, from
    :func:`_weights` (each copy's BatchNorm keeps statistics of its
    own).  The first Dense has no bias: the BatchNorm after it makes a
    bias's gradient 0 up to rounding, which Adam's step turns into a move
    of lr whose sign rounding decides."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(HID, in_units=IN, use_bias=False),
            nn.BatchNorm(in_channels=HID),
            nn.Activation("tanh"), nn.Dense(OUT, in_units=HID))
    net.initialize(ctx=_ctxs(pkg))
    for name, p in net.collect_params().items():
        p.set_data(pkg.nd.array(_weights()[name]))
    return net


def _eager(pkg, net, trainer, data, ctxs=None):
    ctxs = ctxs or _ctxs(pkg)
    loss_fn = pkg.gluon.loss.L2Loss()
    for x, y in data:
        xs = pkg.gluon.utils.split_and_load(x, ctxs)
        ys = pkg.gluon.utils.split_and_load(y, ctxs)
        assert [str(p.context) for p in xs] == [str(c) for c in ctxs]
        with pkg.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        pkg.autograd.backward(losses)
        trainer.step(N)


def _copies(net):
    return {n: [d.asnumpy() for d in p.list_data()]
            for n, p in net.collect_params().items()}


def _assert_copies_close(tnet, jnet, rtol=RTOL, atol=ATOL):
    want, got = _copies(jnet), _copies(tnet)
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name]) == 2
        for d, (g, w) in enumerate(zip(got[name], want[name])):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg="%s copy %d" % (name, d))


_STORES = [("local", None, False), ("device", None, False),
           ("ici", None, False),
           ("device", {"type": "2bit", "threshold": 0.05}, False),
           ("device", {"type": "int8"}, False),
           ("ici", {"type": "2bit", "threshold": 0.05}, False),
           ("ici", {"type": "int8"}, False), ("ici", None, True)]


@pytest.mark.parametrize("kvstore,compress,on_kv", _STORES,
                         ids=["local", "device", "ici", "device-2bit",
                              "device-int8", "ici-2bit", "ici-int8",
                              "ici-update_on_kvstore"])
def test_trainer_over_two_copies_matches_the_reference(kvstore, compress,
                                                       on_kv):
    nets = []
    for pkg in (jmx, tmx):
        net = _net(pkg)
        tr = pkg.gluon.Trainer(net.collect_params(), OPT[0], dict(OPT[1]),
                               kvstore=kvstore, compression_params=compress,
                               update_on_kvstore=on_kv or None)
        _eager(pkg, net, tr, _data())
        nets.append((net, tr))
    (jnet, jtr), (tnet, ttr) = nets
    assert ttr._kvstore.type == jtr._kvstore.type
    assert len(ttr._updaters) == len(jtr._updaters) == 2
    _assert_copies_close(tnet, jnet)


def test_the_overlapped_exchange_over_two_copies(monkeypatch):
    """``MX_EXCHANGE_OVERLAP=1``: each copy's gradient hook notifies the
    session, a bucket launches once both copies of its members landed, and
    the trajectory is the reference's (int8, its residuals keyed by the
    overlapped bucket layout)."""
    monkeypatch.setenv("MX_EXCHANGE_OVERLAP", "1")
    monkeypatch.setenv("MX_KVSTORE_BUCKET_KB", "1")
    nets = []
    for pkg in (jmx, tmx):
        net = _net(pkg)
        tr = pkg.gluon.Trainer(net.collect_params(), OPT[0], dict(OPT[1]),
                               kvstore="device",
                               compression_params={"type": "int8"})
        _eager(pkg, net, tr, _data(4))
        nets.append((net, tr))
    (jnet, _), (tnet, ttr) = nets
    assert ttr._overlap and ttr._exchange_session is not None
    assert len(ttr._hooks) == 2 * sum(
        1 for p in ttr._params if p.grad_req != "null")
    _assert_copies_close(tnet, jnet)


def test_bucketing_off_and_on_give_the_same_two_copy_step(monkeypatch):
    """The fused exchange across copies (the reference's
    ``test_bucket_kb_zero_trainer_step``): bucketing disabled and enabled
    give the same step, which is the reference's."""
    out = {}
    for kb in ("0", "4096"):
        monkeypatch.setenv("MX_KVSTORE_BUCKET_KB", kb)
        net = _net(tmx)
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore="device")
        _eager(tmx, net, tr, _data(2))
        out[kb] = _copies(net)
    jnet = _net(jmx)
    _eager(jmx, jnet, jgluon.Trainer(jnet.collect_params(), "sgd",
                                     {"learning_rate": 0.1},
                                     kvstore="device"), _data(2))
    for name, copies in out["0"].items():
        for a, b in zip(copies, out["4096"][name]):
            np.testing.assert_array_equal(a, b)
    _assert_copies_close(net, jnet)


def test_save_and_load_states_over_two_copies(tmp_path):
    """States saved after two steps and loaded into a fresh Trainer
    (every context's updater takes them, on its own context) continue the
    trajectory: the trained parameters are the uninterrupted run's, and
    every copy is the reference's through the same sequence (whose new
    Trainer, as the port's, starts every copy from the first's, the
    BatchNorm statistics included)."""
    data = _data(3)
    whole = _net(tmx)
    _eager(tmx, whole, tgluon.Trainer(whole.collect_params(), "adam",
                                      {"learning_rate": 0.01}), data)
    nets = []
    for pkg in (jmx, tmx):
        net = _net(pkg)
        tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01})
        _eager(pkg, net, tr, data[:2])
        path = str(tmp_path / pkg.__name__)
        tr.save_states(path)
        tr2 = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01})
        tr2.load_states(path)
        _eager(pkg, net, tr2, data[2:])
        nets.append(net)
    jnet, net = nets
    assert [[str(s.context) for s in (u.states[0] if isinstance(
        u.states[0], (tuple, list)) else (u.states[0],))]
        for u in tr2._updaters] == [["cpu(0)"] * 2, ["cpu(1)"] * 2]
    for name, p in net.collect_params().items():
        if p.grad_req == "null":
            continue
        for a, b in zip(_copies(whole)[name], _copies(net)[name]):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    _assert_copies_close(net, jnet)


# ---------------------------------------------------------------------------
# CompiledStep over two contexts
# ---------------------------------------------------------------------------

def _compiled(pkg, net, trainer, data):
    step = trainer.make_compiled_step(net, pkg.gluon.loss.L2Loss())
    for x, y in data:
        step.step(pkg.nd.array(x, ctx=pkg.cpu(0)),
                  pkg.nd.array(y, ctx=pkg.cpu(0)), batch_size=N)
    return step


@pytest.mark.parametrize("compress", [None, {"type": "int8"}],
                         ids=["plain", "int8"])
def test_compiled_step_over_two_contexts_matches_the_eager_loop(compress):
    """The several-context lane: the batch splits over the copies, the
    store merges, every copy and updater is written; the eager loop's
    weights bitwise, the reference's eager loop's within 1e-5."""
    data = _data()
    runs = []
    for compiled in (False, True):
        net = _net(tmx)
        tr = tgluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01}, kvstore="device",
                            compression_params=compress)
        if compiled:
            step = _compiled(tmx, net, tr, data)
            assert step.compiled, step.fallback_reason
        else:
            _eager(tmx, net, tr, data)
        runs.append((net, tr))
    (enet, etr), (cnet, ctr) = runs
    for name, copies in _copies(enet).items():
        for a, b in zip(copies, _copies(cnet)[name]):
            np.testing.assert_array_equal(b, a, err_msg=name)
    counts = ctr.optimizer._all_index_update_counts
    assert counts[("cpu", 0)] == counts[("cpu", 1)] == \
        etr.optimizer._all_index_update_counts[("cpu", 1)]
    assert set(counts[("cpu", 0)].values()) == {STEPS}
    jnet = _net(jmx)
    _eager(jmx, jnet, jgluon.Trainer(jnet.collect_params(), "adam",
                                     {"learning_rate": 0.01},
                                     kvstore="device",
                                     compression_params=compress), data)
    _assert_copies_close(cnet, jnet)


def test_an_eager_compiled_switch_continues_one_trajectory():
    data = _data(4)
    net = _net(tmx)
    tr = tgluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    _eager(tmx, net, tr, data[:2])
    _compiled(tmx, net, tr, data[2:])
    jnet = _net(jmx)
    _eager(jmx, jnet, jgluon.Trainer(jnet.collect_params(), "adam",
                                     {"learning_rate": 0.01}), data)
    _assert_copies_close(net, jnet)


def test_a_layout_over_several_contexts_falls_back_with_the_reason():
    from mxnet_tpu_torch.parallel import SpecLayout, make_mesh
    net = _net(tmx)
    tr = tgluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    layout = SpecLayout(make_mesh(("data", "fsdp"), (1, 1)))
    step = tr.make_compiled_step(net, tgluon.loss.L2Loss(), layout=layout)
    x, y = _data(1)[0]
    with pytest.warns(UserWarning, match="falling back"):
        step.step(tnd.array(x), tnd.array(y))
    assert not step.compiled and "ONE Trainer context" in \
        step.fallback_reason
    jnet = _net(jmx)
    _eager(jmx, jnet, jgluon.Trainer(jnet.collect_params(), "sgd",
                                     {"learning_rate": 0.1}), [(x, y)])
    _assert_copies_close(net, jnet)
