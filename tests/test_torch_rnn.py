"""The port's recurrent path against the JAX reference, on the CPU.

The fused ``RNN`` op (``mxnet_tpu_torch/ops/rnn.py``) against
``mxnet_tpu.ops.rnn._rnn`` with ``jax.vjp``: outputs, final states and the
gradients of the data, the flat parameters and both initial states, in
all four modes, one or two layers, one or two directions, with
``sequence_length`` (a length of 0, a length above T), the clip of the
returned c, and dropout's rules.  ``gluon.rnn``'s layers (``TNC`` and
``NTC``, ``begin_state``, ``sequence_length``) and cells (each step,
``unroll`` with and without ``valid_length``, the sequential, residual,
bidirectional and zoneout cells) with parameters carried by name, and
three steps of ``examples/word_lm.py``'s model and loop on both packages.
Inputs and parameters come from numpy seeds; the tolerance is fp32's
1e-4.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon, nd as jnd
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ops.rnn import _rnn as jax_rnn, rnn_param_size

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, gluon as tgluon, nd as tnd
from mxnet_tpu_torch.convert import params_from_mxnet_tpu, params_to_numpy
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ops import rnn as tops
from mxnet_tpu_torch.ops.registry import get_op

import chip_smoke

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
T, N, I, H = 5, 3, 4, 6
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def op_inputs(mode, layers, bidirectional, seed=0, t=T):
    dirs = 2 if bidirectional else 1
    size = rnn_param_size(layers, I, H, mode, bidirectional)
    return [rnd(t, N, I, seed=seed), rnd(size, seed=seed + 1, scale=0.4),
            rnd(layers * dirs, N, H, seed=seed + 2),
            rnd(layers * dirs, N, H, seed=seed + 3)]


def cotangents(mode, layers, bidirectional, t=T, seed=7):
    dirs = 2 if bidirectional else 1
    return [rnd(t, N, dirs * H, seed=seed),
            rnd(layers * dirs, N, H, seed=seed + 1),
            rnd(layers * dirs, N, H, seed=seed + 2)]


def reference_op(inputs, cots, lengths=None, **kw):
    """Outputs and the gradients of sum(out_i * cot_i) by jax.vjp, as one
    jitted program (one compile, not one per primitive)."""
    @jax.jit
    def run(inputs, cots, seq):
        outs, vjp = jax.vjp(
            lambda *a: jax_rnn(jax.random.PRNGKey(0), *a, seq, **kw),
            *inputs)
        return outs, vjp(tuple(cots))
    seq = None if lengths is None else jnp.asarray(lengths, jnp.float32)
    outs, grads = run([jnp.asarray(a) for a in inputs],
                      [jnp.asarray(c) for c in cots], seq)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def port_op(inputs, cots, lengths=None, **kw):
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    seq = None if lengths is None else torch.tensor(lengths, dtype=torch.float32)
    outs = tops.rnn(*ts, seq, **kw)
    head = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    head.backward()
    return [o.detach().numpy() for o in outs], [t.grad.numpy() for t in ts]


def assert_same(ref, port):
    for what, j, t in [("out", ref[0][0], port[0][0]),
                       ("h", ref[0][1], port[0][1]),
                       ("c", ref[0][2], port[0][2])] + [
            ("grad " + n, j, t) for n, j, t in
            zip(("data", "params", "state", "state_cell"), ref[1],
                port[1])]:
        close(t, j, what)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_op_matches_the_reference(mode, layers, bidirectional):
    ins = op_inputs(mode, layers, bidirectional)
    cots = cotangents(mode, layers, bidirectional)
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidirectional)
    assert_same(reference_op(ins, cots, **kw), port_op(ins, cots, **kw))


@pytest.mark.parametrize("mode,layers,bidirectional,lengths", [
    ("lstm", 2, False, [0, T + 2, 3]),
    ("gru", 1, False, [T, 1, 0]),
    ("lstm", 2, True, [2, 0, T]),
    ("rnn_tanh", 1, True, [0, 3, 1])])
def test_op_with_sequence_length_matches_the_reference(mode, layers,
                                                       bidirectional,
                                                       lengths):
    ins = op_inputs(mode, layers, bidirectional, seed=3)
    cots = cotangents(mode, layers, bidirectional)
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidirectional, use_sequence_length=True)
    ref = reference_op(ins, cots, lengths, **kw)
    port = port_op(ins, cots, lengths, **kw)
    assert_same(ref, port)
    out, h, c = port[0]
    dirs = 2 if bidirectional else 1
    for n, length in enumerate(lengths):
        assert not out[length:, n].any()       # padded outputs are zero
        if length == 0:                         # h0 and c0 come back
            np.testing.assert_array_equal(h[:, n], ins[2][:, n])
            np.testing.assert_array_equal(c[:, n], ins[3][:, n])
    assert out.shape == (T, N, dirs * H)


def test_a_length_above_t_counts_as_t():
    """The reference's reverse direction reads past the end for a length
    above T and returns NaN there; the port counts such a length as T
    (its forward direction agrees with the reference's)."""
    ins = op_inputs("lstm", 1, True, seed=4)
    cots = cotangents("lstm", 1, True)
    kw = dict(state_size=H, mode="lstm", bidirectional=True,
              use_sequence_length=True)
    long, at_t = port_op(ins, cots, [T + 3, 2, T], **kw), \
        port_op(ins, cots, [T, 2, T], **kw)
    for a, b in zip(long[0] + long[1], at_t[0] + at_t[1]):
        np.testing.assert_array_equal(a, b)
    ref = reference_op(ins, cots, [T + 3, 2, T], **kw)
    assert np.isnan(ref[0][0][:, 0, H:]).any()
    close(long[0][0][:, :, :H], ref[0][0][:, :, :H])


def test_gru_new_gate_is_reset_times_the_hidden_projection():
    """n = tanh(x_n + r * (W_hn h + b_hn)) (``mxnet_tpu/ops/rnn.py``'s GRU
    step), not tanh(x_n + W_hn (r * h) + b_hn): one step in numpy."""
    x, p, h, _ = op_inputs("gru", 1, False, seed=5, t=1)
    out = port_op([x, p, h, np.zeros_like(h)],
                  cotangents("gru", 1, False, t=1), state_size=H,
                  mode="gru")[0][0][0]
    gh = 3 * H
    w_ih = p[:gh * I].reshape(gh, I)
    w_hh = p[gh * I:gh * (I + H)].reshape(gh, H)
    b_ih, b_hh = p[gh * (I + H):gh * (I + H + 1)], p[gh * (I + H + 1):]
    xp, hp = x[0] @ w_ih.T + b_ih, h[0] @ w_hh.T + b_hh

    def sig(v):
        return 1 / (1 + np.exp(-v))
    r = sig(xp[:, :H] + hp[:, :H])
    z = sig(xp[:, H:2 * H] + hp[:, H:2 * H])

    def step(n):
        return (1 - z) * n + z * h[0]
    close(out, step(np.tanh(xp[:, 2 * H:] + r * hp[:, 2 * H:])))
    other = np.tanh(xp[:, 2 * H:] + (r * h[0]) @ w_hh[2 * H:].T
                    + b_hh[2 * H:])
    assert np.abs(out - step(other)).max() > 1e-3


def test_the_clip_acts_on_the_returned_cell_state_only():
    ins = op_inputs("lstm", 2, False, seed=6)
    cots = cotangents("lstm", 2, False)
    kw = dict(state_size=H, num_layers=2, mode="lstm")
    free = port_op(ins, cots, **kw)[0]
    clip = dict(kw, lstm_state_clip_min=-0.2, lstm_state_clip_max=0.2)
    ref, port = reference_op(ins, cots, **clip), port_op(ins, cots, **clip)
    assert_same(ref, port)
    np.testing.assert_array_equal(port[0][0], free[0])   # steps unclipped
    np.testing.assert_array_equal(port[0][1], free[1])
    np.testing.assert_array_equal(port[0][2], np.clip(free[2], -0.2, 0.2))
    assert np.abs(free[2]).max() > 0.2


def test_dropout_acts_between_layers_only_in_training():
    ins = [torch.from_numpy(a) for a in op_inputs("lstm", 2, False, seed=8)]
    one = [torch.from_numpy(a) for a in op_inputs("lstm", 1, False, seed=8)]
    gen = torch.Generator().manual_seed(0)

    def run(xs, layers, **kw):
        return tops.rnn(*xs, state_size=H, num_layers=layers, mode="lstm",
                        generator=gen, **kw)
    for a, b in zip(run(one, 1, p=0.5, training=True), run(one, 1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(run(ins, 2, p=0.5), run(ins, 2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dropped, plain = run(ins, 2, p=0.5, training=True), run(ins, 2)
    assert not torch.equal(dropped[0], plain[0])
    assert torch.equal(dropped[1][:1], plain[1][:1])   # layer 0 untouched


def test_dropout_masks_come_from_the_generator():
    ins = [torch.from_numpy(a) for a in op_inputs("gru", 3, True, seed=9)]

    def run(seed):
        return tops.rnn(*ins, state_size=H, num_layers=3, mode="gru",
                        bidirectional=True, p=0.3, training=True,
                        generator=torch.Generator().manual_seed(seed))[0]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    tmx.random.seed(4)
    a = tnd.RNN(*[tnd.array(x.numpy()) for x in ins], state_size=H,
                num_layers=3, mode="gru", bidirectional=True, p=0.3,
                training=True)[0]
    tmx.random.seed(4)
    b = tnd.RNN(*[tnd.array(x.numpy()) for x in ins], state_size=H,
                num_layers=3, mode="gru", bidirectional=True, p=0.3,
                training=True)[0]
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_the_op_is_registered_under_both_names_with_three_outputs():
    assert get_op("RNN") is get_op("rnn")
    assert get_op("RNN").num_outputs == 3
    ins = op_inputs("gru", 1, False)
    outs = tnd.rnn(*[tnd.array(a) for a in ins[:3]], state_size=H,
                   mode="gru")
    assert [o.shape for o in outs] == [(T, N, H), (1, N, H), (1, N, H)]
    assert not outs[2].asnumpy().any()      # the zero cell state passed on
    with pytest.raises(ValueError, match="parameters given"):
        tnd.RNN(*[tnd.array(a) for a in ins[:3]], state_size=H + 1,
                mode="gru")


class _FlagSpy(TorchDispatchMode):
    """Records cuDNN's TF32 flag at every op the dispatcher runs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append((func.overloadpacket.__name__,
                          torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))

    def recurrences(self):
        """The flags at the recurrent kernels' ops (PyTorch's CPU RNN
        here, ``_cudnn_rnn`` on the card)."""
        return [flag for name, flag in self.seen
                if any(k in name for k in ("rnn", "lstm", "gru"))]


def test_float32_rnn_runs_without_tf32_forward_and_backward():
    """With the global flag on, the recurrence and its backward run inside
    a scope with cuDNN's TF32 off (in the forward, every op but the final
    ``detach``), and the flag comes back."""
    ts = [torch.tensor(a, requires_grad=True)
          for a in op_inputs("lstm", 2, True)]
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with _FlagSpy() as spy:
            outs = tops.rnn(*ts, state_size=H, num_layers=2, mode="lstm",
                            bidirectional=True)
        assert spy.recurrences() and not any(spy.recurrences()), spy.seen
        assert not any(flag for name, flag in spy.seen
                       if name != "detach"), spy.seen
        with _FlagSpy() as spy:
            torch.autograd.grad(sum(o.sum() for o in outs), ts)
        assert spy.recurrences() and not any(spy.recurrences()), spy.seen
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

LAYERS = {
    "lstm_2_bi": lambda m: m.LSTM(H, num_layers=2, bidirectional=True),
    "lstm_ntc": lambda m: m.LSTM(H, layout="NTC", input_size=I),
    "gru_2_ntc": lambda m: m.GRU(H, num_layers=2, layout="NTC"),
    "rnn_tanh_bi": lambda m: m.RNN(H, activation="tanh", bidirectional=True),
    "rnn_relu": lambda m: m.RNN(H),
}


def run_layer(rnn, nd, autograd, make, x, named=None, lengths=None):
    net = make(rnn)
    if named is None:
        net.initialize()
    else:
        params_from_mxnet_tpu(named, net=net, device="cpu")
    ntc = net._layout == "NTC"
    xa = nd.array(x)
    xa.attach_grad()
    states = net.begin_state(x.shape[0] if ntc else x.shape[1])
    for s in states:
        s.attach_grad()
    kw = {} if lengths is None else {"sequence_length": nd.array(lengths)}
    with autograd.record():
        out, new = net(xa, states, **kw)
        head = (out * nd.array(rnd(*out.shape, seed=11))).sum() + sum(
            (s * nd.array(rnd(*s.shape, seed=12 + i))).sum()
            for i, s in enumerate(new))
    head.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()}
    return (net, [out.asnumpy()] + [s.asnumpy() for s in new],
            [xa.grad.asnumpy()] + [s.grad.asnumpy() for s in states], grads)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_reference(name):
    x = rnd(T, N, I, seed=13)
    lengths = np.array([3, T, 0], np.float32) if name == "lstm_2_bi" \
        else None
    jnet, jouts, jgx, jgrads = run_layer(jrnn, jnd, jag, LAYERS[name], x,
                                         lengths=lengths)
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet, touts, tgx, tgrads = run_layer(trnn, tnd, tag, LAYERS[name], x,
                                         named, lengths)
    assert sorted(tgrads) == sorted(jgrads)
    for a, b in zip(touts + tgx, jouts + jgx):
        close(a, b)
    for n in jgrads:
        close(tgrads[n], jgrads[n], n)


def test_a_layer_called_without_states_returns_the_output_only():
    x = rnd(T, N, I, seed=14)
    jnet = jrnn.GRU(H, num_layers=2)
    jnet.initialize()
    want = jnet(jnd.array(x))
    tnet = trnn.GRU(H, num_layers=2)
    params_from_mxnet_tpu({n: p.data().asnumpy() for n, p in
                           jnet.collect_params().items()}, net=tnet,
                          device="cpu")
    got = tnet(tnd.array(x))
    assert isinstance(got, tnd.NDArray)
    close(got.asnumpy(), want.asnumpy())
    assert [s["shape"] for s in tnet.state_info(7)] == \
        [s["shape"] for s in jnet.state_info(7)]
    assert tuple(tnet.l0_i2h_weight.shape) == (3 * H, I)


def test_the_fused_layer_matches_its_cells_unrolled():
    """The reference's ``tests/test_rnn.py`` consistency check, on the
    port alone: a fused layer with a cell's parameters gives the cell's
    unroll."""
    x = tnd.array(rnd(T, N, I, seed=15))
    for mode, cell, layer in [
            ("lstm", trnn.LSTMCell(H), trnn.LSTM(H)),
            ("gru", trnn.GRUCell(H), trnn.GRU(H)),
            ("rnn_tanh", trnn.RNNCell(H, activation="tanh"),
             trnn.RNN(H, activation="tanh"))]:
        cell.initialize(tmx.init.Xavier())
        cell(x[0], cell.begin_state(N))
        layer.initialize()
        layer(x)
        for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            getattr(layer, "l0_" + name).set_data(
                getattr(cell, name).data() + (0.1 if "bias" in name else 0))
            getattr(cell, name).set_data(getattr(layer, "l0_" + name).data())
        fused = layer(x).asnumpy()
        outs, _ = cell.unroll(T, [x[t] for t in range(T)],
                              merge_outputs=False)
        close(np.stack([o.asnumpy() for o in outs]), fused, mode)


def test_layer_dropout_trains_only_under_training_mode():
    x = tnd.array(rnd(T, N, I, seed=16))
    net = trnn.LSTM(H, num_layers=2, dropout=0.5)
    net.initialize()
    net(x)
    plain = trnn.LSTM(H, num_layers=2)
    params_from_mxnet_tpu(params_to_numpy(net), net=plain, device="cpu")
    # the same grad mode on both sides: PyTorch's CPU RNN takes another
    # kernel for inference than for training
    with tag.record(train_mode=False):
        want = plain(x).asnumpy()
        np.testing.assert_array_equal(net(x).asnumpy(), want)
    tnn = tgluon.nn
    tnn.set_dropout_generator(net, torch.Generator().manual_seed(3))
    with tag.record():
        a = net(x).asnumpy()
    tnn.set_dropout_generator(net, torch.Generator().manual_seed(3))
    with tag.record():
        b = net(x).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - want).max() > 1e-3


def test_the_layers_and_cells_reach_the_registered_ops(monkeypatch):
    from mxnet_tpu_torch.ops import registry
    seen = {}
    for name in ("RNN", "FullyConnected", "split", "sigmoid", "tanh",
                 "Activation"):
        op = registry.get_op(name)

        def counted(*a, _fn=op.fn, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(op, "fn", counted)
    x = tnd.array(rnd(T, N, I, seed=20))
    layer = trnn.LSTM(H, num_layers=2)
    layer.initialize()
    layer(x)
    assert seen == {"RNN": 1}
    seen.clear()
    cell = trnn.LSTMCell(H)
    cell.initialize()
    cell.unroll(T, x, layout="TNC")
    assert seen == {"FullyConnected": 2 * T, "split": T, "sigmoid": 3 * T,
                    "tanh": 2 * T}


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

CELLS = {
    "rnn_relu": lambda m: m.RNNCell(H, activation="relu"),
    "lstm": lambda m: m.LSTMCell(H),
    "gru": lambda m: m.GRUCell(H),
    "sequential": lambda m: _stack(m),
    "residual": lambda m: m.ResidualCell(m.GRUCell(I, input_size=I)),
    "zoneout_predict": lambda m: m.ZoneoutCell(m.LSTMCell(H), 0.5, 0.5),
}


def _stack(m):
    cell = m.SequentialRNNCell()
    cell.add(m.LSTMCell(H))
    cell.add(m.DropoutCell(0.5))
    cell.add(m.GRUCell(I))
    return cell


def run_cell(rnn, nd, autograd, make, x, named=None, valid=None,
             step=False):
    cell = make(rnn)
    if named is None:
        cell.initialize()
    else:
        params_from_mxnet_tpu(named, net=cell, device="cpu")
    xa = nd.array(x)
    xa.attach_grad()
    states = cell.begin_state(N)
    with autograd.record(train_mode=False):
        if step:
            out, new = cell(xa[0], states)
        else:
            out, new = cell.unroll(T, xa, layout="TNC",
                                   valid_length=None if valid is None
                                   else nd.array(valid))
        head = (out * out).sum() + sum((s * s).sum() for s in new)
    head.backward()
    grads = {n: p.grad().asnumpy() for n, p in cell.collect_params().items()}
    return cell, [out.asnumpy()] + [s.asnumpy() for s in new] + \
        [xa.grad.asnumpy()], grads


@pytest.mark.parametrize("how", ["step", "unroll", "valid_length"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_matches_the_reference(name, how):
    x = rnd(T, N, I, seed=17)
    valid = np.array([2, T, 1], np.float32) if how == "valid_length" \
        else None
    kw = dict(valid=valid, step=how == "step")
    jcell, jouts, jgrads = run_cell(jrnn, jnd, jag, CELLS[name], x, **kw)
    named = {n: p.data().asnumpy() for n, p in
             jcell.collect_params().items()}
    tcell, touts, tgrads = run_cell(trnn, tnd, tag, CELLS[name], x, named,
                                    **kw)
    assert sorted(tgrads) == sorted(jgrads)
    for a, b in zip(touts, jouts):
        close(a, b)
    for n in jgrads:
        close(tgrads[n], jgrads[n], n)


@pytest.mark.parametrize("valid", [None, [2, T, 0]])
def test_bidirectional_cell_matches_the_reference(valid):
    x = rnd(T, N, I, seed=18)
    res, named = [], None
    for rnn, nd in [(jrnn, jnd), (trnn, tnd)]:
        cell = rnn.BidirectionalCell(rnn.LSTMCell(H), rnn.GRUCell(H))
        if named is None:
            cell.initialize()
            cell.unroll(T, nd.array(x), layout="TNC")
            named = {n: p.data().asnumpy()
                     for n, p in cell.collect_params().items()}
        else:
            params_from_mxnet_tpu(named, net=cell, device="cpu")
        outs, states = cell.unroll(
            T, nd.array(x), layout="TNC", merge_outputs=False,
            valid_length=None if valid is None
            else nd.array(np.array(valid, np.float32)))
        res.append([o.asnumpy() for o in outs] +
                   [s.asnumpy() for s in states])
    assert len(res[0]) == len(res[1]) == T + 3
    for a, b in zip(res[1], res[0]):
        close(a, b)


def test_zoneout_in_training_mixes_the_old_and_new_states():
    cell = trnn.ZoneoutCell(trnn.GRUCell(H), zoneout_outputs=0.5,
                            zoneout_states=0.5)
    cell.initialize()
    x = tnd.array(rnd(T, N, I, seed=19))
    plain, _ = cell.unroll(T, x, layout="TNC")
    tmx.random.seed(5)
    with tag.record():
        a, _ = cell.unroll(T, x, layout="TNC")
    tmx.random.seed(5)
    with tag.record():
        b, _ = cell.unroll(T, x, layout="TNC")
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert np.abs(a.asnumpy() - plain.asnumpy()).max() > 1e-3
    with pytest.raises(AssertionError):
        trnn.ZoneoutCell(trnn.BidirectionalCell(trnn.GRUCell(H),
                                                trnn.GRUCell(H)))
    with pytest.raises(AssertionError, match="modifier"):
        cell.base_cell.begin_state(N)


# ---------------------------------------------------------------------------
# examples/word_lm.py: three steps on both packages
# ---------------------------------------------------------------------------

def _word_lm():
    spec = importlib.util.spec_from_file_location(
        "word_lm_reference", REPO / "examples" / "word_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_three_word_lm_steps_match_the_reference():
    """``examples/word_lm.py``'s model and loop (tied decoder, SGD lr 1.0
    with ``clip_gradient`` 0.25, ``trainer.step(batch * bptt)``, the states
    detached between steps) at vocabulary 50, embedding and hidden 16, 2
    layers, dropout 0, bptt 6, batch 4: the losses and every parameter
    after each step."""
    V, E, HID, L, BPTT, B = 50, 16, 16, 2, 6, 4
    ref = _word_lm()
    ids, _ = ref.load_corpus(V)
    np.testing.assert_array_equal(ids, chip_smoke.lm_corpus(V))
    data = ref.batchify(ids, B)
    jmodel = ref.RNNModel(V, E, HID, L, 0.0)
    jmodel.initialize(jmx.init.Xavier())
    jstate = jmodel.lstm.begin_state(B)
    jmodel(jnd.array(data[:BPTT]), jstate)
    tmodel = chip_smoke.word_lm_model(V, E, HID, L, 0.0)
    params_from_mxnet_tpu({n: p.data().asnumpy() for n, p in
                           jmodel.collect_params().items()}, net=tmodel,
                          device="cpu")
    jtrain = jgluon.Trainer(jmodel.collect_params(), "sgd",
                            {"learning_rate": 1.0, "clip_gradient": 0.25})
    ttrain = tgluon.Trainer(tmodel.collect_params(), "sgd",
                            {"learning_rate": 1.0, "clip_gradient": 0.25})
    jloss, tloss = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        tgluon.loss.SoftmaxCrossEntropyLoss()
    tstate = tmodel.lstm.begin_state(B)
    for i in range(3):
        s = i * BPTT
        x, y = data[s:s + BPTT], data[s + 1:s + 1 + BPTT].astype(np.float32)
        losses = []
        for model, trainer, loss_fn, nd, ag, state in [
                (jmodel, jtrain, jloss, jnd, jag, jstate),
                (tmodel, ttrain, tloss, tnd, tag, tstate)]:
            state = [st.detach() for st in state]
            with ag.record():
                logits, state = model(nd.array(x), state)
                loss = loss_fn(logits, nd.array(y))
            loss.backward()
            trainer.step(B * BPTT)
            losses.append(loss.asnumpy())
            if model is jmodel:
                jstate = state
            else:
                tstate = state
        close(losses[1], losses[0], "loss, step %d" % i)
        want = {n: p.data().asnumpy() for n, p in
                jmodel.collect_params().items()}
        got = params_to_numpy(tmodel)
        assert sorted(got) == sorted(want)
        for n in want:
            close(got[n], want[n], "%s after step %d" % (n, i))
