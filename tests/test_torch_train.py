"""The port's training slice against the JAX reference, on the CPU.

A small BERT (2 layers, 128 units, 2 heads so head dim 64, vocab 1000,
T = 128, batch 2, MLM decoder, dropout 0) is built in ``mxnet_tpu`` with
every parameter drawn from numpy, carried into ``mxnet_tpu_torch`` by
``params_from_mxnet_tpu``, and trained for 3 fp32 steps on both sides from
the same numpy batch: ``mxnet_tpu.parallel.TrainStep`` on a one-device mesh
with the bench's MLM loss, and ``mxnet_tpu_torch.parallel.TrainStep`` with
``SoftmaxCrossEntropyLoss``.  The port's attention runs through the flash
Function (the plain versions of K1-K3 on the CPU); the reference's through
its jnp composition.  Tolerance: rtol 1e-4, atol 1e-5 (the repo's fp32
bound).  The loss, ``functionalize``, ``run_steps``, ``Dropout`` and the
softmax ops are held against the reference's semantics beside it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops.matrix import _pick as jpick
from mxnet_tpu.ops.nn import (_log_softmax as jlog_softmax,
                              _softmax as jsoftmax,
                              _softmax_cross_entropy as jsce)
from mxnet_tpu.parallel import TrainStep as JTrainStep, make_mesh
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu, params_to_numpy
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.gluon.block import functionalize
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.parallel import TrainStep

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
VOCAB, T, B = 1000, 128, 2
CFG = dict(vocab_size=VOCAB, max_length=T, dropout=0.0,
           use_classifier=False)
LR, MOM, STEPS = 0.1, 0.9, 3


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (B, T)).astype(np.int32),
            (np.arange(T)[None, :] >= rng.randint(1, T, (B, 1)))
            .astype(np.int32),
            rng.randint(0, VOCAB, (B, T)).astype(np.int32))


def _jax_bert(seed=1):
    net = jbert.get_bert(2, 128, 2, **CFG)
    net.initialize(mx.init.Normal(0.02))
    tok, seg, _ = _batch()
    net(nd.array(tok, dtype="int32"), nd.array(seg, dtype="int32"))
    rng = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        shape = p.data().shape
        val = 1.0 + 0.1 * rng.randn(*shape) if name.endswith("gamma") \
            else 0.05 * rng.randn(*shape)
        p.set_data(nd.array(val.astype(np.float32)))
    return net


def _jax_mlm_loss(outputs, labels):
    """The bench's MLM loss (bench.py run_bert_bench)."""
    logp = jax.nn.log_softmax(outputs[-1].astype(jnp.float32), axis=-1)
    onehot = jax.nn.one_hot(labels, VOCAB, dtype=logp.dtype)
    return -jnp.mean(jnp.sum(logp * onehot, axis=-1))


def _torch_mlm_loss(outputs, labels):
    return tloss.SoftmaxCrossEntropyLoss()(outputs[-1].float(),
                                           labels).mean()


def _torch_bert(named):
    net = tbert.get_bert(2, 128, 2, **CFG)
    params_from_mxnet_tpu(named, net=net, device="cpu")
    return net


@pytest.fixture(scope="module")
def trained():
    """3 steps on both sides from one set of parameters and one batch;
    the port's flash backward calls are counted."""
    jnet = _jax_bert()
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tok, seg, lab = _batch()
    mesh = make_mesh(axes=("dp",), devices=jax.devices("cpu")[:1])
    jstep = JTrainStep(jnet, _jax_mlm_loss, mesh, learning_rate=LR,
                       momentum=MOM)
    jargs = [jnp.asarray(a) for a in (tok, seg, lab)]
    j_losses = [float(jstep(*jargs)) for _ in range(STEPS)]
    j_params = {n: np.asarray(v) for n, v in jstep.params.items()}

    tnet = _torch_bert(named)
    calls = []
    real_bwd = tatt._flash_bwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tatt, "_flash_bwd",
                   lambda *a: calls.append(a[0].shape) or real_bwd(*a))
        tstep = TrainStep(tnet, _torch_mlm_loss, device="cpu",
                          learning_rate=LR, momentum=MOM)
        t_losses = [float(tstep(tok, seg, lab)) for _ in range(STEPS)]
    return dict(named=named, j_losses=j_losses, j_params=j_params,
                t_losses=t_losses, t_params=params_to_numpy(tstep.params),
                tstep=tstep, tnet=tnet, flash_bwd_calls=calls)


def test_losses_match_reference(trained):
    np.testing.assert_allclose(trained["t_losses"], trained["j_losses"],
                               rtol=RTOL, atol=ATOL)
    assert trained["t_losses"][-1] < trained["t_losses"][0]


def test_params_match_reference_by_name(trained):
    j, t, p0 = trained["j_params"], trained["t_params"], trained["named"]
    assert sorted(t) == sorted(j)
    moved = 0
    for name in j:
        np.testing.assert_allclose(t[name], j[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        # the update itself, not only the parameter it moved
        dj, dt = j[name] - p0[name], t[name] - p0[name]
        np.testing.assert_allclose(dt, dj, rtol=0,
                                   atol=1e-3 * np.abs(dj).max() + 1e-7,
                                   err_msg=name)
        moved += bool(np.abs(dj).max() > 0)
    # the pooler is not on the MLM loss's path: zero gradient, no motion
    assert np.array_equal(t["pooler.weight"], p0["pooler.weight"])
    assert moved == len(j) - 2


def test_training_ran_the_flash_backward(trained):
    """Both layers' attention backward went through the flash Function
    (its plain versions on the CPU), once per layer and step."""
    assert trained["flash_bwd_calls"] == [(B, 2, T, 64)] * (2 * STEPS)


def test_opt_state_is_momentum_in_param_dtype(trained):
    tstep = trained["tstep"]
    assert list(tstep.opt_state) == list(tstep.params)
    for name, m in tstep.opt_state.items():
        assert m.dtype == tstep.params[name].dtype
    assert float(tstep.opt_state["decoder_out.weight"].abs().max()) > 0


def test_write_back_copies_the_step_params(trained):
    tnet = _torch_bert(trained["named"])
    trained["tstep"].write_back(tnet)
    got = params_to_numpy(tnet)
    for name, want in trained["t_params"].items():
        np.testing.assert_array_equal(got[name], want)


def test_run_steps_equals_single_steps(trained):
    tok, seg, lab = _batch()
    a = TrainStep(_torch_bert(trained["named"]), _torch_mlm_loss,
                  device="cpu", learning_rate=LR, momentum=MOM)
    b = TrainStep(_torch_bert(trained["named"]), _torch_mlm_loss,
                  device="cpu", learning_rate=LR, momentum=MOM)
    last = a.run_steps(STEPS, tok, seg, lab)
    singles = [b(tok, seg, lab) for _ in range(STEPS)]
    assert last.dtype == torch.float32
    assert float(last) == float(singles[-1])
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        assert torch.equal(a.opt_state[name], b.opt_state[name]), name
    np.testing.assert_allclose(float(last), trained["j_losses"][-1],
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        a.run_steps(0, tok, seg, lab)


def test_train_step_defaults_to_the_gpu_and_raises_without_one():
    net = tgnn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(MXNetError, match="cuda"):
        TrainStep(net, lambda out, y: out.sum())


# ---------------------------------------------------------------------------
# functionalize
# ---------------------------------------------------------------------------


def test_functionalize_substitutes_params_and_restores_modes():
    net = tgnn.HybridSequential()
    net.add(tgnn.Dense(8, in_units=4, activation="relu"),
            tgnn.Dropout(0.5, generator=torch.Generator().manual_seed(0)),
            tgnn.Dense(3, in_units=8))
    net.initialize(device="cpu", seed=3)
    x = torch.from_numpy(np.random.RandomState(0).randn(5, 4)
                         .astype(np.float32))
    pure_fn, params = functionalize(net)
    assert list(params) == list(net.collect_params())
    with torch.no_grad():
        assert torch.equal(pure_fn(params, x), net(x))
        other = {n: p + 0.5 for n, p in params.items()}
        got = pure_fn(other, x)
        twin = tgnn.HybridSequential()
        twin.add(tgnn.Dense(8, in_units=4, activation="relu"),
                 tgnn.Dropout(0.5), tgnn.Dense(3, in_units=8))
        twin.load_dict(other, device="cpu")
        assert torch.equal(got, twin(x))
        # training=True reaches the dropout; the block's own modes return
        y_train = pure_fn(params, x, training=True)
        assert not torch.equal(y_train, net(x))
    assert not any(m.training for m in net.modules())
    with pytest.raises(RuntimeError):
        pure_fn({n: p for n, p in list(params.items())[1:]}, x)


def test_functionalize_refuses_unmaterialised_params():
    with pytest.raises(MXNetError, match="initialize"):
        functionalize(tgnn.Dense(4, in_units=3))


# ---------------------------------------------------------------------------
# losses and softmax ops against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,sparse,with_sw", [
    (dict(), True, False),
    (dict(weight=0.5), True, True),
    (dict(sparse_label=False), False, False),
    (dict(from_logits=True), True, False),
    (dict(axis=1, batch_axis=0), True, False),
])
def test_softmax_ce_loss_matches_reference(kw, sparse, with_sw):
    rng = np.random.RandomState(5)
    axis = kw.get("axis", -1)
    pred = rng.randn(4, 6, 5).astype(np.float32)
    n_cls = pred.shape[axis]
    lab_shape = tuple(s for i, s in enumerate(pred.shape)
                      if i != axis % pred.ndim)
    if sparse:
        label = rng.randint(0, n_cls, lab_shape).astype(np.float32)
    else:
        label = rng.rand(*pred.shape).astype(np.float32)
    if kw.get("from_logits"):
        pred = np.log(np.exp(pred) / np.exp(pred).sum(-1, keepdims=True))
    sw = rng.rand(4, 1).astype(np.float32) if with_sw else None
    jl = jloss.SoftmaxCrossEntropyLoss(**kw)
    tl = tloss.SoftmaxCELoss(**kw)
    jargs = [nd.array(pred), nd.array(label)] + \
        ([nd.array(sw)] if with_sw else [])
    targs = [torch.from_numpy(pred), torch.from_numpy(label)] + \
        ([torch.from_numpy(sw)] if with_sw else [])
    want = jl(*jargs).asnumpy()
    got = tl(*targs).numpy()
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight", [1.0, 3.0])
def test_l2_loss_matches_reference(weight):
    rng = np.random.RandomState(6)
    pred = rng.randn(3, 7).astype(np.float32)
    label = rng.randn(3, 7).astype(np.float32)
    want = jloss.L2Loss(weight=weight)(nd.array(pred),
                                       nd.array(label)).asnumpy()
    got = tloss.L2Loss(weight=weight)(torch.from_numpy(pred),
                                      torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(TypeError):
        tloss.L2Loss(weight=torch.tensor(1.0))(torch.from_numpy(pred),
                                               torch.from_numpy(label))


@pytest.mark.parametrize("case", ["softmax", "softmax_temp", "softmax_len",
                                  "log_softmax", "pick", "pick_keepdims",
                                  "sce"])
def test_softmax_ops_match_reference(case):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 4, 6).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case == "softmax":
        want, got = jsoftmax(jx, axis=1), tnn.softmax(tx, axis=1)
    elif case == "softmax_temp":
        want = jsoftmax(jx, temperature=2.0)
        got = tnn.softmax(tx, temperature=2.0)
    elif case == "softmax_len":
        length = np.array([2, 6, 0], np.int32)
        want = jsoftmax(jx, length=jnp.asarray(length), use_length=True)
        got = tnn.softmax(tx, length=torch.from_numpy(length),
                          use_length=True)
    elif case == "log_softmax":
        want, got = jlog_softmax(jx, axis=0), tnn.log_softmax(tx, axis=0)
    elif case in ("pick", "pick_keepdims"):
        # out-of-range and fractional indices clip and truncate alike
        idx = np.array([[0, 5, 9, -2], [1.7, 2, 3, 4], [5, 0, 1, 2]],
                       np.float32)
        keep = case == "pick_keepdims"
        want = jpick(jx, jnp.asarray(idx), axis=-1, keepdims=keep)
        got = tnn.pick(tx, torch.from_numpy(idx), axis=-1, keepdims=keep)
    else:
        lab = np.array([[0, 5, 9, -1], [1, 2, 3, 4], [5, 0, 1, 2]],
                       np.int32)
        want = jsce(jx, jnp.asarray(lab))
        got = tnn.softmax_cross_entropy(tx, torch.from_numpy(lab))
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# Dropout draws from an explicit generator
# ---------------------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_dropout_identity_at_zero_rate_and_in_inference():
    x = torch.randn(16, 16, generator=_gen(0))
    d0 = tgnn.Dropout(0.0).train()
    assert torch.equal(d0(x), x)               # no generator needed
    d = tgnn.Dropout(0.5, generator=_gen(1))
    assert not d.training and torch.equal(d(x), x)


def test_dropout_same_seed_same_mask_and_reference_scaling():
    x = torch.ones(64, 64)
    a = tgnn.Dropout(0.25, generator=_gen(7)).train()(x)
    b = tgnn.Dropout(0.25, generator=_gen(7)).train()(x)
    c = tgnn.Dropout(0.25, generator=_gen(8)).train()(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the reference keeps with probability 1 - p and scales by 1 / (1 - p)
    assert set(torch.unique(a).tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    assert 0.15 < float((a == 0).float().mean()) < 0.35
    # axes share one draw along them
    s = tgnn.Dropout(0.5, axes=(1,), generator=_gen(2)).train()(x)
    assert all(torch.equal(s[:, 0], s[:, j]) for j in range(64))


def test_dropout_never_touches_the_global_rng():
    torch.manual_seed(11)
    before = torch.get_rng_state()
    tgnn.Dropout(0.5, generator=_gen(3)).train()(torch.ones(8, 8))
    assert torch.equal(torch.get_rng_state(), before)
    with pytest.raises(MXNetError, match="Generator"):
        tgnn.Dropout(0.5).train()(torch.ones(2))


def test_set_dropout_generator_reaches_every_dropout():
    net = tbert.get_bert(2, 128, 2, vocab_size=50, max_length=16,
                         dropout=0.1)
    g = _gen(0)
    tgnn.set_dropout_generator(net, g)
    drops = [m for m in net.modules() if isinstance(m, tgnn.Dropout)]
    assert len(drops) > 4 and all(m.generator is g for m in drops)


def test_params_to_numpy_round_trips_and_widens_bf16(trained):
    named = trained["named"]
    net = _torch_bert(named)
    back = params_to_numpy(net)
    assert sorted(back) == sorted(named)
    for n in named:
        np.testing.assert_array_equal(back[n], named[n])
    net.cast("bfloat16")
    wide = params_to_numpy(net)
    assert all(v.dtype == np.float32 for v in wide.values())
