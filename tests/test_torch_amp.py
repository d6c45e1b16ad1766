"""``mx.amp`` of the port against the JAX reference, on the CPU.

First one counterpart of every case of ``tests/test_amp.py``, each run on
both packages.  Then the policy on the three routes an op takes
(``nd.*``, a gluon block called on NDArrays or tensors, and
``functionalize``/``TrainStep``): a ``Dense``, a 2-layer BERT whose head
dim 64 sends attention through the flash Function (its plain version on
the CPU) and a narrow ResNet, each under ``amp.init()`` with the
reference's parameters, give the reference's output dtypes and values
within the bf16 rule of ``chip_smoke.compare`` (|d| <= 2e-3 + (2e-3 +
2^-8) |ref| for a bf16 output).  That rule bounds one rounding; through a
net of bf16 products each package rounds at every layer, so for BERT and
ResNet the two packages' outputs may also differ by twice the largest
distance the reference's own AMP output lies from its float32 output (the
bf16 noise of each side).  Then the float16 loss scaler (a skipped
step leaves weights and momenta bitwise unchanged and halves the scale;
``scale_window`` clean steps double it), ``unscale`` and
``convert_hybrid_block``.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp, autograd as jautograd, gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.parallel import TrainStep as JTrainStep, make_mesh

import mxnet_tpu_torch as tmx
from chip_smoke import compare
from mxnet_tpu_torch import amp as tamp, autograd as tautograd
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import functionalize
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.parallel import TrainStep

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

BF16_TOL = 2e-3
PKGS = {"jax": (jmx, jamp, jautograd, jgluon, jnn),
        "port": (tmx, tamp, tautograd, tgluon, tnn)}


@pytest.fixture(autouse=True)
def _cpu_and_amp_off():
    with tmx.cpu():
        yield
    jamp.turn_off()
    tamp.turn_off()


def both(case):
    """``case(mx, amp, autograd, gluon, nn)`` on each package."""
    return {k: case(*pkg) for k, pkg in PKGS.items()}


def dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def to_f32(x):
    """An NDArray or tensor as a float32 torch tensor, and its dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().float(), x.dtype
    if hasattr(x, "_jax"):
        x = x._jax
    if isinstance(x, tmx.nd.NDArray):
        return x.data.detach().float(), x.data.dtype
    dt = torch.bfloat16 if str(x.dtype) == "bfloat16" else \
        getattr(torch, str(x.dtype))
    return torch.from_numpy(np.asarray(x, np.float32)), dt


def assert_bf16_rule(port, ref, ref_fp32=None):
    """Equal dtypes; port within the bf16 rule of the reference, plus twice
    the reference's own AMP-to-float32 distance when ``ref_fp32`` (the
    reference's float32 output) is given."""
    got, gdt = to_f32(port)
    want, wdt = to_f32(ref)
    assert gdt == wdt, (gdt, wdt)
    noise = 0.0
    if ref_fp32 is not None:
        noise = 2.0 * float((want - to_f32(ref_fp32)[0]).abs().max())
    err, ok = compare(got.to(gdt), want, BF16_TOL + noise)
    assert ok, (err, noise)


# ---------------------------------------------------------------------------
# tests/test_amp.py, case by case
# ---------------------------------------------------------------------------

def test_target_op_casts_down():
    def case(mx, amp, *_):
        amp.init()
        out = mx.nd.dot(mx.nd.ones((4, 8)), mx.nd.ones((8, 2)))
        return dtype_name(out), out.astype("float32").asnumpy()
    got = both(case)
    assert got["port"][0] == got["jax"][0] == "bfloat16"
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])
    np.testing.assert_allclose(got["port"][1], 8.0)


def test_fp32_op_casts_up():
    def case(mx, amp, *_):
        amp.init()
        return dtype_name(mx.nd.softmax(mx.nd.ones((2, 3),
                                                   dtype="bfloat16")))
    assert both(case) == {"jax": "float32", "port": "float32"}


def test_widest_cast():
    def case(mx, amp, *_):
        amp.init()
        a = mx.nd.ones((4,), dtype="bfloat16")
        return dtype_name(a + mx.nd.ones((4,), dtype="float32"))
    assert both(case) == {"jax": "float32", "port": "float32"}


@pytest.mark.parametrize("op,act,want", [
    ("Activation", "softrelu", "float32"), ("Activation", "relu", "bfloat16"),
    ("LeakyReLU", "elu", "float32"), ("LeakyReLU", "selu", "float32"),
    ("LeakyReLU", "leaky", "bfloat16"), ("LeakyReLU", "gelu", "bfloat16")])
def test_conditional_fp32(op, act, want):
    def case(mx, amp, *_):
        amp.init()
        x = mx.nd.ones((4,), dtype="bfloat16")
        return dtype_name(getattr(mx.nd, op)(x, act_type=act))
    assert both(case) == {"jax": want, "port": want}


def test_off_by_default_and_turn_off():
    def case(mx, amp, *_):
        a = mx.nd.ones((2, 2))
        seen = [dtype_name(mx.nd.dot(a, a))]
        amp.init()
        seen.append(dtype_name(mx.nd.dot(a, a)))
        amp.turn_off()
        seen.append(dtype_name(mx.nd.dot(a, a)))
        return seen
    assert both(case) == {k: ["float32", "bfloat16", "float32"]
                          for k in PKGS}


def test_grads_flow_through_amp_casts():
    rng = np.random.RandomState(0)
    w0 = rng.randn(8, 2).astype(np.float32)
    x0 = rng.randn(4, 8).astype(np.float32)

    def case(mx, amp, autograd, *_):
        amp.init()
        w = mx.nd.array(w0)
        w.attach_grad()
        x = mx.nd.array(x0)
        with autograd.record():
            y = mx.nd.dot(x, w)
            loss = (y * y).mean()
        loss.backward()
        return w.grad
    got = both(case)
    g = got["port"].asnumpy()
    assert g.dtype == np.float32 and np.isfinite(g).all() and \
        np.abs(g).sum() > 0          # the master gradient stays wide
    assert_bf16_rule(got["port"], got["jax"])


def _toy_trainer(mx, gluon, nn, dtype="float16"):
    net = nn.Dense(1, in_units=4)
    net.initialize()
    if dtype:
        net.cast(dtype)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1,
                             "multi_precision": dtype == "float16"})
    return net, trainer


def test_scale_loss_and_dynamic_scaler():
    def case(mx, amp, autograd, gluon, nn):
        amp.init(target_dtype="float16")
        net, trainer = _toy_trainer(mx, gluon, nn, "float16")
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        assert scaler.loss_scale > 1.0
        scaler.loss_scale = 1024.0
        x = mx.nd.ones((2, 4), dtype="float16")
        y = mx.nd.ones((2, 1), dtype="float16")
        with autograd.record():
            loss = ((net(x) - y) ** 2).mean()
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        assert trainer._scale == pytest.approx(1.0 / 1024.0)
        w_before = net.weight.data().asnumpy().copy()
        trainer.step(2)
        assert not np.allclose(net.weight.data().asnumpy(), w_before)
        return type(scaler).__name__, trainer._scale
    got = both(case)
    assert got["port"] == got["jax"] == ("LossScaler", 1.0 / 1024.0)


def test_overflow_skips_update_and_backs_off():
    def case(mx, amp, autograd, gluon, nn):
        amp.init(target_dtype="float16")
        net, trainer = _toy_trainer(mx, gluon, nn, "float16")
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        with autograd.record():
            loss = net(mx.nd.ones((2, 4), dtype="float16")).mean()
        loss.backward()
        net.weight.grad()[:] = mx.nd.full(net.weight.grad().shape, np.inf,
                                          dtype="float16")
        w_before = net.weight.data().asnumpy().copy()
        s0 = scaler.loss_scale
        trainer.step(2)
        np.testing.assert_array_equal(net.weight.data().asnumpy(), w_before)
        return s0, scaler.loss_scale
    got = both(case)
    assert got["port"] == got["jax"] == (2.0 ** 16, 2.0 ** 15)


def test_bf16_amp_training_converges():
    def case(mx, amp, autograd, gluon, nn):
        amp.init()
        np.random.seed(0)
        mx.random.seed(0)
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu"), nn.Dense(2))
        net.initialize(mx.init.Xavier())
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
        amp.init_trainer(trainer)
        sce = gluon.loss.SoftmaxCrossEntropyLoss()
        X = np.random.randn(128, 8).astype(np.float32)
        Y = (X[:, 0] > 0).astype(np.int32)
        losses = []
        for _ in range(30):
            x, y = mx.nd.array(X), mx.nd.array(Y)
            with autograd.record():
                loss = sce(net(x), y)
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
            scaled.backward()
            trainer.step(128)
            losses.append(float(loss.mean().asnumpy()))
        return losses, dtype_name(net[0].weight.data())
    got = both(case)
    for losses, wdt in got.values():
        assert losses[-1] < 0.3 < losses[0]
        assert wdt == "float32"           # the master weights stay fp32


def test_convert_hybrid_block_keeps_norms_fp32():
    def case(mx, amp, autograd, gluon, nn):
        net = nn.HybridSequential()
        net.add(nn.Dense(8), nn.BatchNorm(), nn.GroupNorm(2),
                nn.InstanceNorm(), nn.LayerNorm(), nn.Dense(2))
        net.initialize()
        net(mx.nd.ones((2, 4)).reshape((2, 4, 1)))
        amp.convert_hybrid_block(net, "bfloat16")
        dts = [dtype_name(net[0].weight.data()),
               dtype_name(net[1].gamma.data()),
               dtype_name(net[1].running_var.data()),
               dtype_name(net[2].beta.data()),
               dtype_name(net[3].gamma.data()),
               dtype_name(net[4].gamma.data()),
               dtype_name(net[5].weight.data())]
        amp.init()
        out = net(mx.nd.ones((2, 4, 1), dtype="bfloat16"))
        assert np.isfinite(out.astype("float32").asnumpy()).all()
        return dts, dtype_name(out)
    got = both(case)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["bfloat16"] + ["float32"] * 5 + ["bfloat16"]


# ---------------------------------------------------------------------------
# the three routes: a Dense, a small BERT, a narrow ResNet
# ---------------------------------------------------------------------------

def test_dense_under_amp_on_every_route():
    rng = np.random.RandomState(3)
    w, b = rng.randn(5, 6).astype(np.float32), rng.randn(5).astype(np.float32)
    x = rng.randn(4, 6).astype(np.float32)
    jamp.init()
    tamp.init()
    jnet = jnn.Dense(5, in_units=6, activation="tanh")
    jnet.initialize()
    jnet.weight.set_data(jmx.nd.array(w))
    jnet.bias.set_data(jmx.nd.array(b))
    want = jnet(jmx.nd.array(x))
    tnet = tnn.Dense(5, in_units=6, activation="tanh")
    params_from_mxnet_tpu({"weight": w, "bias": b}, net=tnet, device="cpu")
    assert_bf16_rule(tnet(tmx.nd.array(x)), want)              # NDArrays
    assert_bf16_rule(tnet(torch.from_numpy(x)), want)          # tensors
    pure, params = functionalize(tnet)
    assert_bf16_rule(pure(params, torch.from_numpy(x)), want)  # functional
    assert_bf16_rule(tmx.nd.FullyConnected(                    # nd.*
        tmx.nd.array(x), tmx.nd.array(w), tmx.nd.array(b), num_hidden=5),
        jmx.nd.FullyConnected(jmx.nd.array(x), jmx.nd.array(w),
                              jmx.nd.array(b), num_hidden=5))


BERT_CFG = dict(vocab_size=50, max_length=64, dropout=0.0)


def _bert_pair(seed=1):
    jnet = jbert.get_bert(2, 128, 2, **BERT_CFG)
    jnet.initialize(jmx.init.Normal(0.02))
    tok, seg, _ = _bert_batch()
    jnet(jmx.nd.array(tok, dtype="int32"), jmx.nd.array(seg, dtype="int32"))
    rng = np.random.RandomState(seed)
    named = {}
    for name, p in jnet.collect_params().items():
        shape = p.data().shape
        val = 1.0 + 0.1 * rng.randn(*shape) if name.endswith("gamma") \
            else 0.05 * rng.randn(*shape)
        named[name] = val.astype(np.float32)
        p.set_data(jmx.nd.array(named[name]))
    tnet = tbert.get_bert(2, 128, 2, **BERT_CFG)
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    return jnet, tnet, named


def _bert_batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 50, (2, 64)).astype(np.int32),
            (np.arange(64)[None, :] >= rng.randint(1, 64, (2, 1)))
            .astype(np.int32),
            rng.randint(0, 50, (2, 64)).astype(np.int32))


def test_bert_under_amp_matches_reference_on_every_route(monkeypatch):
    jnet, tnet, _ = _bert_pair()
    tok, seg, _ = _bert_batch()
    jargs = (jmx.nd.array(tok, dtype="int32"), jmx.nd.array(seg,
                                                            dtype="int32"))
    want_fp32 = jnet(*jargs)
    jamp.init()
    tamp.init()
    want = jnet(*jargs)
    flash = []
    real = tatt._flash_fwd
    monkeypatch.setattr(tatt, "_flash_fwd",
                        lambda *a: flash.append(a[0].dtype) or real(*a))
    routes = {
        "tensors": tnet(torch.from_numpy(tok), torch.from_numpy(seg)),
        "ndarrays": tnet(tmx.nd.array(tok, dtype="int32"),
                         tmx.nd.array(seg, dtype="int32")),
        "functional": functionalize(tnet)[0](
            functionalize(tnet)[1], torch.from_numpy(tok),
            torch.from_numpy(seg)),
    }
    # q, k and v reach the flash Function in bf16, once a layer a route
    assert flash == [torch.bfloat16] * 6
    for outs in routes.values():
        assert len(outs) == len(want) == 4
        for got, ref, ref32 in zip(outs, want, want_fp32):
            assert_bf16_rule(got, ref, ref32)
    assert [dtype_name(o) for o in routes["tensors"]] == \
        ["float32", "bfloat16", "bfloat16", "bfloat16"]


def _jax_mlm_loss(outputs, labels):
    logp = jax.nn.log_softmax(outputs[-1].astype(jnp.float32), axis=-1)
    onehot = jax.nn.one_hot(labels, 50, dtype=logp.dtype)
    return -jnp.mean(jnp.sum(logp * onehot, axis=-1))


def _torch_mlm_loss(outputs, labels):
    return tgluon.loss.SoftmaxCrossEntropyLoss()(outputs[-1].float(),
                                                 labels).mean()


def test_train_step_under_amp_matches_reference():
    """Three ``TrainStep`` steps of the small BERT under ``amp.init()`` on
    both sides: the losses within the bf16 rule (float32 losses from
    bf16 logits), every parameter still float32."""
    jnet, tnet, _ = _bert_pair()
    tok, seg, lab = _bert_batch()
    jamp.init()
    tamp.init()
    mesh = make_mesh(axes=("dp",), devices=jax.devices("cpu")[:1])
    jstep = JTrainStep(jnet, _jax_mlm_loss, mesh, learning_rate=0.1,
                       momentum=0.9)
    jargs = [jnp.asarray(a) for a in (tok, seg, lab)]
    j_losses = [float(jstep(*jargs)) for _ in range(3)]
    tstep = TrainStep(tnet, _torch_mlm_loss, device="cpu",
                      learning_rate=0.1, momentum=0.9)
    t_losses = [float(tstep(tok, seg, lab)) for _ in range(3)]
    err, ok = compare(torch.tensor(t_losses), torch.tensor(j_losses),
                      BF16_TOL)
    assert ok, (t_losses, j_losses)
    assert t_losses[-1] < t_losses[0]
    assert {p.dtype for p in tstep.params.values()} == {torch.float32}


RES_LAYERS, RES_CHANNELS = [2, 2, 2, 2], [8, 8, 16, 32, 64]


def test_resnet_under_amp_matches_reference():
    """A ResNet-18-like net at width 8 in training mode on NDArrays under
    ``amp.init()``: convolutions and dense in bf16, BatchNorm in fp32,
    output dtype and values as the reference's; the running statistics
    stay float32 through the aux write-back."""
    jnet = jresnet.ResNetV1(jresnet.BasicBlockV1, RES_LAYERS, RES_CHANNELS,
                            classes=10)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    jnet(jmx.nd.array(x))
    rng = np.random.RandomState(1)
    named = {}
    for name, p in jnet.collect_params().items():
        shape = p.data().shape
        if name.endswith(("gamma", "running_var")):
            val = 1.0 + 0.2 * np.abs(rng.randn(*shape))
        elif name.endswith(("beta", "running_mean", "bias")):
            val = 0.1 * rng.randn(*shape)
        else:
            val = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        named[name] = val.astype(np.float32)
        p.set_data(jmx.nd.array(named[name]))
    tnet = tresnet.ResNetV1(tresnet.BasicBlockV1, RES_LAYERS, RES_CHANNELS,
                            classes=10)
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    jamp.init()
    tamp.init()
    with jautograd.record():
        want = jnet(jmx.nd.array(x))
    with tautograd.record():
        got = tnet(tmx.nd.array(x))
    want_mean = jnet.features[1].running_mean.data().asnumpy()
    jamp.turn_off()
    with jautograd.record():
        want_fp32 = jnet(jmx.nd.array(x))
    assert_bf16_rule(got, want, want_fp32)
    assert dtype_name(got) == "bfloat16"
    for name, p in tnet.collect_params().items():
        assert p.data().dtype == "float32" or \
            dtype_name(p.data()) == "float32", name
    bn = tnet.features[1]
    np.testing.assert_allclose(bn.running_mean.data().asnumpy(), want_mean,
                               rtol=1e-2, atol=1e-2)


def test_bn_moving_stats_stay_float32_through_nd_batchnorm():
    def case(mx, amp, *_):
        amp.init()
        x = mx.nd.ones((2, 3, 4, 4), dtype="bfloat16")
        g, b = mx.nd.ones((3,)), mx.nd.zeros((3,))
        mm, mv = mx.nd.zeros((3,)), mx.nd.ones((3,))
        out = mx.nd.BatchNorm(x, g, b, mm, mv, fix_gamma=False)
        return dtype_name(out), dtype_name(mm), mm.asnumpy()
    got = both(case)
    assert got["port"][:2] == got["jax"][:2] == ("float32", "float32")
    np.testing.assert_allclose(got["port"][2], got["jax"][2], rtol=1e-6)


def test_indices_and_masks_keep_their_dtype():
    seen = {}
    real = tatt.attention_core

    def spy(q, k, v, **kw):
        seen["q"], seen["mask"] = q.dtype, kw["mask"].dtype
        return real(q, k, v, **kw)

    tamp.init()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("mxnet_tpu_torch.ops.nn.attention_core", spy)
        q = torch.randn(1, 4, 8)
        out = tmx.ops.registry.dispatch(
            "multi_head_attention", q, q, q,
            torch.ones(1, 1, 1, 4, dtype=torch.bool), num_heads=2)
    assert (seen["q"], seen["mask"], out.dtype) == \
        (torch.bfloat16, torch.bool, torch.bfloat16)
    emb = tmx.nd.Embedding(tmx.nd.array([1, 2], dtype="int32"),
                           tmx.nd.ones((4, 3)), input_dim=4, output_dim=3)
    assert dtype_name(emb) == "float32"


# ---------------------------------------------------------------------------
# the float16 loss scaler, unscale, scopes
# ---------------------------------------------------------------------------

def _fp16_momentum_trainer():
    tamp.init(target_dtype="float16")
    net = tnn.Dense(3, in_units=4)
    net.initialize(device="cpu", seed=2)
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
    tamp.init_trainer(trainer)
    return net, trainer


def _step(net, trainer, poison=False):
    x = tmx.nd.array(np.random.RandomState(0).randn(2, 4).astype(np.float32))
    with tautograd.record():
        loss = net(x).astype("float32").sum()
        with tamp.scale_loss(loss, trainer) as scaled:
            pass
    scaled.backward()
    if poison:
        net.weight.grad()[:] = float("nan")
    trainer.step(2)


def _snapshot(net, trainer):
    states = trainer._updaters[0].states
    return [p.data().data.clone() for p in net.collect_params().values()] + \
        [s.data.clone() for s in states.values() if s is not None]


def test_a_non_finite_step_is_skipped_bitwise_and_halves_the_scale():
    net, trainer = _fp16_momentum_trainer()
    scaler = trainer._amp_loss_scaler
    scaler.loss_scale = 256.0
    _step(net, trainer)                       # makes the momenta
    before = _snapshot(net, trainer)
    _step(net, trainer, poison=True)
    after = _snapshot(net, trainer)
    assert len(before) == len(after) == 4
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert scaler.loss_scale == 128.0
    _step(net, trainer)                       # the next step updates
    moved = _snapshot(net, trainer)
    assert not torch.equal(moved[0], after[0])
    assert scaler.loss_scale == 128.0


def test_clean_steps_double_the_scale_up_to_the_cap():
    net, trainer = _fp16_momentum_trainer()
    scaler = trainer._amp_loss_scaler
    scaler._scale_window = 2
    scaler.loss_scale = 2.0 ** 23
    seen = []
    for _ in range(4):
        scaler.update_scale(False)
        seen.append(scaler.loss_scale)
    assert seen == [2.0 ** 23, 2.0 ** 24, 2.0 ** 24, 2.0 ** 24]
    scaler.update_scale(True)
    assert scaler.loss_scale == 2.0 ** 23 and scaler._unskipped == 0


def test_bf16_trainer_takes_the_static_scaler():
    def case(mx, amp, autograd, gluon, nn):
        amp.init()
        net, trainer = _toy_trainer(mx, gluon, nn, None)
        amp.init_trainer(trainer)
        s = trainer._amp_loss_scaler
        return type(s).__name__, s.loss_scale, s.has_overflow([])
    got = both(case)
    assert got["port"] == got["jax"] == ("_StaticScaler", 1.0, False)


def test_unscale_divides_the_gradients_in_place():
    def case(mx, amp, autograd, gluon, nn):
        amp.init(target_dtype="float16")
        net = nn.Dense(2, in_units=3)
        net.initialize()
        net.weight.set_data(mx.nd.array(np.arange(6, dtype=np.float32)
                                        .reshape(2, 3) / 10))
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        amp.init_trainer(trainer)
        trainer._amp_loss_scaler.loss_scale = 8.0
        with autograd.record():
            loss = net(mx.nd.ones((2, 3))).sum()
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        scaled_scale = trainer._scale
        amp.unscale(trainer)
        return (net.weight.grad().asnumpy().astype(np.float32),
                scaled_scale, trainer._scale)
    got = both(case)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-3)
    np.testing.assert_allclose(got["port"][0], 2.0, rtol=1e-3)
    assert got["port"][1:] == got["jax"][1:] == (1.0 / 8.0, 1.0)


def test_state_scope_is_per_thread():
    policy = tamp.make_state("bfloat16")
    seen = []
    with tamp.state_scope(policy):
        t = threading.Thread(target=lambda: seen.append(
            tamp.current_state()))
        t.start()
        t.join()
        a = tmx.nd.ones((2, 2))
        inner = dtype_name(tmx.nd.dot(a, a))
        with tamp.state_scope(None):
            off = dtype_name(tmx.nd.dot(a, a))
    assert seen == [None] and inner == "bfloat16" and off == "float32"
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        tamp.init(target_dtype="float64")
