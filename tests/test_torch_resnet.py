"""The port's ResNet training path against the JAX reference, on the CPU.

Narrow ResNets at 32 x 32, batch 2, one per block type (``ResNetV1`` over
``BasicBlockV1`` / ``BottleneckV1`` and ``ResNetV2`` over ``BasicBlockV2``
/ ``BottleneckV2``, stages of [2, 1] blocks over channels [16, 32, 64], 10
classes), are built in ``mxnet_tpu`` with every parameter drawn from numpy
(running statistics included) and carried into ``mxnet_tpu_torch`` by
name.  On both sides: the forward in predict and in training mode; 3 fp32
``TrainStep`` steps (SGD lr 0.1, momentum 0.9, the bench's fp32
log-softmax loss) from the same batch, with the running statistics
unchanged by the step; and the imperative ``autograd.record()`` /
``backward()`` pass, its gradients and the running statistics it writes.
The full-width ``resnet50_v1`` is checked by name, shape and a strict
load of the reference's parameters.  Tolerance: rtol 1e-4, atol 1e-5 (the
repo's fp32 bound).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd, autograd as jag
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.parallel import TrainStep as JTrainStep, make_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, autograd as tag
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu, params_to_numpy
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.block import functionalize
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.parallel import TrainStep

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
B, HW, CLASSES = 2, 32, 10
LAYERS, CHANNELS = [2, 1], [16, 32, 64]
LR, MOM, STEPS = 0.1, 0.9, 3
KINDS = {
    "v1_basic": ("ResNetV1", "BasicBlockV1"),
    "v1_bottleneck": ("ResNetV1", "BottleneckV1"),
    "v2_basic": ("ResNetV2", "BasicBlockV2"),
    "v2_bottleneck": ("ResNetV2", "BottleneckV2"),
}
STATS = ("running_mean", "running_var")


def _build(pkg, kind):
    net_cls, block_cls = KINDS[kind]
    return getattr(pkg, net_cls)(getattr(pkg, block_cls), LAYERS, CHANNELS,
                                 classes=CLASSES)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 3, HW, HW).astype(np.float32),
            rng.randint(0, CLASSES, B).astype(np.int32))


def _jax_net(kind, seed=1):
    """The reference's net with its deferred shapes resolved and every
    parameter drawn from numpy; returns (net, {name: array})."""
    net = _build(jresnet, kind)
    net.initialize(jmx.init.Zero())         # overwritten below
    net(jnd.zeros((1, 3, HW, HW)))
    rng = np.random.RandomState(seed)
    named = {}
    for name, p in net.collect_params().items():
        shape = p.data().shape
        if name.endswith(("gamma", "running_var")):
            val = 1.0 + 0.2 * np.abs(rng.randn(*shape))
        elif name.endswith(("beta", "running_mean", "bias")):
            val = 0.1 * rng.randn(*shape)
        else:                           # He-scaled weights
            val = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        named[name] = val.astype(np.float32)
        p.set_data(jnd.array(named[name]))
    return net, named


def _torch_net(kind, named):
    net = _build(tresnet, kind)
    params_from_mxnet_tpu(named, net=net, device="cpu")
    return net


def _jax_loss(logits, labels):
    """The bench's loss (bench.py run_bench)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    onehot = jax.nn.one_hot(labels, CLASSES, dtype=logp.dtype)
    return -jnp.mean(jnp.sum(logp * onehot, axis=-1))


def _torch_loss(logits, labels):
    return tloss.SoftmaxCrossEntropyLoss()(logits.float(), labels).mean()


@pytest.fixture(scope="module", params=sorted(KINDS))
def nets(request):
    jnet, named = _jax_net(request.param)
    return request.param, jnet, named


# ---------------------------------------------------------------------------
# forward, each block type
# ---------------------------------------------------------------------------

def test_forward_matches_reference_in_predict_and_training_mode(nets):
    kind, jnet, named = nets
    x, _ = _batch()
    tnet = _torch_net(kind, named)
    assert sorted(n for n, _ in tnet.named_parameters()) == sorted(named)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), jnet(jnd.array(x)).asnumpy(),
                               rtol=RTOL, atol=ATOL)
    # training mode through each package's functionalize: batch statistics
    jfn, jparams = jmx.gluon.block.functionalize(jnet)
    tfn, tparams = functionalize(tnet)
    want = jfn(jparams, jnp.asarray(x), training=True)
    with torch.no_grad():
        got = tfn(tparams, torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for name in named:
        assert np.array_equal(tparams[name].numpy(), named[name]), name


# ---------------------------------------------------------------------------
# TrainStep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["v1_bottleneck", "v2_basic"])
def trained(request):
    kind = request.param
    jnet, named = _jax_net(kind)
    x, y = _batch()
    mesh = make_mesh(axes=("dp",), devices=jax.devices("cpu")[:1])
    jstep = JTrainStep(jnet, _jax_loss, mesh, learning_rate=LR,
                       momentum=MOM)
    j_losses = [float(jstep(jnp.asarray(x), jnp.asarray(y)))
                for _ in range(STEPS)]
    tstep = TrainStep(_torch_net(kind, named), _torch_loss, device="cpu",
                      learning_rate=LR, momentum=MOM)
    t_losses = [float(tstep(x, y)) for _ in range(STEPS)]
    return dict(kind=kind, named=named, j_losses=j_losses,
                j_params={n: np.asarray(v) for n, v in jstep.params.items()},
                t_losses=t_losses, t_params=params_to_numpy(tstep.params))


def test_train_step_losses_match_reference(trained):
    np.testing.assert_allclose(trained["t_losses"], trained["j_losses"],
                               rtol=RTOL, atol=ATOL)
    assert trained["t_losses"][-1] < trained["t_losses"][0]


def test_train_step_params_match_reference(trained):
    j, t, p0 = trained["j_params"], trained["t_params"], trained["named"]
    assert sorted(t) == sorted(j) == sorted(p0)
    for name in j:
        np.testing.assert_allclose(t[name], j[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        dj, dt = j[name] - p0[name], t[name] - p0[name]
        np.testing.assert_allclose(dt, dj, rtol=0,
                                   atol=1e-3 * np.abs(dj).max() + 1e-7,
                                   err_msg=name)


def test_train_step_leaves_running_stats_unchanged(trained):
    """The reference's step never writes the running statistics (their
    gradient is zero in training mode), nor does the port's."""
    stats = [n for n in trained["named"] if n.endswith(STATS)]
    n_bn = sum(n.endswith("gamma") for n in trained["named"])
    assert n_bn >= 9 and len(stats) == 2 * n_bn
    for name in stats:
        np.testing.assert_array_equal(trained["t_params"][name],
                                      trained["named"][name])
        np.testing.assert_array_equal(trained["j_params"][name],
                                      trained["named"][name])


def test_train_step_moves_every_parameter_by_its_gradient(trained):
    """Whatever its grad_req: a V2 net's input BatchNorm
    (``scale=False, center=False``) keeps gamma (fixed to ones, no
    gradient) and moves beta on both sides."""
    j, t, p0 = trained["j_params"], trained["t_params"], trained["named"]
    for name in p0:
        moved = not np.array_equal(t[name], p0[name])
        assert moved == (not np.array_equal(j[name], p0[name])), name
    if trained["kind"].startswith("v2"):
        for side in (j, t):
            assert np.abs(side["features.0.beta"]
                          - p0["features.0.beta"]).max() > 1e-4
            assert np.array_equal(side["features.0.gamma"],
                                  p0["features.0.gamma"])


# ---------------------------------------------------------------------------
# the imperative path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["v1_bottleneck", "v2_bottleneck"])
def test_imperative_record_backward_matches_reference(kind):
    """``autograd.record()`` + ``backward()`` on NDArrays: the gradients
    the reference writes (none for a 'null' grad_req) and the running
    statistics the training forward writes (momentum 0.9, biased
    variance); a predict-mode call afterwards writes nothing."""
    jnet, named = _jax_net(kind, seed=2)
    tnet = _torch_net(kind, named)
    x, y = _batch(1)
    jloss_blk = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        jl = jloss_blk(jnet(jnd.array(x)), jnd.array(y)).mean()
    jl.backward()
    with tmx.cpu():
        with tag.record():
            tl = tloss.SoftmaxCrossEntropyLoss()(tnet(tnd.array(x)),
                                                 tnd.array(y)).mean()
        tl.backward()
    np.testing.assert_allclose(float(tl.asscalar()), float(jl.asscalar()),
                               rtol=RTOL, atol=ATOL)
    tparams = dict(tnet.named_parameters())
    n_grads = 0
    for name, p in jnet.collect_params().items():
        tp = tparams[name]
        np.testing.assert_allclose(tp.detach().numpy(), p.data().asnumpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        if p.grad_req == "null":
            assert tp.grad is None, name
            continue
        want = p.grad().asnumpy()
        np.testing.assert_allclose(tp.grad.numpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        n_grads += 1
    assert n_grads == sum(tp.requires_grad for tp in tparams.values())
    written = [n for n in named if n.endswith(STATS)
               and not np.array_equal(tparams[n].detach().numpy(), named[n])]
    assert len(written) == sum(n.endswith(STATS) for n in named)
    before = params_to_numpy(tnet)
    with tmx.cpu():
        tnet(tnd.array(x))
    after = params_to_numpy(tnet)
    assert all(np.array_equal(before[n], after[n]) for n in before)


# ---------------------------------------------------------------------------
# the full-width model and the zoo
# ---------------------------------------------------------------------------

def test_resnet50_v1_carries_the_reference_params_by_name():
    """Names, shapes and the count (299 tensors, 25,629,032 values, running
    statistics and the bottlenecks' biases included), a strict load, and
    the way back."""
    jnet = jvision.resnet50_v1()
    jnet.initialize(jmx.init.Zero())
    jnet(jnd.zeros((1, 3, HW, HW)))        # resolves the deferred shapes
    rng = np.random.RandomState(3)
    named = {n: rng.randn(*p.data().shape).astype(np.float32)
             for n, p in jnet.collect_params().items()}
    tnet = tvision.resnet50_v1()
    shapes = {n: tuple(p.shape) for n, p in tnet.named_parameters()}
    assert list(shapes) == list(named)
    assert shapes == {n: v.shape for n, v in named.items()}
    assert len(named) == 299
    assert sum(v.size for v in named.values()) == 25_629_032
    for name in ("features.0.weight", "features.1.running_mean",
                 "features.4.0.body.0.bias",
                 "features.4.0.downsample.0.weight", "output.weight"):
        assert name in shapes
    assert "features.4.0.body.3.bias" not in shapes    # the 3x3 has none
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    back = params_to_numpy(tnet)
    for n in named:
        np.testing.assert_array_equal(back[n], named[n])
    with pytest.raises(RuntimeError, match="features.0.weight"):
        params_from_mxnet_tpu(dict(list(named.items())[1:]),
                              net=tvision.resnet50_v1(), device="cpu")


def test_thumbnail_stem_matches_reference():
    jnet = jresnet.ResNetV1(jresnet.BasicBlockV1, [1, 1], [8, 8, 16],
                            classes=CLASSES, thumbnail=True)
    jnet.initialize(jmx.init.Xavier())
    x, _ = _batch(2)
    want = jnet(jnd.array(x)).asnumpy()
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = tresnet.ResNetV1(tresnet.BasicBlockV1, [1, 1], [8, 8, 16],
                            classes=CLASSES, thumbnail=True)
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tuple(tnet.features[0].weight.shape) == (8, 3, 3, 3)


def test_get_model_covers_the_resnet_names_only():
    # the registry has held every reference name since the rest of the
    # vision zoo came (tests/test_torch_vision_zoo.py); the resnet names
    # are checked here, in order
    names = ["resnet%d_v%d" % (n, v) for v in (1, 2)
             for n in (18, 34, 50, 101, 152)]
    assert sorted(tvision._models) == sorted(jvision._models)
    for name in names:
        jn = {n: p.shape for n, p in
              jvision.get_model(name).collect_params().items()}
        tn = dict(tvision.get_model(name.upper()).named_parameters())
        assert list(tn) == list(jn), name
    for name in ("resnet51_v1", "vgg17", "densenet122"):
        with pytest.raises(ValueError, match="not supported"):
            tvision.get_model(name)
    with pytest.raises(FileNotFoundError):
        tvision.resnet18_v1(pretrained=True)
    with pytest.raises(ValueError):
        tresnet.get_resnet(3, 18)


def test_resnet_entry_points_default_to_the_gpu():
    net = tvision.resnet18_v1(classes=4)
    assert all(p.is_meta for p in net.parameters())
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(MXNetError, match="cuda"):
        net.initialize()
    cpu_net = tvision.resnet18_v1(classes=4).initialize(device="cpu")
    with pytest.raises(MXNetError, match="cuda"):
        TrainStep(cpu_net, _torch_loss)
    stats = dict(cpu_net.named_parameters())
    assert float(stats["features.1.running_var"].min()) == 1.0
    assert float(stats["features.1.running_mean"].abs().max()) == 0.0
    assert not stats["features.1.running_mean"].requires_grad


# ---------------------------------------------------------------------------
# run as a script: the spread behind chip_smoke.py's fp32 ResNet-50 rule
# ---------------------------------------------------------------------------

def tf32_round(t):
    """float32 rounded to TF32 (10 mantissa bits, to nearest), as a tensor
    core reads an operand under TF32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Conv(torch.autograd.Function):
    """The port's fp32 convolution with every operand rounded to TF32, in
    the forward and both backward products."""

    @staticmethod
    def forward(ctx, data, weight, conf):
        ctx.save_for_backward(data, weight)
        ctx.conf = conf
        return torch.ops.aten.convolution(tf32_round(data),
                                          tf32_round(weight), None, *conf)

    @staticmethod
    def backward(ctx, grad):
        data, weight = ctx.saved_tensors
        gd, gw, _ = torch.ops.aten.convolution_backward(
            tf32_round(grad), tf32_round(data), tf32_round(weight), None,
            *ctx.conf, [True, True, False])
        return gd, gw, None


def fp32_spread(batch=2):
    """``chip_smoke.py``'s fp32 ResNet-50 check on the CPU: the gradients
    of one step (``TrainStep``'s first change is -lr x them) in fp32, and
    in fp32 with TF32-rounded convolutions, each against fp64, as the
    worst tensor's max-entry error over its max|ref| and its L2 error over
    its L2 norm (tensors under 1e-6 of the net's largest gradient left
    out), with the loss's relative error."""
    import chip_smoke
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.ops import nn as tops
    net = tvision.resnet50_v1(classes=chip_smoke.RESNET_CLASSES)
    net.initialize(initializer.Xavier(), seed=chip_smoke.SEED, device="cpu")
    p0 = {n: p.detach() for n, p in net.named_parameters()}
    x, y = chip_smoke.resnet_batch_host(batch)
    real = tops._Float32Conv

    def grads(dtype, conv=real):
        tops._Float32Conv = conv
        try:
            model = tvision.resnet50_v1(
                classes=chip_smoke.RESNET_CLASSES).load_dict(
                    p0, device="cpu").cast(dtype)
            fn, params = functionalize(model)
            return chip_smoke.functional_grads(
                fn, params, chip_smoke.resnet_loss,
                torch.from_numpy(x).to(dtype), torch.from_numpy(y))
        finally:
            tops._Float32Conv = real

    loss64, g64 = grads(torch.float64)
    top = max(float(g.abs().max()) for g in g64.values())
    out = {"batch": batch}
    for name, dtype, conv in (("fp32", torch.float32, real),
                              ("tf32_convs", torch.float32, _TF32Conv)):
        loss, g = grads(dtype, conv)
        entry, l2 = [], []
        for n, ref in g64.items():
            if float(ref.abs().max()) < 1e-6 * top:
                continue
            d = g[n].double() - ref
            entry.append((float(d.abs().max() / ref.abs().max()), n))
            l2.append((float(d.norm() / ref.norm()), n))
        out[name] = {"loss_rel": abs(loss - loss64) / loss64,
                     "worst_entry": max(entry), "worst_l2": max(l2),
                     "median_l2": sorted(l2)[len(l2) // 2][0]}
    return out


if __name__ == "__main__":
    import json
    torch.set_num_threads(4)
    print(json.dumps(fp32_spread()))
