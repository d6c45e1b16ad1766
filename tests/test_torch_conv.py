"""The port's Convolution, Deconvolution, Pooling, BatchNorm and Activation
ops and the gluon conv layers against the JAX reference, on the CPU.

Each op of ``mxnet_tpu_torch.ops.nn`` is held against the matching
function of ``mxnet_tpu.ops.nn`` (``_convolution``, ``_deconvolution``,
``_pooling``, ``_batch_norm``, ``_activation``), called directly on the
same numpy inputs made from a seed; gradients against ``jax.vjp`` of the
reference function under one random cotangent.  The layers of
``gluon/nn/conv_layers.py`` and ``BatchNorm`` are held against the
reference's layers with the parameters carried across by name.
Tolerance: rtol 1e-4, atol 1e-5 (the repo's fp32 bound).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd, autograd as jag
from mxnet_tpu.gluon import nn as jgnn
from mxnet_tpu.ops import nn as jops

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, autograd as tag
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops.registry import get_op

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Convolution and Deconvolution
# ---------------------------------------------------------------------------

# (spatial shape, kernel, stride, pad, dilate, channels in, filters, group,
#  bias)
CONV_CASES = {
    "1d": ((11,), (3,), (1,), (1,), (1,), 4, 6, 1, True),
    "1d_strided_dilated": ((13,), (3,), (2,), (2,), (2,), 4, 6, 2, False),
    "1d_depthwise": ((9,), (5,), (1,), (2,), (1,), 4, 4, 4, True),
    "2d": ((9, 8), (3, 3), (1, 1), (1, 1), (1, 1), 4, 6, 1, True),
    "2d_stride_pad": ((9, 8), (3, 2), (2, 1), (1, 0), (1, 1), 4, 6, 1,
                      False),
    "2d_dilated_group": ((10, 9), (3, 3), (1, 2), (2, 1), (2, 1), 4, 6, 2,
                         True),
    "2d_depthwise": ((8, 8), (3, 3), (2, 2), (1, 1), (1, 1), 6, 6, 6, False),
    "2d_1x1_strided": ((8, 8), (1, 1), (2, 2), (0, 0), (1, 1), 4, 8, 1,
                       True),
    "3d": ((5, 6, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1), 3, 4, 1,
           True),
    "3d_strided_group": ((6, 5, 7), (3, 2, 3), (2, 1, 2), (1, 0, 1),
                         (1, 1, 2), 4, 6, 2, False),
    "3d_depthwise": ((5, 5, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1),
                     4, 4, 4, True),
}


def _conv_inputs(case, seed=0):
    spatial, k, s, p, d, cin, nf, g, bias = CONV_CASES[case]
    rng = np.random.RandomState(seed)
    x = _rand(rng, 2, cin, *spatial)
    w = _rand(rng, nf, cin // g, *k)
    b = _rand(rng, nf) if bias else None
    kw = dict(kernel=k, stride=s, pad=p, dilate=d, num_filter=nf,
              num_group=g, no_bias=not bias)
    return x, w, b, kw


def _maybe(a, f):
    return None if a is None else f(a)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_reference(case):
    x, w, b, kw = _conv_inputs(case)
    want = jops._convolution(jnp.asarray(x), jnp.asarray(w),
                             _maybe(b, jnp.asarray), **kw)
    got = tops.convolution(torch.from_numpy(x), torch.from_numpy(w),
                           _maybe(b, torch.from_numpy), **kw)
    _close(got, want)


@pytest.mark.parametrize("case", ["1d", "2d_stride_pad", "2d_dilated_group",
                                  "2d_depthwise", "3d_strided_group"])
def test_convolution_gradients_match_reference(case):
    x, w, b, kw = _conv_inputs(case, seed=1)
    b = _rand(np.random.RandomState(2), kw["num_filter"])
    kw["no_bias"] = False
    out, vjp = jax.vjp(lambda *a: jops._convolution(*a, **kw),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ct = _rand(np.random.RandomState(3), *out.shape)
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = torch.autograd.grad(tops.convolution(*leaves, **kw), leaves,
                              torch.from_numpy(ct))
    for g, j in zip(got, want):
        _close(g, j)


# (spatial, kernel, stride, pad, adj, channels in, filters, group, bias)
DECONV_CASES = {
    "1d_adj": ((7,), (3,), (2,), (1,), (1,), 4, 6, 1, False),
    "2d": ((5, 6), (3, 3), (1, 1), (0, 0), (0, 0), 4, 6, 1, True),
    "2d_stride_adj": ((5, 6), (4, 3), (2, 2), (1, 1), (1, 0), 4, 6, 1,
                      True),
    "2d_group_adj": ((5, 5), (3, 3), (2, 3), (1, 1), (1, 2), 4, 6, 2,
                     False),
    "3d_adj": ((3, 4, 3), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 0, 1), 2, 3,
               1, True),
}


@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution_matches_reference(case):
    spatial, k, s, p, adj, cin, nf, g, bias = DECONV_CASES[case]
    rng = np.random.RandomState(4)
    x = _rand(rng, 2, cin, *spatial)
    w = _rand(rng, cin, nf // g, *k)
    b = _rand(rng, nf) if bias else None
    kw = dict(kernel=k, stride=s, pad=p, adj=adj, num_filter=nf,
              num_group=g, no_bias=not bias)
    want = jops._deconvolution(jnp.asarray(x), jnp.asarray(w),
                               _maybe(b, jnp.asarray), **kw)
    got = tops.deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                             _maybe(b, torch.from_numpy), **kw)
    _close(got, want)


class _FlagSpy(TorchDispatchMode):
    """Records cuDNN's TF32 flag at each convolution the dispatcher
    runs, forward and backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.seen.append((func.overloadpacket.__name__,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("op", ["convolution", "deconvolution"])
def test_float32_conv_runs_without_tf32_forward_and_backward(op):
    """With the global flag on, an fp32 convolution and its backward each
    run inside a scope with cuDNN's TF32 off, and the flag comes back; a
    bf16 convolution is left to the global flag."""
    x = torch.randn(2, 4, 6, 6, requires_grad=True)
    w = torch.randn(4, 4, 3, 3, requires_grad=True)
    fn = getattr(tops, op)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with _FlagSpy() as spy:
            out = fn(x, w, kernel=(3, 3), pad=(1, 1))
            torch.autograd.grad(out.sum(), [x, w])
        assert torch.backends.cudnn.allow_tf32 is True
        names = [n for n, _ in spy.seen]
        assert names == ["convolution", "convolution_backward"], spy.seen
        assert not any(flag for _, flag in spy.seen), spy.seen
        with _FlagSpy() as spy:
            fn(x.detach().bfloat16(), w.detach().bfloat16(), kernel=(3, 3),
               pad=(1, 1))
        assert spy.seen == [("convolution", True)]
    finally:
        torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

# (input shape, kernel, stride, pad)
POOL_SHAPES = {
    "1d": ((2, 3, 11), (3,), (2,), (1,)),
    "2d": ((2, 3, 9, 10), (3, 2), (2, 2), (1, 1)),
    "2d_resnet_stem": ((2, 3, 12, 12), (3, 3), (2, 2), (1, 1)),
    "2d_overhang": ((2, 2, 7, 8), (2, 3), (3, 2), (1, 1)),
    "3d": ((1, 2, 5, 7, 6), (2, 3, 2), (2, 2, 1), (0, 1, 1)),
}
POOL_TYPES = [("max", True), ("avg", True), ("avg", False), ("sum", True),
              ("lp", True)]


@pytest.mark.parametrize("convention", ["valid", "full"])
@pytest.mark.parametrize("pool_type,cip", POOL_TYPES)
@pytest.mark.parametrize("shape", sorted(POOL_SHAPES))
def test_pooling_matches_reference(shape, pool_type, cip, convention):
    dims, k, s, p = POOL_SHAPES[shape]
    x = _rand(np.random.RandomState(5), *dims)
    kw = dict(kernel=k, stride=s, pad=p, pool_type=pool_type,
              pooling_convention=convention, count_include_pad=cip)
    want = jops._pooling(jnp.asarray(x), **kw)
    got = tops.pooling(torch.from_numpy(x), **kw)
    _close(got, want)


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_global_pooling_matches_reference(pool_type):
    x = _rand(np.random.RandomState(6), 2, 3, 5, 4)
    kw = dict(kernel=(1, 1), pool_type=pool_type, global_pool=True)
    want = jops._pooling(jnp.asarray(x), **kw)
    got = tops.pooling(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == (2, 3, 1, 1)
    _close(got, want)


@pytest.mark.parametrize("pool_type,cip,expect", [
    ("max", True, [0.0, 2.0, 4.0, -np.inf]),
    ("avg", True, [0.0, 1.5, 3.5, 0.0]),
    ("avg", False, [0.0, 1.5, 3.5, np.nan]),
])
def test_full_convention_keeps_a_window_wholly_in_padding(pool_type, cip,
                                                          expect):
    """x = [0..4], kernel 2, stride 2, pad 1: the ``full`` convention pads
    the right by max(needed - pad, pad) = 2, so the last window is all
    padding; torch's own ceil_mode would drop it."""
    x = np.arange(5, dtype=np.float32).reshape(1, 1, 5)
    kw = dict(kernel=(2,), stride=(2,), pad=(1,), pool_type=pool_type,
              pooling_convention="full", count_include_pad=cip)
    got = tops.pooling(torch.from_numpy(x), **kw).numpy().ravel()
    want = np.asarray(jops._pooling(jnp.asarray(x), **kw)).ravel()
    np.testing.assert_array_equal(got, np.array(expect, np.float32))
    np.testing.assert_array_equal(got, want)
    if pool_type == "max":
        assert torch.nn.functional.max_pool1d(
            torch.from_numpy(x), 2, 2, 1, ceil_mode=True).shape[-1] == 3


@pytest.mark.parametrize("pool_type,convention", [
    ("max", "valid"), ("max", "full"), ("avg", "full"), ("lp", "valid")])
def test_pooling_gradients_match_reference(pool_type, convention):
    x = _rand(np.random.RandomState(7), 2, 3, 9, 10)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=pool_type,
              pooling_convention=convention, count_include_pad=False)
    out, vjp = jax.vjp(lambda a: jops._pooling(a, **kw), jnp.asarray(x))
    ct = _rand(np.random.RandomState(8), *out.shape)
    want, = vjp(jnp.asarray(ct))
    leaf = torch.from_numpy(x).requires_grad_()
    got, = torch.autograd.grad(tops.pooling(leaf, **kw), [leaf],
                               torch.from_numpy(ct))
    _close(got, want)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------

def _bn_inputs(seed=9, shape=(4, 3, 5, 6), axis=1):
    rng = np.random.RandomState(seed)
    c = shape[axis]
    x = 2.0 + 3.0 * _rand(rng, *shape)
    return (x, 1.0 + 0.2 * _rand(rng, c), 0.5 * _rand(rng, c),
            0.3 * _rand(rng, c), 1.0 + 0.5 * np.abs(_rand(rng, c)))


@pytest.mark.parametrize("axis,shape", [(1, (4, 3, 5, 6)), (1, (6, 4)),
                                        (-1, (3, 5, 4))])
@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batch_norm_matches_reference(use_global_stats, fix_gamma, axis,
                                      shape):
    args = _bn_inputs(shape=shape, axis=axis)
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
              use_global_stats=use_global_stats, axis=axis)
    want = jops._batch_norm(*map(jnp.asarray, args), **kw)
    got = tops.batch_norm(*map(torch.from_numpy, args), **kw)
    for g, j in zip(got, want):        # out, new moving mean, new var
        _close(g, j)
    if use_global_stats:
        np.testing.assert_array_equal(got[1].numpy(), args[3])


def test_batch_norm_not_training_uses_the_moving_stats():
    args = _bn_inputs()
    want = jops._batch_norm(*map(jnp.asarray, args), fix_gamma=False,
                            training=False)
    got = tops.batch_norm(*map(torch.from_numpy, args), fix_gamma=False,
                          training=False)
    for g, j in zip(got, want):
        _close(g, j)


def test_batch_norm_moving_stats_use_the_biased_variance():
    x, g, b, mm, mv = _bn_inputs()
    _, mean, var = tops.batch_norm(*map(torch.from_numpy, (x, g, b, mm, mv)),
                                   momentum=0.9)
    red = (0, 2, 3)
    np.testing.assert_allclose(mean.numpy(), 0.9 * mm + 0.1 * x.mean(red),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(var.numpy(), 0.9 * mv + 0.1 * x.var(red),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_global_stats", [False, True])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batch_norm_gradients_match_reference(fix_gamma, use_global_stats):
    """Gradients of the output with respect to data, gamma, beta and the
    moving statistics (zero in training mode, where the output does not
    read them)."""
    args = _bn_inputs(seed=10)
    kw = dict(fix_gamma=fix_gamma, use_global_stats=use_global_stats)
    out, vjp = jax.vjp(lambda *a: jops._batch_norm(*a, **kw)[0],
                       *map(jnp.asarray, args))
    ct = _rand(np.random.RandomState(11), *out.shape)
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(tops.batch_norm(*leaves, **kw)[0], leaves,
                              torch.from_numpy(ct), allow_unused=True)
    for g, j, leaf in zip(got, want, leaves):
        _close(torch.zeros_like(leaf) if g is None else g, j)


def test_nd_batch_norm_writes_the_moving_stats_as_the_reference():
    """``nd.BatchNorm`` (training on by default, inside ``record()`` or
    not) returns only the output and writes the new moving statistics
    into its moving-stat arrays, as the reference's aux write-back does;
    with ``use_global_stats`` they stay as they were."""
    args = _bn_inputs(seed=12)
    with tmx.cpu():
        for kw in (dict(fix_gamma=False), dict(use_global_stats=True)):
            j_in = [jnd.array(a) for a in args]
            t_in = [tnd.array(a) for a in args]
            j_out = jnd.BatchNorm(*j_in, **kw)
            t_out = tnd.BatchNorm(*t_in, **kw)
            assert isinstance(t_out, tnd.NDArray)
            _close(t_out.asnumpy(), j_out.asnumpy())
            for i in (3, 4):
                _close(t_in[i].asnumpy(), j_in[i].asnumpy())
            if kw.get("use_global_stats"):
                np.testing.assert_array_equal(t_in[3].asnumpy(), args[3])
            else:
                assert not np.allclose(t_in[3].asnumpy(), args[3])
        # under record(), the output carries a gradient, the stats do not
        t_in = [tnd.array(a) for a in args]
        t_in[0].attach_grad()
        with tag.record():
            y = tnd.BatchNorm(*t_in, fix_gamma=False)
        y.backward()
        assert np.abs(t_in[0].grad.asnumpy()).max() > 0
        assert not np.allclose(t_in[4].asnumpy(), args[4])


def test_registered_names_and_aliases():
    for name, alias in [("Convolution", "convolution"),
                        ("Deconvolution", "deconvolution"),
                        ("Pooling", "pooling"), ("BatchNorm", "batch_norm"),
                        ("Activation", "activation")]:
        assert get_op(name) is get_op(alias)
        assert callable(getattr(tnd, name))
    assert get_op("BatchNorm").aux_writeback == {1: 3, 2: 4}
    assert get_op("BatchNorm").num_outputs == 3


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "log_sigmoid", "mish"])
def test_activation_matches_reference(act):
    x = 4.0 * _rand(np.random.RandomState(13), 5, 7)
    out, vjp = jax.vjp(lambda a: jops._activation(a, act_type=act),
                       jnp.asarray(x))
    ct = _rand(np.random.RandomState(14), 5, 7)
    leaf = torch.from_numpy(x).requires_grad_()
    got = tops.activation(leaf, act_type=act)
    _close(got, out)
    g, = torch.autograd.grad(got, [leaf], torch.from_numpy(ct))
    _close(g, vjp(jnp.asarray(ct))[0])
    with tmx.cpu():
        _close(tnd.Activation(tnd.array(x), act_type=act).asnumpy(), out)


# ---------------------------------------------------------------------------
# gluon layers
# ---------------------------------------------------------------------------

def _carry(jblock, tblock, x, seed=15):
    """Resolve the reference block's shapes on ``x``, draw its parameters
    from numpy and load them into the port's block by name."""
    jblock.initialize()
    jblock(jnd.array(x))
    rng = np.random.RandomState(seed)
    named = {}
    for name, p in jblock.collect_params().items():
        val = 0.3 * _rand(rng, *p.data().shape)
        if name.endswith(("gamma", "running_var")):
            val = 1.0 + np.abs(val)
        p.set_data(jnd.array(val))
        named[name] = val
    params_from_mxnet_tpu(named, net=tblock, device="cpu")
    return named


LAYERS = {
    "Conv1D": (lambda: jgnn.Conv1D(5, 3, strides=2, padding=1),
               lambda: tgnn.Conv1D(5, 3, strides=2, padding=1,
                                   in_channels=4), (2, 4, 9)),
    "Conv2D_group_act": (
        lambda: jgnn.Conv2D(6, (3, 2), padding=(1, 0), groups=2,
                            activation="relu"),
        lambda: tgnn.Conv2D(6, (3, 2), padding=(1, 0), groups=2,
                            activation="relu", in_channels=4),
        (2, 4, 7, 6)),
    "Conv2D_no_bias": (
        lambda: jgnn.Conv2D(3, 3, strides=2, dilation=2, use_bias=False),
        lambda: tgnn.Conv2D(3, 3, strides=2, dilation=2, use_bias=False,
                            in_channels=4), (2, 4, 9, 9)),
    "Conv3D": (lambda: jgnn.Conv3D(3, 2, padding=1),
               lambda: tgnn.Conv3D(3, 2, padding=1, in_channels=2),
               (1, 2, 4, 5, 4)),
    "Conv1DTranspose": (
        lambda: jgnn.Conv1DTranspose(3, 3, strides=2, output_padding=1),
        lambda: tgnn.Conv1DTranspose(3, 3, strides=2, output_padding=1,
                                     in_channels=4), (2, 4, 6)),
    "Conv2DTranspose": (
        lambda: jgnn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                     output_padding=1, groups=2),
        lambda: tgnn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                     output_padding=1, groups=2,
                                     in_channels=4), (2, 4, 5, 5)),
    "Conv3DTranspose": (
        lambda: jgnn.Conv3DTranspose(2, 2, strides=2),
        lambda: tgnn.Conv3DTranspose(2, 2, strides=2, in_channels=3),
        (1, 3, 3, 3, 3)),
    "MaxPool1D": (lambda: jgnn.MaxPool1D(3, 2, 1, ceil_mode=True),
                  lambda: tgnn.MaxPool1D(3, 2, 1, ceil_mode=True),
                  (2, 3, 10)),
    "MaxPool2D": (lambda: jgnn.MaxPool2D(3, 2, 1),
                  lambda: tgnn.MaxPool2D(3, 2, 1), (2, 3, 9, 8)),
    "MaxPool3D": (lambda: jgnn.MaxPool3D(2), lambda: tgnn.MaxPool3D(2),
                  (1, 2, 4, 5, 4)),
    "AvgPool1D": (lambda: jgnn.AvgPool1D(2, padding=1,
                                         count_include_pad=False),
                  lambda: tgnn.AvgPool1D(2, padding=1,
                                         count_include_pad=False),
                  (2, 3, 7)),
    "AvgPool2D_ceil": (lambda: jgnn.AvgPool2D(3, 2, 1, ceil_mode=True),
                       lambda: tgnn.AvgPool2D(3, 2, 1, ceil_mode=True),
                       (2, 3, 8, 8)),
    "AvgPool3D": (lambda: jgnn.AvgPool3D(2, 1),
                  lambda: tgnn.AvgPool3D(2, 1), (1, 2, 3, 4, 3)),
    "GlobalMaxPool1D": (jgnn.GlobalMaxPool1D, tgnn.GlobalMaxPool1D,
                        (2, 3, 7)),
    "GlobalMaxPool2D": (jgnn.GlobalMaxPool2D, tgnn.GlobalMaxPool2D,
                        (2, 3, 5, 4)),
    "GlobalMaxPool3D": (jgnn.GlobalMaxPool3D, tgnn.GlobalMaxPool3D,
                        (1, 2, 3, 4, 3)),
    "GlobalAvgPool1D": (jgnn.GlobalAvgPool1D, tgnn.GlobalAvgPool1D,
                        (2, 3, 7)),
    "GlobalAvgPool2D": (jgnn.GlobalAvgPool2D, tgnn.GlobalAvgPool2D,
                        (2, 3, 5, 4)),
    "GlobalAvgPool3D": (jgnn.GlobalAvgPool3D, tgnn.GlobalAvgPool3D,
                        (1, 2, 3, 4, 3)),
    "ReflectionPad2D": (lambda: jgnn.ReflectionPad2D(2),
                        lambda: tgnn.ReflectionPad2D(2), (2, 3, 5, 4)),
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_reference(layer):
    make_j, make_t, shape = LAYERS[layer]
    x = _rand(np.random.RandomState(16), *shape)
    jblock, tblock = make_j(), make_t()
    named = _carry(jblock, tblock, x)
    assert sorted(named) == sorted(n for n, _ in tblock.named_parameters())
    _close(tblock(torch.from_numpy(x)), jblock(jnd.array(x)).asnumpy())


def test_conv_layers_need_in_channels_and_a_channel_first_layout():
    # without in_channels the size is left to the first forward (deferred
    # init), as in the reference
    w = tgnn.Conv2D(4, 3).weight
    assert w.shape == (4, 0, 3, 3) and w._tensor().is_meta
    assert tgnn.BatchNorm().running_var.shape == (0,)
    with pytest.raises(ValueError, match="layout"):
        tgnn.Conv2D(4, 3, layout="NHWC", in_channels=3)
    w = tgnn.Conv2DTranspose(6, 3, groups=2, in_channels=4).weight
    assert w.shape == (4, 3, 3, 3) and w._tensor().is_meta


def _bn_pair(**kw):
    x = 1.0 + 2.0 * _rand(np.random.RandomState(17), 4, 3, 5, 5)
    jbn, tbn = jgnn.BatchNorm(**kw), tgnn.BatchNorm(in_channels=3, **kw)
    named = _carry(jbn, tbn, x)
    return x, jbn, tbn, named


@pytest.mark.parametrize("kw", [dict(), dict(scale=False, center=False),
                                dict(use_global_stats=True),
                                dict(momentum=0.7, epsilon=1e-3)])
def test_batchnorm_layer_matches_reference(kw):
    """Predict mode, then a recorded training forward and backward on
    NDArrays: the output, the gradients the reference writes (none for a
    'null' grad_req) and the running statistics it writes."""
    x, jbn, tbn, named = _bn_pair(**kw)
    _close(tbn(torch.from_numpy(x)), jbn(jnd.array(x)).asnumpy())
    # a random head: with ones, gamma's gradient sum(x_hat) is 0 + noise
    head = _rand(np.random.RandomState(18), *x.shape)
    with jag.record():
        jy = jbn(jnd.array(x))
        jloss = (jy * jnd.array(head)).sum()
    jloss.backward()
    with tmx.cpu():
        with tag.record():
            ty = tbn(tnd.array(x))
            tloss = (ty * tnd.array(head)).sum()
        tloss.backward()
    _close(ty.asnumpy(), jy.asnumpy())
    tparams = dict(tbn.named_parameters())
    for name, p in jbn.collect_params().items():
        _close(tparams[name], p.data().asnumpy())
        if p.grad_req == "null":
            assert tparams[name].grad is None, name
        else:
            _close(tparams[name].grad, p.grad().asnumpy())
    moved = not np.array_equal(tparams["running_mean"].detach().numpy(),
                               named["running_mean"])
    assert moved == (not kw.get("use_global_stats", False))


def test_batchnorm_layer_writes_only_on_ndarrays_in_training_mode():
    x, _, tbn, named = _bn_pair()
    stats = ("running_mean", "running_var")

    def unchanged():
        return all(np.array_equal(getattr(tbn, n).data().asnumpy(),
                                  named[n]) for n in stats)

    tbn.train()(torch.from_numpy(x))            # tensors: torch's call
    with tmx.cpu():
        tbn(tnd.array(x))                       # NDArrays, predict mode
        assert unchanged()
        with tag.record(train_mode=False):
            tbn(tnd.array(x))
        assert unchanged()
        with tag.train_mode():
            tbn(tnd.array(x))                   # training, not recording
    assert not unchanged()
    assert tbn.training and not tbn._write_aux
