"""The port's ``ops/spatial.py`` against the JAX reference on the CPU.

Each op (``GridGenerator``, ``BilinearSampler``, ``SpatialTransformer``,
``ROIPooling``, ``ROIAlign``, ``RROIAlign``, ``Correlation``, ``im2col``)
runs through ``nd`` in both packages on the same seeded inputs; values and
the gradients of ``sum(out * cotangent)`` with respect to every floating
input the reference differentiates, at 1e-4 in fp32.  Sample points are
kept off integer coordinates, where a bilinear read's gradient has a kink.
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as jautograd, nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd, nd as tnd

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
PKGS = {"jax": (jnd, jautograd), "port": (tnd, tautograd)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def run(op, inputs, grad_of, **kw):
    res = {}
    for name, (nd, autograd) in PKGS.items():
        arrs = [nd.array(a) for a in inputs]
        for i in grad_of:
            arrs[i].attach_grad()
        with autograd.record():
            out = getattr(nd, op)(*arrs, **kw)
            cot = nd.array(rnd(*out.shape, seed=17))
            head = (out * cot).sum()
        head.backward()
        res[name] = (out.asnumpy(), [arrs[i].grad.asnumpy()
                                     for i in grad_of])
    (jv, jg), (tv, tg) = res["jax"], res["port"]
    assert jv.shape == tv.shape, (jv.shape, tv.shape)
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    return tv


def test_grid_generator_affine():
    theta = np.array([[0.9, 0.2, 0.1, -0.15, 1.1, -0.05],
                      [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], np.float32)
    run("GridGenerator", [theta], (0,), transform_type="affine",
        target_shape=(5, 7))


def test_grid_generator_warp():
    run("GridGenerator", [rnd(2, 2, 4, 6)], (0,), transform_type="warp")


@pytest.mark.parametrize("out_hw", [(5, 6), (9, 4)])
def test_bilinear_sampler_with_gradients_of_data_and_grid(out_hw):
    data = rnd(2, 3, 6, 8)
    # spans past [-1, 1], so some corners read the zero padding
    grid = np.random.RandomState(3).uniform(
        -1.3, 1.3, (2, 2) + out_hw).astype(np.float32)
    run("BilinearSampler", [data, grid], (0, 1))


def test_spatial_transformer():
    data = rnd(2, 3, 7, 9)
    loc = np.array([[0.8, 0.3, 0.05, -0.2, 0.9, 0.1],
                    [1.1, -0.1, -0.07, 0.15, 0.95, 0.03]], np.float32)
    run("SpatialTransformer", [data, loc], (0, 1), target_shape=(6, 5),
        transform_type="affine", sampler_type="bilinear")


ROIS = np.array([[0, 1.3, 2.2, 9.7, 8.1],
                 [1, 0.0, 0.0, 11.0, 9.0],
                 [0, 5.6, 1.1, 7.2, 3.9],
                 [1, -2.2, 3.3, 4.4, 12.5]], np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pooling(scale):
    data = rnd(2, 3, 10, 12)
    run("ROIPooling", [data, ROIS], (0,), pooled_size=(3, 4),
        spatial_scale=scale)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("name", ["ROIAlign", "_contrib_ROIAlign",
                                  "roi_align"])
def test_roi_align(name, aligned):
    data = rnd(2, 3, 10, 12)
    run(name, [data, ROIS + 0.013], (0, 1), pooled_size=(2, 3),
        spatial_scale=0.8, sample_ratio=2, aligned=aligned)


def test_rroi_align():
    data = rnd(2, 3, 10, 12)
    rois = np.array([[0, 5.1, 4.3, 6.2, 3.7, 30.0],
                     [1, 6.6, 5.2, 4.1, 5.9, -115.0],
                     [0, 2.2, 7.9, 9.3, 2.4, 0.0]], np.float32)
    run("RROIAlign", [data, rois], (0, 1), pooled_size=(3, 2),
        spatial_scale=1.0, sampling_ratio=2)


@pytest.mark.parametrize("multiply", [True, False])
@pytest.mark.parametrize("d,stride2", [(1, 1), (2, 2)])
def test_correlation(d, stride2, multiply):
    a, b = rnd(2, 3, 5, 6), rnd(2, 3, 5, 6, seed=1)
    out = run("Correlation", [a, b], (0, 1), max_displacement=d,
              stride2=stride2, is_multiply=multiply)
    assert out.shape[1] == len(range(-d, d + 1, stride2)) ** 2


@pytest.mark.parametrize("kw", [
    {"kernel": (3, 3), "stride": (1, 1), "dilate": (1, 1), "pad": (1, 1)},
    {"kernel": (2, 3), "stride": (2, 1), "dilate": (1, 2), "pad": (0, 2)}])
def test_im2col(kw):
    run("im2col", [rnd(2, 3, 6, 7)], (0,), **kw)
