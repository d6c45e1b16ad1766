"""The port's ``ops/image.py`` and the transforms that run it, against the
JAX reference on the CPU.

Every ``_image_*`` op and the OpenCV-plugin ops run through ``nd`` in both
packages on the same seeded HWC / NHWC inputs at 1e-4.  The random ops
draw their factor from a JAX key in the reference and from the port's
``mx.random`` generator here, so they are held at a fixed factor
(``min_factor == max_factor``, ``p`` of 0 or 1, ``alpha_std`` 0), and
their draws by their moments (the mean within 5 standard errors of 2000
draws, the variance within 15 %).  ``RandomHue``, ``Rotate`` and
``RandomRotation``: the rotation angle is Python's ``random`` draw in both
packages, bit for bit under one seed, and the images agree at 1e-4.
"""
import io
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.data.vision import transforms as jtf
from mxnet_tpu.ops import image as jimage

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf
from mxnet_tpu_torch.ops import image as timage

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
N_DRAWS = 2000


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def img(shape=(6, 7, 3), seed=0, dtype=np.float32):
    x = np.random.RandomState(seed).uniform(0, 255, shape)
    return x.astype(dtype)


def both(op, data, **kw):
    j = getattr(jnd, op)(jnd.array(data, dtype=data.dtype), **kw).asnumpy()
    t = getattr(tnd, op)(tnd.array(data, dtype=data.dtype), **kw).asnumpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape,
                                                       j.dtype, t.dtype)
    return j, t


def close(j, t, tol=TOL):
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * max(
        1.0, float(np.abs(j).max())))


@pytest.mark.parametrize("shape", [(6, 7, 3), (2, 6, 7, 3)])
@pytest.mark.parametrize("op,kw", [
    ("_image_to_tensor", {}),
    ("_image_crop", {"x": 1, "y": 2, "width": 4, "height": 3}),
    ("_image_flip_left_right", {}),
    ("_image_flip_top_bottom", {}),
    ("_image_adjust_lighting", {"alpha": (0.1, -0.2, 0.05)}),
    ("_image_random_brightness", {"min_factor": 0.7, "max_factor": 0.7}),
    ("_image_random_contrast", {"min_factor": 1.3, "max_factor": 1.3}),
    ("_image_random_saturation", {"min_factor": 0.4, "max_factor": 0.4}),
    ("_image_random_hue", {"min_factor": 0.3, "max_factor": 0.3}),
    ("_image_random_hue", {"min_factor": -0.45, "max_factor": -0.45}),
    ("_image_random_lighting", {"alpha_std": 0.0}),
    ("_image_random_flip_left_right", {"p": 1.0}),
    ("_image_random_flip_left_right", {"p": 0.0}),
    ("_image_random_flip_top_bottom", {"p": 1.0}),
])
def test_image_op_at_a_fixed_factor(op, kw, shape):
    dtype = np.uint8 if op == "_image_to_tensor" else np.float32
    close(*both(op, img(shape, dtype=dtype), **kw))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_uint8_ops_keep_the_dtype(dtype):
    x = img((5, 4, 3), dtype=dtype)
    for op, kw in [("_image_flip_left_right", {}),
                   ("_image_random_brightness", {"min_factor": 1.0,
                                                 "max_factor": 1.0})]:
        j, t = both(op, x, **kw)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("batch", [False, True])
def test_normalize(batch):
    x = img((2, 3, 5, 4) if batch else (3, 5, 4)) / 255.0
    close(*both("_image_normalize", x, mean=(0.4, 0.5, 0.6),
                std=(0.2, 0.3, 0.25)))


@pytest.mark.parametrize("size,interp", [((4, 3), 1), ((13, 9), 1),
                                         ((5, 11), 1), ((4, 3), 0),
                                         ((13, 9), 0), (5, 1)])
@pytest.mark.parametrize("shape", [(6, 7, 3), (2, 6, 7, 3)])
def test_resize_is_jax_image_resize(size, interp, shape):
    close(*both("_image_resize", img(shape), size=size, interp=interp))


def test_cvimresize():
    close(*both("_cvimresize", img((8, 10, 3)), w=5, h=12, interp=1))


@pytest.mark.parametrize("border", [0, 1, 2, 3, 4])
def test_cv_copy_make_border(border):
    x = img((5, 6, 3), dtype=np.uint8)
    j, t = both("_cvcopyMakeBorder", x, top=2, bot=1, left=3, right=2,
                type=border, value=7.0)
    np.testing.assert_array_equal(t, j)


def test_cv_copy_make_border_per_channel_values():
    x = img((4, 4, 3))
    j, t = both("_cvcopyMakeBorder", x, top=1, bot=2, left=0, right=1,
                type=0, values=(1.0, 2.0, 3.0))
    np.testing.assert_array_equal(t, j)


def test_cvimdecode_of_a_png():
    from PIL import Image
    x = img((5, 6, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(x).save(buf, format="PNG")
    raw = np.frombuffer(buf.getvalue(), np.uint8)
    for to_rgb in (True, False):
        j = jnd._cvimdecode(jnd.array(raw, dtype="uint8"),
                            to_rgb=to_rgb).asnumpy()
        t = tnd._cvimdecode(tnd.array(raw, dtype="uint8"),
                            to_rgb=to_rgb).asnumpy()
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[:, :, ::-1], x)


def test_the_color_jitter_parts_at_fixed_factors():
    """``_image_random_color_jitter`` is brightness, contrast, saturation
    and hue in that order, each a draw; at fixed factors its parts are the
    reference's."""
    x = img((6, 7, 3))
    j = jimage._hue(jimage._saturation(jimage._contrast(
        jimage._brightness(jnd.array(x)._jax, 1.2), 0.8), 1.4), -0.1)
    tx = torch.from_numpy(x)
    t = timage._hue(timage._saturation(timage._contrast(
        timage._brightness(tx, torch.tensor(1.2)), torch.tensor(0.8)),
        torch.tensor(1.4)), torch.tensor(-0.1))
    close(np.asarray(j), t.numpy())


# ---------------------------------------------------------------------------
# the draws, by their moments
# ---------------------------------------------------------------------------

def _moments(draws, mean, var):
    d = np.asarray(draws, np.float64)
    assert abs(d.mean() - mean) < 5 * np.sqrt(var / len(d)) + 1e-6, \
        (d.mean(), mean)
    assert abs(d.var() - var) < 0.15 * var, (d.var(), var)


def test_brightness_draws_are_uniform_over_the_range():
    tmx.random.seed(3)
    ones = tnd.ones((1, 1, 3))
    w = [float(tnd._image_random_brightness(ones, min_factor=0.5,
                                            max_factor=1.5).asnumpy()[0, 0,
                                                                      0])
         for _ in range(N_DRAWS)]
    _moments(w, 1.0, 1.0 / 12)
    assert 0.5 <= min(w) and max(w) < 1.5


def test_color_jitter_brightness_draws_clamp_at_zero():
    tmx.random.seed(4)
    ones = tnd.ones((1, 1, 3))
    w = [float(tnd._image_random_color_jitter(ones, brightness=1.5)
               .asnumpy()[0, 0, 0]) for _ in range(N_DRAWS)]
    _moments(w, 1.25, 2.5 ** 2 / 12)          # U[max(0, 1 - 1.5), 2.5]
    assert min(w) >= 0.0


def test_flip_draws_are_bernoulli():
    tmx.random.seed(5)
    x = tnd.array(np.arange(6, dtype=np.float32).reshape(1, 2, 3))
    flips = [float(tnd._image_random_flip_left_right(x, p=0.3)
                   .asnumpy()[0, 0, 0] != 0) for _ in range(N_DRAWS)]
    _moments(flips, 0.3, 0.21)


def test_lighting_draws_are_normal():
    tmx.random.seed(6)
    x = tnd.zeros((1, 1, 3))
    eig = (np.array(timage._EIGVEC, np.float32)
           * np.array(timage._EIGVAL, np.float32))
    alphas = [np.linalg.solve(eig, tnd._image_random_lighting(
        x, alpha_std=0.1).asnumpy()[0, 0]) for _ in range(N_DRAWS)]
    for c in range(3):
        _moments([a[c] for a in alphas], 0.0, 0.01)


def test_hue_draws_repeat_under_a_seed_and_stay_in_the_range():
    x = tnd.array(img((4, 4, 3)))

    def draws(seed):
        tmx.random.seed(seed)
        return [tnd._image_random_hue(x, min_factor=-0.2,
                                      max_factor=0.2).asnumpy()
                for _ in range(3)]
    a, b, c = draws(7), draws(7), draws(8)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    lo = timage._hue(x.data, torch.tensor(-0.2)).numpy()
    assert not np.allclose(a[0], lo)


# ---------------------------------------------------------------------------
# the three transforms
# ---------------------------------------------------------------------------

def test_random_hue_transform_at_a_fixed_factor():
    x = img((5, 6, 3))
    close(jtf.RandomHue(0.0)(jnd.array(x)).asnumpy(),
          ttf.RandomHue(0.0)(tnd.array(x)).asnumpy())
    tmx.random.seed(1)
    out = ttf.RandomHue(0.25)(x).asnumpy()
    assert out.shape == x.shape and np.isfinite(out).all()


@pytest.mark.parametrize("deg", [0.0, 30.0, -75.5, 90.0, 180.0])
@pytest.mark.parametrize("shape", [(9, 9, 3), (6, 11, 2)])
def test_rotate(deg, shape):
    x = img(shape)
    close(jtf.Rotate(deg)(jnd.array(x)).asnumpy(),
          ttf.Rotate(deg)(tnd.array(x)).asnumpy())


def test_rotate_by_90_is_rot90():
    x = img((7, 7, 3))
    np.testing.assert_allclose(ttf.Rotate(90.0)(x).asnumpy(),
                               np.rot90(x), rtol=TOL, atol=TOL * 255)


def test_random_rotation_draws_pythons_random_bit_for_bit():
    x = img((8, 10, 3))
    outs, states = {}, {}
    for name, tf, nd in (("jax", jtf, jnd), ("port", ttf, tnd)):
        random.seed(11)
        t = tf.RandomRotation((-40.0, 40.0), rotate_with_proba=0.7)
        outs[name] = [t(nd.array(x)).asnumpy() for _ in range(6)]
        states[name] = random.getstate()
    assert states["port"] == states["jax"]
    for j, t in zip(outs["jax"], outs["port"]):
        close(j, t)
    assert any(np.array_equal(o, x) for o in outs["port"])   # proba < 1
    assert not all(np.array_equal(o, x) for o in outs["port"])


def test_rotate_zoom_raises_as_in_the_reference():
    for tf in (jtf, ttf):
        with pytest.raises(NotImplementedError):
            tf.Rotate(10, zoom_in=True)
