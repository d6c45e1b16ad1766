"""Vision transforms.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py`` (reference:
python/mxnet/gluon/data/vision/transforms.py: Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, CropResize, RandomResizedCrop, the random
flips, RandomBrightness, RandomContrast, RandomSaturation,
RandomLighting, RandomColorJitter, RandomGray).  Transforms run on the
host, on HWC uint8 or float samples (numpy, tensors or NDArrays), inside
the DataLoader's workers; each returns an NDArray on the current context.
Random choices draw from Python's ``random`` (``RandomLighting`` from
numpy's global generator) in the reference's order, so the same seeds
give its output bit for bit.  ``RandomHue``, ``Rotate`` and
``RandomRotation`` run the registered ops ``_image_random_hue``,
``GridGenerator`` and ``BilinearSampler`` (``ops/image.py``,
``ops/spatial.py``) as the reference does; the hue factor comes from the
port's ``mx.random`` generator (the reference's from a JAX key), the
rotation angle from Python's ``random``, as in the reference.
"""
from __future__ import annotations

import math
import random as _pyrandom
from typing import List, Optional, Sequence, Tuple

import numpy as _np
import torch

from .... import ndarray as nd
from ....ndarray.ndarray import NDArray, invoke
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomLighting", "RandomColorJitter", "CropResize", "RandomHue", "RandomGray", "Rotate", "RandomRotation"]


def _to_np(x) -> _np.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):     # an NDArray that Block.__call__ unwrapped
        return x.detach().cpu().numpy()
    return _np.asarray(x)


class Compose(Sequential):
    """Sequentially apply transforms (reference: transforms.Compose)."""

    def __init__(self, transforms: List[Block]):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        if isinstance(x, NDArray):
            return x.astype(self._dtype)
        return nd.array(_to_np(x).astype(self._dtype))


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference: ToTensor)."""

    def forward(self, x):
        arr = _to_np(x).astype(_np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return nd.array(arr)


class Normalize(Block):
    """(x - mean) / std per channel on CHW input (reference: Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, _np.float32)
        self._std = _np.asarray(std, _np.float32)

    def forward(self, x):
        arr = _to_np(x).astype(_np.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return nd.array((arr - mean) / std)


def _resize_np(img: _np.ndarray, size: Tuple[int, int]) -> _np.ndarray:
    """Bilinear resize HWC via separable linear interpolation (the role of
    OpenCV resize in src/io/image_aug_default.cc)."""
    h, w = img.shape[:2]
    out_w, out_h = size
    if (h, w) == (out_h, out_w):
        return img
    ys = _np.linspace(0, h - 1, out_h)
    xs = _np.linspace(0, w - 1, out_w)
    y0 = _np.floor(ys).astype(int)
    x0 = _np.floor(xs).astype(int)
    y1 = _np.minimum(y0 + 1, h - 1)
    x1 = _np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img_f = img.astype(_np.float32)
    if img_f.ndim == 2:
        img_f = img_f[:, :, None]
    top = img_f[y0][:, x0] * (1 - wx) + img_f[y0][:, x1] * wx
    bot = img_f[y1][:, x0] * (1 - wx) + img_f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.dtype == _np.uint8:
        out = _np.clip(out, 0, 255).astype(_np.uint8)
    return out if img.ndim == 3 else out[:, :, 0]


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._keep = keep_ratio

    def forward(self, x):
        img = _to_np(x)
        w, h = self._size
        if self._keep:
            ih, iw = img.shape[:2]
            scale = min(w / iw, h / ih)
            w, h = int(iw * scale), int(ih * scale)
        return nd.array(_resize_np(img, (w, h)))


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        img = _to_np(x)
        h, w = img.shape[:2]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        out = img[y0:y0 + ch, x0:x0 + cw]
        if out.shape[:2] != (ch, cw):
            out = _resize_np(out, (cw, ch))
        return nd.array(out)


class CropResize(Block):
    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y, self._w, self._h = x, y, width, height
        self._size = size

    def forward(self, data):
        img = _to_np(data)
        out = img[self._y:self._y + self._h, self._x:self._x + self._w]
        if self._size:
            size = (self._size, self._size) if isinstance(self._size, int) \
                else tuple(self._size)
            out = _resize_np(out, size)
        return nd.array(out)


class RandomResizedCrop(Block):
    """Random area/aspect crop then resize (reference: RandomResizedCrop —
    the ImageNet training augmentation)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        img = _to_np(x)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            aspect = _pyrandom.uniform(*self._ratio)
            cw = int(round((target_area * aspect) ** 0.5))
            ch = int(round((target_area / aspect) ** 0.5))
            if cw <= w and ch <= h:
                x0 = _pyrandom.randint(0, w - cw)
                y0 = _pyrandom.randint(0, h - ch)
                crop = img[y0:y0 + ch, x0:x0 + cw]
                return nd.array(_resize_np(crop, self._size))
        return nd.array(_resize_np(img, self._size))


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _pyrandom.random() < self._p:
            return nd.array(_to_np(x)[:, ::-1].copy())
        return x if isinstance(x, NDArray) else nd.array(_to_np(x))


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _pyrandom.random() < self._p:
            return nd.array(_to_np(x)[::-1].copy())
        return x if isinstance(x, NDArray) else nd.array(_to_np(x))


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._b, self._b)
        return nd.array(_to_np(x).astype(_np.float32) * alpha)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        img = _to_np(x).astype(_np.float32)
        alpha = 1.0 + _pyrandom.uniform(-self._c, self._c)
        gray = img.mean()
        return nd.array(gray + alpha * (img - gray))


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        img = _to_np(x).astype(_np.float32)
        alpha = 1.0 + _pyrandom.uniform(-self._s, self._s)
        if img.ndim == 3 and img.shape[2] == 3:
            gray = img @ _np.array([0.299, 0.587, 0.114], _np.float32)
            return nd.array(gray[:, :, None] + alpha * (img - gray[:, :, None]))
        return nd.array(img)


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise (reference: RandomLighting)."""

    _eigval = _np.array([55.46, 4.794, 1.148], _np.float32)
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], _np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        img = _to_np(x).astype(_np.float32)
        if img.ndim != 3 or img.shape[2] != 3:
            return nd.array(img)
        alpha = _np.random.normal(0, self._alpha, 3).astype(_np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return nd.array(img + rgb)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        ts = list(self._ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class RandomHue(Block):
    """Random hue jitter: the ``_image_random_hue`` op with a factor from
    [-hue, hue] (reference: transforms.RandomHue)."""

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        return invoke("_image_random_hue", nd.array(_to_np(x)),
                      min_factor=-self._h, max_factor=self._h)


class RandomGray(Block):
    """With probability p, collapse to ITU-R BT.601 luma replicated over
    channels (reference: transforms.RandomGray)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _pyrandom.random() >= self._p:
            return x if isinstance(x, nd.NDArray) else nd.array(_to_np(x))
        a = _to_np(x).astype(_np.float32)
        luma = (0.299 * a[..., 0] + 0.587 * a[..., 1]
                + 0.114 * a[..., 2])
        return nd.array(_np.stack([luma] * a.shape[-1], axis=-1))


class Rotate(Block):
    """Rotate by a fixed angle (degrees, counter-clockwise), bilinear with
    zero padding (reference: transforms.Rotate)."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        if zoom_in or zoom_out:
            raise NotImplementedError(
                "Rotate: zoom_in/zoom_out not implemented")
        self._deg = rotation_degrees

    def forward(self, x):
        return _rotate_hwc(x, self._deg)


class RandomRotation(Block):
    """Rotate by a uniform random angle from [lo, hi] degrees, with
    probability ``rotate_with_proba`` (reference:
    transforms.RandomRotation)."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        if zoom_in or zoom_out:
            raise NotImplementedError(
                "RandomRotation: zoom_in/zoom_out not implemented")
        self._lim = angle_limits
        self._p = rotate_with_proba

    def forward(self, x):
        if _pyrandom.random() >= self._p:
            return x if isinstance(x, NDArray) else nd.array(_to_np(x))
        return _rotate_hwc(x, _pyrandom.uniform(*self._lim))


def rotation_theta(deg, H, W) -> _np.ndarray:
    """The (1, 6) affine ``GridGenerator`` parameters that rotate an H x W
    image by ``deg`` degrees counter-clockwise about its centre.  The
    grid maps output to input and the image's y axis points down, so the
    angle is negated; the sine terms carry the aspect ratio, so the
    rotation is rigid in pixels when H != W."""
    th = -math.radians(deg)
    sx = max(W - 1, 1) / 2.0
    sy = max(H - 1, 1) / 2.0
    return _np.array([[math.cos(th), math.sin(th) * sy / sx, 0.0,
                       -math.sin(th) * sx / sy, math.cos(th), 0.0]],
                     _np.float32)


def _rotate_hwc(x, deg):
    """An HWC image rotated about its centre through the ``GridGenerator``
    and ``BilinearSampler`` ops."""
    a = _to_np(x).astype(_np.float32)
    chw = _np.moveaxis(a, -1, 0)[None]                  # (1, C, H, W)
    grid = invoke("GridGenerator", nd.array(rotation_theta(deg, *a.shape[:2])),
                  transform_type="affine", target_shape=a.shape[:2])
    out = invoke("BilinearSampler", nd.array(chw), grid)
    return nd.array(_np.moveaxis(out.asnumpy()[0], 0, -1))
