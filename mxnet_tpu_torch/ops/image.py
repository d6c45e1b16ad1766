"""``mx.nd.image.*`` operators.

Counterpart of ``mxnet_tpu/ops/image.py`` (reference:
src/operator/image/image_random.cc + image_resize.cc: ``_image_to_tensor``,
``_image_normalize``, ``_image_resize``, ``_image_crop``, the flips,
``_image_adjust_lighting``, the ``_image_random_*`` jitters; and the
OpenCV-plugin ops ``_cvimdecode``, ``_cvimread``, ``_cvimresize``,
``_cvcopyMakeBorder``).  Layout is HWC (or NHWC for a batch), uint8 or
float, as in the reference.

The random ops draw their factor from the calling thread's generator of
the data's device (:func:`.random.generator`, seeded by
``mx.random.seed``); the reference draws from a JAX key, so the draws
cannot match it bit for bit, and the tests hold the functions at a fixed
factor and the draws by their moments.  ``_image_resize`` builds the
same per-axis weight matrices as ``jax.image.resize`` (a triangle kernel,
widened when downsampling, normalised per output sample) and contracts
the image with them, so it computes the reference's function.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .random import _rand, _randn
from .registry import register

__all__ = ["resize_weights"]

# ITU-R BT.601 luma weights (the reference's grayscale coefficients)
_LUMA = (0.299, 0.587, 0.114)
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))
_T_YIQ = ((0.299, 0.587, 0.114),
          (0.596, -0.274, -0.321),
          (0.211, -0.523, 0.311))
_T_RGB = ((1.0, 0.956, 0.621),
          (1.0, -0.272, -0.647),
          (1.0, -1.107, 1.705))


def _is_batch(x):
    return x.dim() == 4


def _const(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


@register("_image_to_tensor", aliases=["image_to_tensor"])
def _to_tensor(data):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""
    x = data.float() / 255.0
    return x.permute(0, 3, 1, 2) if _is_batch(data) else x.permute(2, 0, 1)


@register("_image_normalize", aliases=["image_normalize"])
def _normalize(data, mean=(0.0,), std=(1.0,)):
    """CHW (or NCHW) float: ``(x - mean) / std`` per channel."""
    mean = _const(mean, data)
    std = _const(std, data)
    shape = (1, -1, 1, 1) if _is_batch(data) else (-1, 1, 1)
    return (data - mean.reshape(shape)) / std.reshape(shape)


def resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """The (in_size, out_size) float32 weight matrix of
    ``jax.image.resize``'s linear method along one axis (antialiased:
    the triangle kernel is widened by in/out when downsampling)."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_nearest(x, out_shape):
    for d, (m, n) in enumerate(zip(x.shape, out_shape)):
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long().to(x.device)
            x = x.index_select(d, idx)
    return x


def _resize_linear(x, out_shape):
    x = x.float()
    for d, (m, n) in enumerate(zip(x.shape, out_shape)):
        if m != n:
            w = resize_weights(m, n, x.device)
            x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


def _resize_to(data, h, w, interp):
    if _is_batch(data):
        shape = (data.shape[0], h, w, data.shape[3])
    else:
        shape = (h, w, data.shape[2])
    if interp == 0:
        return _resize_nearest(data.float(), shape).to(data.dtype)
    return _resize_linear(data, shape).to(data.dtype)


@register("_image_resize", aliases=["image_resize"])
def _resize(data, size=(0, 0), keep_ratio=False, interp=1):
    """HWC (NHWC) resize to ``size`` (w, h); ``interp`` 0 is nearest,
    anything else linear; computed in float32 and cast back."""
    if isinstance(size, int):
        size = (size, size)
    w, h = int(size[0]), int(size[1] if len(size) > 1 else size[0])
    return _resize_to(data, h, w, interp)


@register("_image_crop", aliases=["image_crop"])
def _crop(data, x=0, y=0, width=1, height=1):
    if _is_batch(data):
        return data[:, y:y + height, x:x + width, :]
    return data[y:y + height, x:x + width, :]


@register("_image_flip_left_right", aliases=["image_flip_left_right"])
def _flip_lr(data):
    return torch.flip(data, dims=(-2,))


@register("_image_flip_top_bottom", aliases=["image_flip_top_bottom"])
def _flip_tb(data):
    return torch.flip(data, dims=(-3,))


@register("_image_adjust_lighting", aliases=["image_adjust_lighting"])
def _adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """AlexNet-style PCA lighting shift."""
    alpha = alpha if isinstance(alpha, torch.Tensor) else _const(alpha, data)
    shift = (_const(_EIGVEC, data) * alpha * _const(_EIGVAL, data)).sum(1)
    return (data.float() + shift).to(data.dtype)


def _blend(a, b, w):
    return w * a.float() + (1.0 - w) * b.float()


def _grayscale(x):
    g = (x.float() * _const(_LUMA, x)).sum(dim=-1, keepdim=True)
    return g.expand(x.shape)


def _brightness(x, w):
    return _blend(x, torch.zeros_like(x, dtype=torch.float32), w)


def _contrast(x, w):
    mean = _grayscale(x).mean()
    return _blend(x, mean.expand(x.shape), w)


def _saturation(x, w):
    return _blend(x, _grayscale(x), w)


def _hue(x, w):
    """Rotate the chroma in YIQ space by ``w * pi``."""
    h = w * math.pi
    u, v = torch.cos(h), torch.sin(h)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, u, -v]),
                       torch.stack([zero, v, u])])
    m = _const(_T_RGB, x) @ rot @ _const(_T_YIQ, x)
    return x.float() @ m.T


def _uniform(data, low, high):
    """One float32 draw from [low, high) on data's device."""
    return low + (high - low) * _rand((), data.device)


def _rand_w(data, frac):
    # clamp at 0: a fraction above 1 must brighten or flatten, never invert
    return _uniform(data, max(0.0, 1.0 - frac), 1.0 + frac)


@register("_image_random_brightness", aliases=["image_random_brightness"],
          differentiable=False)
def _random_brightness(data, min_factor=0.0, max_factor=0.0):
    w = _uniform(data, min_factor, max_factor)
    return _brightness(data, w).to(data.dtype)


@register("_image_random_contrast", aliases=["image_random_contrast"],
          differentiable=False)
def _random_contrast(data, min_factor=0.0, max_factor=0.0):
    w = _uniform(data, min_factor, max_factor)
    return _contrast(data, w).to(data.dtype)


@register("_image_random_saturation", aliases=["image_random_saturation"],
          differentiable=False)
def _random_saturation(data, min_factor=0.0, max_factor=0.0):
    w = _uniform(data, min_factor, max_factor)
    return _saturation(data, w).to(data.dtype)


@register("_image_random_hue", aliases=["image_random_hue"],
          differentiable=False)
def _random_hue(data, min_factor=0.0, max_factor=0.0):
    w = _uniform(data, min_factor, max_factor)
    return _hue(data, w).to(data.dtype)


@register("_image_random_color_jitter", aliases=["image_random_color_jitter"],
          differentiable=False)
def _random_color_jitter(data, brightness=0.0, contrast=0.0,
                         saturation=0.0, hue=0.0):
    """Brightness, contrast, saturation and hue jitter in that order, each
    with its own draw."""
    x = data.float()
    if brightness > 0:
        x = _brightness(x, _rand_w(data, brightness))
    if contrast > 0:
        x = _contrast(x, _rand_w(data, contrast))
    if saturation > 0:
        x = _saturation(x, _rand_w(data, saturation))
    if hue > 0:
        x = _hue(x, _uniform(data, -hue, hue))
    return x.to(data.dtype)


@register("_image_random_lighting", aliases=["image_random_lighting"],
          differentiable=False)
def _random_lighting(data, alpha_std=0.05):
    return _adjust_lighting(data, _randn((3,), data.device) * alpha_std)


@register("_image_random_flip_left_right",
          aliases=["image_random_flip_left_right"], differentiable=False)
def _random_flip_lr(data, p=0.5):
    return torch.flip(data, dims=(-2,)) \
        if bool(_rand((), data.device) < p) else data


@register("_image_random_flip_top_bottom",
          aliases=["image_random_flip_top_bottom"], differentiable=False)
def _random_flip_tb(data, p=0.5):
    return torch.flip(data, dims=(-3,)) \
        if bool(_rand((), data.device) < p) else data


# ---------------------------------------------------------------------------
# the OpenCV-plugin ops (reference: plugin/opencv/cv_api.cc); decode is the
# port's mx.image.imdecode (libjpeg, else PIL)
# ---------------------------------------------------------------------------


@register("_cvimdecode", aliases=["cvimdecode"], differentiable=False)
def _cvimdecode(buf, flag=1, to_rgb=True):
    from ..image import imdecode
    raw = buf.detach().cpu().numpy().astype(np.uint8).tobytes() \
        if isinstance(buf, torch.Tensor) else bytes(buf)
    return imdecode(raw, flag=flag, to_rgb=to_rgb).data


@register("_cvimread", aliases=["cvimread"], differentiable=False)
def _cvimread(filename="", flag=1, to_rgb=True, device=None):
    from PIL import Image
    if flag == 0:               # OpenCV IMREAD_GRAYSCALE
        arr = np.asarray(Image.open(filename).convert("L"), np.uint8)
        arr = arr[:, :, None]
    else:
        arr = np.asarray(Image.open(filename).convert("RGB"), np.uint8)
        if not to_rgb:          # OpenCV's own channel order is BGR
            arr = arr[:, :, ::-1]
    return torch.from_numpy(arr.copy()).to(device or "cpu")


@register("_cvimresize", aliases=["cvimresize"], differentiable=False)
def _cvimresize(data, w=1, h=1, interp=1):
    return _resize_to(data, int(h), int(w), interp)


_BORDER = {1: "edge", 2: "symmetric", 3: "wrap", 4: "reflect"}


def _border_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "symmetric":             # edge repeated: abc|cba
        i = torch.remainder(i, 2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    period = max(2 * (n - 1), 1)        # reflect: edge not repeated
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register("_cvcopyMakeBorder", aliases=["copyMakeBorder_op"],
          differentiable=False)
def _cvcopy_make_border(data, top=0, bot=0, left=0, right=0, type=0,
                        value=0.0, values=()):
    """HWC border of (top, bot) rows and (left, right) columns: constant
    (type 0, ``value`` or per-channel ``values``), replicate (1), reflect
    with the edge repeated (2), wrap (3), reflect without it (4)."""
    if type == 0:
        out = F.pad(data.movedim(-1, 0).float(), (left, right, top, bot),
                    value=float(value)).movedim(0, -1)
        if values:
            fill = torch.tensor([values[min(c, len(values) - 1)]
                                 for c in range(data.shape[-1])],
                                dtype=torch.float32, device=data.device)
            inside = torch.zeros(out.shape[:2], dtype=torch.bool,
                                 device=data.device)
            inside[top:top + data.shape[0], left:left + data.shape[1]] = True
            out = torch.where(inside[..., None], out, fill)
        return out.to(data.dtype)
    mode = _BORDER.get(type)
    if mode is None:
        raise ValueError("unsupported border type %r" % (type,))
    out = data.index_select(0, _border_index(data.shape[0], top, bot, mode,
                                             data.device))
    return out.index_select(1, _border_index(data.shape[1], left, right,
                                             mode, data.device))
