"""mx.image: image decode, resize, crops and augmenters.

Counterpart of ``mxnet_tpu/image/__init__.py`` (reference:
python/mxnet/image/image.py: imdecode, imread, imresize, resize_short,
fixed_crop, center_crop, random_crop, random_size_crop, color_normalize,
the Augmenters, CreateAugmenter; src/io/image_aug_default.cc).  Decode
and augmentation stay on the host: they are per sample, of varying shape
and branchy.  JPEG decodes through the native libjpeg decoder of
``src/imdecode.cc`` (built by :mod:`.._native`), other formats and a
machine without the toolchain through PIL, as in the reference.  The
functions take HWC uint8 or float32 NDArrays or numpy arrays and return
NDArrays on the CPU.  Random choices draw from Python's ``random`` (and
``LightingAug`` from numpy's global generator) in the reference's order,
so the same seeds give the reference's output bit for bit.
``ImageIter`` is ``io.ImageRecordIter``; ``ImageDetIter`` and the
detection augmenters are :mod:`.detection`'s.
"""
from __future__ import annotations

import io as _io
import threading as _threading
import logging
import os
import random as _pyrandom
from typing import List, Optional, Sequence, Tuple

import numpy as _np

import torch

from .. import ndarray as nd
from ..ndarray.ndarray import NDArray
from ..device import cpu

__all__ = ["imdecode", "imread", "imresize", "imrotate", "resize_short",
           "fixed_crop", "center_crop", "random_crop", "random_size_crop",
           "color_normalize", "copyMakeBorder",
           "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "CastAug", "HorizontalFlipAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "CreateAugmenter", "ImageIter", "scale_down"]


def _pil():
    from PIL import Image
    return Image


def _to_nd(arr: _np.ndarray) -> NDArray:
    return nd.array(_np.ascontiguousarray(arr), ctx=cpu(), dtype=arr.dtype)


def _to_np(img) -> _np.ndarray:
    if isinstance(img, NDArray):
        return img.asnumpy()
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return _np.asarray(img)


# -- codecs -------------------------------------------------------------------

_NATIVE_JPEG = None
_NATIVE_JPEG_TRIED = False


_NATIVE_JPEG_LOCK = _threading.Lock()


def _native_jpeg():
    """ctypes handle on the native libjpeg decoder (src/imdecode.cc), the
    reference's C++ decode path; None when the toolchain or libjpeg is
    missing (PIL decodes then).  The first call builds under a lock, so a
    thread pool's concurrent first batch waits for the native path
    instead of decoding through PIL."""
    global _NATIVE_JPEG, _NATIVE_JPEG_TRIED
    if _NATIVE_JPEG_TRIED:
        return _NATIVE_JPEG
    with _NATIVE_JPEG_LOCK:
        if _NATIVE_JPEG_TRIED:
            return _NATIVE_JPEG
        try:
            import ctypes
            from .. import _native
            lib = _native.load("imdecode")
            lib.MXImdecode.restype = ctypes.c_int
            lib.MXImdecode.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.MXImdecodeFree.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte)]
            _NATIVE_JPEG = lib
        except OSError:
            _NATIVE_JPEG = None
        _NATIVE_JPEG_TRIED = True
    return _NATIVE_JPEG


def _imdecode_native(buf: bytes, flag: int):
    lib = _native_jpeg()
    if lib is None:
        return None
    import ctypes
    out = ctypes.POINTER(ctypes.c_ubyte)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.MXImdecode(buf, len(buf), 1 if flag == 0 else 3,
                        ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c))
    if rc != 0:
        return None          # not a JPEG / corrupt: PIL path decides
    try:
        n = h.value * w.value * c.value
        arr = _np.ctypeslib.as_array(out, shape=(n,)).reshape(
            h.value, w.value, c.value).copy()
    finally:
        lib.MXImdecodeFree(out)
    return arr


def imdecode(buf: bytes, to_rgb: int = 1, flag: int = 1) -> NDArray:
    """Decode JPEG/PNG bytes → HWC uint8 NDArray (reference: mx.image.imdecode
    → cv::imdecode).  ``flag=0`` decodes grayscale (H, W, 1); to_rgb keeps
    RGB channel order (the reference's default converts BGR→RGB).

    JPEG rides the native GIL-free decoder (src/imdecode.cc, the
    reference's C++ parser role); PNG/other formats and build-less
    environments fall back to PIL."""
    arr = _imdecode_native(bytes(buf), flag)
    if arr is not None:
        if flag != 0 and not to_rgb:
            arr = arr[:, :, ::-1]
        return _to_nd(arr)
    Image = _pil()
    pil = Image.open(_io.BytesIO(buf))
    if flag == 0:
        arr = _np.asarray(pil.convert("L"))[:, :, None]
    else:
        arr = _np.asarray(pil.convert("RGB"))
        if not to_rgb:
            arr = arr[:, :, ::-1]  # BGR, matching OpenCV-style consumers
    return _to_nd(arr)


def imread(filename: str, to_rgb: int = 1, flag: int = 1) -> NDArray:
    """Read + decode an image file (reference: mx.image.imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


_INTERP = {0: "NEAREST", 1: "BILINEAR", 2: "BICUBIC", 3: "LANCZOS",
           4: "LANCZOS", 9: "BILINEAR", 10: "BILINEAR"}


def _resample(interp: int):
    Image = _pil()
    return getattr(Image.Resampling, _INTERP.get(interp, "BILINEAR"))


def imresize(src, w: int, h: int, interp: int = 1) -> NDArray:
    """Resize to exactly (h, w) (reference: mx.image.imresize)."""
    arr = _to_np(src)
    Image = _pil()
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    pil = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    out = _np.asarray(pil.resize((w, h), _resample(interp)))
    if squeeze:
        out = out[:, :, None]
    return _to_nd(out)


def imrotate(src, rotation_degrees: float, zoom_in: bool = False,
             zoom_out: bool = False) -> NDArray:
    """Rotate around the center (reference: mx.image.imrotate)."""
    arr = _to_np(src)
    Image = _pil()
    pil = Image.fromarray(arr)
    out = pil.rotate(rotation_degrees, resample=_resample(1),
                     expand=zoom_out)
    out = _np.asarray(out)
    if zoom_out:
        out = _np.asarray(Image.fromarray(out).resize(
            (arr.shape[1], arr.shape[0]), _resample(1)))
    return _to_nd(out)


def resize_short(src, size: int, interp: int = 2) -> NDArray:
    """Scale so the SHORTER side equals size (reference: resize_short)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(arr, new_w, new_h, interp)


def copyMakeBorder(src, top, bot, left, right, *_args, **_kw) -> NDArray:
    """Zero-pad borders (reference: mx.image.copyMakeBorder)."""
    arr = _to_np(src)
    return _to_nd(_np.pad(arr, ((top, bot), (left, right), (0, 0))))


# -- crops --------------------------------------------------------------------

def fixed_crop(src, x0: int, y0: int, w: int, h: int,
               size: Optional[Tuple[int, int]] = None,
               interp: int = 2) -> NDArray:
    arr = _to_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(arr, size[0], size[1], interp)
    return _to_nd(arr)


def center_crop(src, size: Tuple[int, int], interp: int = 2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_crop(src, size: Tuple[int, int], interp: int = 2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_size_crop(src, size: Tuple[int, int], area, ratio,
                     interp: int = 2, max_attempts: int = 10):
    """Inception-style random area/aspect crop (reference:
    random_size_crop — the ResNet training augmentation)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(max_attempts):
        target_area = _pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        aspect = _np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            return fixed_crop(arr, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(arr, size, interp)


def color_normalize(src, mean, std=None):
    """(x - mean) / std in float32 (reference: color_normalize)."""
    arr = _to_np(src).astype(_np.float32)
    mean = _to_np(mean) if not isinstance(mean, (int, float)) else mean
    arr = arr - mean
    if std is not None:
        std = _to_np(std) if not isinstance(std, (int, float)) else std
        arr = arr / std
    return _to_nd(arr.astype(_np.float32))


# -- augmenters (reference: image.py Augmenter hierarchy) --------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src: NDArray) -> NDArray:
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts: Sequence[Augmenter]):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts: Sequence[Augmenter]):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        ts = self.ts[:]
        _pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _to_nd(_to_np(src)[:, ::-1])
        return src


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = size, area, ratio, \
            interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        arr = _to_np(src).astype(_np.float32) * alpha
        return _to_nd(arr)


class ContrastJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = _to_np(src).astype(_np.float32)
        gray = (arr * self._coef).sum() * (3.0 / arr.size)
        return _to_nd(arr * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = _to_np(src).astype(_np.float32)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        return _to_nd(arr * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    _tyiq = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], _np.float32)
    _ityiq = _np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], _np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        u, w = _np.cos(alpha * _np.pi), _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       _np.float32)
        t = self._ityiq @ bt @ self._tyiq
        arr = _to_np(src).astype(_np.float32)
        return _to_nd(arr @ t.T)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,)).astype(
            _np.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _to_nd(_to_np(src).astype(_np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = _np.asarray(mean, _np.float32) \
            if mean is not None else None
        self.std = _np.asarray(std, _np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = _to_np(src).astype(_np.float32)
            gray = (arr * self._coef).sum(axis=2, keepdims=True)
            return _to_nd(_np.broadcast_to(gray, arr.shape).copy())
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Assemble the standard augmentation pipeline (reference:
    image.CreateAugmenter — the ImageRecordIter default chain)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def scale_down(src_size, size):
    """Scale `size` (w, h) down proportionally to fit within `src_size`
    (w, h) (reference: image.scale_down — crop sizes must not exceed the
    source image; scale_down((640,480),(720,120)) == (640,106))."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


# ImageIter lives with the other iterators; the detection path with its
# module (image/detection.py imports this one, so it is loaded on first use)
_DETECTION = ("ImageDetIter", "CreateDetAugmenter", "DetAugmenter",
              "DetHorizontalFlipAug", "DetRandomCropAug", "DetBorderAug")


def __getattr__(name):
    if name == "ImageIter":
        from ..io import ImageRecordIter
        return ImageRecordIter
    if name in _DETECTION:
        from . import detection
        return getattr(detection, name)
    raise AttributeError(name)
