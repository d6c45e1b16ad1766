"""Detection input path: ``ImageDetIter`` and the label-aware augmenters.

Counterpart of ``mxnet_tpu/image/detection.py`` (reference:
python/mxnet/image/detection.py: ImageDetIter, DetHorizontalFlipAug,
DetRandomCropAug, DetBorderAug, CreateDetAugmenter), the SSD training
input.

A label is (N, 5+) rows ``[class, xmin, ymin, xmax, ymax, ...]`` with
coordinates normalised to [0, 1]; a row of -1 is padding.  In a .rec the
header's label is the flat ``[header_width, object_width, <extra>,
obj0..., obj1...]`` of ``tools/im2rec.py --pack-label``.  The iterator
pads every image's objects to the dataset's maximum with -1, so batches
are rectangular.

Random choices draw from :func:`_det_rng`, a thread-local numpy
``RandomState`` that ``ImageDetIter`` seeds from (iterator seed, record
key, epoch) before each record, so the same seed gives the reference's
boxes and pixels bit for bit whichever worker thread takes the record.
Decode and augmentation run on the host, on ``preprocess_threads``
threads, each in the context current where the iterator was made
(``device.in_context``); batches come back as NDArrays on the CPU, for
``io.DevicePrefetcher`` to move.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as _np

from ..base import MXNetError
from ..device import cpu, current_context, in_context
from ..io import DataBatch, DataDesc, DataIter
from . import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
               ForceResizeAug, _to_nd, _to_np, imdecode)

__all__ = ["ImageDetIter", "DetAugmenter", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetBorderAug", "CreateDetAugmenter"]

_TL = threading.local()


def _det_rng() -> _np.random.RandomState:
    """The calling thread's detection ``RandomState`` (an unseeded one for
    an augmenter used on its own)."""
    rng = getattr(_TL, "rng", None)
    if rng is None:
        rng = _np.random.RandomState()
        _TL.rng = rng
    return rng


class DetAugmenter:
    """Transforms (image, label) together; label (N, 5+) normalised."""

    def __call__(self, src, label):
        raise NotImplementedError


class _DetImageOnly(DetAugmenter):
    """An image augmenter that moves no pixel (colour, cast, normalise)."""

    def __init__(self, aug: Augmenter):
        self.aug = aug

    def __call__(self, src, label):
        return self.aug(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """With probability ``p``, mirror the image and the boxes' x."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _det_rng().rand() < self.p:
            src = _to_nd(_to_np(src)[:, ::-1, :].copy())
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """The SSD crop: up to ``max_attempts`` crops of a random area and
    aspect ratio, the first that covers at least ``min_object_covered``
    of some object is taken; objects whose centre leaves the crop are
    dropped (-1) and the rest renormalised and clipped to it."""

    def __init__(self, min_object_covered=0.3,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.3, 1.0),
                 max_attempts=20):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        valid = label[:, 0] >= 0
        if not valid.any():
            return src, label
        boxes = label[valid, 1:5]
        rng = _det_rng()
        for _ in range(self.max_attempts):
            scale = rng.uniform(*self.area_range)
            ratio = rng.uniform(*self.aspect_ratio_range)
            cw = min(1.0, _np.sqrt(scale * ratio))
            ch = min(1.0, _np.sqrt(scale / ratio))
            cx0 = rng.uniform(0, 1 - cw)
            cy0 = rng.uniform(0, 1 - ch)
            crop = _np.array([cx0, cy0, cx0 + cw, cy0 + ch])
            ix1 = _np.maximum(boxes[:, 0], crop[0])
            iy1 = _np.maximum(boxes[:, 1], crop[1])
            ix2 = _np.minimum(boxes[:, 2], crop[2])
            iy2 = _np.minimum(boxes[:, 3], crop[3])
            inter = _np.maximum(ix2 - ix1, 0) * _np.maximum(iy2 - iy1, 0)
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            cover = inter / _np.maximum(area, 1e-12)
            if (cover >= self.min_object_covered).any():
                return self._apply(src, label, crop, h, w)
        return src, label

    @staticmethod
    def _apply(src, label, crop, h, w):
        x0, y0 = int(crop[0] * w), int(crop[1] * h)
        x1, y1 = int(crop[2] * w), int(crop[3] * h)
        arr = _to_np(src)[y0:y1, x0:x1, :]
        out = label.copy()
        cw, ch = crop[2] - crop[0], crop[3] - crop[1]
        for i in range(out.shape[0]):
            if out[i, 0] < 0:
                continue
            cx = (out[i, 1] + out[i, 3]) / 2
            cy = (out[i, 2] + out[i, 4]) / 2
            if not (crop[0] <= cx <= crop[2] and crop[1] <= cy <= crop[3]):
                out[i] = -1.0
                continue
            out[i, 1] = _np.clip((out[i, 1] - crop[0]) / cw, 0, 1)
            out[i, 3] = _np.clip((out[i, 3] - crop[0]) / cw, 0, 1)
            out[i, 2] = _np.clip((out[i, 2] - crop[1]) / ch, 0, 1)
            out[i, 4] = _np.clip((out[i, 4] - crop[1]) / ch, 0, 1)
        return _to_nd(arr.copy()), out


class DetBorderAug(DetAugmenter):
    """Zoom out: with probability ``p``, place the image at a random spot
    of a canvas up to ``max_expand`` times larger filled with ``fill``,
    shrinking the boxes with it."""

    def __init__(self, max_expand=2.0, fill=127, p=0.5):
        self.max_expand = max_expand
        self.fill = fill
        self.p = p

    def __call__(self, src, label):
        rng = _det_rng()
        if rng.rand() >= self.p:
            return src, label
        arr = _to_np(src)
        h, w, c = arr.shape
        ratio = rng.uniform(1.0, self.max_expand)
        nh, nw = int(h * ratio), int(w * ratio)
        oy = rng.randint(0, nh - h + 1)
        ox = rng.randint(0, nw - w + 1)
        canvas = _np.full((nh, nw, c), self.fill, arr.dtype)
        canvas[oy:oy + h, ox:ox + w, :] = arr
        out = label.copy()
        valid = out[:, 0] >= 0
        out[valid, 1] = (out[valid, 1] * w + ox) / nw
        out[valid, 3] = (out[valid, 3] * w + ox) / nw
        out[valid, 2] = (out[valid, 2] * h + oy) / nh
        out[valid, 4] = (out[valid, 4] * h + oy) / nh
        return _to_nd(canvas), out


class _DetForceResize(DetAugmenter):
    """Resize to the network's input size; normalised boxes are
    unchanged."""

    def __init__(self, size: Tuple[int, int], interp=2):
        self.aug = ForceResizeAug(size, interp)

    def __call__(self, src, label):
        return self.aug(src), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0.0, rand_pad=0.0,
                       rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, hue=0,
                       min_object_covered=0.3,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 1.0), max_expand=2.0,
                       pad_val=127, inter_method=2, **_kw):
    """The SSD augmentation chain: crop, expand, resize to ``data_shape``,
    mirror, colour jitter, cast to float32, normalise (``mean``/``std``
    True take the ImageNet values)."""
    augs: List[DetAugmenter] = []
    if rand_crop > 0:
        augs.append(DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                     area_range))
    if rand_pad > 0:
        augs.append(DetBorderAug(max_expand, pad_val, rand_pad))
    augs.append(_DetForceResize((data_shape[2], data_shape[1]),
                                inter_method))
    if rand_mirror:
        augs.append(DetHorizontalFlipAug(0.5))
    if brightness or contrast or saturation:
        augs.append(_DetImageOnly(ColorJitterAug(brightness, contrast,
                                                 saturation)))
    augs.append(_DetImageOnly(CastAug()))
    if mean is not None or std is not None:
        if mean is True:
            mean = _np.array([123.68, 116.28, 103.53], _np.float32)
        if std is True:
            std = _np.array([58.395, 57.12, 57.375], _np.float32)
        augs.append(_DetImageOnly(ColorNormalizeAug(mean, std)))
    return augs


def _parse_det_label(flat) -> _np.ndarray:
    """A record's flat label -> (N, 5) float32 objects."""
    flat = _np.asarray(flat, _np.float32).ravel()
    if flat.size < 2:
        return _np.full((0, 5), -1.0, _np.float32)
    header_width = int(flat[0])
    obj_width = int(flat[1])
    if obj_width < 5:
        raise MXNetError("det label object_width must be >= 5, got %d"
                         % obj_width)
    body = flat[header_width:]
    n = body.size // obj_width
    return body[:n * obj_width].reshape(n, obj_width)[:, :5] \
        .astype(_np.float32)


def augment_det(augs, img, label, max_objs, dtype=_np.float32):
    """Run the chain on one (image, label) and return the CHW array and
    the label padded with -1 to ``max_objs`` rows."""
    for aug in augs:
        img, label = aug(img, label) if isinstance(aug, DetAugmenter) \
            else (aug(img), label)
    pad = _np.full((max_objs, 5), -1.0, _np.float32)
    n = min(label.shape[0], max_objs)
    pad[:n] = label[:n]
    return _to_np(img).astype(dtype).transpose(2, 0, 1), pad


def _det_record_rng(seed: int, key: int, epoch: int) -> None:
    """Seed the calling thread's :func:`_det_rng` for record ``key`` of
    ``epoch``: the same draws whichever thread takes the record."""
    _TL.rng = _np.random.RandomState(
        (int(seed) * 1000003 + int(key) * 9176 + int(epoch)) % (2 ** 31))


class ImageDetIter(DataIter):
    """Detection batches from an indexed .rec: ``DataBatch(data=(B, C, H,
    W) float, label=(B, max_objects, 5))``; a last short batch is filled
    from the start of the order and its ``pad`` says how many."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, aug_list=None,
                 mean=None, std=None, rand_crop=0.0, rand_pad=0.0,
                 rand_mirror=False, preprocess_threads=4, seed=0,
                 num_parts=1, part_index=0, dtype="float32", **kw):
        super().__init__(batch_size)
        from .. import recordio
        self.data_shape = tuple(data_shape)
        self._dtype = _np.dtype(dtype)
        self._idx_path = path_imgidx or path_imgrec[:-4] + ".idx"
        self._record = recordio.MXIndexedRecordIO(self._idx_path,
                                                  path_imgrec, "r")
        keys = self._record.keys
        if not keys:
            raise MXNetError("ImageDetIter needs indexed records (.idx)")
        self._keys = _np.asarray(keys[part_index::num_parts])
        self._shuffle = shuffle
        self._seed = int(seed)
        self._epoch = 0
        self._rng = _np.random.RandomState(seed)
        if aug_list is None:
            aug_list = CreateDetAugmenter(
                (3,) + tuple(self.data_shape[1:]), rand_crop=rand_crop,
                rand_pad=rand_pad, rand_mirror=rand_mirror, mean=mean,
                std=std, **kw)
        self._augs = aug_list
        self._pool = ThreadPoolExecutor(max_workers=preprocess_threads)
        self._load = in_context(current_context(), self._load_one)
        self._lock = threading.Lock()
        # one pass over the headers sizes the label pad
        self._max_objs = 1
        for k in self._keys:
            self._max_objs = max(self._max_objs,
                                 self._read_label(int(k)).shape[0])
        self.reset()

    def _read_label(self, key: int) -> _np.ndarray:
        from .. import recordio as rio
        with self._lock:
            payload = self._record.read_idx(key)
        header, _ = rio.unpack(payload)
        return _parse_det_label(header.label)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         self._dtype)]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size, self._max_objs, 5),
                         _np.float32)]

    def reset(self):
        self._order = self._keys.copy()
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0
        with self._lock:
            self._epoch += 1

    def _load_one(self, key):
        from .. import recordio as rio
        with self._lock:
            epoch = self._epoch
            payload = self._record.read_idx(int(key))
        _det_record_rng(self._seed, key, epoch)
        header, img_bytes = rio.unpack(payload)
        return augment_det(self._augs, imdecode(img_bytes),
                           _parse_det_label(header.label), self._max_objs,
                           self._dtype)

    def next(self) -> DataBatch:
        from .. import ndarray as nd
        if self._cursor >= len(self._order):
            raise StopIteration
        keys = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        npad = self.batch_size - len(keys)
        if npad:
            keys = _np.concatenate([keys, self._order[:npad]])
        results = list(self._pool.map(self._load, keys))
        data = _np.stack([r[0] for r in results])
        label = _np.stack([r[1] for r in results])
        return DataBatch(data=[nd.array(data, ctx=cpu(), dtype=data.dtype)],
                         label=[nd.array(label, ctx=cpu())], pad=npad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
