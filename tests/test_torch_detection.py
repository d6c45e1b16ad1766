"""The port's detection input path (``image/detection.py``) against the
JAX reference on the CPU.

The augmenters draw from a thread-local numpy ``RandomState``
(``_det_rng``) and the colour jitter from Python's ``random``; seeded alike,
both packages give the same boxes and pixels bit for bit.  ``ImageDetIter``
reads a small indexed .rec of seeded JPEG images with packed detection
labels that the test writes (decoded on the CPU, as
``tests/test_torch_io.py`` does it); its batches are held bitwise to the
reference's over two epochs, and its labels are padded with -1 to the
dataset's largest object count.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage, recordio as jrec
from mxnet_tpu.image import detection as jdet

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image as timage, recordio as trec
from mxnet_tpu_torch.image import detection as tdet

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _image(seed=0, shape=(40, 56, 3)):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)


def _label(seed=0, n=4):
    rng = np.random.RandomState(seed + 100)
    x1, y1 = rng.uniform(0, 0.6, n), rng.uniform(0, 0.6, n)
    w, h = rng.uniform(0.1, 0.4, n), rng.uniform(0.1, 0.4, n)
    lab = np.stack([rng.randint(0, 5, n).astype(np.float64), x1, y1,
                    x1 + w, y1 + h], axis=1).astype(np.float32)
    lab[-1] = -1.0                            # a padding row
    return lab


def _run(mod, nd, augs, img, label, seed):
    """The chain over (img, label) with the thread's det rng and Python's
    random seeded."""
    mod._TL.rng = np.random.RandomState(seed)
    random.seed(seed)
    src = nd.array(img, dtype="uint8")
    for aug in augs:
        src, label = aug(src, label) if isinstance(aug, mod.DetAugmenter) \
            else (aug(src), label)
    return src.asnumpy(), label


def _same(j, t):
    assert j[0].dtype == t[0].dtype and j[0].shape == t[0].shape
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


AUGS = {
    "flip": lambda m: [m.DetHorizontalFlipAug(0.5)],
    "crop": lambda m: [m.DetRandomCropAug(0.3)],
    "crop_tight": lambda m: [m.DetRandomCropAug(
        0.9, aspect_ratio_range=(0.5, 2.0), area_range=(0.1, 0.5),
        max_attempts=5)],
    "border": lambda m: [m.DetBorderAug(2.5, fill=99, p=0.7)],
}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_is_bitwise_on_the_seed(name, seed):
    img, lab = _image(seed), _label(seed)
    _same(_run(jdet, jmx.nd, AUGS[name](jdet), img, lab, seed),
          _run(tdet, tmx.nd, AUGS[name](tdet), img, lab, seed))


CREATE = {
    "ssd": dict(data_shape=(3, 30, 30), rand_crop=0.5, rand_pad=0.5,
                rand_mirror=True, mean=True, std=True),
    "jitter": dict(data_shape=(3, 24, 32), rand_crop=1.0, rand_mirror=True,
                   brightness=0.3, contrast=0.2, saturation=0.4,
                   inter_method=1),
    "plain": dict(data_shape=(3, 20, 20)),
}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", sorted(CREATE))
def test_create_det_augmenter_is_bitwise_on_the_seed(case, seed):
    img, lab = _image(seed), _label(seed)
    j = _run(jdet, jmx.nd, jdet.CreateDetAugmenter(**CREATE[case]), img,
             lab, seed)
    t = _run(tdet, tmx.nd, tdet.CreateDetAugmenter(**CREATE[case]), img,
             lab, seed)
    _same(j, t)
    assert t[0].shape == CREATE[case]["data_shape"][1:] + (3,)
    assert t[0].dtype == np.float32


def test_mx_image_names_the_detection_path():
    for name in ("ImageDetIter", "CreateDetAugmenter", "DetAugmenter",
                 "DetHorizontalFlipAug", "DetRandomCropAug",
                 "DetBorderAug"):
        assert getattr(timage, name) is getattr(tdet, name)


# ---------------------------------------------------------------------------
# ImageDetIter over a .rec the test writes
# ---------------------------------------------------------------------------

def _pack_det(tmp_path, n=10):
    """Seeded JPEG images of two sizes with 1-5 objects each, as
    ``[header_width, object_width, objects...]`` labels (object width 6:
    one extra column, which the iterator drops)."""
    rng = np.random.RandomState(21)
    prefix = str(tmp_path / "det")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    counts = []
    for i in range(n):
        img = _image(i, (36, 44, 3) if i % 2 else (50, 40, 3))
        k = int(rng.randint(1, 6))
        counts.append(k)
        lab = _label(i, k + 1)[:k]
        objs = np.concatenate([lab, rng.rand(k, 1).astype(np.float32)], 1)
        flat = np.concatenate([[2.0, 6.0], objs.ravel()]).astype(np.float32)
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, flat, i, 0), img,
                                     quality=90, img_fmt=".jpg"))
    w.close()
    return prefix + ".rec", counts


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, rand_crop=0.5, rand_pad=0.5,
         rand_mirror=True, mean=True, std=True, seed=3,
         preprocess_threads=3),
    dict(batch_size=3, preprocess_threads=1, seed=0)])
def test_image_det_iter_is_bitwise_and_pads_labels(tmp_path, kw):
    rec, counts = _pack_det(tmp_path)
    got = {}
    for name, mod in (("jax", jdet), ("port", tdet)):
        it = mod.ImageDetIter(rec, (3, 32, 32), **kw)
        got[name] = (_epochs(it), it.provide_data, it.provide_label)
    j, t = got["jax"][0], got["port"][0]
    assert len(t) == len(j) == 2 * -(-10 // kw["batch_size"])
    for (jd, jl, jp), (td, tl, tp) in zip(j, t):
        assert td.dtype == jd.dtype == np.float32 and tp == jp
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    # labels padded with -1 to the dataset's maximum
    assert t[0][1].shape == (kw["batch_size"], max(counts), 5)
    if "rand_crop" not in kw:
        first = t[0][1]
        for row, k in zip(first, counts):
            assert (row[k:] == -1).all() and (row[:k, 0] >= 0).all()
    assert [tuple(d.shape) for d in got["port"][1]] == \
        [tuple(d.shape) for d in got["jax"][1]]
    assert [tuple(d.shape) for d in got["port"][2]] == \
        [tuple(d.shape) for d in got["jax"][2]]


def test_image_det_iter_threads_take_the_owners_context(tmp_path):
    rec, _ = _pack_det(tmp_path, n=4)
    seen = []
    real = tdet.augment_det

    def spy(*a, **kw):
        seen.append(str(tmx.current_context()))
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdet, "augment_det", spy)
        it = tdet.ImageDetIter(rec, (3, 16, 16), batch_size=4,
                               preprocess_threads=2)
        batch = it.next()
    assert seen == ["cpu(0)"] * 4
    assert str(batch.data[0].context) == "cpu(0)"
