"""The port's ``gluon.data`` (datasets, samplers, ``DataLoader``, vision
datasets and transforms) and ``gluon.nn.Sequential`` against the JAX
reference, on the CPU.

Every comparison is bitwise: samplers give the reference's indices under
the same ``np.random`` seed; datasets the reference's samples; the
loader the reference's batches in process, on a thread pool and on
spawned worker processes (two spawn tests: each spawn costs seconds);
every transform the reference's pixels under the same ``random`` and
``np.random`` seeds.  ``RandomHue``, ``Rotate`` and ``RandomRotation``
raise "not ported".
"""
import gzip
import os
import pickle
import random

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd, recordio as jrec
from mxnet_tpu.gluon import data as jdata, nn as jgnn
from mxnet_tpu.gluon.data.vision import transforms as JT

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, recordio as trec
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon import data as tdata, nn as tgnn
from mxnet_tpu_torch.gluon.data.vision import transforms as TT

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _same(t, j, what=""):
    """Bitwise equality of nested port / reference samples or batches,
    dtypes included."""
    if isinstance(j, (tuple, list)):
        assert isinstance(t, (tuple, list)) and len(t) == len(j), what
        for a, b in zip(t, j):
            _same(a, b, what)
        return
    tv, jv = _np(t), _np(j)
    assert tv.dtype == jv.dtype, (what, tv.dtype, jv.dtype)
    np.testing.assert_array_equal(tv, jv, err_msg=what)


# -- samplers -----------------------------------------------------------------

_SAMPLERS = {
    "sequential": lambda m: m.SequentialSampler(7, start=3),
    "random": lambda m: m.RandomSampler(11),
    "filter": lambda m: m.FilterSampler(lambda x: x % 3 == 0,
                                        list(range(20))),
    "interval": lambda m: m.IntervalSampler(10, 3),
    "interval_no_rollover": lambda m: m.IntervalSampler(10, 3,
                                                        rollover=False),
    "batch_keep": lambda m: m.BatchSampler(m.RandomSampler(11), 4, "keep"),
    "batch_discard": lambda m: m.BatchSampler(m.SequentialSampler(11), 4,
                                              "discard"),
    "batch_rollover": lambda m: m.BatchSampler(m.RandomSampler(11), 4,
                                               "rollover"),
}


@pytest.mark.parametrize("name", sorted(_SAMPLERS))
def test_sampler_matches_reference(name):
    got = []
    for mod in (tdata, jdata):
        np.random.seed(2)
        s = _SAMPLERS[name](mod)
        got.append([list(s), len(s), list(s), len(s)])
    assert got[0] == got[1]


def test_batch_sampler_refuses_an_unknown_last_batch():
    for mod in (tdata, jdata):
        s = mod.BatchSampler(mod.SequentialSampler(5), 2, "nope")
        with pytest.raises(ValueError, match="last_batch"):
            list(s)


# -- datasets -----------------------------------------------------------------

def _arrays():
    rng = np.random.RandomState(0)
    return rng.randn(10, 3).astype(np.float32), \
        np.arange(10, dtype=np.int32)


def test_dataset_views_match_reference():
    x, y = _arrays()
    views = {
        "array": lambda d: d,
        "filter": lambda d: d.filter(lambda s: s[1] % 2 == 0),
        "shard": lambda d: d.shard(3, 1),
        "take": lambda d: d.take(4),
        "sample": lambda d: d.sample(d_sampler(d)),
        "transform": lambda d: d.transform(lambda a, b: (a * 2, b + 1)),
        "transform_eager": lambda d: d.transform(lambda a, b: (a - 1, b),
                                                 lazy=False),
        "transform_first": lambda d: d.transform_first(lambda a: a ** 2),
    }

    def d_sampler(d):
        return [7, 2, 5]

    for name, view in views.items():
        t = view(tdata.ArrayDataset(x, y))
        j = view(jdata.ArrayDataset(x, y))
        assert len(t) == len(j), name
        for i in range(len(j)):
            _same(t[i], j[i], name)
    t, j = tdata.SimpleDataset(list(range(5))), \
        jdata.SimpleDataset(list(range(5)))
    assert [t[i] for i in range(5)] == [j[i] for i in range(5)]
    _same(tdata.ArrayDataset(tnd.array(y))[3],
          jdata.ArrayDataset(jnd.array(y))[3])


def _write_pack(tmp_path, mod, n=6):
    rng = np.random.RandomState(3)
    prefix = str(tmp_path / "imgs")
    w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = (rng.rand(16, 12, 3) * 255).astype(np.uint8)
        w.write_idx(i, mod.pack_img(mod.IRHeader(0, float(i % 2), i, 0),
                                    img, img_fmt=".png"))
    w.close()
    return prefix + ".rec"


def test_record_file_and_image_record_datasets_match_reference(tmp_path):
    from mxnet_tpu.gluon.data.vision import ImageRecordDataset as JIRD
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset as TIRD
    rec = _write_pack(tmp_path, trec)
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 6
    assert all(t[i] == j[i] for i in range(6))
    t, j = TIRD(rec), JIRD(rec)
    for i in range(6):
        (ti, tl), (ji, jl) = t[i], j[i]
        _same(ti, ji)
        assert tl == jl and isinstance(tl, float)
    t = TIRD(rec, flag=0, transform=lambda im, lab: (im[:4], lab * 2))
    j = JIRD(rec, flag=0, transform=lambda im, lab: (im[:4], lab * 2))
    _same(t[3][0], j[3][0])


def test_synthetic_image_dataset_matches_reference():
    from mxnet_tpu.gluon.data.vision import SyntheticImageDataset as J
    from mxnet_tpu_torch.gluon.data.vision import SyntheticImageDataset as T
    for kw in ({}, {"shape": (8, 6, 3), "num_classes": 4, "seed": 3,
                    "dtype": "float32"}):
        t, j = T(num_samples=20, **kw), J(num_samples=20, **kw)
        assert len(t) == len(j)
        for i in (0, 7, 19):
            _same(t[i], j[i])


def test_mnist_and_cifar_read_local_files_as_the_reference(tmp_path):
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv
    rng = np.random.RandomState(4)
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    for name, arr in (("t10k-images-idx3-ubyte",
                       rng.randint(0, 256, (5, 28, 28))),
                      ("t10k-labels-idx1-ubyte", rng.randint(0, 10, 5))):
        arr = arr.astype(np.uint8)
        head = (0x800 | arr.ndim).to_bytes(4, "big") + b"".join(
            d.to_bytes(4, "big") for d in arr.shape)
        with gzip.open(str(mnist / (name + ".gz")), "wb") as f:
            f.write(head + arr.tobytes())
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    with open(str(cifar / "test_batch"), "wb") as f:
        pickle.dump({"data": rng.randint(0, 256, (4, 3072)),
                     "labels": [1, 2, 3, 4]}, f)
    with open(str(cifar / "test"), "wb") as f:
        pickle.dump({"data": rng.randint(0, 256, (4, 3072)),
                     "fine_labels": [9, 8, 7, 6]}, f)
    pairs = [(tv.MNIST(str(mnist), train=False),
              jv.MNIST(str(mnist), train=False)),
             (tv.FashionMNIST(str(mnist), train=False),
              jv.FashionMNIST(str(mnist), train=False)),
             (tv.CIFAR10(str(cifar), train=False),
              jv.CIFAR10(str(cifar), train=False)),
             (tv.CIFAR100(str(cifar), train=False),
              jv.CIFAR100(str(cifar), train=False))]
    for t, j in pairs:
        assert len(t) == len(j)
        for i in range(len(j)):
            _same(t[i], j[i])
    with pytest.raises(FileNotFoundError, match="no network"):
        tv.MNIST(str(tmp_path / "absent"))


def test_image_folder_dataset_matches_reference(tmp_path):
    from PIL import Image
    from mxnet_tpu.gluon.data.vision import ImageFolderDataset as J
    from mxnet_tpu_torch.gluon.data.vision import ImageFolderDataset as T
    rng = np.random.RandomState(5)
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for i in range(2):
            img = (rng.rand(10, 8, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(str(tmp_path / c / ("%d.jpg" % i)),
                                      quality=90)
        np.save(str(tmp_path / c / "raw.npy"), img)
    t, j = T(str(tmp_path)), J(str(tmp_path))
    assert t.synsets == j.synsets == ["cat", "dog"]
    assert t.items == j.items
    for i in range(len(j)):
        _same(t[i][0], j[i][0])
        assert t[i][1] == j[i][1]


# -- DataLoader ---------------------------------------------------------------

class _SquareDataset:
    """Top-level (picklable) dataset: sample i -> (i^2 row, i)."""

    def __init__(self, n, width=8):
        self.n = n
        self.width = width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        row = np.full((self.width,), float(i * i), np.float32)
        return row, np.float32(i)


def _epoch(loader_cls, dataset, seed, **kw):
    np.random.seed(seed)
    return list(loader_cls(dataset, **kw))


@pytest.mark.parametrize("kw", [
    dict(batch_size=8, shuffle=True),
    dict(batch_size=8, shuffle=True, last_batch="discard"),
    dict(batch_size=8, last_batch="rollover"),
    dict(batch_size=5, num_workers=2, thread_pool=True),
    dict(batch_size=6, pin_memory=True),
])
def test_dataloader_in_process_matches_reference(kw):
    ds = _SquareDataset(37)
    _same(_epoch(tdata.DataLoader, ds, 1, **kw),
          _epoch(jdata.DataLoader, ds, 1, **kw))


def test_dataloader_over_transforms_matches_reference():
    from mxnet_tpu.gluon.data.vision import SyntheticImageDataset as J
    from mxnet_tpu_torch.gluon.data.vision import SyntheticImageDataset as T

    def compose(T_):
        return T_.Compose([T_.RandomFlipLeftRight(), T_.ToTensor(),
                           T_.Normalize((0.485, 0.456, 0.406),
                                        (0.229, 0.224, 0.225))])

    got = []
    for Syn, T_, dl in ((T, TT, tdata), (J, JT, jdata)):
        random.seed(3)
        ds = Syn(num_samples=12, shape=(8, 6, 3)).transform_first(
            compose(T_))
        got.append(_epoch(dl.DataLoader, ds, 2, batch_size=4,
                          shuffle=True))
    _same(*got)
    assert got[0][0][0].shape == (4, 3, 8, 6)


def test_dataloader_thread_pool_runs_in_the_iterating_context():
    def make(i):
        return tnd.full((2,), float(i))      # no ctx: the current context

    loader = tdata.DataLoader(tdata.SimpleDataset(list(range(6))).transform(
        make), batch_size=3, num_workers=2, thread_pool=True)
    batches = list(loader)
    assert [b.context for b in batches] == [tmx.cpu()] * 2
    np.testing.assert_array_equal(batches[1].asnumpy()[:, 0], [3, 4, 5])


def test_dataloader_process_workers_pinned_and_in_order():
    """Spawned workers (pinned to the CPU) give the in-process batches in
    order across two epochs of one pool; ``pin_memory`` assembles them in
    pinned memory where CUDA is present."""
    ds = _SquareDataset(37)
    workers = tdata.DataLoader(ds, batch_size=8, num_workers=2,
                               pin_memory=True)
    try:
        for _ in range(2):
            got = list(workers)
            want = list(jdata.DataLoader(ds, batch_size=8))
            _same(got, want)
            assert all(b.data.is_pinned() == torch.cuda.is_available()
                       for batch in got for b in batch)
    finally:
        workers._shutdown_pool()
    assert workers._mp_pool is None


def test_dataloader_unpicklable_dataset_raises_helpfully():
    base = tdata.ArrayDataset(tnd.array(np.arange(8, dtype=np.float32)))
    ds = base.transform(lambda x: x * 2)        # a lambda does not pickle
    with pytest.raises(RuntimeError, match="picklable"):
        list(tdata.DataLoader(ds, batch_size=4, num_workers=2))
    out = list(tdata.DataLoader(ds, batch_size=4, num_workers=2,
                                thread_pool=True))
    np.testing.assert_allclose(out[0].asnumpy(), [0.0, 2.0, 4.0, 6.0])


def test_dataloader_argument_errors_match_reference():
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="batch_size"):
            mod.DataLoader(_SquareDataset(4))
        with pytest.raises(ValueError, match="shuffle"):
            mod.DataLoader(_SquareDataset(4), batch_size=2, shuffle=True,
                           sampler=mod.SequentialSampler(4))
        with pytest.raises(ValueError, match="batch_sampler"):
            mod.DataLoader(_SquareDataset(4), batch_size=2,
                           batch_sampler=mod.BatchSampler(
                               mod.SequentialSampler(4), 2))
    loader = tdata.DataLoader(_SquareDataset(9), batch_sampler=tdata
                              .BatchSampler(tdata.SequentialSampler(9), 4))
    assert len(loader) == 3


# -- transforms ---------------------------------------------------------------

_TRANSFORMS = {
    "cast": (lambda T: T.Cast("float16"), "u8"),
    "to_tensor": (lambda T: T.ToTensor(), "u8"),
    "to_tensor_batch": (lambda T: T.ToTensor(), "u8_batch"),
    "normalize": (lambda T: T.Normalize((0.1, 0.2, 0.3), (0.5, 0.6, 0.7)),
                  "chw"),
    "resize": (lambda T: T.Resize((11, 7)), "u8"),
    "resize_keep": (lambda T: T.Resize(9, keep_ratio=True), "f32"),
    "center_crop": (lambda T: T.CenterCrop((6, 5)), "u8"),
    "center_crop_up": (lambda T: T.CenterCrop(20), "u8"),
    "crop_resize": (lambda T: T.CropResize(1, 2, 6, 5, size=(4, 4)), "u8"),
    "random_resized_crop": (lambda T: T.RandomResizedCrop(7), "u8"),
    "flip_lr": (lambda T: T.RandomFlipLeftRight(), "u8"),
    "flip_tb": (lambda T: T.RandomFlipTopBottom(0.7), "u8"),
    "brightness": (lambda T: T.RandomBrightness(0.4), "u8"),
    "contrast": (lambda T: T.RandomContrast(0.4), "f32"),
    "saturation": (lambda T: T.RandomSaturation(0.4), "u8"),
    "lighting": (lambda T: T.RandomLighting(0.1), "u8"),
    "color_jitter": (lambda T: T.RandomColorJitter(0.2, 0.3, 0.4), "u8"),
    "gray": (lambda T: T.RandomGray(0.6), "f32"),
    "compose": (lambda T: T.Compose([T.RandomResizedCrop(8),
                                     T.RandomFlipLeftRight(), T.ToTensor(),
                                     T.Normalize(0.5, 0.25)]), "u8"),
}


def _sample(kind, pkg_nd=None):
    rng = np.random.RandomState(12)
    if kind == "u8":
        x = (rng.rand(14, 10, 3) * 255).astype(np.uint8)
    elif kind == "u8_batch":
        x = (rng.rand(2, 14, 10, 3) * 255).astype(np.uint8)
    elif kind == "chw":
        x = rng.rand(3, 6, 5).astype(np.float32)
    else:
        x = rng.rand(14, 10, 3).astype(np.float32)
    return x if pkg_nd is None else pkg_nd.array(x, dtype=x.dtype)


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
@pytest.mark.parametrize("as_ndarray", [False, True])
def test_transform_matches_reference(name, as_ndarray):
    build, kind = _TRANSFORMS[name]
    got = []
    for T_, pkg_nd in ((TT, tnd), (JT, jnd)):
        t = build(T_)
        random.seed(5)
        np.random.seed(5)
        got.append([t(_sample(kind, pkg_nd if as_ndarray else None))
                    for _ in range(3)])
    _same(*got, what=name)


@pytest.mark.parametrize("name,args", [("RandomHue", (0.3,)),
                                       ("Rotate", (90,)),
                                       ("RandomRotation", ((-45, 45),))])
def test_unported_transforms_raise(name, args):
    """The three transforms that raised "not ported" until their ops came
    (ops/image.py, ops/spatial.py) now run: the image's shape and dtype
    as the reference's, and, where no JAX key draws, its values at 1e-4;
    ``zoom_in`` raises as in the reference."""
    img = np.random.RandomState(5).uniform(0, 255, (9, 11, 3)) \
        .astype(np.float32)
    outs = []
    for tf, nd in ((JT, jnd), (TT, tnd)):
        random.seed(2)
        outs.append(getattr(tf, name)(*args)(nd.array(img)).asnumpy())
    assert outs[1].shape == outs[0].shape == img.shape
    assert outs[1].dtype == outs[0].dtype
    if name != "RandomHue":
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4,
                                   atol=1e-4 * 255)
        with pytest.raises(NotImplementedError):
            getattr(TT, name)(*args, zoom_in=True)


# -- nn.Sequential ------------------------------------------------------------

def test_sequential_matches_reference():
    x = np.random.RandomState(7).randn(5, 4).astype(np.float32)
    nets = []
    for m in (jgnn, tgnn):
        net = m.Sequential()
        net.add(m.Dense(6, activation="relu", in_units=4),
                m.Dense(3, in_units=6))
        nets.append(net)
    jnet, tnet = nets
    jnet.initialize()
    params_from_mxnet_tpu({n: p.data().asnumpy()
                           for n, p in jnet.collect_params().items()},
                          net=tnet, device="cpu")
    np.testing.assert_allclose(tnet(tnd.array(x)).asnumpy(),
                               jnet(jnd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-6)
    assert len(tnet) == len(jnet) == 2
    head = tnet[:1]
    assert isinstance(head, tgnn.Sequential) and len(head) == 1
    np.testing.assert_allclose(head(tnd.array(x)).asnumpy(),
                               jnet[:1](jnd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-6)
    assert [type(b).__name__ for b in tnet] == ["Dense", "Dense"]
    assert not isinstance(tgnn.HybridSequential(), tgnn.Sequential)
