"""The port's ``recordio``, ``mx.io`` iterators and ``mx.image`` against the
JAX reference, on the CPU.

Cases mirror ``tests/test_io.py``.  Every comparison is bitwise: records
and ``.rec``/``.idx`` files cross between the packages both ways (native
and pure-Python readers and writers); iterators give the reference's
batches (data, label, pad, descriptors) under the same ``np.random`` seed;
``imdecode`` (the native libjpeg path and PIL's), the crops, resizes and
every augmenter of ``CreateAugmenter`` give the reference's pixels under
the same ``random`` and ``np.random`` seeds.  ``ImageRecordIter`` runs its
random augmenters on one preprocessing thread, since several threads
draw from Python's ``random`` in no fixed order in both packages.
"""
import io as _io
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec, image as jimg, io as jio
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trec, image as timg, io as tio
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

MAGIC = (0xced7230a).to_bytes(4, "little")
PAYLOADS = [b"x", b"hello world", b"", b"z" * 4097, MAGIC,
            b"ab" + MAGIC + b"cd", MAGIC + MAGIC, b"tail" + MAGIC]


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _same(t, j, what=""):
    """Bitwise equality of a port array and a reference array, dtype
    included."""
    tv = t.asnumpy() if hasattr(t, "asnumpy") else np.asarray(t)
    jv = j.asnumpy() if hasattr(j, "asnumpy") else np.asarray(j)
    assert tv.dtype == jv.dtype, (what, tv.dtype, jv.dtype)
    np.testing.assert_array_equal(tv, jv, err_msg=what)


def _read_all(rec):
    out = []
    while True:
        x = rec.read()
        if x is None:
            return out
        out.append(x)


def _python_only(module, monkeypatch):
    monkeypatch.setattr(module, "_LIB", None)
    monkeypatch.setattr(module, "_LIB_TRIED", True)


# -- recordio -----------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port"),
                                           ("port-python", "port")])
def test_recordio_files_cross_between_the_packages(tmp_path, monkeypatch,
                                                   writer, reader):
    path = str(tmp_path / "a.rec")
    if writer == "port-python":
        _python_only(trec, monkeypatch)
    w = (jrec if writer == "ref" else trec).MXRecordIO(path, "w")
    for p in PAYLOADS:
        w.write(p)
    w.close()
    monkeypatch.undo()
    r = (jrec if reader == "ref" else trec).MXRecordIO(path, "r")
    assert _read_all(r) == PAYLOADS
    r.reset()
    assert r.read() == PAYLOADS[0]
    r.close()


def test_native_and_python_writers_write_the_reference_bytes(tmp_path,
                                                            monkeypatch):
    assert trec._get_lib() is not None, "the port's native build failed"
    paths = {k: str(tmp_path / (k + ".rec"))
             for k in ("ref", "native", "python")}
    for key, mod in (("ref", jrec), ("native", trec)):
        w = mod.MXRecordIO(paths[key], "w")
        for p in PAYLOADS:
            w.write(p)
        w.close()
    _python_only(trec, monkeypatch)
    w = trec.MXRecordIO(paths["python"], "w")
    assert w._pyfile is not None
    for p in PAYLOADS:
        w.write(p)
    w.close()
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert blobs["native"] == blobs["ref"] == blobs["python"]
    r = trec.MXRecordIO(paths["native"], "r")      # the python reader
    assert _read_all(r) == PAYLOADS


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_indexed_recordio_crosses_both_ways(tmp_path, writer):
    rec, idx = str(tmp_path / "b.rec"), str(tmp_path / "b.idx")
    wmod, rmod = (jrec, trec) if writer == "ref" else (trec, jrec)
    w = wmod.MXIndexedRecordIO(idx, rec, "w")
    for i in range(10):
        w.write_idx(i, b"rec%03d" % i + MAGIC * (i % 3))
    w.close()
    for mod in (rmod, trec):
        r = mod.MXIndexedRecordIO(idx, rec, "r")
        assert r.keys == list(range(10))
        for i in (7, 0, 9, 3):
            assert r.read_idx(i) == b"rec%03d" % i + MAGIC * (i % 3)
        r.close()


def test_pack_unpack_match_the_reference():
    for header, payload in [(jrec.IRHeader(0, 2.5, 5, 7), b"body"),
                            (jrec.IRHeader(0, [1.0, 2.0, 3.0], 1, 0),
                             b"vec")]:
        theader = trec.IRHeader(*header)
        s = trec.pack(theader, payload)
        assert s == jrec.pack(header, payload)
        th, tp = trec.unpack(s)
        jh, jp = jrec.unpack(s)
        assert tp == jp == payload
        assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
        np.testing.assert_array_equal(th.label, jh.label)


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_unpack_img_match_the_reference(fmt):
    img = (np.random.RandomState(1).rand(24, 16, 3) * 255).astype(np.uint8)
    header = trec.IRHeader(0, 2.0, 5, 0)
    s = trec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img(jrec.IRHeader(*header), img, quality=90,
                              img_fmt=fmt)
    for iscolor in (1, 0):
        (th, tv), (jh, jv) = (trec.unpack_img(s, iscolor),
                              jrec.unpack_img(s, iscolor))
        assert th == jh
        _same(tv, jv)
    if fmt == ".png":
        np.testing.assert_array_equal(trec.unpack_img(s)[1], img)


def _torn(tmp_path, payloads, cut):
    path = str(tmp_path / "torn.rec")
    w = trec.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - cut)
    return path


@pytest.mark.parametrize("native", [True, False])
def test_recordio_truncated_tail_names_uri_and_offset(tmp_path, monkeypatch,
                                                      native):
    path = _torn(tmp_path, [b"alpha", b"beta", b"gamma-payload"], 6)
    if not native:
        _python_only(trec, monkeypatch)
    r = trec.MXRecordIO(path, "r")
    assert r.read() == b"alpha" and r.read() == b"beta"
    tail = r.tell()
    with pytest.raises(OSError) as ei:
        r.read()
    assert path in str(ei.value)
    if not native:          # the reference's python reader says where
        assert "byte offset %d" % tail in str(ei.value)
        assert "truncated" in str(ei.value)
    r.close()


def test_recordio_corrupt_header_detected(tmp_path, monkeypatch):
    _python_only(trec, monkeypatch)
    path = str(tmp_path / "bad.rec")
    w = trec.MXRecordIO(path, "w")
    w.write(b"first")
    w.write(b"second")
    w.close()
    with open(path, "r+b") as f:
        f.seek(-16, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    r = trec.MXRecordIO(path, "r")
    assert r.read() == b"first"
    with pytest.raises(OSError, match="byte offset"):
        r.read()


def test_recordio_tolerate_corrupt_skips_and_counts(tmp_path, monkeypatch):
    _python_only(trec, monkeypatch)
    monkeypatch.setenv("MX_RECORDIO_TOLERATE_CORRUPT", "1")
    path = _torn(tmp_path, [b"keep-1", b"keep-2", b"doomed-payload"], 5)
    r = trec.MXRecordIO(path, "r")
    with pytest.warns(UserWarning, match="skipping"):
        assert _read_all(r) == [b"keep-1", b"keep-2"]
    assert r.corrupt_skipped == 1
    assert r.read() is None and r.corrupt_skipped == 1
    r.reset()
    assert r.read() == b"keep-1" and r.read() == b"keep-2"
    with pytest.warns(UserWarning, match="skipping"):
        assert r.read() is None
    assert r.corrupt_skipped == 2


def test_indexed_recordio_tolerate_survives_one_bad_record(tmp_path,
                                                         monkeypatch):
    _python_only(trec, monkeypatch)
    monkeypatch.setenv("MX_RECORDIO_TOLERATE_CORRUPT", "1")
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(3):
        w.write_idx(i, b"payload-%d" % i)
    w.close()
    r = trec.MXIndexedRecordIO(idx, rec, "r")
    with open(rec, "r+b") as f:
        f.seek(r.idx[1])
        f.write(b"\xde\xad\xbe\xef")
    assert r.read_idx(0) == b"payload-0"
    with pytest.warns(UserWarning, match="skipping"):
        assert r.read_idx(1) is None
    assert r.corrupt_skipped == 1
    assert r.read_idx(2) == b"payload-2" and r.read_idx(0) == b"payload-0"


def test_a_reader_pickles_and_reopens(tmp_path):
    import pickle
    rec, idx = str(tmp_path / "p.rec"), str(tmp_path / "p.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    w.write_idx(0, b"zero")
    with pytest.raises(RuntimeError, match="not picklable"):
        pickle.dumps(w)
    w.close()
    r = pickle.loads(pickle.dumps(trec.MXIndexedRecordIO(idx, rec, "r")))
    assert r.read_idx(0) == b"zero"


# -- mx.io iterators ----------------------------------------------------------

def _batches(it):
    return [(b.data, b.label, b.pad) for b in it]


def _same_batches(tb, jb):
    assert len(tb) == len(jb)
    for k, ((td, tl, tp), (jd, jl, jp)) in enumerate(zip(tb, jb)):
        assert tp == jp, k
        for t, j in zip(td, jd):
            _same(t, j, "data %d" % k)
        for t, j in zip(tl or [], jl or []):
            _same(t, j, "label %d" % k)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_reference(handle, shuffle):
    rng = np.random.RandomState(0)
    X = rng.randn(10, 4).astype(np.float32)
    Y = np.arange(10, dtype=np.float32)
    got = {}
    for name, mod in (("ref", jio), ("port", tio)):
        np.random.seed(3)
        it = mod.NDArrayIter(X, Y, batch_size=3, shuffle=shuffle,
                             last_batch_handle=handle)
        epochs = [_batches(it)]
        it.reset()
        epochs.append(_batches(it))
        got[name] = (epochs, it.provide_data, it.provide_label)
    for te, je in zip(got["port"][0], got["ref"][0]):
        _same_batches(te, je)
    assert got["port"][1:] == got["ref"][1:]


def test_ndarray_iter_dict_inputs_and_descriptors():
    data = {"a": np.zeros((4, 2), np.float32), "b": np.ones((4, 3),
                                                            np.int32)}
    tit, jit = tio.NDArrayIter(data, batch_size=2), \
        jio.NDArrayIter(data, batch_size=2)
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    _same_batches(_batches(tit), _batches(jit))
    assert tio.DataDesc.get_batch_axis("NCHW") == 0
    assert "data shapes" in repr(tio.NDArrayIter(data, batch_size=2).next())


def test_resize_and_prefetching_iter_match_reference():
    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    for size in (2, 5):
        _same_batches(
            _batches(tio.ResizeIter(tio.NDArrayIter(X, batch_size=2), size)),
            _batches(jio.ResizeIter(jio.NDArrayIter(X, batch_size=2), size)))
    tp = tio.PrefetchingIter([tio.NDArrayIter(X, batch_size=2),
                              tio.NDArrayIter(X * 2, batch_size=2)])
    jp = jio.PrefetchingIter([jio.NDArrayIter(X, batch_size=2),
                              jio.NDArrayIter(X * 2, batch_size=2)])
    _same_batches(_batches(tp), _batches(jp))
    tp.reset()
    jp.reset()
    _same_batches(_batches(tp), _batches(jp))
    tp.close()
    jp.close()


def test_prefetching_iter_threads_run_in_the_callers_context():
    """The current context is thread-local: a worker thread made under
    ``with mx.cpu():`` would otherwise default to the GPU."""
    class Made(tio.DataIter):
        def __init__(self):
            super().__init__(batch_size=1)
            self.left = 2

        def next(self):
            if not self.left:
                raise StopIteration
            self.left -= 1
            return tio.DataBatch([tnd.zeros((1,))], [])

    with tio.PrefetchingIter(Made()) as p:
        got = [b.data[0].context for b in p]
    assert got == [tmx.cpu()] * 2


def test_prefetching_iter_lifecycle_and_errors():
    def tiny():
        return tio.NDArrayIter(np.zeros((8, 2), np.float32),
                               np.zeros(8, np.float32), batch_size=4)

    p = tio.PrefetchingIter(tiny())
    assert p.next() is not None
    p.close()
    p.close()
    assert p._pool._shutdown
    for call in (p.next, p.reset):
        with pytest.raises(MXNetError):
            call()
    with tio.PrefetchingIter(tiny()) as p:
        assert sum(1 for _ in p) == 2

    class Boom(tio.DataIter):
        def __init__(self):
            super().__init__(batch_size=4)

        def next(self):
            raise ValueError("kaput")

    p = tio.PrefetchingIter([tiny(), Boom()])
    try:
        with pytest.raises(MXNetError) as ei:
            p.next()
        assert "inner iterator 1" in str(ei.value) and "Boom" in \
            str(ei.value)
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        p.close()


def test_csv_iter_matches_reference(tmp_path):
    rng = np.random.RandomState(2)
    data = rng.rand(7, 3).astype(np.float32)
    labels = np.arange(7, dtype=np.float32)
    dcsv, lcsv = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dcsv, data, delimiter=",")
    np.savetxt(lcsv, labels, delimiter=",")
    for kw in ({"label_csv": lcsv}, {"round_batch": False}):
        _same_batches(
            _batches(tio.CSVIter(data_csv=dcsv, data_shape=(3,),
                                 batch_size=2, **kw)),
            _batches(jio.CSVIter(data_csv=dcsv, data_shape=(3,),
                                 batch_size=2, **kw)))


def _write_idx(tmp_path, images, labels):
    img_path = str(tmp_path / "imgs-idx3-ubyte")
    lab_path = str(tmp_path / "labs-idx1-ubyte")
    n, h, w = images.shape
    with open(img_path, "wb") as f:
        f.write((0x803).to_bytes(4, "big"))
        for dim in (n, h, w):
            f.write(dim.to_bytes(4, "big"))
        f.write(images.astype(np.uint8).tobytes())
    with open(lab_path, "wb") as f:
        f.write((0x801).to_bytes(4, "big"))
        f.write(n.to_bytes(4, "big"))
        f.write(labels.astype(np.uint8).tobytes())
    return img_path, lab_path


@pytest.mark.parametrize("kw", [{"flat": False}, {"flat": True},
                                {"num_parts": 2, "part_index": 1},
                                {"shuffle": True}])
def test_mnist_iter_matches_reference(tmp_path, kw):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (10, 28, 28)).astype(np.uint8)
    labels = (np.arange(10) % 10).astype(np.uint8)
    paths = _write_idx(tmp_path, images, labels)
    got = []
    for mod in (tio, jio):
        np.random.seed(5)
        got.append(_batches(mod.MNISTIter(*paths, batch_size=4, **kw)))
    _same_batches(*got)


def test_libsvm_iter_is_not_ported(tmp_path):
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        f.write("1 0:1.5 3:2.0\n")
    with pytest.raises(MXNetError, match="not ported"):
        tio.LibSVMIter(data_libsvm=path, data_shape=(5,), batch_size=1)


def _pack(tmp_path, n=12, size=(32, 40), fmt=".jpg"):
    """An indexed .rec of seeded noisy images written by the port."""
    rng = np.random.RandomState(11)
    prefix = str(tmp_path / "pack")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = (rng.rand(size[0], size[1], 3) * 255).astype(np.uint8)
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 3), i, 0),
                                     img, quality=90, img_fmt=fmt))
    w.close()
    return prefix + ".rec"


_RECORD_ITER_CASES = {
    "center": dict(data_shape=(3, 28, 28), batch_size=4,
                   preprocess_threads=2),
    "augment": dict(data_shape=(3, 24, 24), batch_size=5, shuffle=True,
                    rand_crop=True, rand_mirror=True, mean_r=123.0,
                    mean_g=116.0, mean_b=103.0, std_r=58.0, std_g=57.0,
                    std_b=57.5, seed=4, preprocess_threads=1),
    "resize": dict(data_shape=(3, 20, 20), batch_size=4, resize=24,
                   rand_crop=True, rand_resize=True, shuffle=True, seed=2,
                   preprocess_threads=1, round_batch=False),
    "shard": dict(data_shape=(3, 32, 32), batch_size=2, num_parts=2,
                  part_index=1),
}


@pytest.mark.parametrize("case", sorted(_RECORD_ITER_CASES))
def test_image_record_iter_matches_reference(tmp_path, case):
    rec = _pack(tmp_path)
    got = []
    for mod in (tio, jio):
        random.seed(9)
        it = mod.ImageRecordIter(path_imgrec=rec,
                                 **_RECORD_ITER_CASES[case])
        epochs = _batches(it)
        it.reset()
        got.append(epochs + _batches(it))
    _same_batches(*got)


def test_image_record_uint8_iter_matches_reference(tmp_path):
    rec = _pack(tmp_path, n=8)
    got = [_batches(mod.ImageRecordUInt8Iter(path_imgrec=rec,
                                             data_shape=(3, 28, 28),
                                             batch_size=4))
           for mod in (tio, jio)]
    _same_batches(*got)
    assert str(got[0][0][0][0].dtype) == "uint8"
    with pytest.raises(MXNetError):
        tio.ImageRecordUInt8Iter(path_imgrec=rec, data_shape=(3, 28, 28),
                                 batch_size=4, mean_r=123.0)


# -- mx.image -----------------------------------------------------------------

def _encoded(fmt, shape=(40, 30, 3), seed=0):
    from PIL import Image
    img = (np.random.RandomState(seed).rand(*shape) * 255).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, quality=92) \
        if fmt == "JPEG" else Image.fromarray(img).save(buf, format=fmt)
    return img, buf.getvalue()


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_imdecode_matches_reference(fmt, tmp_path):
    img, blob = _encoded(fmt)
    for kw in ({}, {"flag": 0}, {"to_rgb": 0}):
        _same(timg.imdecode(blob, **kw), jimg.imdecode(blob, **kw), kw)
    if fmt == "PNG":
        np.testing.assert_array_equal(timg.imdecode(blob).asnumpy(), img)
    path = str(tmp_path / "x.img")
    with open(path, "wb") as f:
        f.write(blob)
    _same(timg.imread(path), jimg.imread(path))


def test_native_jpeg_decoder_matches_pil():
    from PIL import Image
    assert timg._native_jpeg() is not None, "the port's native build failed"
    _, jpeg = _encoded("JPEG", (32, 48, 3))
    nat = timg._imdecode_native(jpeg, 1)
    pil = np.asarray(Image.open(_io.BytesIO(jpeg)).convert("RGB"))
    np.testing.assert_array_equal(nat, pil)
    assert timg._imdecode_native(jpeg, 0).shape[2] in (1, 3)
    assert timg._imdecode_native(b"\xff\xd8not-a-real-jpeg" * 3, 1) is None
    _, png = _encoded("PNG", (32, 48, 3))
    assert timg._imdecode_native(png, 1) is None


def test_image_functions_match_reference():
    img, _ = _encoded("PNG", (40, 30, 3), seed=3)
    src_t, src_j = tnd.array(img, dtype="uint8"), jnd.array(img,
                                                             dtype="uint8")
    for name, args in [("imresize", (15, 20)), ("imresize", (17, 9, 0)),
                       ("resize_short", (16,)), ("fixed_crop",
                                                 (3, 4, 10, 12)),
                       ("fixed_crop", (3, 4, 10, 12, (8, 8))),
                       ("copyMakeBorder", (1, 2, 3, 4)),
                       ("imrotate", (30.0,))]:
        _same(getattr(timg, name)(src_t, *args),
              getattr(jimg, name)(src_j, *args), name)
    for name, args in [("center_crop", ((8, 8),)),
                       ("random_crop", ((8, 10),)),
                       ("random_size_crop", ((12, 12), 0.3, (0.75, 1.33)))]:
        random.seed(4)
        tout, trect = getattr(timg, name)(src_t, *args)
        random.seed(4)
        jout, jrect = getattr(jimg, name)(src_j, *args)
        _same(tout, jout, name)
        assert trect == jrect
    mean, std = np.array([1.0, 2.0, 3.0]), np.array([2.0, 2.0, 2.0])
    _same(timg.color_normalize(src_t, mean, std),
          jimg.color_normalize(src_j, mean, std))
    for args in [((640, 480), (720, 120)), ((360, 1000), (480, 500))]:
        assert timg.scale_down(*args) == jimg.scale_down(*args)
    assert timg.ImageIter is tio.ImageRecordIter
    from mxnet_tpu_torch.image import detection
    assert timg.ImageDetIter is detection.ImageDetIter


_AUGMENTERS = {
    "crop_mirror": dict(resize=16, rand_crop=True, rand_mirror=True,
                        mean=True, std=True),
    "resized_crop": dict(rand_crop=True, rand_resize=True),
    "color": dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.1),
    "pca_gray": dict(pca_noise=0.1, rand_gray=0.5, rand_mirror=True),
}


@pytest.mark.parametrize("case", sorted(_AUGMENTERS))
def test_create_augmenter_chain_matches_reference(case):
    img, _ = _encoded("PNG", (40, 30, 3), seed=6)
    outs = []
    for mod, pkg_nd in ((timg, tnd), (jimg, jnd)):
        augs = mod.CreateAugmenter(data_shape=(3, 12, 12), **_AUGMENTERS[case])
        random.seed(8)
        np.random.seed(8)
        got = []
        for _ in range(4):
            out = pkg_nd.array(img, dtype="uint8")
            for a in augs:
                out = a(out)
            got.append(out)
        outs.append((got, [a.dumps() for a in augs]))
    for t, j in zip(outs[0][0], outs[1][0]):
        _same(t, j, case)
    assert outs[0][1] == outs[1][1]
