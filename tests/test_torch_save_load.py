"""``nd.save`` / ``nd.load`` and the gluon parameter files of the port
against the JAX reference, on the CPU.

* ``nd.save_bytes`` gives the reference's bytes exactly for every
  mshadow type flag 0-12 (bfloat16 as its 16-bit patterns), a 0-d array,
  an empty array, an empty list, a list and a dict; a file of either
  package loads bitwise in the other; the V1 magic loads; a sparse
  storage type raises, naming Queue 1 item 8; a loaded array lands on the
  current context.
* ``Block.save_parameters`` / ``load_parameters`` across the packages: a
  two-layer, 64-unit BERT and a ``resnet18_v1`` whose BatchNorm running
  statistics are drawn away from their initial values, saved by one
  package and loaded
  by the other, give the same forward within 1e-4 (fp32).  A file of
  parameters with copies on ``[cpu(0), cpu(1)]`` is byte for byte the
  reference's (the mean of the copies); ``deduplicate`` over shared
  parameters, ``allow_missing``, ``ignore_extra`` (the reference's
  ``AssertionError`` texts), ``cast_dtype`` with both ``dtype_source``s,
  ``ParameterDict.save`` / ``load`` with their prefixes,
  ``Servable.from_block``, ``Block.params`` and ``Block.summary``.
"""
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.serve import Servable

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
FLAGS = ["float32", "float64", "float16", "uint8", "int32", "int8", "int64",
         "bool", "int16", "uint16", "uint32", "uint64", "bfloat16"]
#: the types the reference's arrays cannot hold (JAX without x64)
WIDE = {"float64", "int64", "uint64"}
SHAPES = [(), (0,), (3,), (2, 3, 5)]


class _Host:
    """A host array the reference's writer takes as it takes an NDArray
    (it reads ``asnumpy()``): the way to give it the types its own arrays
    narrow."""

    def __init__(self, a):
        self.a = a

    def asnumpy(self):
        return self.a


def _host_values(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    x = (np.asarray(rng.randn(*shape)) * 50).astype(np.float32)
    if dtype == "bool":
        return np.asarray(x > 0)
    if dtype.startswith("u"):
        x = np.abs(x)
    return np.asarray(x.astype(np.float32 if dtype == "bfloat16" else dtype))


def _pair(dtype, shape, seed=0):
    """The same array in the reference (an NDArray, or a host array for a
    wide type) and in the port (an NDArray over a tensor of the type)."""
    x = _host_values(dtype, shape, seed)
    if dtype in WIDE:
        return _Host(x), tmx.nd.NDArray(torch.from_numpy(x.copy()))
    return (jmx.nd.array(x, dtype=dtype, ctx=jmx.cpu()),
            tmx.nd.array(x, dtype=dtype, ctx=tmx.cpu()))


def _bits(a):
    """An NDArray's values as comparable host bits (bf16 as float32)."""
    return np.asarray(a.asnumpy(), dtype=None if str(a.dtype) != "bfloat16"
                      else np.float32)


@pytest.mark.parametrize("dtype", FLAGS)
def test_save_bytes_is_the_reference_bytes_for_every_flag(dtype):
    for i, shape in enumerate(SHAPES):
        j, t = _pair(dtype, shape, i)
        want = jmx.nd.save_bytes({"a": j, "b": j})
        assert tmx.nd.save_bytes({"a": t, "b": t}) == want, shape
        assert tmx.nd.save_bytes([t]) == jmx.nd.save_bytes([j]), shape
        flag = struct.unpack_from("<i", want, 24 + 12 + 4 * len(shape) + 8)
        assert flag[0] == FLAGS.index(dtype)


@pytest.mark.parametrize("dtype", FLAGS)
def test_a_file_of_either_package_loads_bitwise_in_the_other(dtype):
    for i, shape in enumerate(SHAPES):
        j, t = _pair(dtype, shape, i)
        with tmx.cpu():
            got = tmx.nd.load_bytes(jmx.nd.save_bytes([j]))[0]
        want = tmx.nd.array(_host_values(dtype, shape, i), dtype=dtype,
                            ctx=tmx.cpu())
        # the port keeps float64 and narrows (u)int64 as its arrays do
        assert str(got.dtype) == ("float64" if dtype == "float64"
                                  else str(want.dtype))
        np.testing.assert_array_equal(got.asnumpy(),
                                      j.asnumpy().astype(got.asnumpy().dtype))
        if dtype in WIDE:
            continue
        back = jmx.nd.load_bytes(tmx.nd.save_bytes([t]))[0]
        assert str(back.dtype) == str(j.dtype)
        np.testing.assert_array_equal(_bits(back), _bits(j))


def test_empty_list_list_and_dict_round_trip():
    assert tmx.nd.save_bytes([]) == jmx.nd.save_bytes([])
    assert tmx.nd.load_bytes(tmx.nd.save_bytes([])) == []
    arrays = [_pair("float32", (2, 2), s) for s in range(3)]
    lst = tmx.nd.save_bytes([t for _, t in arrays])
    assert lst == jmx.nd.save_bytes([j for j, _ in arrays])
    keys = ["zeta", "alpha", "mid"]              # key order, not sorted
    dct = tmx.nd.save_bytes(dict(zip(keys, [t for _, t in arrays])))
    assert dct == jmx.nd.save_bytes(dict(zip(keys, [j for j, _ in arrays])))
    with tmx.cpu():
        got_list = tmx.nd.load_bytes(lst)
        got_dict = tmx.nd.load_bytes(dct)
        got_one = tmx.nd.load_bytes(tmx.nd.save_bytes(arrays[0][1]))
    assert list(got_dict) == keys
    for (_, t), a, k in zip(arrays, got_list, keys):
        np.testing.assert_array_equal(a.asnumpy(), t.asnumpy())
        np.testing.assert_array_equal(got_dict[k].asnumpy(), t.asnumpy())
    assert len(got_one) == 1


def test_the_v1_magic_loads_in_both():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    raw = struct.pack("<QQQ", 0x112, 0, 1) + struct.pack(
        "<IIIIiii", 0xF993FAC8, 2, 2, 3, 1, 0, 0) + x.tobytes() + \
        struct.pack("<Q", 0)
    with tmx.cpu():
        got = tmx.nd.load_bytes(raw)[0]
    np.testing.assert_array_equal(got.asnumpy(), x)
    np.testing.assert_array_equal(jmx.nd.load_bytes(raw)[0].asnumpy(), x)


@pytest.mark.parametrize("stype", [1, 2])
def test_a_sparse_array_in_a_file_raises_naming_item_8(stype):
    raw = struct.pack("<QQQ", 0x112, 0, 1) + struct.pack(
        "<Ii", 0xF993FAC9, stype) + b"\0" * 64
    with pytest.raises(tmx.MXNetError, match="Queue 1 item 8"):
        tmx.nd.load_bytes(raw)


def test_a_loaded_array_lands_on_the_current_context(tmp_path):
    fname = str(tmp_path / "a.nd")
    a = tmx.nd.array(np.ones((2, 2), np.float32), ctx=tmx.cpu())
    a.save(fname)
    with tmx.cpu(1):
        got = tmx.nd.load(fname)[0]
    assert got.context == tmx.cpu(1)
    jmx.nd.save(str(tmp_path / "j.nd"), jmx.nd.ones((2, 2)))
    assert open(fname, "rb").read() == open(str(tmp_path / "j.nd"),
                                            "rb").read()


# ---------------------------------------------------------------------------
# the gluon parameter files
# ---------------------------------------------------------------------------

BERT_CFG = dict(vocab_size=100, max_length=32, dropout=0.0)
B, T = 2, 32


def _bert_inputs():
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 100, size=(B, T)).astype(np.int32)
    types = (np.arange(T)[None, :] >= 20).astype(np.int32).repeat(B, 0)
    return tokens, types


def _outputs(pkg, net, *inputs):
    with pkg.cpu():
        out = net(*[pkg.nd.array(x, dtype=x.dtype, ctx=pkg.cpu())
                    for x in inputs])
    out = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in out]


def _assert_outputs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_bert_parameters_cross_both_ways(tmp_path):
    tokens, types = _bert_inputs()
    jnet = jbert.get_bert(2, 64, 1, **BERT_CFG)
    jnet.initialize(jmx.init.Normal(0.02), ctx=jmx.cpu())
    want = _outputs(jmx, jnet, tokens, types)
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet = tbert.get_bert(2, 64, 1, **BERT_CFG)
    tnet.load_parameters(str(tmp_path / "j.params"), ctx=tmx.cpu())
    _assert_outputs_close(_outputs(tmx, tnet, tokens, types), want)

    tnet2 = tbert.get_bert(2, 64, 1, **BERT_CFG)
    tnet2.initialize(tmx.init.Normal(0.02), ctx=tmx.cpu(), seed=3)
    want2 = _outputs(tmx, tnet2, tokens, types)
    tnet2.save_parameters(str(tmp_path / "t.params"))
    jnet2 = jbert.get_bert(2, 64, 1, **BERT_CFG)
    jnet2.initialize(ctx=jmx.cpu())
    _outputs(jmx, jnet2, tokens, types)         # the deferred sizes
    jnet2.load_parameters(str(tmp_path / "t.params"), ctx=jmx.cpu())
    _assert_outputs_close(_outputs(jmx, jnet2, tokens, types), want2)


def _moved_statistics(pkg, net, seed):
    """BatchNorm's running statistics away from their initial values
    (drawn with numpy; a training forward would compile every op of the
    reference twice)."""
    rng = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        if "running_" in name:
            p.set_data(pkg.nd.array(0.5 + rng.rand(*p.shape).astype(
                np.float32), ctx=pkg.cpu()))


def test_resnet18_parameters_cross_both_ways(tmp_path):
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    jnet = jvision.resnet18_v1(classes=10)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    _outputs(jmx, jnet, x)                      # the deferred sizes
    _moved_statistics(jmx, jnet, 2)
    want = _outputs(jmx, jnet, x)
    jnet.save_parameters(str(tmp_path / "j.params"))
    tnet = tvision.resnet18_v1(classes=10)
    tnet.load_parameters(str(tmp_path / "j.params"), ctx=tmx.cpu())
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    mean = tnet.collect_params()["features.1.running_mean"].data()
    assert np.abs(mean.asnumpy()).max() > 0
    _assert_outputs_close(_outputs(tmx, tnet, x), want)

    tnet2 = tvision.resnet18_v1(classes=10)
    tnet2.initialize(tmx.init.Xavier(), ctx=tmx.cpu(), seed=5)
    _moved_statistics(tmx, tnet2, 3)
    want2 = _outputs(tmx, tnet2, x)
    tnet2.save_parameters(str(tmp_path / "t.params"))
    jnet2 = jvision.resnet18_v1(classes=10)
    jnet2.load_parameters(str(tmp_path / "t.params"), ctx=jmx.cpu())
    _assert_outputs_close(_outputs(jmx, jnet2, x), want2)


def _mlp(pkg, shared=False):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4, in_units=4), pkg.gluon.nn.Dense(4,
                                                                  in_units=4),
            pkg.gluon.nn.Dense(2, in_units=4))
    if shared:
        net[1].share_parameters(net[0].collect_params())
    return net


def _fill(pkg, net, seed=0, ctx=None):
    """Initialise on ``ctx`` and give every copy of every parameter
    values from numpy (copy k: the values plus k)."""
    net.initialize(ctx=ctx or pkg.cpu())
    rng = np.random.RandomState(seed)
    seen = set()
    for p in net.collect_params().values():
        if id(p) in seen:       # a shared parameter, under a second name
            continue
        seen.add(id(p))
        base = rng.randn(*p.shape).astype(np.float32)
        for k, d in enumerate(p.list_data()):
            d[:] = pkg.nd.array(base + k, ctx=d.context)
    return net


@pytest.mark.parametrize("dedup", [False, True])
def test_shared_parameters_and_deduplicate(tmp_path, dedup):
    files = []
    for pkg, tag in ((jmx, "j"), (tmx, "t")):
        net = _fill(pkg, _mlp(pkg, shared=True))
        fname = str(tmp_path / ("%s.params" % tag))
        net.save_parameters(fname, deduplicate=dedup)
        files.append(open(fname, "rb").read())
    assert files[0] == files[1]
    with tmx.cpu():
        keys = list(tmx.nd.load(fname))
    assert keys == (["0.weight", "0.bias", "2.weight", "2.bias"] if dedup
                    else ["0.weight", "0.bias", "1.weight", "1.bias",
                          "2.weight", "2.bias"])
    fresh = _mlp(tmx, shared=True)
    fresh.load_parameters(fname, ctx=tmx.cpu(), allow_missing=dedup)
    src = _fill(tmx, _mlp(tmx, shared=True))
    for name, p in src.collect_params().items():
        np.testing.assert_array_equal(
            fresh.collect_params()[name].data().asnumpy(),
            p.data().asnumpy())
    assert fresh[1].weight is fresh[0].weight


def test_copies_are_saved_as_their_mean_and_loaded_into_each(tmp_path):
    files = []
    for pkg, tag in ((jmx, "j"), (tmx, "t")):
        net = _fill(pkg, _mlp(pkg), ctx=[pkg.cpu(0), pkg.cpu(1)])
        fname = str(tmp_path / ("%s.params" % tag))
        net.save_parameters(fname)
        files.append(open(fname, "rb").read())
    assert files[0] == files[1]
    net = _mlp(tmx)
    net.initialize(ctx=[tmx.cpu(0), tmx.cpu(1)])
    net.load_parameters(fname)
    with tmx.cpu():
        saved = tmx.nd.load(fname)
    for name, p in net.collect_params().items():
        for d in p.list_data():
            np.testing.assert_array_equal(d.asnumpy(),
                                          saved[name].asnumpy())


def _assertion_text(fn):
    with pytest.raises(AssertionError) as e:
        fn()
    return str(e.value)


def test_missing_and_extra_names(tmp_path):
    small = {"0.weight": np.ones((4, 4), np.float32)}
    big = {n: np.ones(s, np.float32) for n, s in [
        ("0.weight", (4, 4)), ("0.bias", (4,)), ("1.weight", (4, 4)),
        ("1.bias", (4,)), ("2.weight", (2, 4)), ("2.bias", (2,)),
        ("9.weight", (1,))]}
    texts = []
    for pkg in (jmx, tmx):
        ctx = pkg.cpu()
        for tag, arrays in (("small", small), ("big", big)):
            pkg.nd.save(str(tmp_path / tag), {
                k: pkg.nd.array(v, ctx=ctx) for k, v in arrays.items()})
        net = _mlp(pkg)
        net.initialize(ctx=ctx)
        texts.append(_assertion_text(lambda: net.load_parameters(
            str(tmp_path / "small"), ctx=ctx)))
        texts.append(_assertion_text(lambda: net.load_parameters(
            str(tmp_path / "big"), ctx=ctx)))
        net.load_parameters(str(tmp_path / "small"), ctx=ctx,
                            allow_missing=True)
        net.load_parameters(str(tmp_path / "big"), ctx=ctx,
                            ignore_extra=True)
        assert (net[2].bias.data().asnumpy() == 1).all()
    assert texts[:2] == texts[2:]
    assert "allow_missing=True" in texts[0] and "ignore_extra" in texts[1]


@pytest.mark.parametrize("source", ["current", "saved"])
def test_cast_dtype(tmp_path, source):
    got = []
    for pkg in (jmx, tmx):
        src = _fill(pkg, _mlp(pkg))
        if source == "saved":
            src.cast("float16")
        fname = str(tmp_path / "m.params")
        src.save_parameters(fname)
        net = _mlp(pkg)
        net.initialize(ctx=pkg.cpu())
        if source == "current":
            net.cast("float16")
        net.load_parameters(fname, ctx=pkg.cpu(), cast_dtype=True,
                            dtype_source=source)
        got.append({n: (str(p.data().dtype), p.data().asnumpy())
                    for n, p in net.collect_params().items()})
    for name, (dtype, value) in got[0].items():
        assert got[1][name][0] == dtype == "float16"
        np.testing.assert_array_equal(got[1][name][1], value)


def test_parameter_dict_save_and_load_with_prefixes(tmp_path):
    files = []
    for pkg, tag in ((jmx, "j"), (tmx, "t")):
        net = _fill(pkg, _mlp(pkg))
        fname = str(tmp_path / ("%s.params" % tag))
        net.collect_params().save(fname, strip_prefix="0.")
        files.append(open(fname, "rb").read())
    assert files[0] == files[1]
    with tmx.cpu():
        assert list(tmx.nd.load(fname))[:2] == ["weight", "bias"]
    net = _mlp(tmx)
    params = net.collect_params("^0")
    params.load(fname, ctx=tmx.cpu(), restore_prefix="0.",
                ignore_extra=True)
    src = _fill(tmx, _mlp(tmx))
    np.testing.assert_array_equal(net[0].weight.data().asnumpy(),
                                  src[0].weight.data().asnumpy())


def test_servable_from_block_serves_the_loaded_parameters(tmp_path):
    src = _fill(tmx, _mlp(tmx))
    fname = str(tmp_path / "m.params")
    src.save_parameters(fname)
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    sv = Servable.from_block(_mlp(tmx), fname, ctx=tmx.cpu(), device="cpu")
    got = sv.to_host(sv.dispatch(2, [x]))[0]
    with torch.inference_mode():
        want = src(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(tmx.MXNetError, match="Queue 1 item 8"):
        Servable.from_checkpoint("model")


def test_block_params_and_summary(capsys):
    printed = []
    for pkg in (jmx, tmx):
        net = _mlp(pkg)
        net.initialize(ctx=pkg.cpu())
        assert list(net[0].params.keys()) == ["weight", "bias"]
        net.summary()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "Total params: %d" % (16 + 4 + 16 + 4 + 8 + 2) in printed[1]


def test_a_parameter_of_unknown_shape_takes_the_file_s(tmp_path):
    src = jmx.gluon.nn.Dense(4, in_units=3)
    src.initialize(ctx=jmx.cpu())
    fname = str(tmp_path / "d.params")
    src.save_parameters(fname)
    net = tmx.gluon.nn.Dense(4)                 # in_units deferred
    net.load_parameters(fname, ctx=tmx.cpu())
    assert net.weight.shape == (4, 3)
    np.testing.assert_array_equal(net.weight.data().asnumpy(),
                                  src.weight.data().asnumpy())
    x = np.ones((2, 3), np.float32)
    _assert_outputs_close(_outputs(tmx, net, x), _outputs(jmx, src, x))


def test_arg_and_aux_prefixes_are_dropped(tmp_path):
    """A file keyed as the symbolic era wrote it (``arg:`` / ``aux:``)
    loads by the names after the prefix, in both packages."""
    values = {"arg:0.weight": np.full((4, 4), 2.0, np.float32),
              "aux:2.bias": np.full((2,), 3.0, np.float32)}
    for pkg in (jmx, tmx):
        fname = str(tmp_path / "p.params")
        pkg.nd.save(fname, {k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in values.items()})
        net = _mlp(pkg)
        net.initialize(ctx=pkg.cpu())
        net.load_parameters(fname, ctx=pkg.cpu(), allow_missing=True)
        assert (net[0].weight.data().asnumpy() == 2).all()
        assert (net[2].bias.data().asnumpy() == 3).all()
