"""The port's NDArray and op registry (``mxnet_tpu_torch.nd``) against the
JAX reference (``mxnet_tpu.nd``), on the CPU.

The cases of ``tests/test_ndarray.py`` that this slice covers (all but
save/load, dlpack and the engine modes) are written once as functions of a
package's ``(mx, nd)`` and run on both, from the same numpy inputs; the
port runs under ``with mx.cpu():`` because its default context is the GPU.
Outputs are compared at rtol 1e-6 (fp32).  Cases that repeat each other
are parametrised.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke

RTOL = 1e-6
PACKAGES = {"jax": (jmx, jnd, jinvoke), "port": (tmx, tnd, tinvoke)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def both(case, *args):
    """``case(mx, nd, invoke, *args)`` on each package; its results (numpy
    arrays, numbers, tuples) as {'jax': ..., 'port': ...}."""
    return {name: case(*pkg, *args) for name, pkg in PACKAGES.items()}


def assert_same(got, rtol=RTOL):
    j, t = got["jax"], got["port"]
    assert len(j) == len(t)
    for a, b in zip(j, t):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, (a.shape, b.shape)
            np.testing.assert_allclose(b, a, rtol=rtol)
        else:
            assert a == b, (a, b)


def _np(x):
    return x.asnumpy()


# ---------------------------------------------------------------------------
# creation, context, dtype
# ---------------------------------------------------------------------------

def test_creation_basics():
    def case(mx, nd, invoke):
        a = nd.zeros((2, 3))
        b = nd.ones((4,), dtype="int32")
        c = nd.array([[1, 2], [3, 4]])
        d = nd.full((2, 2), 7.5)
        e = nd.arange(0, 10, 2)
        return [a.shape, str(a.dtype), str(b.dtype), str(c.dtype), _np(a),
                _np(b), _np(c), _np(d), _np(e), str(e.dtype)]
    got = both(case)
    assert_same(got)
    assert got["port"][3] == "float32"       # python lists -> float32


def test_context_placement():
    t = tnd.zeros((2, 2), ctx=tmx.cpu())
    assert t.context == tmx.cpu() and t.data.device.type == "cpu"
    h = t.as_in_context(tmx.cpu())
    assert h is t and h.context == tmx.cpu()
    c = t.copyto(tmx.cpu())
    assert c is not t and c.context == tmx.cpu()
    np.testing.assert_array_equal(c.asnumpy(), t.asnumpy())
    assert tmx.gpu(0) == tmx.Context("gpu", 0) != tmx.cpu()
    assert str(tmx.gpu(1)) == "gpu(1)"
    assert tmx.gpu(1).torch_device == torch.device("cuda", 1)


def test_default_context_is_the_gpu_and_a_scope_sets_it():
    with tmx.gpu(0):
        assert tmx.current_context() == tmx.gpu(0)
        with tmx.cpu():
            assert tmx.current_context() == tmx.cpu()
            assert tnd.ones((2,)).context == tmx.cpu()
        assert tmx.current_context() == tmx.gpu(0)
        if not torch.cuda.is_available():
            # the GPU by default, and no silent move to the CPU
            with pytest.raises(MXNetError, match="cuda"):
                tnd.zeros((2, 2))
            with pytest.raises(MXNetError, match="cuda"):
                tnd.array([1.0])
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="cuda"):
            tnd.ones((2,), ctx=tmx.gpu(0))


def test_device_resolve_accepts_contexts_and_strings():
    from mxnet_tpu_torch.device import resolve
    assert resolve(tmx.cpu()) == torch.device("cpu")
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    assert resolve(None) == torch.device("cpu")     # inside the fixture
    with pytest.raises(MXNetError, match="unknown device type"):
        tmx.Context("tpu", 0)


@pytest.mark.parametrize("src, dtype", [
    (np.arange(6, dtype=np.int32), None),
    (np.arange(6, dtype=np.float64), None),
    (np.arange(6, dtype=np.float32), "float16"),
    ([1.5, 2.5], "int32"),
    ([[1, 2]], None),
])
def test_array_dtypes(src, dtype):
    def case(mx, nd, invoke):
        a = nd.array(src, dtype=dtype)
        return [str(a.dtype), _np(a)]
    assert_same(both(case))


# ---------------------------------------------------------------------------
# arithmetic, in place, comparisons
# ---------------------------------------------------------------------------

A = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
B = np.array([10.0, 20.0], np.float32)

BINARY = {
    "add": lambda a, b: a + b,
    "radd": lambda a, b: 3 + a,
    "sub": lambda a, b: a - b,
    "rsub": lambda a, b: 1.5 - a,
    "mul_scalar": lambda a, b: a * 2,
    "rmul": lambda a, b: 2 * a,
    "div": lambda a, b: a / b,
    "rdiv": lambda a, b: 1.0 / a,
    "pow_scalar": lambda a, b: a ** 2,
    "rpow": lambda a, b: 2.0 ** a,
    "pow": lambda a, b: a ** (b / 10),
    "mod": lambda a, b: a % 3,
    "neg": lambda a, b: -a,
    "abs": lambda a, b: abs(-a),
    "eq": lambda a, b: a == a,
    "ne": lambda a, b: a != 2.0,
    "gt": lambda a, b: a > 2.0,
    "ge": lambda a, b: a >= b / 5,
    "lt": lambda a, b: a < 3.0,
    "le": lambda a, b: a <= 3.0,
    "matmul": lambda a, b: a @ a,
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_arithmetic_and_broadcast(op):
    def case(mx, nd, invoke):
        out = BINARY[op](nd.array(A), nd.array(B))
        return [_np(out), str(out.dtype)]
    assert_same(both(case))


def test_int_arithmetic_takes_the_array_type():
    def case(mx, nd, invoke):
        a = nd.array(np.array([1, 2, 3], np.int32))
        return [_np(a * 2.5), str((a * 2.5).dtype), _np(a + 1),
                _np(a == 2), str((a == 2).dtype)]
    assert_same(both(case))


@pytest.mark.parametrize("op, want", [
    ("+=", [3, 3, 3]), ("*=", [2, 2, 2]), ("/=", [0.5, 0.5, 0.5]),
    ("-=", [-1, -1, -1])])
def test_inplace_ops(op, want):
    def case(mx, nd, invoke):
        a = nd.ones((3,))
        view = a[0:2]
        if op == "+=":
            a += 2
        elif op == "*=":
            a *= 2
        elif op == "/=":
            a /= 2
        else:
            a -= 2
        return [_np(a), _np(view)]
    got = both(case)
    assert_same(got)
    np.testing.assert_array_equal(got["port"][0], want)


def test_inplace_with_array_operand():
    def case(mx, nd, invoke):
        a = nd.array(A)
        a += nd.array(B)
        a *= a
        return [_np(a)]
    assert_same(both(case))


# ---------------------------------------------------------------------------
# indexing and views
# ---------------------------------------------------------------------------

def test_setitem_full_and_partial():
    def case(mx, nd, invoke):
        a = nd.zeros((3, 4))
        a[:] = 5
        out = [_np(a)]
        a[1] = 7
        a[0, 2] = -1
        a[:, 1] = nd.array([9.0, 9.0, 9.0])
        a[2, 1:3] = np.array([4.0, 6.0], np.float32)
        return out + [_np(a)]
    assert_same(both(case))


def test_slice_is_view():
    def case(mx, nd, invoke):
        a = nd.zeros((4, 4))
        v = a[1:3]
        v[:] = 3.0
        out = [_np(a)]
        v2 = v[0]
        v2[:] = 5.0
        out.append(_np(a))
        a[:] = 1.0
        return out + [_np(v), _np(v2)]
    got = both(case)
    assert_same(got)
    expected = np.zeros((4, 4))
    expected[1:3] = 3.0
    expected[1] = 5.0
    np.testing.assert_array_equal(got["port"][1], expected)


def test_reshape_view_writes_through():
    def case(mx, nd, invoke):
        a = nd.zeros((2, 6))
        r = a.reshape((3, 4))
        r[:] = 2.0
        return [_np(a), a.reshape((-1,)).shape, a.reshape((0, 3, 2)).shape,
                a.reshape(4, -1).shape]
    got = both(case)
    assert_same(got)
    np.testing.assert_array_equal(got["port"][0], np.full((2, 6), 2.0))


def test_advanced_indexing_is_copy():
    def case(mx, nd, invoke):
        a = nd.array(np.arange(12).reshape(3, 4).astype(np.float32))
        picked = a[nd.array([0, 2], dtype="int32")]
        first = _np(picked)
        picked[:] = -1
        return [first, _np(a), _np(a[np.array([2, 1])])]
    got = both(case)
    assert_same(got)
    assert (got["port"][1] >= 0).all()


@pytest.mark.parametrize("key", [
    slice(None, None, 2), slice(8, 2, -2), slice(None, None, -1),
    slice(-3, None), 4, -1, (Ellipsis,), slice(1, 9, 3)])
def test_basic_indexing_and_negative_steps(key):
    def case(mx, nd, invoke):
        a = nd.array(np.arange(10, dtype=np.float32))
        return [_np(a[key])]
    assert_same(both(case))


@pytest.mark.parametrize("key", [
    (slice(None), 1), (1, slice(None, None, -1)), (Ellipsis, 0),
    (None, 1), (slice(0, 2), slice(1, 3)), (-1, -2)])
def test_2d_indexing(key):
    def case(mx, nd, invoke):
        a = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        return [_np(a[key])]
    assert_same(both(case))


def test_write_through_a_negative_step_slice():
    a = tnd.array(np.arange(6, dtype=np.float32))
    a[4:0:-2] = tnd.array([10.0, 20.0])
    np.testing.assert_array_equal(a.asnumpy(), [0, 1, 20, 3, 10, 5])
    with pytest.raises(MXNetError, match="more than one"):
        tnd.zeros((3, 3))[::-1, ::-1] = 1.0


def test_integer_index_out_of_range_raises():
    with pytest.raises(IndexError):
        tnd.zeros((3,))[3]


def test_scalar_conversions():
    def case(mx, nd, invoke):
        a = nd.array([3.5])
        b = nd.array([[2]], dtype="int32")
        return [float(a), float(a.asscalar()), int(b), bool(nd.array([1.0]))]
    got = both(case)
    assert_same(got)
    assert got["port"] == [3.5, 3.5, 2, True]
    with pytest.raises(ValueError):
        tnd.zeros((2, 2)).asscalar()
    with pytest.raises(ValueError):
        bool(tnd.zeros((2,)))


def test_copy_semantics():
    def case(mx, nd, invoke):
        a = nd.ones((2, 2))
        b = a.copy()
        b[:] = 0
        c = nd.zeros((2, 2))
        a.copyto(c)
        d = nd.zeros((2, 2), dtype="int32")
        (a * 3.7).copyto(d)
        return [_np(a), _np(b), _np(c), _np(d), str(d.dtype)]
    assert_same(both(case))


def test_astype():
    def case(mx, nd, invoke):
        a = nd.array([1.5, 2.5])
        b = a.astype("int32")
        c = a.astype("bfloat16")
        d = c.astype("float32")
        return [str(b.dtype), _np(b), str(c.dtype), _np(d),
                a.astype("float32", copy=False) is a]
    got = both(case)
    assert_same(got)
    assert got["port"][2] == "bfloat16"


def test_bfloat16_arithmetic_rounds_the_scalar_first():
    def case(mx, nd, invoke):
        a = nd.array(np.linspace(-3, 3, 13, dtype=np.float32)) \
            .astype("bfloat16")
        return [_np((a + 0.1).astype("float32")),
                _np((a * 1.7).astype("float32")),
                _np(a.sum().astype("float32"))]
    assert_same(both(case))


def test_wait_and_sync():
    def case(mx, nd, invoke):
        a = nd.ones((16, 16))
        b = nd.dot(a, a)
        b.wait_to_read()
        nd.waitall()
        return [_np(b)]
    got = both(case)
    assert_same(got)
    assert (got["port"][0] == 16).all()


# ---------------------------------------------------------------------------
# method forms, the classic positional convention, the op battery
# ---------------------------------------------------------------------------

X6 = np.arange(6, dtype=np.float32).reshape(2, 3)

METHODS = {
    "sum": lambda x: x.sum(),
    "sum_axis": lambda x: x.sum(axis=1, keepdims=True),
    "mean_axis": lambda x: x.mean(axis=1),
    "max": lambda x: x.max(),
    "max_axis": lambda x: x.max(axis=0),
    "min": lambda x: x.min(axis=1),
    "T": lambda x: x.T,
    "transpose": lambda x: x.transpose((1, 0)),
    "flatten": lambda x: x.reshape((2, 3, 1)).flatten(),
    "expand_dims": lambda x: x.expand_dims(0),
    "squeeze": lambda x: x.expand_dims(0).squeeze(),
    "clip": lambda x: x.clip(1, 4),
    "exp": lambda x: x.exp(),
    "log": lambda x: (x + 1).log(),
    "sqrt": lambda x: x.sqrt(),
    "relu": lambda x: (x - 2).relu(),
    "sigmoid": lambda x: x.sigmoid(),
    "tanh": lambda x: x.tanh(),
    "softmax": lambda x: x.softmax(),
    "log_softmax": lambda x: x.log_softmax(axis=0),
    "dot": lambda x: x.dot(x.T),
    "argmax": lambda x: x.argmax(axis=1),
    "one_hot": lambda x: x.argmax(axis=1).one_hot(4),
    "slice_axis": lambda x: x.slice_axis(1, 0, 2),
    "split": lambda x: x.split(3, axis=1)[1],
    "broadcast_to": lambda x: x[0:1].broadcast_to((4, 3)),
    "abs": lambda x: (x - 3).abs(),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_method_forms(name):
    def case(mx, nd, invoke):
        out = METHODS[name](nd.array(X6))
        return [_np(out), out.shape]
    assert_same(both(case), rtol=1e-6)


POSITIONAL = {
    "reshape": lambda nd, invoke, x: nd.reshape(x, (3, 2)),
    "tile": lambda nd, invoke, x: nd.tile(x, (2, 1)),
    "repeat": lambda nd, invoke, x: nd.repeat(x, 2),
    "repeat_axis": lambda nd, invoke, x: nd.repeat(x, 2, axis=1),
    "expand_dims": lambda nd, invoke, x: nd.expand_dims(x, 0),
    "one_hot": lambda nd, invoke, x: nd.one_hot(
        nd.array(np.array([0, 2], np.float32)), 3),
    "flip": lambda nd, invoke, x: nd.flip(x, 1),
    "invoke_broadcast_add": lambda nd, invoke, x: invoke(
        "broadcast_add", x, 1.5),
}


@pytest.mark.parametrize("name", sorted(POSITIONAL))
def test_positional_attr_convention(name):
    def case(mx, nd, invoke):
        out = POSITIONAL[name](nd, invoke, nd.array(X6))
        return [_np(out), out.shape]
    assert_same(both(case))


def test_positional_and_keyword_duplicate_raises():
    with pytest.raises(TypeError, match="multiple values"):
        tnd.expand_dims(tnd.array(X6), 0, axis=1)


BATTERY = {
    "transpose": lambda nd, x: nd.transpose(x, (1, 0)),
    "swapaxes": lambda nd, x: nd.swapaxes(x, 0, 1),
    "clip": lambda nd, x: nd.clip(x, 1, 4),
    "split": lambda nd, x: nd.split(x, 3)[2],
    "concat": lambda nd, x: nd.concat(x, x, dim=0),
    "concat_default": lambda nd, x: nd.concat(x, x),
    "dot_transpose_a": lambda nd, x: nd.dot(x, x, True),
    "dot_transpose_b": lambda nd, x: nd.dot(x, x, transpose_b=True),
    "sum": lambda nd, x: nd.sum(x, 1),
    "sum_exclude": lambda nd, x: nd.sum(x, axis=1, exclude=True),
    "mean": lambda nd, x: nd.mean(x, 0, True),
    "argmax": lambda nd, x: nd.argmax(x, 1),
    "slice_axis": lambda nd, x: nd.slice_axis(x, 1, 0, 2),
    "squeeze": lambda nd, x: nd.squeeze(nd.expand_dims(x, 0), 0),
    "stack": lambda nd, x: nd.stack(x, x, axis=0),
    "stack_list": lambda nd, x: nd.stack([x, x * 2], axis=1),
    "broadcast_axis": lambda nd, x: nd.broadcast_axis(
        nd.expand_dims(x, 0), 0, 4),
    "cast": lambda nd, x: nd.cast(x, "int32"),
    "one_hot_values": lambda nd, x: nd.one_hot(
        nd.array(np.array([0, 2, 7, -1], np.float32)), 3, on_value=5,
        off_value=-1),
    "sequence_mask": lambda nd, x: nd.SequenceMask(
        nd.ones((3, 2)), nd.array(np.array([1, 2], np.float32)), True,
        value=-9),
    "topk_indices": lambda nd, x: nd.topk(x, k=2, ret_typ="indices"),
    "topk_value": lambda nd, x: nd.topk(x, k=2, ret_typ="value"),
    "topk_mask": lambda nd, x: nd.topk(x, k=2, ret_typ="mask"),
    "topk_ascend": lambda nd, x: nd.topk(x, axis=0, k=1, is_ascend=True),
    "relu": lambda nd, x: nd.relu(x - 2),
    "negative": lambda nd, x: nd.negative(x),
    "softmax": lambda nd, x: nd.softmax(x, axis=0),
    "broadcast_mul": lambda nd, x: nd.broadcast_mul(x, nd.array(
        np.array([[2.0], [3.0]], np.float32))),
    "broadcast_greater": lambda nd, x: nd.broadcast_greater(
        x, nd.array(np.full((2, 3), 2.0, np.float32))),
    "elemwise_add": lambda nd, x: nd.elemwise_add(x, x),
    "scalar_op": lambda nd, x: nd._rminus_scalar(x, scalar=10.0),
}


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_classic_idiom_battery(name):
    def case(mx, nd, invoke):
        out = BATTERY[name](nd, nd.array(X6))
        return [_np(out), out.shape, str(out.dtype)]
    assert_same(both(case))


def test_split_returns_a_list_of_every_part():
    def case(mx, nd, invoke):
        parts = nd.split(nd.array(X6), num_outputs=2, axis=0,
                         squeeze_axis=True)
        return [len(parts)] + [_np(p) for p in parts]
    assert_same(both(case))


def test_out_argument_writes_in_place():
    def case(mx, nd, invoke):
        x = nd.array(X6)
        o = nd.zeros((2, 3))
        r = nd.relu(x - 2, out=o)
        return [_np(o), r is o]
    assert_same(both(case))


def test_registry_refuses_silent_duplicates():
    from mxnet_tpu_torch.ops import registry
    with pytest.raises(ValueError, match="already registered"):
        registry.register("relu", lambda x: x)
    assert "broadcast_add" in registry.list_ops()
    assert registry.get_op("_plus").name == "broadcast_add"
    with pytest.raises(KeyError, match="not registered"):
        registry.get_op("no_such_op_anywhere")
    with pytest.raises(AttributeError):
        tnd.no_such_op_anywhere


def test_repr_and_len():
    a = tnd.array(X6)
    assert len(a) == 2 and "NDArray 2x3 @cpu(0)" in repr(a)
    assert a.size == 6 and a.ndim == 2 and a.stype == "default"
    assert a.tolist() == X6.tolist()


# ---------------------------------------------------------------------------
# divergences from the reference found by a CPU probe, each repaired: every
# case below failed on the port before its repair
# ---------------------------------------------------------------------------

def _values_and_dtypes(*arrays):
    out = []
    for a in arrays:
        out += [a.shape, str(a.dtype), _np(a)]
    return out


@pytest.mark.parametrize("source", [
    3.0, 7, np.array(2.5), np.float64(1.5), np.int64(5), np.array(True),
    np.array([4.0])], ids=["float", "int", "0d", "np-float64", "np-int64",
                          "0d-bool", "1d"])
def test_array_of_a_scalar_keeps_its_shape(source):
    """A scalar or 0-d array gives shape (), a 1-element array (1,)."""
    got = both(lambda mx, nd, invoke: _values_and_dtypes(nd.array(source)))
    assert_same(got)
    assert got["port"][0] == np.shape(source)


@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8", "bool"])
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_mean_of_integer_and_bool_arrays(dtype, axis):
    """Averaged in float32, then cast back (toward zero): along axis 1,
    [[-1, 2], [-3, -4], [5, 6]] gives [0, -3, 5]."""
    x = np.array([[-1, 2], [-3, -4], [5, 6]]).astype(dtype)
    got = both(lambda mx, nd, invoke: _values_and_dtypes(
        nd.mean(nd.array(x), axis=axis),
        nd.mean(nd.array(x), axis=axis, keepdims=True)))
    assert_same(got)
    if dtype == "int32" and axis == 1:
        np.testing.assert_array_equal(got["port"][2], [0, -3, 5])


TOPK_DATA = {
    "row": (np.array([[1, 3, 3, 3]], np.float32), 2, -1),
    "mod3": ((np.arange(40) % 3).astype(np.float32), 5, -1),
    "cols": ((np.arange(24).reshape(6, 4) % 2).astype(np.float32), 3, 0),
}


# the reference's mask along an axis other than the last has the shape of
# its index array moved to the end, (6, 3) here, not x's: not held to it
TOPK_CASES = [(d, a, r) for d in sorted(TOPK_DATA) for a in (False, True)
              for r in ("indices", "value", "both", "mask")
              if (d, r) != ("cols", "mask")]


@pytest.mark.parametrize("data,is_ascend,ret_typ", TOPK_CASES)
def test_topk_orders_ties_lowest_index_first(data, is_ascend, ret_typ):
    """Among equal values the lowest index comes first, as the reference's
    lax.top_k orders them: [[1, 3, 3, 3]] with k = 2 gives [1, 2]."""
    x, k, axis = TOPK_DATA[data]

    def case(mx, nd, invoke):
        out = nd.topk(nd.array(x), k=k, axis=axis, ret_typ=ret_typ,
                      is_ascend=is_ascend)
        return _values_and_dtypes(*(out if isinstance(out, list)
                                    else [out]))
    got = both(case)
    assert_same(got)
    if (data, is_ascend, ret_typ) == ("row", False, "indices"):
        np.testing.assert_array_equal(got["port"][2], [[1, 2]])


@pytest.mark.parametrize("shape,axis", [((2, 3), 0), ((1, 3, 1), (0, 1)),
                                        ((1, 3, 4), -1)])
def test_squeeze_of_an_axis_not_of_size_one_raises(shape, axis):
    for nd in (jnd, tnd):
        with pytest.raises(ValueError, match="size not equal to one"):
            nd.squeeze(nd.ones(shape), axis=axis)


@pytest.mark.parametrize("shape,axis", [((1, 3, 1), (0, 2)), ((1, 3), 0),
                                        ((3, 1), -1), ((1, 1), None)])
def test_squeeze_of_size_one_axes(shape, axis):
    got = both(lambda mx, nd, invoke: _values_and_dtypes(
        nd.squeeze(nd.ones(shape), axis=axis)))
    assert_same(got)


def test_int64_narrows_to_int32():
    """The reference holds no int64 (JAX without x64): int64 data and int64
    requests of the creation ops and of astype give int32."""
    ids = np.array([[3, 0, 2], [1, 1, 4]], dtype=np.int64)

    def case(mx, nd, invoke):
        return _values_and_dtypes(
            nd.array(ids), nd.array(ids.astype(np.float32), dtype="int64"),
            nd.array(np.int64(9)), nd.zeros((2,), dtype="int64"),
            nd.ones((2,), dtype="int64"), nd.full((2,), 3, dtype="int64"),
            nd.arange(0, 4, dtype="int64"), nd.array(ids).astype("int64"),
            nd.topk(nd.array(ids.astype(np.float32)), k=2, dtype="int64"))
    got = both(case)
    assert_same(got)
    assert set(got["port"][1::3]) == {"int32"}


def test_narrowed_ids_index_where_int64_is_needed():
    """The ops that need int64 indices cast int32 ids themselves: one_hot,
    indexing by an index array, embedding, pick and the cross-entropy's
    targets."""
    from mxnet_tpu_torch.ops import nn as tnn
    ids = np.array([[3, 0, 2], [1, 1, 4]], dtype=np.int64)
    got = both(lambda mx, nd, invoke: _values_and_dtypes(
        nd.one_hot(nd.array(ids), depth=5),
        nd.array(np.arange(10.0))[nd.array(ids)]))
    assert_same(got)
    t_ids = tnd.array(ids).data
    assert t_ids.dtype == torch.int32
    w = torch.arange(20.0).reshape(5, 4)
    assert torch.equal(tnn.embedding(t_ids, w), w[torch.from_numpy(ids)])
    logits = torch.arange(30.0).reshape(6, 5) / 7
    labels = t_ids.reshape(-1)
    want = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(ids).reshape(-1), reduction="none")
    np.testing.assert_allclose(
        tnn.softmax_cross_entropy(logits, labels).numpy(),
        want.sum().numpy(), rtol=1e-6)
    np.testing.assert_array_equal(
        tnn.pick(logits, labels).numpy(),
        logits[torch.arange(6), torch.from_numpy(ids).reshape(-1)].numpy())


@pytest.mark.parametrize("exp", [-1, -2, -3, -64, 0, 1, 3, 70])
def test_integer_power_matches_the_reference(exp):
    """Integer powers are the reference's binary exponentiation over the
    exponent's low six bits, wrapping: a negative exponent gives values
    (torch raises, or gives 0), 0 ** e is 0 for e != 0."""
    x = np.array([2, -3, 0, 5, 1, -1, 7], dtype=np.int32)
    e = np.full(7, exp, dtype=np.int32)
    got = both(lambda mx, nd, invoke: _values_and_dtypes(
        nd.array(x) ** exp, nd.array(x) ** nd.array(e),
        nd.broadcast_power(nd.array(x), nd.array(e)), 2 ** nd.array(e)))
    assert_same(got)


def test_integer_mod_by_zero_gives_zero():
    """An integer divisor of 0 gives 0 (torch raises); otherwise the
    remainder takes the divisor's sign."""
    x = np.array([2, -3, 0, 5, 7, -7, 7, -7], dtype=np.int32)
    d = np.array([0, 2, 0, 3, 2, 2, -2, 0], dtype=np.int32)
    got = both(lambda mx, nd, invoke: _values_and_dtypes(
        nd.array(x) % 0, nd.array(x) % nd.array(d), 5 % nd.array(d),
        nd.broadcast_mod(nd.array(x), nd.array(d)), nd.array(x) % -2,
        nd.array(x.astype(np.float32)) % 2.5))
    assert_same(got)


@pytest.mark.parametrize("src", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "int32"])
def test_float_to_integer_casts_saturate(src, dtype):
    """Out-of-range values saturate and NaN gives 0, as in the reference:
    -1.7 to uint8 is 0 and 300.2 is 255 (torch's conversion wraps them to
    255 and 44)."""
    x = np.array([-1.7, 300.2, 12.5, 255.9, -300.0, np.nan, np.inf,
                  -np.inf, 3e9, -3e9, 70000.0], dtype=np.float32)

    def case(mx, nd, invoke):
        a = nd.array(x).astype(src)
        return _values_and_dtypes(a.astype(dtype),
                                  nd.cast(a, dtype=dtype))
    got = both(case)
    assert_same(got)
    if (src, dtype) == ("float32", "uint8"):
        np.testing.assert_array_equal(got["port"][2][:2], [0, 255])


def test_asnumpy_of_bfloat16_is_float32_with_the_bf16_values():
    """A documented difference: the reference returns ml_dtypes.bfloat16,
    the port float32 holding exactly the same values (the card's machine
    has no ml_dtypes)."""
    x = np.array([1.0, 1.00390625, 3.14159, -2e-3, 65504.0, 1e30],
                 dtype=np.float32)
    ref = jnd.array(x).astype("bfloat16").asnumpy()
    got = tnd.array(x).astype("bfloat16").asnumpy()
    assert got.dtype == np.float32 and ref.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got, ref.astype(np.float32))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_nd_concatenate(axis):
    rng = np.random.RandomState(3)
    xs = [rng.randn(2, 3).astype(np.float32) for _ in range(3)]
    out = {}
    for pkg, (_, nd, _) in PACKAGES.items():
        out[pkg] = nd.concatenate([nd.array(x) for x in xs],
                                  axis=axis).asnumpy()
    np.testing.assert_array_equal(out["port"], out["jax"])


def test_nd_exports_are_the_reference_s():
    """Less ``save`` / ``load`` (ROADMAP Queue 1 item 5); the port adds
    ``stack`` and ``concat`` to ``__all__``."""
    assert sorted(set(tnd.__all__) - {"stack", "concat"}) == \
        sorted(set(jnd.__all__) - {"save", "load"})
