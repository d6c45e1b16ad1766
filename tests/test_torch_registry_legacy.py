"""The legacy op names of ``elemwise``, ``scalar``, ``reduce``, ``matrix``
and ``creation`` against the JAX reference on the CPU.

Every name of :data:`LEGACY_NAMES` is a registered op of the port.  Each is
called through ``invoke`` and, where the name is an identifier, as
``nd.<name>``, in both packages on the same seeded numpy inputs: fp32
values within 1e-4, integer and bool values exactly (dtype included), and,
where the reference marks the op differentiable, the gradients of
``sum(out * cotangent)`` with respect to its floating inputs within 1e-4.
The places where ``torch`` answers differently from the ``jnp`` call the
reference makes (ties, negative steps, non-positive integers, repeated
indices, overflow, a matrix that is not positive definite) each have a
case of their own.
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as jautograd, nd as jnd
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke
from mxnet_tpu.ops import registry as jregistry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd, nd as tnd
from mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from mxnet_tpu_torch.ops import registry

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
PACKAGES = {"jax": (jnd, jautograd, jinvoke),
            "port": (tnd, tautograd, tinvoke)}

#: the names the reference registers from its five op modules that the
#: port lacked (the ``_np*``, ``_npi_*``, ``_npx_*`` and ``_contrib_*``
#: names wait for ``numpy/`` and ``contrib/``)
LEGACY_NAMES = [
    # elemwise.py
    "where", "smooth_l1", "isnan", "isinf", "isfinite", "logical_and",
    "logical_or", "logical_xor", "logical_not", "broadcast_logical_and",
    "broadcast_logical_or", "broadcast_logical_xor", "softsign", "gamma",
    "identity", "_copy", "amp_cast",
    # elemwise.py's _BINARY table
    "maximum", "minimum", "_maximum", "_minimum", "broadcast_maximum",
    "broadcast_minimum", "broadcast_hypot", "arctan2",
    # elemwise.py's _UNARY table
    "square", "reciprocal", "rsqrt", "cbrt", "sign", "floor", "ceil",
    "round", "rint", "trunc", "fix", "log10", "log2", "log1p", "expm1",
    "cos", "tan", "cosh", "sinh", "arcsin", "arccos", "arctan", "arcsinh",
    "arccosh", "arctanh", "erf", "erfinv", "gammaln", "digamma",
    # scalar.py
    "maximum_scalar", "minimum_scalar", "hypot_scalar", "smooth_l1_scalar",
    "equal_scalar", "not_equal_scalar", "greater_scalar",
    "greater_equal_scalar", "lesser_scalar", "lesser_equal_scalar",
    "logical_and_scalar", "logical_or_scalar", "logical_xor_scalar",
    "_maximum_scalar", "_minimum_scalar", "_hypot_scalar",
    "_smooth_l1_scalar", "_equal_scalar", "_not_equal_scalar",
    "_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
    "_lesser_equal_scalar", "_logical_and_scalar", "_logical_or_scalar",
    "_logical_xor_scalar",
    # reduce.py
    "sort", "argsort", "argmin", "argmax_channel", "prod", "nansum",
    "nanprod", "cumsum", "cumprod",
    # matrix.py
    "zeros_like", "zeros_like_op", "ones_like", "ones_like_op", "take",
    "gather_nd", "scatter_nd", "batch_dot", "slice", "crop", "slice_like",
    "split_v2", "_split_v2", "diag", "depth_to_space", "space_to_depth",
    "boolean_mask", "where_op", "shape_array", "size_array", "SequenceLast",
    "SequenceReverse", "_slice_assign", "_slice_assign_scalar",
    "_crop_assign", "_crop_assign_scalar", "_internal_getitem",
    "linalg_gemm2", "linalg_potrf", "linalg_syrk", "linalg_trsm",
    # creation.py
    "_eye", "eye_op", "_linspace", "linspace_op",
]


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def rnd(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def ints(*shape, seed=0, lo=-3, hi=4):
    return np.random.RandomState(seed).randint(lo, hi, shape) \
        .astype(np.int32)


def _floating(dtype):
    return np.issubdtype(np.dtype(dtype), np.floating)


def run(name, inputs, params=None, grad_of=(), via="invoke", seed=0):
    """Op ``name`` in both packages on ``inputs`` (numpy arrays; a Python
    number stays an operand) with ``params``, called through ``invoke`` or
    ``nd.<name>``; returns {package: ([outputs], [gradients])}, the
    gradients those of ``sum(out * cotangent)`` over the floating outputs
    with respect to the inputs in ``grad_of``."""
    params = params or {}
    res = {}
    for pkg, (nd, autograd, invoke) in PACKAGES.items():
        arrs = [nd.array(a, dtype=a.dtype) if isinstance(a, np.ndarray)
                else a for a in inputs]
        for i in grad_of:
            arrs[i].attach_grad()
        with autograd.record():
            if via == "nd":
                out = getattr(nd, name)(*arrs, **params)
            else:
                out = invoke(name, *arrs, **params)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            if grad_of:
                head = None
                for k, o in enumerate(outs):
                    if not _floating(o.dtype):
                        continue
                    cot = nd.array(np.random.RandomState(seed + 7 + k)
                                   .randn(*o.shape).astype(np.float32))
                    term = (o * cot).sum()
                    head = term if head is None else head + term
        if grad_of:
            head.backward()
        res[pkg] = ([o.asnumpy() for o in outs],
                    [arrs[i].grad.asnumpy() for i in grad_of])
    return res


def assert_same(res, tol=TOL):
    (jo, jg), (to, tg) = res["jax"], res["port"]
    assert len(jo) == len(to), (len(jo), len(to))
    for a, b in zip(jo, to):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (a.shape, b.shape, a.dtype, b.dtype)
        if _floating(a.dtype):
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(b, a)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# one case per name: (inputs, params); the gradient is checked for every
# floating input of an op the reference marks differentiable
# ---------------------------------------------------------------------------

HALVES = np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5],
                   [-2.7, -0.2, 0.0, 0.2, 2.7, 3.5]], np.float32)
WITH_ZEROS = np.array([[0.0, 1.5, -2.0], [0.0, 0.0, 3.0]], np.float32)
SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, 1.0, -3.0], np.float32)
UNIT = rnd(3, 4, lo=-0.9, hi=0.9)
POS = rnd(3, 4, lo=0.5, hi=3.0)
ANY = rnd(3, 4)


def _spd(n, seed):
    a = rnd(2, n, n, seed=seed)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)) \
        .astype(np.float32)


def _tril(n, seed):
    a = np.tril(rnd(2, n, n, seed=seed)) + 3 * np.eye(n, dtype=np.float32)
    return a.astype(np.float32)


def _tie_pair():
    a = rnd(3, 4, seed=1)
    b = rnd(1, 4, seed=2)
    a[0] = b[0]            # ties: the gradient is split evenly
    return [a, b]


UNARY_DOMAIN = {
    "square": ANY, "reciprocal": POS, "rsqrt": POS,
    "cbrt": rnd(3, 4, lo=0.2, hi=3.0) * np.sign(ANY), "log10": POS,
    "log2": POS, "log1p": POS, "expm1": ANY, "cos": ANY, "tan": UNIT,
    "cosh": ANY, "sinh": ANY, "arcsin": UNIT, "arccos": UNIT,
    "arctan": ANY, "arcsinh": ANY, "arccosh": rnd(3, 4, lo=1.2, hi=3.0),
    "arctanh": UNIT, "erf": ANY, "erfinv": UNIT, "gammaln": POS,
    "digamma": POS, "gamma": POS, "softsign": ANY, "identity": ANY,
    "_copy": ANY,
}

CASES = {name: ([x], {}) for name, x in UNARY_DOMAIN.items()}
CASES.update({name: ([HALVES], {}) for name in
              ("sign", "floor", "ceil", "round", "rint", "trunc", "fix")})
CASES.update({name: ([SPECIAL], {}) for name in
              ("isnan", "isinf", "isfinite")})
CASES["logical_not"] = ([WITH_ZEROS], {})
for _n in ("logical_and", "logical_or", "logical_xor"):
    CASES[_n] = ([WITH_ZEROS, WITH_ZEROS[::-1].copy()], {})
    CASES["broadcast_" + _n] = ([WITH_ZEROS, WITH_ZEROS[:1, ::-1].copy()],
                                {})
for _n in ("maximum", "minimum", "_maximum", "_minimum",
           "broadcast_maximum", "broadcast_minimum"):
    CASES[_n] = (_tie_pair(), {})
CASES["broadcast_hypot"] = ([rnd(3, 4, seed=1), rnd(1, 4, seed=2)], {})
CASES["arctan2"] = ([rnd(3, 4, seed=1), rnd(3, 4, seed=2)], {})
CASES["where"] = ([(rnd(3, 4, seed=3) > 0).astype(np.float32),
                   rnd(3, 4, seed=1), rnd(3, 4, seed=2)], {})
CASES["where_op"] = CASES["where"]
CASES["smooth_l1"] = ([np.array([-2.0, -0.25, 0.0, 0.1, 0.25, 0.3, 1.5],
                                np.float32)], {"scalar": 2.0})
CASES["amp_cast"] = ([ANY], {"dtype": "float16"})
for _n in ("maximum_scalar", "minimum_scalar"):
    CASES[_n] = ([HALVES], {"scalar": 0.5})
CASES["hypot_scalar"] = ([ANY], {"scalar": 1.5})
CASES["smooth_l1_scalar"] = ([np.array([-2.0, -1.0, 0.0, 0.3, 1.0, 1.5],
                                       np.float32)], {"scalar": 1.0})
for _n in ("equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal"):
    CASES[_n + "_scalar"] = ([HALVES], {"scalar": 0.5})
for _n in ("and", "or", "xor"):
    CASES["logical_%s_scalar" % _n] = ([WITH_ZEROS], {"scalar": 0.5})
for _n in list(CASES):
    if _n.endswith("_scalar") and not _n.startswith("_"):
        CASES["_" + _n] = CASES[_n]
CASES["sort"] = ([rnd(3, 5)], {"axis": 1, "is_ascend": False})
CASES["argsort"] = ([rnd(3, 5)], {"axis": 0})
CASES["argmin"] = ([rnd(3, 5)], {"axis": 1})
CASES["argmax_channel"] = ([rnd(2, 4, 3)], {})
CASES["prod"] = ([rnd(2, 3, 4, lo=0.5, hi=1.5)], {"axis": (0, 2),
                                                  "keepdims": True})
_nan = rnd(3, 4)
_nan[0, 1] = _nan[2, 3] = np.nan
CASES["nansum"] = ([_nan], {"axis": 1})
CASES["nanprod"] = ([_nan], {"axis": 0})
CASES["cumsum"] = ([rnd(3, 4)], {"axis": 1})
CASES["cumprod"] = ([rnd(3, 4, lo=0.5, hi=1.5)], {})
for _n in ("zeros_like", "zeros_like_op", "ones_like", "ones_like_op"):
    CASES[_n] = ([ANY], {})
CASES["take"] = ([rnd(4, 3), np.array([[0, 3], [1, 1]], np.float32)],
                 {"axis": 0})
CASES["gather_nd"] = ([rnd(3, 4, 2), np.array([[0, 2, 1], [3, 0, 3]],
                                               np.float32)], {})
CASES["scatter_nd"] = ([rnd(3, 2), np.array([[0, 2, 1]], np.float32)],
                       {"shape": (4, 2)})
CASES["batch_dot"] = ([rnd(2, 3, 4, seed=1), rnd(2, 5, 4, seed=2)],
                      {"transpose_b": True})
CASES["slice"] = ([rnd(4, 5, 3)], {"begin": (1, None), "end": (3, 4),
                                   "step": (None, 2)})
CASES["crop"] = ([rnd(4, 5)], {"begin": (0, 1), "end": (2, 5)})
CASES["slice_like"] = ([rnd(4, 5), rnd(2, 3, seed=1)], {"axes": (1,)})
CASES["split_v2"] = ([rnd(6, 4)], {"indices": (1, 4), "axis": 0})
CASES["_split_v2"] = ([rnd(4, 6)], {"sections": 3, "axis": 1,
                                    "squeeze_axis": False})
CASES["diag"] = ([rnd(2, 4, 4)], {"k": 1})
CASES["depth_to_space"] = ([rnd(2, 8, 3, 2)], {"block_size": 2})
CASES["space_to_depth"] = ([rnd(2, 2, 4, 6)], {"block_size": 2})
CASES["boolean_mask"] = ([rnd(4, 3), np.array([1, 0, 1, 1], np.float32)],
                         {})
CASES["shape_array"] = ([rnd(2, 3, 4)], {})
CASES["size_array"] = ([rnd(2, 3, 4)], {})
CASES["SequenceLast"] = ([rnd(5, 3, 2), np.array([2, 5, 1], np.float32)],
                         {"use_sequence_length": True})
CASES["SequenceReverse"] = ([rnd(5, 3, 2), np.array([2, 5, 1],
                                                    np.float32)],
                            {"use_sequence_length": True})
CASES["_slice_assign"] = ([rnd(4, 5), rnd(2, 2, seed=1)],
                          {"begin": (1, 0), "end": (3, 4),
                           "step": (None, 2)})
CASES["_crop_assign"] = CASES["_slice_assign"]
CASES["_slice_assign_scalar"] = ([rnd(4, 5)], {"scalar": 7.5,
                                               "begin": (1, 1),
                                               "end": (3, 5)})
CASES["_crop_assign_scalar"] = CASES["_slice_assign_scalar"]
CASES["_internal_getitem"] = ([rnd(4, 5)], {"key": (slice(1, None),
                                                    slice(None, None, 2))})
CASES["linalg_gemm2"] = ([rnd(2, 3, 4, seed=1), rnd(2, 3, 5, seed=2)],
                         {"transpose_a": True, "alpha": 0.5})
CASES["linalg_potrf"] = ([_spd(3, 1)], {})
CASES["linalg_syrk"] = ([rnd(2, 3, 4)], {"transpose": True, "alpha": 2.0})
CASES["linalg_trsm"] = ([_tril(3, 1), rnd(2, 3, 2, seed=2)],
                        {"alpha": 1.5})
CASES["_eye"] = ([], {"N": 3, "M": 5, "k": 1})
CASES["eye_op"] = ([], {"N": 4, "k": -1})
CASES["_linspace"] = ([], {"start": -1.0, "stop": 2.0, "num": 7})
CASES["linspace_op"] = ([], {"start": 0.0, "stop": 1.0, "num": 5,
                             "endpoint": False})


def test_every_legacy_name_is_a_port_op_under_the_references_op():
    assert len(LEGACY_NAMES) == len(set(LEGACY_NAMES)) == 124
    missing = [n for n in LEGACY_NAMES if n not in registry.list_ops()]
    assert not missing, missing
    # aliases of one reference op are aliases of one port op
    for n in LEGACY_NAMES:
        same = [m for m in LEGACY_NAMES
                if jregistry.get_op(m) is jregistry.get_op(n)]
        assert {registry.get_op(m).name for m in same} == \
            {registry.get_op(n).name}, (n, same)
        assert registry.get_op(n).differentiable == \
            jregistry.get_op(n).differentiable, n
        assert registry.get_op(n).num_outputs == \
            jregistry.get_op(n).num_outputs, n


def test_every_legacy_name_has_a_parity_case():
    assert sorted(CASES) == sorted(LEGACY_NAMES)


def _grad_inputs(name, inputs):
    if not jregistry.get_op(name).differentiable:
        return ()
    skip = {0} if name in ("where", "where_op") else set()   # the condition
    return tuple(i for i, a in enumerate(inputs)
                 if isinstance(a, np.ndarray) and _floating(a.dtype)
                 and i not in skip)


@pytest.mark.parametrize("name", LEGACY_NAMES)
def test_legacy_op_answers_as_the_reference(name):
    inputs, params = CASES[name]
    assert_same(run(name, inputs, params, _grad_inputs(name, inputs)))
    if name.isidentifier() and hasattr(jnd, name):
        assert_same(run(name, inputs, params, via="nd"))


# ---------------------------------------------------------------------------
# the places where torch's obvious call answers otherwise
# ---------------------------------------------------------------------------

TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0],
                 [0.0, 0.0, 0.0, -1.0, -1.0, 5.0]], np.float32)


@pytest.mark.parametrize("is_ascend", [True, False])
@pytest.mark.parametrize("name", ["sort", "argsort"])
def test_sort_keeps_the_references_order_of_ties(name, is_ascend):
    # descending is the stable ascending order reversed: ties come highest
    # index first, where torch's stable descending sort gives lowest first
    res = run(name, [TIES], {"is_ascend": is_ascend})
    assert_same(res)
    if name == "argsort" and not is_ascend:
        np.testing.assert_array_equal(res["port"][0][0][0],
                                      [5, 2, 0, 3, 4, 1])


@pytest.mark.parametrize("name", ["argmin", "argsort"])
def test_argmin_and_argsort_of_integers_and_axis_none(name):
    x = ints(3, 5, seed=4, lo=0, hi=3)
    params = {} if name == "argmin" else {"axis": 0, "dtype": "int32"}
    assert_same(run(name, [x], params))


def test_argmin_takes_the_first_of_equal_entries():
    res = run("argmin", [TIES], {"axis": 1})
    assert_same(res)
    np.testing.assert_array_equal(res["port"][0][0], [1, 3])
    assert_same(run("argmin", [TIES], {"keepdims": True}))


@pytest.mark.parametrize("name", ["fix", "trunc", "floor", "ceil", "round",
                                  "rint"])
def test_rounding_at_negative_values_and_on_integers(name):
    assert_same(run(name, [HALVES]))
    assert_same(run(name, [ints(2, 5)]))


@pytest.mark.parametrize("name", ["gamma", "gammaln", "digamma"])
def test_gamma_family_at_non_positive_integers(name):
    x = np.array([0.0, -1.0, -2.0, -1.5, -0.5, 0.5, 3.0], np.float32)
    res = run(name, [x])
    assert_same(res)
    if name == "digamma":
        assert np.isnan(res["port"][0][0][:3]).all()   # torch: -inf at 0


@pytest.mark.parametrize("mode", ["clip", "wrap", "raise"])
def test_take_modes(mode):
    idx = np.array([[-1.0, 5.0], [1.7, -0.5]], np.float32)
    res = run("take", [rnd(4, 3), idx], {"axis": 0, "mode": mode},
              grad_of=(0,))
    assert_same(res)
    assert_same(run("take", [rnd(3, 4), idx], {"axis": 1, "mode": mode}))


def test_gather_nd_with_repeated_indices_accumulates_the_gradient():
    idx = np.array([[0, 2, 0, 0], [1, 1, 1, 3]], np.float32)
    assert_same(run("gather_nd", [rnd(3, 4), idx], grad_of=(0,)))


def test_scatter_nd_with_repeated_indices_keeps_the_last_write():
    idx = np.array([[0, 1, 0, 2, 0]], np.float32)
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    res = run("scatter_nd", [data, idx], {"shape": (3,)}, grad_of=(0,))
    assert_same(res)
    np.testing.assert_array_equal(res["port"][0][0], [5.0, 2.0, 4.0])
    # only the write that lands gets a gradient
    assert (res["port"][1][0][[0, 2]] == 0).all()


def test_scatter_nd_over_two_leading_axes_with_negative_indices():
    idx = np.array([[0, -1, 1], [2, 0, 2]], np.float32)
    assert_same(run("scatter_nd", [rnd(3, 2), idx], {"shape": (2, 3, 2)},
                    grad_of=(0,)))


@pytest.mark.parametrize("begin,end,step", [
    ((3, None), (0, None), (-1, -2)),
    ((None, 4), (None, 0), (-2, -1)),
    ((-1,), (None,), (-1,)),
])
def test_slice_assign_and_slice_with_negative_steps(begin, end, step):
    x = rnd(5, 6)
    region = run("slice", [x], {"begin": begin, "end": end, "step": step},
                 grad_of=(0,))
    assert_same(region)
    rhs = rnd(*region["jax"][0][0].shape, seed=3)
    assert_same(run("_slice_assign", [x, rhs], {"begin": begin, "end": end,
                                                "step": step},
                    grad_of=(0, 1)))
    assert_same(run("_slice_assign_scalar", [x], {
        "scalar": -4.0, "begin": begin, "end": end, "step": step},
        grad_of=(0,)))


def test_slice_assign_broadcasts_its_value():
    assert_same(run("_slice_assign", [rnd(4, 5), rnd(1, 2, seed=1)],
                    {"begin": (0, 1), "end": (4, 3)}, grad_of=(0, 1)))


@pytest.mark.parametrize("key", [
    (slice(None, None, -1), 1),
    (Ellipsis, slice(3, 0, -2)),
    (None, 2, slice(None, None, -1)),
])
def test_internal_getitem_basic_keys(key):
    assert_same(run("_internal_getitem", [rnd(4, 5)], {"key": key},
                    grad_of=(0,)))


@pytest.mark.parametrize("index", [[0, 0, 0, 0], [1, 0, 1, 1], [1, 1, 1, 1]])
def test_boolean_mask_output_shape(index):
    res = run("boolean_mask", [rnd(4, 3), np.array(index, np.float32)])
    assert_same(res)
    assert res["port"][0][0].shape == (sum(index), 3)
    assert_same(run("boolean_mask", [rnd(2, 4), np.array(index, np.float32)],
                    {"axis": 1}))


@pytest.mark.parametrize("name", ["equal_scalar", "not_equal_scalar",
                                  "greater_scalar", "greater_equal_scalar",
                                  "lesser_scalar", "lesser_equal_scalar",
                                  "logical_and_scalar", "logical_or_scalar",
                                  "logical_xor_scalar"])
def test_scalar_comparisons_keep_the_data_dtype(name):
    # an integer tensor gives integers (broadcast_equal gives float32), the
    # scalar is truncated for the comparison and kept for the logic
    x = ints(3, 4)
    res = run(name, [x], {"scalar": 1.5})
    assert_same(res)
    assert res["port"][0][0].dtype == np.int32
    assert_same(run(name, [x], {"scalar": 0.5}))


@pytest.mark.parametrize("name", ["broadcast_equal", "broadcast_logical_and",
                                  "logical_not"])
def test_broadcast_comparisons_of_integers_give_float32(name):
    ins = [ints(3, 4)] if name == "logical_not" else [ints(3, 4),
                                                      ints(1, 4, seed=1)]
    res = run(name, ins)
    assert_same(res)
    assert res["port"][0][0].dtype == np.float32


def test_hypot_does_not_overflow():
    big = np.array([3e38, 1e30, -2e38, 0.0], np.float32)
    res = run("broadcast_hypot", [big, big[::-1].copy()])
    assert_same(res)
    assert np.isfinite(res["port"][0][0]).all()
    assert_same(run("hypot_scalar", [big], {"scalar": 1e38}))


def test_maximum_with_a_number_operand_and_integers():
    assert_same(run("maximum", [HALVES, 0.5], grad_of=(0,)))
    assert_same(run("minimum", [ints(3, 4), ints(3, 4, seed=1)]))
    assert_same(run("broadcast_maximum", [ints(3, 4), 1.5]))


def test_potrf_keeps_zeros_above_and_nan_for_an_indefinite_matrix():
    res = run("linalg_potrf", [_spd(4, 2)], grad_of=(0,))
    assert_same(res)
    assert (np.triu(res["port"][0][0], 1) == 0).all()
    bad = np.array([[[1.0, 2.0], [2.0, 1.0]], [[4.0, 2.0], [2.0, 3.0]]],
                   np.float32)
    res = run("linalg_potrf", [bad])
    (jv,), (tv,) = res["jax"][0], res["port"][0]
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_allclose(np.nan_to_num(tv), np.nan_to_num(jv),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("params", [
    {"transpose": True}, {"rightside": True}, {"lower": False},
    {"transpose": True, "rightside": True, "alpha": -2.0}])
def test_trsm_variants(params):
    a = _tril(3, 4)
    if not params.get("lower", True):
        a = a.transpose(0, 2, 1).copy()
    b = rnd(2, 3, 3, seed=5)
    assert_same(run("linalg_trsm", [a, b], params, grad_of=(0, 1)))


@pytest.mark.parametrize("name,params", [
    ("cumsum", {}), ("cumsum", {"axis": 0}), ("cumprod", {"axis": 1}),
    ("prod", {}), ("prod", {"axis": 1, "exclude": True})])
def test_integer_reductions_keep_their_type(name, params):
    assert_same(run(name, [ints(3, 4, lo=1, hi=3)], params))


def test_prod_gradient_with_a_zero():
    x = rnd(3, 4, lo=0.5, hi=1.5)
    x[1, 2] = 0.0
    assert_same(run("prod", [x], {"axis": 1}, grad_of=(0,)))


@pytest.mark.parametrize("name", ["where", "maximum", "square", "zeros_like",
                                  "ones_like"])
def test_nd_functions_the_reference_has(name):
    ins = {"where": CASES["where"][0], "maximum": _tie_pair(),
           "square": [ANY], "zeros_like": [ANY], "ones_like": [ANY]}[name]
    assert_same(run(name, ins, via="nd"))


@pytest.mark.parametrize("args", [dict(N=3), dict(N=2, M=4, k=2),
                                  dict(N=4, k=-1, dtype="int32")])
def test_nd_eye(args):
    out = {k: nd.eye(**args).asnumpy() for k, (nd, _, _) in PACKAGES.items()}
    assert out["port"].dtype == out["jax"].dtype
    np.testing.assert_array_equal(out["port"], out["jax"])


def test_identity_returns_a_copy():
    x = tnd.array(ANY)
    y = tnd.identity(x)
    y[:] = 0.0
    np.testing.assert_array_equal(x.asnumpy(), ANY)


# ---------------------------------------------------------------------------
# ops/nn.py's legacy names (the 11 ``_npx_*`` ones wait for ``numpy/``)
# ---------------------------------------------------------------------------

NN_LEGACY_NAMES = [
    "AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D",
    "BilinearResize2D", "_contrib_BilinearResize2D", "UpSampling",
    "softmin", "SoftmaxOutput", "softmax_output", "RMSNorm",
    "LinearRegressionOutput", "linear_regression_output",
    "MAERegressionOutput", "mae_regression_output",
    "LogisticRegressionOutput", "logistic_regression_output",
]
NN_TOL = 1e-5       # resizing and pooling: the arithmetic is the same
IMG16 = rnd(2, 3, 16, 16, seed=11)
IMG8 = rnd(2, 3, 8, 8, seed=12)
LOGITS = rnd(4, 5, 3, seed=13)
LAB = rnd(4, 5, 3, seed=14)
NN_CASES = {
    "AdaptiveAvgPooling2D": ([IMG16], {"output_size": (4, 2)}),
    "BilinearResize2D": ([IMG16], {"height": 8, "width": 8}),
    "UpSampling": ([IMG8], {"scale": 2, "sample_type": "nearest"}),
    "softmin": ([LOGITS], {"axis": 1, "temperature": 2.0}),
    "SoftmaxOutput": ([LOGITS, LAB], {}),
    "RMSNorm": ([LOGITS, rnd(3, seed=15)], {}),
    "LinearRegressionOutput": ([LOGITS, LAB], {}),
    "MAERegressionOutput": ([LOGITS, LAB], {"grad_scale": 2.0}),
    "LogisticRegressionOutput": ([LOGITS, LAB], {}),
}
for _n in ("AdaptiveAvgPooling2D", "BilinearResize2D"):
    NN_CASES["_contrib_" + _n] = NN_CASES[_n]
for _n, _a in (("SoftmaxOutput", "softmax_output"),
               ("LinearRegressionOutput", "linear_regression_output"),
               ("MAERegressionOutput", "mae_regression_output"),
               ("LogisticRegressionOutput", "logistic_regression_output")):
    NN_CASES[_a] = NN_CASES[_n]


def test_every_nn_legacy_name_is_a_port_op_under_the_references_op():
    assert len(NN_LEGACY_NAMES) == len(set(NN_LEGACY_NAMES)) == 15
    missing = [n for n in NN_LEGACY_NAMES if n not in registry.list_ops()]
    assert not missing, missing
    for n in NN_LEGACY_NAMES:
        same = [m for m in NN_LEGACY_NAMES
                if jregistry.get_op(m) is jregistry.get_op(n)]
        assert {registry.get_op(m).name for m in same} == \
            {registry.get_op(n).name}, (n, same)
        assert registry.get_op(n).differentiable == \
            jregistry.get_op(n).differentiable, n
        assert registry.get_op(n).num_outputs == \
            jregistry.get_op(n).num_outputs, n
        assert registry.get_op(n).name == jregistry.get_op(n).name, n


def test_every_nn_legacy_name_has_a_parity_case():
    assert sorted(NN_CASES) == sorted(NN_LEGACY_NAMES)


@pytest.mark.parametrize("name", NN_LEGACY_NAMES)
def test_nn_legacy_op_answers_as_the_reference(name):
    """Forward, and the gradient through autograd with respect to the
    data (the ``*Output`` ops: the VJP of their forward, not upstream
    MXNet's ``p - onehot``)."""
    inputs, params = NN_CASES[name]
    grad_of = (0, 1) if name == "RMSNorm" else (0,)
    assert_same(run(name, inputs, params, grad_of), tol=NN_TOL)
    if name.isidentifier() and hasattr(jnd, name):
        assert_same(run(name, inputs, params, via="nd"), tol=NN_TOL)


@pytest.mark.parametrize("src,dst", [((16, 16), (8, 8)), ((8, 8), (5, 5)),
                                     ((8, 8), (13, 11)), ((16, 8), (5, 13)),
                                     ((7, 9), (7, 4)), ((6, 6), (6, 6))])
def test_bilinear_resize_shrinks_with_jax_s_antialiasing(src, dst):
    """jax.image.resize(method="linear") antialiases when it shrinks, so
    F.interpolate(mode="bilinear") would miss it there."""
    x = rnd(2, 3, *src, seed=16)
    params = {"height": dst[0], "width": dst[1]}
    res = run("BilinearResize2D", [x], params, grad_of=(0,))
    assert_same(res, tol=NN_TOL)
    if dst[0] < src[0]:
        import torch
        import torch.nn.functional as F
        plain = F.interpolate(torch.from_numpy(x), size=dst, mode="bilinear",
                              align_corners=False).numpy()
        assert np.abs(plain - res["jax"][0][0]).max() > 1e-3


@pytest.mark.parametrize("params", [{"scale_height": 0.5, "scale_width": 2.0},
                                    {"height": 9, "scale_width": 0.75}])
def test_bilinear_resize_by_scales(params):
    assert_same(run("BilinearResize2D", [IMG16], params, grad_of=(0,)),
                tol=NN_TOL)


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("sample_type", ["nearest", "bilinear"])
def test_up_sampling(scale, sample_type):
    assert_same(run("UpSampling", [IMG8], {"scale": scale,
                                           "sample_type": sample_type},
                    grad_of=(0,)), tol=NN_TOL)


@pytest.mark.parametrize("output_size", [1, 2, (8, 4), 16])
def test_adaptive_avg_pooling_over_bins_that_divide(output_size):
    assert_same(run("AdaptiveAvgPooling2D", [IMG16],
                    {"output_size": output_size}, grad_of=(0,)), tol=NN_TOL)


@pytest.mark.parametrize("output_size", [3, (5, 4), 7])
def test_adaptive_avg_pooling_raises_where_the_reference_does(output_size):
    """The reference averages equal bins by a reshape, which fails on a
    size the output does not divide; the port raises too, and never takes
    F.adaptive_avg_pool2d's uneven bins."""
    for pkg, (nd, _, invoke) in PACKAGES.items():
        with pytest.raises(TypeError):
            invoke("AdaptiveAvgPooling2D", nd.array(IMG16),
                   output_size=output_size)


@pytest.mark.parametrize("multi_output", [False, True])
def test_softmax_output_takes_the_vjp_of_its_softmax(multi_output):
    res = run("SoftmaxOutput", [LOGITS, LAB], {"multi_output": multi_output,
                                               "ignore_label": 1.0,
                                               "use_ignore": True},
              grad_of=(0,))
    assert_same(res, tol=NN_TOL)
    axis = 1 if multi_output else -1
    np.testing.assert_allclose(res["port"][0][0].sum(axis=axis), 1.0,
                               rtol=1e-5)


def test_rms_norm_rounds_to_bf16_before_gamma():
    x = rnd(4, 6, seed=17)
    gamma = rnd(6, seed=18)
    out = {}
    for pkg, (nd, _, invoke) in PACKAGES.items():
        y = invoke("RMSNorm", nd.array(x, dtype="bfloat16"),
                   nd.array(gamma), axis=-1, eps=1e-6)
        out[pkg] = (str(y.dtype), y.asnumpy().astype(np.float32))
    assert out["port"][0] == out["jax"][0] == "float32"
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-6,
                               atol=1e-6)
    bf = {}
    for pkg, (nd, _, invoke) in PACKAGES.items():
        y = invoke("RMSNorm", nd.array(x, dtype="bfloat16"),
                   nd.array(gamma, dtype="bfloat16"), axis=0)
        bf[pkg] = y.asnumpy().astype(np.float32)
    np.testing.assert_array_equal(bf["port"], bf["jax"])


def test_the_regression_outputs_do_not_alias_their_data():
    x = tnd.array(ANY)
    for name in ("LinearRegressionOutput", "MAERegressionOutput"):
        y = getattr(tnd, name)(x, x)
        y[:] = 0.0
        np.testing.assert_array_equal(x.asnumpy(), ANY)
