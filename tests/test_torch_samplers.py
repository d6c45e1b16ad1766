"""The 14 numpy-era samplers that carry the 28 legacy aliases, and AMP's
finite checks and multicast (``all_finite``, ``multi_all_finite``,
``amp_multicast``), in the port against the JAX reference, on the CPU.

JAX keys are not torch generators, so draws cannot match bit for bit.
Each sampler is held exactly on what does not depend on the bits: its
registered names (the ``_npi_*`` name and both aliases, one op), the
output's shape and dtype for ``size=None``, an int and a tuple and for a
requested dtype, its parameter errors (an array parameter raises
``TypeError`` as in the reference, ``zipf`` with ``a <= 1`` raises
``ValueError``) and determinism under one seed.  Its draws are held by
their moments: the ``_npi_*`` rows of the reference's ``MOMENTS`` table
(``tests/test_random.py``: 5 standard errors on the mean, 15 % on the
variance, N = 40,000), and for the other eight the closed-form moments at
the same tolerance (the circular mean and resultant length for
``vonmises``, the quartiles for ``standard_cauchy``), with the reference's
own checks of ``tests/test_numpy_extras.py`` besides.  The AMP ops are
held exactly: on every float dtype, clean and with an inf, a -inf or a NaN
planted, and under ``amp.init()``.
"""
import functools

import jax
import numpy as np
import pytest
import scipy.special as ss
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke
from mxnet_tpu.ops import registry as jregistry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.ndarray.ndarray import invoke
from mxnet_tpu_torch.ops import registry as tregistry

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

N = 40_000
SAMPLERS = ["_npi_laplace", "_npi_beta", "_npi_chisquare", "_npi_standard_t",
            "_npi_lognormal", "_npi_triangular", "_npi_dirichlet",
            "_npi_standard_cauchy", "_npi_standard_gamma",
            "_npi_noncentral_chisquare", "_npi_wald", "_npi_logseries",
            "_npi_vonmises", "_npi_zipf"]
# one valid parameter set per sampler (its first parameter is scalar)
PARAMS = {
    "_npi_laplace": dict(loc=-1.0, scale=0.5),
    "_npi_beta": dict(a=2.0, b=6.0),
    "_npi_chisquare": dict(df=5.0),
    "_npi_standard_t": dict(df=10.0),
    "_npi_lognormal": dict(mean=0.0, sigma=0.5),
    "_npi_triangular": dict(left=0.0, mode=1.0, right=2.0),
    "_npi_dirichlet": dict(alpha=(1.0, 2.0, 3.0)),
    "_npi_standard_cauchy": dict(),
    "_npi_standard_gamma": dict(shape_param=2.0),
    "_npi_noncentral_chisquare": dict(df=3.0, nonc=2.0),
    "_npi_wald": dict(mean=3.0, scale=2.0),
    "_npi_logseries": dict(p=0.5),
    "_npi_vonmises": dict(mu=0.5, kappa=4.0),
    "_npi_zipf": dict(a=3.0),
}
_ROWS = [m for m in __import__("test_random").MOMENTS
         if m[0].startswith("_npi_")]


@pytest.fixture(autouse=True)
def _cpu_and_amp_off():
    with tmx.cpu():
        yield
    jamp.turn_off()
    tamp.turn_off()


def draws(op, size=(N,), **params):
    tmx.random.seed(7)
    return invoke(op, size=size, **params).asnumpy().astype(np.float64)


def _moments_ok(x, mean, var, what):
    assert np.isfinite(x).all(), what
    se_mean = np.sqrt(var / x.size)
    assert abs(x.mean() - mean) < 5 * se_mean + 1e-3, (what, x.mean(), mean)
    assert abs(x.var() - var) < 0.15 * var + 5e-3, (what, x.var(), var)


# ---------------------------------------------------------------------------
# names, shapes, dtypes, errors
# ---------------------------------------------------------------------------

def _names_of(registry, op):
    target = registry.get_op(op)
    return sorted(n for n in registry.list_ops()
                  if registry.get_op(n) is target)


@pytest.mark.parametrize("op", SAMPLERS)
def test_sampler_is_registered_under_the_reference_names(op):
    names = _names_of(tregistry, op)
    assert names == _names_of(jregistry, op)
    assert len(names) == 3                  # _npi_<x>, random_<x>, <x>
    for n in names:
        assert hasattr(tmx.nd, n)
    assert not tregistry.get_op(op).differentiable


def test_fourteen_samplers_carry_twenty_eight_aliases():
    aliases = {n for op in SAMPLERS for n in _names_of(tregistry, op)} - \
        set(SAMPLERS)
    assert len(aliases) == 28


_SIZES = [None, 5, (2, 3)]


def _reference_shape_dtype(op, **kw):
    """The reference op's output shape and dtype name, traced by
    ``jax.eval_shape`` (no compile per shape)."""
    out = jax.eval_shape(functools.partial(jregistry.get_op(op).fn, **kw),
                         jax.random.PRNGKey(0))
    return tuple(out.shape), str(np.dtype(out.dtype))


@pytest.mark.parametrize("size", _SIZES, ids=["none", "int", "tuple"])
@pytest.mark.parametrize("op", SAMPLERS)
def test_sampler_shape_and_dtype_match_reference(op, size):
    kw = dict(PARAMS[op])
    if size is not None:
        kw["size"] = size
    got = invoke(op, **kw)
    assert (got.shape, str(got.dtype)) == _reference_shape_dtype(op, **kw)
    other = "float32" if op in ("_npi_logseries", "_npi_zipf") \
        else "float16"
    got = invoke(op, dtype=other, size=(3,), **PARAMS[op])
    assert (got.shape, str(got.dtype)) == _reference_shape_dtype(
        op, dtype=other, size=(3,), **PARAMS[op])


@pytest.mark.parametrize("op", [o for o in SAMPLERS
                                if o not in ("_npi_logseries", "_npi_zipf")])
def test_float64_sampler_draws_in_float64(op):
    """Asked for float64, a sampler draws in float64: its values are not
    all float32 values widened (where the reference narrows to float32)."""
    got = invoke(op, dtype="float64", size=(256,), **PARAMS[op]).asnumpy()
    assert got.dtype == np.float64
    assert np.isfinite(got).all()
    assert not np.array_equal(got, got.astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("op", [o for o in SAMPLERS
                                if o != "_npi_standard_cauchy"])
def test_array_parameter_raises_type_error_as_in_reference(op):
    kw = dict(PARAMS[op])
    first = next(iter(kw))
    kw[first] = np.array([1.0, 2.0]) if op != "_npi_dirichlet" \
        else np.array([1.0, 2.0])
    for inv in (invoke, jinvoke):
        with pytest.raises(TypeError):
            inv(op, size=(2,), **kw)


def test_zipf_needs_a_above_one_as_in_reference():
    for inv in (invoke, jinvoke):
        with pytest.raises(ValueError):
            inv("_npi_zipf", a=1.0, size=(4,))


@pytest.mark.parametrize("op", SAMPLERS)
def test_sampler_is_deterministic_under_one_seed(op):
    tmx.random.seed(5)
    a = invoke(op, size=(64,), **PARAMS[op]).asnumpy()
    tmx.random.seed(5)
    b = invoke(op, size=(64,), **PARAMS[op]).asnumpy()
    c = invoke(op, size=(64,), **PARAMS[op]).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# ---------------------------------------------------------------------------
# moments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,params,mean,var", _ROWS,
                         ids=[m[0] for m in _ROWS])
def test_reference_moment_rows(op, params, mean, var):
    params = dict(params)
    size = params.pop("size")
    _moments_ok(draws(op, size=size, **params), mean, var, op)


def test_every_reference_npi_row_is_covered():
    assert len(_ROWS) == 6


def _logseries_moments(p):
    lg = np.log(1 - p)
    mean = -p / ((1 - p) * lg)
    var = -p * (p + lg) / ((1 - p) ** 2 * lg ** 2)
    return mean, var


OTHER_MOMENTS = [
    ("_npi_standard_gamma", dict(shape_param=2.0), 2.0, 2.0),
    ("_npi_noncentral_chisquare", dict(df=3.0, nonc=2.0), 5.0, 14.0),
    ("_npi_wald", dict(mean=3.0, scale=2.0), 3.0, 27.0 / 2.0),
    ("_npi_logseries", dict(p=0.5)) + _logseries_moments(0.5),
    ("_npi_zipf", dict(a=6.0), ss.zeta(5.0) / ss.zeta(6.0),
     ss.zeta(4.0) / ss.zeta(6.0) - (ss.zeta(5.0) / ss.zeta(6.0)) ** 2),
]


@pytest.mark.parametrize("op,params,mean,var", OTHER_MOMENTS,
                         ids=[m[0] for m in OTHER_MOMENTS])
def test_closed_form_moments(op, params, mean, var):
    _moments_ok(draws(op, **params), mean, var, op)


def test_dirichlet_sums_to_one_with_the_component_moments():
    alpha = np.array([1.0, 2.0, 3.0])
    d = draws("_npi_dirichlet", alpha=tuple(alpha))
    assert d.shape == (N, 3)
    np.testing.assert_allclose(d.sum(1), np.ones(N), rtol=1e-5)
    a0 = alpha.sum()
    for i in range(3):
        _moments_ok(d[:, i], alpha[i] / a0,
                    alpha[i] * (a0 - alpha[i]) / (a0 ** 2 * (a0 + 1)),
                    "dirichlet[%d]" % i)


def test_vonmises_circular_moments_and_range():
    vm = draws("_npi_vonmises", mu=0.5, kappa=4.0, size=(50000,))
    assert (vm >= -np.pi).all() and (vm <= np.pi).all()
    z = np.exp(1j * vm).mean()
    assert abs(np.angle(z) - 0.5) < 0.02
    assert abs(abs(z) - ss.i1(4.0) / ss.i0(4.0)) < 0.01
    vm0 = draws("_npi_vonmises", mu=0.0, kappa=0.0, size=(20000,))
    assert np.isfinite(vm0).all() and abs(np.exp(1j * vm0).mean()) < 0.03


def test_cauchy_quartiles_and_the_reference_checks():
    sc = draws("_npi_standard_cauchy")
    q1, med, q3 = np.percentile(sc, [25, 50, 75])
    # the quartiles of the standard Cauchy are -1, 0, 1; the standard error
    # of a sample quantile is sqrt(q (1 - q)) / (sqrt(N) f(x_q))
    se = np.sqrt(0.25 * 0.75 / N) / (1.0 / (2 * np.pi))
    assert abs(q1 + 1) < 5 * se and abs(q3 - 1) < 5 * se
    assert abs(med) < 5 * np.sqrt(0.25 / N) * np.pi
    # tests/test_numpy_extras.py's own checks of the other samplers
    z = draws("_npi_zipf", a=3.0, size=(50000,))
    assert z.min() >= 1
    assert abs(z.mean() - ss.zeta(2.0) / ss.zeta(3.0)) < 0.05
    ls = draws("_npi_logseries", p=0.5, size=(50000,))
    assert ls.min() >= 1 and abs(ls.mean() - _logseries_moments(0.5)[0]) \
        < 0.03
    assert abs(draws("_npi_wald", mean=3.0, scale=2.0).mean() - 3.0) < 0.15
    t5 = draws("_npi_standard_t", df=5.0)
    assert abs(t5.std() - np.sqrt(5.0 / 3.0)) < 0.05


# ---------------------------------------------------------------------------
# all_finite, multi_all_finite, amp_multicast
# ---------------------------------------------------------------------------

FLOATS = ["float16", "bfloat16", "float32", "float64"]
PLANTS = [None, np.inf, -np.inf, np.nan]


def _arr(pkg, x, dt):
    return pkg.nd.array(x, dtype=dt)


@pytest.mark.parametrize("plant", PLANTS, ids=["clean", "inf", "-inf",
                                                "nan"])
@pytest.mark.parametrize("dt", FLOATS)
def test_all_finite_and_multi_all_finite_match_reference(dt, plant):
    rng = np.random.RandomState(0)
    xs = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    if plant is not None:
        xs[1][2] = plant
    want_ok = 0.0 if plant is not None else 1.0
    for pkg, inv in ((tmx, invoke), (jmx, jinvoke)):
        a = inv("all_finite", _arr(pkg, xs[1], dt))
        assert a.shape == (1,) and str(a.dtype) == "float32"
        assert a.asnumpy().tolist() == [want_ok]
        assert inv("all_finite", _arr(pkg, xs[0], dt)).asnumpy()[0] == 1.0
        m = inv("multi_all_finite", *[_arr(pkg, x, dt) for x in xs],
                num_arrays=2)
        assert m.shape == (1,) and str(m.dtype) == "float32"
        assert m.asnumpy().tolist() == [want_ok]
    assert not tregistry.get_op("all_finite").differentiable
    assert not tregistry.get_op("multi_all_finite").differentiable


_PAIRS = [(a, b) for a in FLOATS[:3] for b in FLOATS[:3]]


@pytest.mark.parametrize("narrow", [False, True], ids=["widest",
                                                        "narrowest"])
@pytest.mark.parametrize("pair", _PAIRS, ids=["-".join(p) for p in _PAIRS])
def test_amp_multicast_matches_reference(pair, narrow):
    rng = np.random.RandomState(1)
    xs = [rng.randn(4, 3).astype(np.float32), rng.randn(6).astype(np.float32)]
    outs = []
    for pkg, inv in ((tmx, invoke), (jmx, jinvoke)):
        r = inv("amp_multicast", *[_arr(pkg, x, d) for x, d in zip(xs, pair)],
                num_outputs=2, cast_narrow=narrow)
        assert isinstance(r, list) and len(r) == 2
        outs.append([(str(o.dtype), o.shape,
                      o.asnumpy().astype(np.float32)) for o in r])
    for (td, ts, tv), (jd, js, jv) in zip(*outs):
        assert td == jd and ts == js
        np.testing.assert_array_equal(tv, jv)
    assert tregistry.get_op("amp_multicast").num_outputs == 0   # variable


def test_amp_multicast_orders_float64_above_float32():
    a = tmx.nd.array(np.ones(2), dtype="float64")
    b = tmx.nd.array(np.ones(2), dtype="float16")
    wide = invoke("amp_multicast", a, b, num_outputs=2)
    narrow = invoke("amp_multicast", a, b, num_outputs=2, cast_narrow=True)
    assert [str(o.dtype) for o in wide] == ["float64", "float64"]
    assert [str(o.dtype) for o in narrow] == ["float16", "float16"]


def test_amp_ops_dispatch_under_amp_init_as_in_reference():
    """Under ``amp.init()`` none of the three is on a list: their inputs
    pass uncast in both packages."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3).astype(np.float32)
    x[1, 1] = np.inf
    got = []
    for pkg, amp in ((tmx, tamp), (jmx, jamp)):
        amp.init()
        a = pkg.nd.array(x, dtype="bfloat16")
        b = pkg.nd.array(x)
        r = pkg.nd.amp_multicast(a, b, num_outputs=2)
        f = pkg.nd.all_finite(b)
        m = pkg.nd.multi_all_finite(a, b, num_arrays=2)
        c = pkg.nd.amp_multicast(a, b, num_outputs=2, cast_narrow=True)
        got.append(([str(o.dtype) for o in r], [str(o.dtype) for o in c],
                    f.asnumpy().tolist(), m.asnumpy().tolist()))
        amp.turn_off()
    assert got[0] == got[1]
    assert got[0][0] == ["float32", "float32"]
    assert got[0][2] == [0.0] and got[0][3] == [0.0]
