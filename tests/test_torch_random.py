"""The port's random ops (``ops/random.py``, ``nd.random``,
``mx.random.seed``) against the reference's own battery
(``tests/test_random.py``), on the CPU.

JAX keys are not torch generators, so draws cannot match the reference
bit for bit; they are held as the reference holds its own: the closed-form
moments of every ``_random_*`` row of its ``MOMENTS`` table (5 standard
errors on the mean, 15 % on the variance, at N = 40,000; the ``_npi_*``
rows wait for the ``numpy`` front end), a chi-square test of uniformity,
bounds and coverage, determinism under one seed and divergence across
seeds (and across threads' own streams), per-entry parameters of the
``_sample_*`` family, ``shuffle`` as a permutation, the reference's
shapes and dtypes, and no draw from torch's global generator.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ndarray.ndarray import invoke

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

N = 40_000
_ROWS = [m for m in __import__("test_random").MOMENTS
         if m[0].startswith("_random_")]


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def draws(op, **params):
    tmx.random.seed(7)
    return invoke(op, shape=(N,), **params).asnumpy().astype(np.float64)


@pytest.mark.parametrize("op,params,mean,var", _ROWS,
                         ids=[m[0] for m in _ROWS])
def test_distribution_moments(op, params, mean, var):
    x = draws(op, **params)
    assert np.isfinite(x).all()
    se_mean = np.sqrt(var / N)
    assert abs(x.mean() - mean) < 5 * se_mean + 1e-3, (op, x.mean(), mean)
    assert abs(x.var() - var) < 0.15 * var + 5e-3, (op, x.var(), var)


def test_every_reference_random_row_is_covered():
    assert len(_ROWS) == 12


def test_uniform_chi_square():
    x = draws("_random_uniform", low=0.0, high=1.0)
    counts, _ = np.histogram(x, bins=20, range=(0.0, 1.0))
    expect = N / 20.0
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 43.8, chi2


def test_randint_bounds_and_coverage():
    x = draws("_random_randint", low=3, high=11)
    assert x.min() >= 3 and x.max() <= 10
    assert set(np.unique(x).astype(int)) == set(range(3, 11))


def test_bernoulli_rate():
    x = draws("_random_bernoulli", prob=0.3)
    assert set(np.unique(x)) <= {0.0, 1.0}
    assert abs(x.mean() - 0.3) < 5 * np.sqrt(0.21 / N)


def test_seed_determinism_and_divergence():
    tmx.random.seed(42)
    a = invoke("_random_normal", shape=(64,)).asnumpy()
    tmx.random.seed(42)
    b = invoke("_random_normal", shape=(64,)).asnumpy()
    np.testing.assert_array_equal(a, b)
    c = invoke("_random_normal", shape=(64,)).asnumpy()  # stream advanced
    assert not np.array_equal(a, c)
    tmx.random.seed(43)
    d = invoke("_random_normal", shape=(64,)).asnumpy()
    assert not np.array_equal(a, d)
    tmx.random.seed(42, ctx=tmx.cpu())
    np.testing.assert_array_equal(
        invoke("_random_normal", shape=(64,)).asnumpy(), a)


def test_no_draw_touches_torchs_global_generator():
    state = torch.get_rng_state()
    tmx.random.seed(1)
    for op, params, _, _ in _ROWS:
        invoke(op, shape=(16,), **params)
    invoke("shuffle", tnd.arange(8))
    assert torch.equal(torch.get_rng_state(), state)


def test_each_thread_has_its_own_stream_as_in_the_reference():
    tmx.random.seed(5)
    main = invoke("_random_uniform", shape=(8,)).asnumpy()
    got = {}

    def worker():
        with tmx.cpu():
            got["fresh"] = invoke("_random_uniform", shape=(8,)).asnumpy()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    tmx.random.seed(0)          # a thread that never seeded draws seed 0
    np.testing.assert_array_equal(
        got["fresh"], invoke("_random_uniform", shape=(8,)).asnumpy())
    assert not np.array_equal(main, got["fresh"])


def test_sample_ops_parameter_broadcast():
    tmx.random.seed(0)
    mu = tnd.array(np.array([0.0, 100.0], np.float32))
    sd = tnd.array(np.array([1.0, 1.0], np.float32))
    out = invoke("_sample_normal", mu, sd, shape=(4000,)).asnumpy()
    assert out.shape == (2, 4000)
    assert abs(out[0].mean()) < 0.2 and abs(out[1].mean() - 100.0) < 0.2
    lo = tnd.array(np.array([[0.0], [10.0]], np.float32))
    hi = tnd.array(np.array([[1.0], [20.0]], np.float32))
    u = invoke("_sample_uniform", lo, hi, shape=3).asnumpy()
    assert u.shape == (2, 1, 3)
    assert (u[0] >= 0).all() and (u[0] < 1).all() and (u[1] >= 10).all()
    lam = tnd.array(np.array([1.0, 50.0], np.float32))
    for op, args in (("_sample_poisson", (lam,)),
                     ("_sample_exponential", (lam,)),
                     ("_sample_gamma", (lam, tnd.ones((2,)))),
                     ("_sample_negative_binomial",
                      (lam, tnd.full((2,), 0.5))),
                     ("_sample_generalized_negative_binomial",
                      (lam, tnd.full((2,), 0.25)))):
        x = invoke(op, *args, shape=(N,)).asnumpy()
        assert x.shape == (2, N)
        means = {"_sample_poisson": [1, 50], "_sample_exponential":
                 [1, 1 / 50], "_sample_gamma": [1, 50],
                 "_sample_negative_binomial": [1, 50],
                 "_sample_generalized_negative_binomial": [1, 50]}[op]
        np.testing.assert_allclose(x.mean(axis=1), means, rtol=0.05,
                                   err_msg=op)


def test_shuffle_is_permutation():
    tmx.random.seed(1)
    x = tnd.array(np.arange(512, dtype=np.float32))
    y = invoke("shuffle", x).asnumpy()
    assert sorted(y.tolist()) == list(range(512))
    assert not np.array_equal(y, np.arange(512))
    rows = tnd.array(np.arange(12, dtype=np.float32).reshape(6, 2))
    r = tnd.random.shuffle(rows).asnumpy()
    assert sorted(r[:, 0].tolist()) == list(range(0, 12, 2))
    np.testing.assert_array_equal(r[:, 1], r[:, 0] + 1)


def test_f_geometric_power_negative_binomial_moments():
    tmx.random.seed(0)
    f = invoke("_random_f", dfnum=5.0, dfden=8.0, shape=(N,)).asnumpy()
    assert abs(f.mean() - 8 / 6) < 0.05
    g = invoke("_random_geometric", p=0.3, shape=(N,)).asnumpy()
    assert abs(g.mean() - 1 / 0.3) < 0.1 and g.min() >= 1
    p = invoke("_random_power", a=3.0, shape=(N,)).asnumpy()
    assert abs(p.mean() - 0.75) < 0.01 and p.max() <= 1.0
    nb = invoke("_random_negative_binomial", k=4, p=0.4,
                shape=(N,)).asnumpy()
    assert abs(nb.mean() - 6.0) < 0.15


def test_multinomial_shapes_and_log_probabilities_match_reference():
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], np.float32)
    tmx.random.seed(0)
    jmx.random.seed(0)
    for kw in ({}, {"shape": 4}, {"shape": (2, 3)}):
        t = invoke("_sample_multinomial", tnd.array(probs), **kw)
        j = jinvoke("_sample_multinomial", jmx.nd.array(probs), **kw)
        assert t.shape == j.shape and str(t.dtype) == str(j.dtype)
    t = tnd.random.multinomial(tnd.array(probs[0]))
    assert t.shape == () and 0 <= int(t.asnumpy()) <= 2
    samp, logp = invoke("_sample_multinomial", tnd.array(probs), shape=N,
                        get_prob=True)
    samp, logp = samp.asnumpy(), logp.asnumpy()
    np.testing.assert_allclose(logp, np.log(probs[np.arange(2)[:, None],
                                                  samp]), rtol=1e-6)
    np.testing.assert_allclose([(samp[0] == k).mean() for k in range(3)],
                               probs[0], atol=0.01)
    assert (samp[1] != 2).all()


_LIKE = [("_random_uniform_like", {"low": -1.0, "high": 3.0}, 1.0, 4 / 3),
         ("_random_normal_like", {"loc": 2.0, "scale": 3.0}, 2.0, 9.0),
         ("sample_normal_like", {"loc": 2.0, "scale": 3.0}, 2.0, 9.0),
         ("_random_exponential_like", {"lam": 2.0}, 0.5, 0.25),
         ("_random_gamma_like", {"alpha": 4.0, "beta": 0.5}, 2.0, 1.0),
         ("_random_poisson_like", {"lam": 6.0}, 6.0, 6.0),
         ("_random_negative_binomial_like", {"k": 5, "p": 0.5}, 5.0, 10.0),
         ("_random_generalized_negative_binomial_like",
          {"mu": 4.0, "alpha": 0.25}, 4.0, 8.0)]


@pytest.mark.parametrize("op,params,mean,var", _LIKE,
                         ids=[m[0] for m in _LIKE])
def test_like_forms_take_the_templates_shape_and_dtype(op, params, mean,
                                                       var):
    tmx.random.seed(3)
    out = invoke(op, tnd.zeros((200, 200)), **params)
    ref = jinvoke(op, jmx.nd.zeros((2, 2)), **params)
    assert out.shape == (200, 200) and str(out.dtype) == str(ref.dtype)
    x = out.asnumpy().astype(np.float64)
    assert abs(x.mean() - mean) < 5 * np.sqrt(var / x.size) + 1e-3
    assert abs(x.var() - var) < 0.15 * var + 5e-3


def test_nd_random_namespace_dtypes_and_contexts():
    tmx.random.seed(2)
    for name in ("uniform", "normal", "gamma", "exponential", "poisson",
                 "randint", "bernoulli"):
        fn = getattr(tnd.random, name)
        t = fn(shape=(3, 2), ctx=tmx.cpu()) if name != "randint" else \
            fn(0, 5, shape=(3, 2))
        j = getattr(jmx.nd.random, name)(shape=(3, 2)) \
            if name != "randint" else jmx.nd.random.randint(0, 5,
                                                            shape=(3, 2))
        assert t.shape == j.shape and str(t.dtype) == str(j.dtype), name
        assert t.context == tmx.cpu()
    assert tnd.random.randn(2, 3).shape == (2, 3)
    x = tnd.random.uniform(0, 1, shape=(4,), dtype="bfloat16")
    assert x.dtype == "bfloat16"
    z, cnt = invoke("_sample_unique_zipfian", range_max=1000, shape=(64,))
    z = z.asnumpy()
    assert len(set(z.tolist())) == 64 and z.min() >= 0 and z.max() < 1000
    assert cnt.shape == (64,) and (cnt.asnumpy() > 0).all()
