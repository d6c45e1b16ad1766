"""Random sampling ops.

Counterpart of ``mxnet_tpu/ops/random.py`` (reference:
src/operator/random/sample_op.cc, multisample_op.cc,
unique_sample_op.cc; src/resource.cc's per-device random states seeded by
``mx.random.seed``).  What differs, and why:

* The reference folds a counter into a root JAX key per draw.  Here every
  draw comes from an explicit ``torch.Generator`` of the output's device,
  never from torch's global generator, so :func:`seed` fixes every stream
  the ops draw from.  JAX keys are not torch generators, so the draws
  cannot equal the reference's bit for bit; the tests hold them to the
  same moments, bounds, determinism and shapes as the reference's own
  (``tests/test_random.py``).
* As in the reference, the state is per thread: a thread that never
  seeded draws from seed 0, and :func:`seed` reseeds the calling thread's
  generators on every device (the reference's ``seed(s, ctx)`` collapses
  to one root key too).
* An op with no array input gets its device from dispatch (``ctx=``,
  else the current context); the others draw on their input's device.
  Draws are made in float32 (float64 when asked) and cast to the
  requested dtype.  Of the ``_npi_*`` samplers, the 14 that carry the
  legacy aliases (``laplace``, ``random_laplace``, ...) are here; the
  others wait for the ``numpy`` front end.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import torch_dtype
from .registry import register

__all__ = ["seed", "generator"]

_state = threading.local()
_DEFAULT_SEED = 0


def _root():
    if not hasattr(_state, "seed"):
        _state.seed = _DEFAULT_SEED
        _state.gens = {}
    return _state


def seed(seed_val: int) -> None:
    """Reseed the calling thread's generators, on every device."""
    st = _root()
    st.seed = int(seed_val)
    st.gens = {}


def generator(device) -> torch.Generator:
    """The calling thread's generator of ``device``, made from the current
    seed at its first use."""
    st = _root()
    device = torch.device(device)
    key = (device.type, device.index or 0)
    gen = st.gens.get(key)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(st.seed)
        st.gens[key] = gen
    return gen


def _dt(dtype):
    return torch.float32 if dtype in (None, "None") else torch_dtype(dtype)


def _shape(shape):
    if isinstance(shape, (tuple, list)):
        return tuple(int(s) for s in shape)
    return (int(shape),) if shape else ()


def _work(dt):
    """The dtype a draw is made in."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _rand(shape, device, dt=torch.float32):
    return torch.rand(_shape(shape), generator=generator(device),
                      device=device, dtype=_work(dt))


def _randn(shape, device, dt=torch.float32):
    return torch.randn(_shape(shape), generator=generator(device),
                       device=device, dtype=_work(dt))


def _u(shape, device):
    """Uniform in (0, 1): open at 0 so ``log`` stays finite."""
    return _rand(shape, device).clamp_min(torch.finfo(torch.float32).tiny)


def _gamma_draw(alpha, device):
    """Gamma(alpha, 1) draws, one per entry of the float32 tensor
    ``alpha``."""
    return torch._standard_gamma(alpha, generator=generator(device))


def _poisson_draw(lam, device):
    return torch.poisson(lam, generator=generator(device))


def _full(shape, value, device):
    return torch.full(_shape(shape), float(value), dtype=torch.float32,
                      device=device)


@register("_random_uniform", aliases=["random_uniform", "uniform"],
          differentiable=False)
def _uniform(low=0.0, high=1.0, shape=(), dtype=None, device=None):
    dt = _dt(dtype)
    return (_rand(shape, device, dt) * (high - low) + low).to(dt)


@register("_random_normal", aliases=["random_normal", "normal"],
          differentiable=False)
def _normal(loc=0.0, scale=1.0, shape=(), dtype=None, device=None):
    dt = _dt(dtype)
    return (_randn(shape, device, dt) * scale + loc).to(dt)


@register("_random_gamma", aliases=["random_gamma"], differentiable=False)
def _gamma(alpha=1.0, beta=1.0, shape=(), dtype=None, device=None):
    g = _gamma_draw(_full(shape, alpha, device), device)
    return (g * beta).to(_dt(dtype))


@register("_random_exponential", aliases=["random_exponential"],
          differentiable=False)
def _exponential(lam=1.0, shape=(), dtype=None, device=None):
    e = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    e.exponential_(1.0, generator=generator(device))
    return (e / lam).to(_dt(dtype))


@register("_random_poisson", aliases=["random_poisson"],
          differentiable=False)
def _poisson(lam=1.0, shape=(), dtype=None, device=None):
    return _poisson_draw(_full(shape, lam, device), device).to(_dt(dtype))


@register("_random_randint", aliases=["random_randint"],
          differentiable=False)
def _randint(low=0, high=2, shape=(), dtype="int32", device=None):
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator(device), device=device,
                         dtype=torch_dtype(dtype or "int32"))


@register("_random_bernoulli", aliases=["bernoulli"], differentiable=False)
def _bernoulli(prob=0.5, shape=(), dtype=None, device=None):
    p = _full(shape, prob, device)
    return torch.bernoulli(p, generator=generator(device)).to(_dt(dtype))


@register("_sample_multinomial",
          aliases=["sample_multinomial", "multinomial"],
          differentiable=False)
def _multinomial(data, shape=(), get_prob=False, dtype="int32"):
    """``shape`` draws of a category per row of probabilities ``data``
    (..., k): output ``data.shape[:-1] + shape`` (a scalar for one row and
    no ``shape``); ``get_prob`` also returns each draw's log
    probability."""
    extra = _shape(shape)
    n = int(np.prod(extra)) if extra else 1
    probs = data.float().clamp_min(1e-37)
    rows = probs.reshape(-1, probs.shape[-1])
    samp = torch.multinomial(rows, n, replacement=True,
                             generator=generator(data.device))
    samp = samp.reshape(tuple(data.shape[:-1]) + extra)
    if get_prob:
        logp = torch.log(rows).gather(1, samp.reshape(rows.shape[0], n))
        return (samp.to(torch_dtype(dtype or "int32")),
                logp.reshape(samp.shape))
    return samp.to(torch_dtype(dtype or "int32"))


@register("shuffle", aliases=["_shuffle"], differentiable=False)
def _shuffle(data):
    """A random permutation of ``data`` along its first axis."""
    perm = torch.randperm(data.shape[0], generator=generator(data.device),
                          device=data.device)
    return data[perm]


@register("sample_normal_like", differentiable=False)
def _normal_like(data, loc=0.0, scale=1.0):
    return (_randn(data.shape, data.device) * scale + loc).to(data.dtype)


# -- the distribution tail (sample_op.cc): inverse-CDF transforms over
# uniform, gamma and Poisson draws -------------------------------------------

@register("_random_negative_binomial",
          aliases=["random_negative_binomial", "negative_binomial"],
          differentiable=False)
def _negative_binomial(k=1, p=1.0, shape=(), dtype=None, device=None):
    """NB(k, p) == Poisson(Gamma(k, (1 - p) / p))."""
    lam = _gamma_draw(_full(shape, float(k), device), device) * \
        ((1.0 - p) / max(p, 1e-12))
    return _poisson_draw(lam, device).to(_dt(dtype))


@register("_random_generalized_negative_binomial",
          aliases=["random_generalized_negative_binomial",
                   "generalized_negative_binomial"],
          differentiable=False)
def _gen_negative_binomial(mu=1.0, alpha=1.0, shape=(), dtype=None,
                           device=None):
    """GNB(mu, alpha): Poisson with a Gamma(1 / alpha, mu * alpha) rate."""
    if alpha == 0.0:
        return _poisson_draw(_full(shape, mu, device), device) \
            .to(_dt(dtype))
    lam = _gamma_draw(_full(shape, 1.0 / alpha, device), device) * \
        (mu * alpha)
    return _poisson_draw(lam, device).to(_dt(dtype))


@register("_random_pareto", aliases=["random_pareto", "pareto"],
          differentiable=False)
def _pareto(a=1.0, shape=(), dtype=None, device=None):
    return torch.expm1(-torch.log(_u(shape, device)) / a).to(_dt(dtype))


@register("_random_rayleigh", aliases=["random_rayleigh", "rayleigh"],
          differentiable=False)
def _rayleigh(scale=1.0, shape=(), dtype=None, device=None):
    u = _u(shape, device)
    return (scale * torch.sqrt(-2.0 * torch.log(u))).to(_dt(dtype))


@register("_random_weibull", aliases=["random_weibull", "weibull"],
          differentiable=False)
def _weibull(a=1.0, shape=(), dtype=None, device=None):
    u = _u(shape, device)
    return torch.pow(-torch.log(u), 1.0 / a).to(_dt(dtype))


@register("_random_logistic", aliases=["random_logistic", "logistic"],
          differentiable=False)
def _logistic(loc=0.0, scale=1.0, shape=(), dtype=None, device=None):
    u = _u(shape, device)
    return ((torch.log(u) - torch.log1p(-u)) * scale + loc).to(_dt(dtype))


@register("_random_gumbel", aliases=["random_gumbel", "gumbel"],
          differentiable=False)
def _gumbel(loc=0.0, scale=1.0, shape=(), dtype=None, device=None):
    u = _u(shape, device)
    return (-torch.log(-torch.log(u)) * scale + loc).to(_dt(dtype))


@register("_random_f", aliases=["random_f"], differentiable=False)
def _f_dist(dfnum=1.0, dfden=1.0, shape=(), dtype=None, device=None):
    """F(d1, d2) = (X1 / d1) / (X2 / d2) for chi-square X1, X2."""
    x1 = 2.0 * _gamma_draw(_full(shape, dfnum / 2.0, device), device)
    x2 = 2.0 * _gamma_draw(_full(shape, dfden / 2.0, device), device)
    return ((x1 / dfnum) / (x2 / dfden)).to(_dt(dtype))


@register("_random_geometric", aliases=["random_geometric"],
          differentiable=False)
def _geometric(p=0.5, shape=(), dtype=None, device=None):
    """Trials to the first success, support {1, 2, ...}:
    ceil(log(U) / log(1 - p))."""
    u = _u(shape, device)
    return torch.ceil(torch.log(u) / np.log1p(-p)).to(_dt(dtype))


@register("_random_power", aliases=["random_power"], differentiable=False)
def _power_dist(a=1.0, shape=(), dtype=None, device=None):
    """The power distribution on [0, 1]: U^(1 / a)."""
    return torch.pow(_u(shape, device), 1.0 / a).to(_dt(dtype))


# -- the sample_* family (multisample_op.cc): per-entry parameters as
# tensors; each entry draws ``shape`` samples --------------------------------

def _per_entry(params, shape):
    """``params`` broadcast to ``params[0].shape + shape`` in float32."""
    extra = _shape(shape)
    out_shape = tuple(params[0].shape) + extra
    return [p.float().reshape(tuple(p.shape) + (1,) * len(extra))
            .expand(out_shape) for p in params], out_shape


@register("_sample_uniform", aliases=["sample_uniform"],
          differentiable=False)
def _sample_uniform(low, high, shape=(), dtype=None):
    (lo, hi), out_shape = _per_entry((low, high), shape)
    u = _rand(out_shape, low.device)
    return (lo + u * (hi - lo)).to(_dt(dtype))


@register("_sample_normal", aliases=["sample_normal"], differentiable=False)
def _sample_normal(mu, sigma, shape=(), dtype=None):
    (m, s), out_shape = _per_entry((mu, sigma), shape)
    return (m + _randn(out_shape, mu.device) * s).to(_dt(dtype))


@register("_sample_gamma", aliases=["sample_gamma"], differentiable=False)
def _sample_gamma(alpha, beta, shape=(), dtype=None):
    (a, b), _ = _per_entry((alpha, beta), shape)
    return (_gamma_draw(a.contiguous(), alpha.device) * b).to(_dt(dtype))


@register("_sample_exponential", aliases=["sample_exponential"],
          differentiable=False)
def _sample_exponential(lam, shape=(), dtype=None):
    (lm,), out_shape = _per_entry((lam,), shape)
    e = torch.empty(out_shape, dtype=torch.float32, device=lam.device)
    e.exponential_(1.0, generator=generator(lam.device))
    return (e / lm).to(_dt(dtype))


@register("_sample_poisson", aliases=["sample_poisson"],
          differentiable=False)
def _sample_poisson(lam, shape=(), dtype=None):
    (lm,), _ = _per_entry((lam,), shape)
    return _poisson_draw(lm.contiguous(), lam.device).to(_dt(dtype))


@register("_sample_negative_binomial",
          aliases=["sample_negative_binomial"], differentiable=False)
def _sample_negative_binomial(k, p, shape=(), dtype=None):
    (kb, pb), _ = _per_entry((k, p), shape)
    lam = _gamma_draw(kb.contiguous(), k.device) * \
        ((1.0 - pb) / pb.clamp_min(1e-12))
    return _poisson_draw(lam, k.device).to(_dt(dtype))


@register("_sample_generalized_negative_binomial",
          aliases=["sample_generalized_negative_binomial"],
          differentiable=False)
def _sample_gen_negative_binomial(mu, alpha, shape=(), dtype=None):
    (mb, ab), _ = _per_entry((mu, alpha), shape)
    r = 1.0 / ab.clamp_min(1e-12)
    lam = _gamma_draw(r.contiguous(), mu.device) * (mb * ab)
    return _poisson_draw(lam, mu.device).to(_dt(dtype))


@register("_sample_unique_zipfian", aliases=["sample_unique_zipfian"],
          differentiable=False, num_outputs=2)
def _sample_unique_zipfian(range_max=1, shape=(), device=None):
    """Unique log-uniform (Zipfian) draws for sampled softmax: the samples
    (int64) and each one's expected count over the trials made.  The
    rejection loop is numpy's, seeded from the device's generator."""
    n = int(np.prod(_shape(shape))) if _shape(shape) else 1
    seed_val = int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=generator(device),
                                 device=device))
    rng = np.random.RandomState(seed_val)
    log_range = np.log(range_max + 1.0)
    out, seen, trials = [], set(), 0
    while len(out) < n:
        v = int(np.exp(rng.rand() * log_range)) - 1
        v = min(max(v, 0), range_max - 1)
        trials += 1
        if v not in seen:
            seen.add(v)
            out.append(v)
    samples = np.asarray(out, np.int64)
    prob = np.log((samples + 2.0) / (samples + 1.0)) / log_range
    return (torch.as_tensor(samples, device=device),
            torch.as_tensor((prob * trials).astype(np.float32),
                            device=device))


# -- the *_like forms (sample_op.cc): the template's shape and dtype ---------

@register("_random_uniform_like", aliases=["random_uniform_like"],
          differentiable=False)
def _uniform_like(data, low=0.0, high=1.0):
    return (_rand(data.shape, data.device) * (high - low) + low) \
        .to(data.dtype)


@register("_random_normal_like", aliases=["random_normal_like"],
          differentiable=False)
def _random_normal_like(data, loc=0.0, scale=1.0):
    return (_randn(data.shape, data.device) * scale + loc).to(data.dtype)


@register("_random_exponential_like", aliases=["random_exponential_like"],
          differentiable=False)
def _exponential_like(data, lam=1.0):
    return _exponential(lam, tuple(data.shape), device=data.device) \
        .to(data.dtype)


@register("_random_gamma_like", aliases=["random_gamma_like"],
          differentiable=False)
def _gamma_like(data, alpha=1.0, beta=1.0):
    return _gamma(alpha, beta, tuple(data.shape), device=data.device) \
        .to(data.dtype)


@register("_random_poisson_like", aliases=["random_poisson_like"],
          differentiable=False)
def _poisson_like(data, lam=1.0):
    return _poisson(lam, tuple(data.shape), device=data.device) \
        .to(data.dtype)


@register("_random_negative_binomial_like",
          aliases=["random_negative_binomial_like"], differentiable=False)
def _negative_binomial_like(data, k=1, p=1.0):
    return _negative_binomial(k, p, tuple(data.shape), device=data.device) \
        .to(data.dtype)


@register("_random_generalized_negative_binomial_like",
          aliases=["random_generalized_negative_binomial_like"],
          differentiable=False)
def _gnb_like(data, mu=1.0, alpha=1.0):
    return _gen_negative_binomial(mu, max(alpha, 1e-12), tuple(data.shape),
                                  device=data.device).to(data.dtype)


# -- the numpy-era samplers that carry the legacy aliases
# (src/operator/numpy/random/*.cc): ``size`` is the output shape (None: a
# scalar), the parameters are Python scalars, as the reference's static
# parameters are (an array raises TypeError there too) ------------------------

def _scalars(op, **params):
    """Each parameter as a float; an array raises ``TypeError``."""
    out = []
    for name, v in params.items():
        if isinstance(v, bool) or not isinstance(v, (int, float, np.number)):
            raise TypeError("%s: parameter %r must be a scalar, got %r"
                            % (op, name, type(v).__name__))
        out.append(float(v))
    return out


@register("_npi_laplace", aliases=["random_laplace", "laplace"],
          differentiable=False)
def _npi_laplace(loc=0.0, scale=1.0, size=None, dtype=None, device=None):
    loc, scale = _scalars("laplace", loc=loc, scale=scale)
    dt = _dt(dtype)
    u = _rand(size, device, dt).clamp_min(1e-7) - 0.5     # (-0.5, 0.5)
    x = -torch.sign(u) * torch.log1p(-2.0 * u.abs())
    return (x * scale + loc).to(dt)


@register("_npi_beta", aliases=["random_beta", "beta"],
          differentiable=False)
def _npi_beta(a=1.0, b=1.0, size=None, dtype=None, device=None):
    """X / (X + Y) for X ~ Gamma(a), Y ~ Gamma(b)."""
    a, b = _scalars("beta", a=a, b=b)
    dt = _dt(dtype)
    x = _gamma_draw(_full(size, a, device).to(_work(dt)), device)
    y = _gamma_draw(_full(size, b, device).to(_work(dt)), device)
    return (x / (x + y)).to(dt)


@register("_npi_chisquare", aliases=["random_chisquare", "chisquare"],
          differentiable=False)
def _npi_chisquare(df=1.0, size=None, dtype=None, device=None):
    (df,) = _scalars("chisquare", df=df)
    dt = _dt(dtype)
    g = _gamma_draw(_full(size, df / 2.0, device).to(_work(dt)), device)
    return (2.0 * g).to(dt)


@register("_npi_standard_t", aliases=["random_standard_t", "standard_t"],
          differentiable=False)
def _npi_standard_t(df=1.0, size=None, dtype=None, device=None):
    """Z / sqrt(V / df) for Z ~ N(0, 1), V ~ chi-square(df)."""
    (df,) = _scalars("standard_t", df=df)
    dt = _dt(dtype)
    z = _randn(size, device, dt)
    v = 2.0 * _gamma_draw(_full(size, df / 2.0, device).to(z.dtype), device)
    return (z / torch.sqrt(v / df)).to(dt)


@register("_npi_lognormal", aliases=["random_lognormal", "lognormal"],
          differentiable=False)
def _npi_lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, device=None):
    mean, sigma = _scalars("lognormal", mean=mean, sigma=sigma)
    dt = _dt(dtype)
    return torch.exp(_randn(size, device, dt) * sigma + mean).to(dt)


@register("_npi_triangular", aliases=["random_triangular", "triangular"],
          differentiable=False)
def _npi_triangular(left=0.0, mode=0.5, right=1.0, size=None, dtype=None,
                    device=None):
    left, mode, right = _scalars("triangular", left=left, mode=mode,
                                 right=right)
    dt = _dt(dtype)
    u = _rand(size, device, dt)
    c = (mode - left) / (right - left)
    lo = left + torch.sqrt(u * (right - left) * (mode - left))
    hi = right - torch.sqrt((1 - u) * (right - left) * (right - mode))
    return torch.where(u < c, lo, hi).to(dt)


@register("_npi_dirichlet", aliases=["random_dirichlet", "dirichlet"],
          differentiable=False)
def _npi_dirichlet(alpha=(1.0,), size=None, dtype=None, device=None):
    """Normalised Gamma(alpha_i) draws: shape ``size + (len(alpha),)``."""
    if not isinstance(alpha, (tuple, list)):
        raise TypeError("dirichlet: alpha must be a tuple of scalars, got "
                        "%r" % type(alpha).__name__)
    alpha = _scalars("dirichlet", **{"alpha%d" % i: a
                                     for i, a in enumerate(alpha)})
    dt = _dt(dtype)
    a = torch.tensor(alpha, dtype=_work(dt), device=device)
    g = _gamma_draw(a.expand(_shape(size) + (len(alpha),)).contiguous(),
                    device)
    return (g / g.sum(-1, keepdim=True)).to(dt)


@register("_npi_standard_cauchy",
          aliases=["random_standard_cauchy", "standard_cauchy"],
          differentiable=False)
def _npi_standard_cauchy(size=None, dtype=None, device=None):
    """tan(pi (U - 1/2)), U in (0, 1)."""
    dt = _dt(dtype)
    u = _rand(size, device, dt).clamp_min(1e-7)
    return torch.tan(np.pi * (u - 0.5)).to(dt)


@register("_npi_standard_gamma",
          aliases=["random_standard_gamma", "standard_gamma"],
          differentiable=False)
def _npi_standard_gamma(shape_param=1.0, size=None, dtype=None, device=None):
    (k,) = _scalars("standard_gamma", shape_param=shape_param)
    dt = _dt(dtype)
    return _gamma_draw(_full(size, k, device).to(_work(dt)),
                       device).to(dt)


@register("_npi_noncentral_chisquare",
          aliases=["random_noncentral_chisquare", "noncentral_chisquare"],
          differentiable=False)
def _npi_noncentral_chisquare(df=1.0, nonc=0.0, size=None, dtype=None,
                              device=None):
    """The Poisson mixture: chi-square(df + 2K) for K ~ Poisson(nonc / 2)."""
    df, nonc = _scalars("noncentral_chisquare", df=df, nonc=nonc)
    dt = _dt(dtype)
    k = _poisson_draw(_full(size, nonc / 2.0, device), device)
    g = _gamma_draw(((df + 2.0 * k) / 2.0).to(_work(dt)), device)
    return (2.0 * g).to(dt)


@register("_npi_wald", aliases=["random_wald", "wald"],
          differentiable=False)
def _npi_wald(mean=1.0, scale=1.0, size=None, dtype=None, device=None):
    """The inverse Gaussian by the Michael-Schucany-Haas transform."""
    mean, scale = _scalars("wald", mean=mean, scale=scale)
    dt = _dt(dtype)
    v = _randn(size, device, dt) ** 2
    x = (mean + (mean ** 2) * v / (2.0 * scale)
         - (mean / (2.0 * scale))
         * torch.sqrt(4.0 * mean * scale * v + (mean * v) ** 2))
    u = _rand(size, device, dt)
    return torch.where(u <= mean / (mean + x), x, (mean ** 2) / x).to(dt)


@register("_npi_logseries", aliases=["random_logseries", "logseries"],
          differentiable=False)
def _npi_logseries(p=0.5, size=None, dtype=None, device=None):
    """Kemp's exact two-uniform sampler: floor(1 + ln(V) / ln(1 - (1 -
    p)^U)), U and V in [1e-7, 1), as the reference draws them.  One
    elementwise pass on the device; no rejection."""
    (p,) = _scalars("logseries", p=p)
    u = _rand(size, device) * (1.0 - 1e-7) + 1e-7
    v = _rand(size, device) * (1.0 - 1e-7) + 1e-7
    q = 1.0 - torch.pow(torch.tensor(1.0 - p, device=device), u)
    x = torch.floor(1.0 + torch.log(v) / torch.log(q))
    return x.clamp_min(1.0).to(torch_dtype(dtype or "int32"))


_REJECTION_ROUNDS = 64


@register("_npi_vonmises", aliases=["random_vonmises", "vonmises"],
          differentiable=False)
def _npi_vonmises(mu=0.0, kappa=1.0, size=None, dtype=None, device=None):
    """Best and Fisher's (1979) rejection sampler, drawn as the reference
    draws it: 64 rounds, each proposing for every entry at once on the
    device and keeping an entry's first accepted proposal (a round accepts
    65 % or more, so an entry unfilled after 64 rounds has odds below
    1e-29).  No per-sample loop and no host read.  ``kappa`` below 1e-6 is
    the uniform circular distribution, as in numpy."""
    mu, kappa = _scalars("vonmises", mu=mu, kappa=kappa)
    dt = _dt(dtype)
    shape = _shape(size)
    if kappa < 1e-6:
        theta = 2.0 * np.pi * _rand(shape, device, dt) - np.pi
        return (torch.remainder(theta + mu + np.pi, 2.0 * np.pi)
                - np.pi).to(dt)
    r = 1.0 + np.sqrt(1.0 + 4.0 * kappa ** 2)
    rho = (r - np.sqrt(2.0 * r)) / (2.0 * kappa)
    s = (1.0 + rho ** 2) / (2.0 * rho)
    out = torch.zeros(shape, dtype=_work(dt), device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for _ in range(_REJECTION_ROUNDS):
        u1, u2, u3 = (_rand(shape, device, dt) * (1.0 - 1e-7) + 1e-7
                      for _ in range(3))
        z = torch.cos(np.pi * u1)
        f = (1.0 + s * z) / (s + z)
        c = kappa * (s - f)
        accept = (c * (2.0 - c) - u2 > 0) | \
            (torch.log(c / u2) + 1.0 - c >= 0)
        theta = torch.sign(u3 - 0.5) * torch.arccos(f.clamp(-1.0, 1.0))
        out = torch.where(done | ~accept, out, theta)
        done = done | accept
    return (torch.remainder(out + mu + np.pi, 2.0 * np.pi) - np.pi).to(dt)


@register("_npi_zipf", aliases=["random_zipf", "zipf"],
          differentiable=False)
def _npi_zipf(a=2.0, size=None, dtype=None, device=None):
    """Devroye's rejection-inversion sampler, drawn as the reference draws
    it: 64 rounds, each proposing x = floor(U^(-1 / (a - 1))) for every
    entry at once on the device and keeping an entry's first accepted
    proposal (a round accepts half or more for a > 1, so an entry unfilled
    after 64 rounds has odds below 1e-19; it keeps 1).  No per-sample loop
    and no host read."""
    (a,) = _scalars("zipf", a=a)
    if not a > 1.0:
        raise ValueError("zipf: a must be > 1 (got %r)" % (a,))
    shape = _shape(size)
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.ones(shape, dtype=torch.float32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for _ in range(_REJECTION_ROUNDS):
        u = _rand(shape, device) * (1.0 - 1e-7) + 1e-7
        v = _rand(shape, device)
        x = torch.floor(torch.pow(u, -1.0 / am1))
        t = torch.pow(1.0 + 1.0 / x, am1)
        accept = (v * x * (t - 1.0) / (b - 1.0) <= t / b) & (x >= 1.0) & \
            torch.isfinite(x)
        out = torch.where(done | ~accept, out, x)
        done = done | accept
    return out.to(torch_dtype(dtype or "int32"))
