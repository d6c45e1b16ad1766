"""The port's other thirteen optimizers and their 22 dense update ops
against the JAX reference, on the CPU.

Each registered op (``nd.rmsprop_update``, ``nd.multi_lars``,
``nd.preloaded_multi_sgd_mom_update``, ``nd.multi_mp_lans_update``, ...,
each alias by its own name) is called 3 times on the same seeded numpy
inputs in both packages; every array it writes in place and every output
it returns must agree.  Each optimizer (RMSProp plain and centred,
AdaGrad, AdaDelta, Ftrl, LARS, SignSGD, Signum, DCASGD, Test, FTML,
Adamax, Nadam and SGLD's deterministic part), in float32 and in bfloat16
with ``multi_precision``, takes 3 steps through an ``Updater`` over three
parameters with ``lr_mult``/``wd_mult`` from ``param_dict``; weights and
states must agree after every step.  Tolerance: float32 within 1e-6 +
1e-5 * |ref|; a bfloat16 weight within one bfloat16 ulp of the
reference's.  SGLD's noise is held by its mean and standard deviation on
2**18 draws of an explicit ``torch.Generator``: each within 6 standard
errors of N(0, lr).  The four ``_sparse_*`` updates raise, naming Queue 1
item 8.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

SHAPE = (4, 6)
N = 3                       # the length of the per-layer vectors


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _f32(a):
    a = a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)
    return np.asarray(a, dtype=np.float32)


def assert_close(got, want, bf16=False, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    assert np.isfinite(want).all(), what
    if bf16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        bad = np.abs(got - want) > ulp
    else:
        bad = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert not bad.any(), "%s: %d entries off, worst %g" % (
        what, bad.sum(), np.abs(got - want).max())


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------

# input letters: w f32 weight, W bf16 weight, g f32 gradient, G bf16
# gradient, m f32 state, p f32 state >= 1, s small f32 state, h a row
# history (4, 1) >= 0, M the f32 master of the last W, L a (N,) or (2,)
# vector of lrs, D of wds, q a (N,) vector of positive sums of squares
LARS_KW = dict(eta=0.01, eps=1e-8, rescale_grad=0.5)
LAMB_KW = dict(learning_rates=(0.01, 0.02), wds=(0.01, 0.0), t=2,
               lower_bound=0.01, upper_bound=20.0, rescale_grad=0.5,
               num_weights=2)
OPS = {
    "rmsprop_update": ("wgp", dict(lr=0.01, gamma1=0.9, wd=0.01,
                                   rescale_grad=0.5, clip_gradient=0.3,
                                   clip_weights=1.5)),
    "rmsprop_update[bf16]": ("Wgp", dict(lr=0.01, wd=0.01)),
    "rmspropalex_update": ("wgpss", dict(lr=0.01, gamma1=0.95, gamma2=0.9,
                                         wd=0.01, rescale_grad=0.5,
                                         clip_weights=1.5)),
    "adagrad_update": ("wgp", dict(lr=0.1, epsilon=1e-7, wd=0.01,
                                   rescale_grad=0.5, clip_gradient=0.4)),
    "adagrad_update[bf16]": ("Wgp", dict(lr=0.1, wd=0.01)),
    "ftrl_update": ("wgmp", dict(lr=0.1, lamda1=0.01, beta=1.0, wd=0.01,
                                 rescale_grad=0.5, clip_gradient=0.8)),
    "ftml_update": ("wgppm", dict(lr=0.0025, beta1=0.6, beta2=0.999, t=2,
                                  wd=0.01, rescale_grad=0.5,
                                  clip_grad=0.8)),
    "signsgd_update": ("wg", dict(lr=0.01, wd=0.01, rescale_grad=0.5)),
    "signsgd_update[bf16]": ("WG", dict(lr=0.01, wd=0.01)),
    "signum_update": ("wgm", dict(lr=0.01, momentum=0.9, wd=0.01,
                                  wd_lh=0.01, clip_gradient=0.3)),
    "group_adagrad_update": ("wgh", dict(lr=0.1, rescale_grad=0.5,
                                         clip_gradient=0.4)),
    "_contrib_group_adagrad_update": ("wgh", dict(lr=0.1, epsilon=1e-4)),
    "multi_lars": ("LqqD", LARS_KW),
    "preloaded_multi_sgd_update": ("wgwgLD", dict(rescale_grad=0.5,
                                                  num_weights=2)),
    "preloaded_multi_sgd_mom_update": ("wgmwgmLD", dict(
        momentum=0.9, clip_gradient=0.3, num_weights=2)),
    "preloaded_multi_mp_sgd_update": ("WGMWGMLD", dict(num_weights=2)),
    "preloaded_multi_mp_sgd_mom_update": ("WGmMWGmMLD", dict(
        momentum=0.9, num_weights=2)),
    "multi_lamb_update": ("wgmpwgmp", LAMB_KW),
    "_contrib_multi_lamb_update": ("wgmpwgmp", dict(
        LAMB_KW, bias_correction=False, clip_gradient=0.5)),
    "multi_mp_lamb_update": ("WGmpMWGmpM", LAMB_KW),
    "_contrib_multi_mp_lamb_update": ("WGmpMWGmpM", LAMB_KW),
    "multi_lans_update": ("wgmpwgmp", LAMB_KW),
    "_multi_lans_update": ("wgmpwgmp", dict(LAMB_KW, clip_gradient=0.2)),
    "multi_mp_lans_update": ("WGmpMWGmpM", LAMB_KW),
    "_multi_mp_lans_update": ("WGmpMWGmpM", dict(LAMB_KW,
                                                 bias_correction=False)),
}


def _op_inputs(letters, seed):
    rng = np.random.RandomState(seed)
    vec = 2 if "L" in letters and "q" not in letters else N
    out, last_w = [], None
    for c in letters:
        if c in "wgmWGs":
            a = rng.randn(*SHAPE).astype(np.float32)
        if c == "s":
            a = a * np.float32(0.1)
        if c in "WG":
            a = _f32(jnd.array(a, dtype="bfloat16"))     # bf16 values
        if c == "W":
            last_w = a
        if c == "p":
            a = 1.0 + np.abs(rng.randn(*SHAPE)).astype(np.float32)
        elif c == "h":
            a = np.abs(rng.randn(SHAPE[0], 1)).astype(np.float32)
        elif c == "M":
            a = last_w.copy()
        elif c == "L":
            a = rng.uniform(0.01, 0.1, vec).astype(np.float32)
        elif c == "D":
            a = rng.uniform(0.0, 0.02, vec).astype(np.float32)
        elif c == "q":
            a = rng.uniform(0.5, 4.0, vec).astype(np.float32)
        out.append((a, "bfloat16" if c in "WG" else "float32"))
    return out


def _run_op(pkg_nd, name, letters, kw, steps=3):
    arrays = [pkg_nd.array(a, dtype=dt) for a, dt in _op_inputs(letters, 5)]
    results = []
    for _ in range(steps):
        out = getattr(pkg_nd, name)(*arrays, **kw)
        outs = out if isinstance(out, list) else [out]
        results.append([_f32(o) for o in outs] + [_f32(a) for a in arrays])
    return results


@pytest.mark.parametrize("case", sorted(OPS))
def test_update_op_matches_reference(case):
    letters, kw = OPS[case]
    name = case.split("[")[0]
    want = _run_op(jnd, name, letters, kw)
    got = _run_op(tnd, name, letters, kw)
    n_out = len(want[0]) - len(letters)
    for step, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            idx = i - n_out
            bf16 = idx >= 0 and letters[idx] in "WG"
            assert_close(a, b, bf16, "%s step %d array %d" % (case, step, i))


def test_every_dense_update_op_of_the_reference_is_registered():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    def names(reg):
        return {n for n in reg.list_ops()
                if reg.get_op(n).fn.__module__.endswith("ops.optimizer")}

    missing = names(jreg) - names(treg)
    assert missing == set(), sorted(missing)
    assert {n.split("[")[0] for n in OPS} >= {
        n for n in names(jreg) if not n.startswith("_sparse_")} - {
        n for n in names(jreg) if n in _EARLIER_OPS}


#: the update ops tested in tests/test_torch_optimizer.py
_EARLIER_OPS = {
    "sgd_update", "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
    "nag_mom_update", "mp_nag_mom_update", "adam_update", "adamw_update",
    "_adamw_update", "_contrib_adamw_update", "mp_adamw_update",
    "_mp_adamw_update", "lamb_update_phase1", "lamb_update_phase2",
    "mp_lamb_update_phase1", "mp_lamb_update_phase2", "multi_sgd_update",
    "multi_sgd_mom_update", "multi_mp_sgd_update", "multi_mp_sgd_mom_update",
    "multi_sum_sq", "reset_arrays", "multi_adamw_update",
    "_multi_adamw_update", "multi_mp_adamw_update", "_multi_mp_adamw_update"}


@pytest.mark.parametrize("name", ["_sparse_sgd_update",
                                  "_sparse_sgd_mom_update",
                                  "_sparse_adam_update",
                                  "_sparse_adagrad_update"])
def test_sparse_updates_raise_naming_item_8(name):
    w = tnd.array(np.ones(3, np.float32))
    with pytest.raises(MXNetError, match="Queue 1 item 8"):
        getattr(tnd, name)(w, w, w)


# ---------------------------------------------------------------------------
# the optimizers through an Updater
# ---------------------------------------------------------------------------

class _Mults:
    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


OPTIMIZERS = {
    "rmsprop": ("rmsprop", dict(learning_rate=0.01, wd=0.01,
                                clip_gradient=0.5, clip_weights=2.0)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, wd=0.01,
                                         centered=True)),
    "adagrad": ("adagrad", dict(learning_rate=0.1, wd=0.01,
                                clip_gradient=0.5)),
    "adadelta": ("adadelta", dict(rho=0.9, wd=0.01)),
    "ftrl": ("ftrl", dict(learning_rate=0.1, lamda1=0.01, wd=0.01)),
    "lars": ("lars", dict(learning_rate=0.1, momentum=0.9, eta=0.01,
                          wd=0.01)),
    "signsgd": ("signsgd", dict(learning_rate=0.01, wd=0.01)),
    "signum": ("signum", dict(learning_rate=0.01, wd=0.01, wd_lh=0.01)),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    "test": ("test", dict()),
    "ftml": ("ftml", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5)),
    "adamax": ("adamax", dict(learning_rate=0.01, wd=0.01)),
    "nadam": ("nadam", dict(learning_rate=0.01, wd=0.01,
                            clip_gradient=0.5)),
}
PARAM_SHAPES = [(4, 5), (5,), (3, 2, 2)]
MULTS = {0: (0.5, 0.0), 1: (1.0, 2.0), 2: (1.0, 1.0)}


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _run_optimizer(pkg, name, kw, bf16, steps=3):
    optimizer = pkg.optimizer.create(
        name, rescale_grad=0.25, multi_precision=bf16,
        param_dict={i: _Mults(*m) for i, m in MULTS.items()}, **kw)
    updater = pkg.optimizer.get_updater(optimizer)
    rng = np.random.RandomState(11)
    dt = "bfloat16" if bf16 else "float32"
    weights = [pkg.nd.array(rng.randn(*s).astype(np.float32), dtype=dt)
               for s in PARAM_SHAPES]
    trace = []
    for _ in range(steps):
        grads = [pkg.nd.array(rng.randn(*s).astype(np.float32), dtype=dt)
                 for s in PARAM_SHAPES]
        updater(list(range(len(weights))), grads, weights)
        assert all(str(w.dtype) == dt for w in weights)
        trace.append(([_f32(w) for w in weights],
                      [_f32(s) for i in range(len(weights))
                       for s in _flat(updater.states[i])]))
    return trace, optimizer


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_mp"])
@pytest.mark.parametrize("opt_key", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(opt_key, bf16):
    name, kw = OPTIMIZERS[opt_key]
    want, jopt = _run_optimizer(jmx, name, kw, bf16)
    got, topt = _run_optimizer(tmx, name, kw, bf16)
    for step, ((gw, gs), (ww, ws)) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(gw, ww)):
            assert_close(a, b, bf16, "step %d weight %d" % (step, i))
        assert len(gs) == len(ws)
        for i, (a, b) in enumerate(zip(gs, ws)):
            assert_close(a, b, False, "step %d state %d" % (step, i))
    assert topt.num_update == jopt.num_update
    assert type(topt).__name__ == type(jopt).__name__


def test_the_thirteen_are_registered_under_the_reference_names():
    for name in list(OPTIMIZERS) + ["sgld"]:
        name = OPTIMIZERS.get(name, (name,))[0]
        assert type(tmx.optimizer.create(name)).__name__ == \
            type(jmx.optimizer.create(name)).__name__


def _sgld_run(pkg, generator=None, steps=3, shape=(4, 5)):
    kw = dict(learning_rate=0.04, wd=0.01, rescale_grad=0.5,
              clip_gradient=0.7)
    if generator is not None:
        kw["generator"] = generator
    optimizer = pkg.optimizer.create("sgld", **kw)
    updater = pkg.optimizer.get_updater(optimizer)
    rng = np.random.RandomState(3)
    w = pkg.nd.array(rng.randn(*shape).astype(np.float32))
    trace = []
    for _ in range(steps):
        g = pkg.nd.array(rng.randn(*shape).astype(np.float32))
        updater(0, g, w)
        trace.append(_f32(w))
    return trace


def test_sgld_deterministic_part_matches_reference(monkeypatch):
    """The reference with its noise set to 0 against the port with its
    noise taken out.  The update is affine in the weight with slope
    ``1 - lr * wd / 2``, so the port's weight after step t is the
    reference's plus e_t, e_t = (1 - lr * wd / 2) e_(t-1) + noise_t, and
    the noise is known from a twin of the port's generator."""
    zero = lambda loc, scale, shape, ctx: jnd.zeros(shape, ctx=ctx)  # noqa
    monkeypatch.setattr(jnd.random, "normal", zero)
    want = _sgld_run(jmx)
    got = _sgld_run(tmx, torch.Generator().manual_seed(7))
    twin = torch.Generator().manual_seed(7)
    e = np.zeros((4, 5), np.float64)
    for step, (g, w) in enumerate(zip(got, want)):
        noise = (torch.randn((4, 5), generator=twin)
                 * math.sqrt(0.04)).numpy()
        e = (1.0 - 0.04 * 0.01 / 2) * e + noise
        assert_close(g - e, w, what="step %d" % step)


def test_sgld_noise_is_normal_with_variance_lr():
    """With a zero gradient, wd 0 and weight 0, one step is the noise
    alone: N(0, lr) entries.  On n = 2**18 draws the mean's standard
    error is sqrt(lr / n) and the standard deviation's about
    sqrt(lr / (2 n)); each must be within 6 of them."""
    n, lr = 2 ** 18, 0.04
    opt = tmx.optimizer.create("sgld", learning_rate=lr,
                               generator=torch.Generator().manual_seed(1))
    w = tnd.zeros((n,))
    opt.update(0, w, tnd.zeros((n,)), None)
    x = w.asnumpy().astype(np.float64)
    assert abs(x.mean()) < 6 * math.sqrt(lr / n)
    assert abs(x.std() - math.sqrt(lr)) < 6 * math.sqrt(lr / (2 * n))
