"""The port's optimizer update ops, optimizers and lr schedulers against the
JAX reference, on the CPU.

Each registered update op (``nd.sgd_update``, ``nd.mp_sgd_mom_update``,
``nd.multi_adamw_update``, ...) is called 3 times on the same seeded numpy
inputs in both packages; every input it writes in place and every output
it returns must agree.  Each optimizer (SGD plain, and with momentum, wd,
``clip_gradient`` and a scheduler; NAG; Adam; AdamW; LAMB), in float32
and in bfloat16 with ``multi_precision``, takes 4 steps through an
``Updater`` over three parameters with ``lr_mult``/``wd_mult`` from
``param_dict``, both fused (the default ``aggregate_num``) and one
parameter at a time (``aggregate_num=0``); weights and states must agree
after every step.  Tolerance: float32 within 1e-6 + 1e-5 * |ref|; a
bfloat16 weight within one bfloat16 ulp of the reference's.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import lr_scheduler as jsched

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

SHAPE = (4, 6)


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
    if bf16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        bad = np.abs(got - want) > ulp
    else:
        bad = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert not bad.any(), "%s: %d entries off, worst %g" % (
        what, bad.sum(), np.abs(got - want).max())


# ---------------------------------------------------------------------------
# the registered update ops
# ---------------------------------------------------------------------------

# input letters: w f32 weight, W bf16 weight, g f32 gradient, G bf16
# gradient, m f32 state, v f32 state >= 0, M the f32 master of the last W
# (or an f32 weight), r the rescale tensor, n a positive norm ()
OPS = {
    "sgd_update": ("wg", dict(lr=0.1, wd=0.01, rescale_grad=0.5,
                              clip_gradient=0.3)),
    "sgd_mom_update": ("wgm", dict(lr=0.1, momentum=0.9, wd=0.01,
                                   rescale_grad=0.5, clip_gradient=0.3)),
    "mp_sgd_update": ("WGM", dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    "mp_sgd_mom_update": ("WGmM", dict(lr=0.1, momentum=0.9, wd=0.01,
                                       clip_gradient=0.4)),
    "nag_mom_update": ("wgm", dict(lr=0.1, momentum=0.9, wd=0.01,
                                   rescale_grad=0.5)),
    "mp_nag_mom_update": ("WGmM", dict(lr=0.1, momentum=0.9, wd=0.01)),
    "adam_update": ("wgmv", dict(lr=0.01, wd=0.01, rescale_grad=0.5,
                                 clip_gradient=1.0)),
    "adamw_update": ("wgmv", dict(lr=0.01, wd=0.1, eta=0.5,
                                  rescale_grad=0.5)),
    "mp_adamw_update": ("WGmvMr", dict(lr=0.01, wd=0.1, clip_gradient=0.5)),
    "lamb_update_phase1": ("gwmv", dict(t=2, wd=0.01, rescale_grad=0.5)),
    "lamb_update_phase2": ("wg", dict(lr=0.01, lower_bound=0.1,
                                      upper_bound=10.0)),
    "mp_lamb_update_phase1": ("GMmv", dict(t=3, wd=0.01,
                                           clip_gradient=1.0)),
    "mp_lamb_update_phase2": ("WgnnM", dict(lr=0.01, lower_bound=0.5)),
    "multi_sgd_update": ("wgwg", dict(lrs=(0.1, 0.2), wds=(0.0, 0.01),
                                      rescale_grad=0.5, num_weights=2)),
    "multi_sgd_mom_update": ("wgmwgm", dict(lrs=(0.1, 0.2), wds=(0.01, 0),
                                            momentum=0.9, num_weights=2)),
    "multi_mp_sgd_update": ("WGMWGM", dict(lrs=(0.1, 0.2), wds=(0, 0.01),
                                           num_weights=2)),
    "multi_mp_sgd_mom_update": ("WGmMWGmM", dict(
        lrs=(0.1, 0.2), wds=(0.01, 0.0), momentum=0.9, clip_gradient=0.3,
        num_weights=2)),
    "multi_adamw_update": ("wgmvwgmvr", dict(
        lrs=(0.01, 0.02), wds=(0.1, 0.0), etas=(1.0, 0.5), num_weights=2)),
    "multi_mp_adamw_update": ("WGmvMWGmvMr", dict(
        lrs=(0.01, 0.02), wds=(0.1, 0.0), etas=(1.0, 0.5), num_weights=2)),
    "multi_sum_sq": ("wW", dict(num_arrays=2)),
    "reset_arrays": ("wm", dict(num_arrays=2)),
}


def _op_inputs(letters, seed):
    rng = np.random.RandomState(seed)
    out, last_w = [], None
    for c in letters:
        if c in "wgmW G":
            a = rng.randn(*SHAPE).astype(np.float32)
        if c in "WG":
            a = _f32(jnd.array(a, dtype="bfloat16"))     # bf16 values
        if c == "W":
            last_w = a
        if c == "v":
            a = np.abs(rng.randn(*SHAPE)).astype(np.float32)
        elif c == "M":
            a = last_w.copy() if last_w is not None else \
                rng.randn(*SHAPE).astype(np.float32)
        elif c == "r":
            a = np.array(0.25, np.float32)
        elif c == "n":
            a = np.array(1.0 + abs(rng.randn()), np.float32)
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


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_reference(name):
    letters, kw = OPS[name]
    want = _run_op(jnd, name, letters, kw)
    got = _run_op(tnd, name, letters, kw)
    n_out = len(want[0]) - len(letters)
    for step, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            idx = i - n_out
            bf16 = idx >= 0 and letters[idx] in "WG"
            assert_close(a, b, bf16, "%s step %d array %d" % (name, step, i))


def test_update_ops_write_in_place_and_return_the_weight():
    w = tnd.array(np.ones(3, np.float32))
    g = tnd.array(np.ones(3, np.float32))
    m = tnd.zeros((3,))
    got = tnd.sgd_mom_update(w, g, m, lr=0.5, momentum=0.9)
    assert got is w
    np.testing.assert_allclose(m.asnumpy(), -0.5)
    np.testing.assert_allclose(w.asnumpy(), 0.5)
    assert tnd.multi_sgd_update(w, g, lrs=(0.5,), num_weights=1) == []
    np.testing.assert_allclose(w.asnumpy(), 0.0)


# ---------------------------------------------------------------------------
# the optimizers through an Updater
# ---------------------------------------------------------------------------

class _Mults:
    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


def _sgd_sched(pkg):
    sched = pkg.MultiFactorScheduler(step=[2, 3], factor=0.5)
    return dict(learning_rate=0.1, momentum=0.9, lr_scheduler=sched)


OPTIMIZERS = {
    "sgd": ("sgd", lambda pkg: dict(learning_rate=0.1)),
    "sgd_momentum_wd_clip": ("sgd", lambda pkg: dict(
        learning_rate=0.1, momentum=0.9, wd=0.01, clip_gradient=0.5)),
    "sgd_momentum_scheduler": ("sgd", _sgd_sched),
    "nag": ("nag", lambda pkg: dict(learning_rate=0.1, momentum=0.9,
                                    wd=0.01)),
    "adam": ("adam", lambda pkg: dict(learning_rate=0.01, wd=0.01)),
    "adamw": ("adamw", lambda pkg: dict(learning_rate=0.01, wd=0.1)),
    "lamb": ("lamb", lambda pkg: dict(learning_rate=0.01, wd=0.01,
                                      lower_bound=1e-3, upper_bound=10.0)),
}
PARAM_SHAPES = [(4, 5), (5,), (3, 2, 2)]
MULTS = {0: (0.5, 0.0), 1: (1.0, 2.0), 2: (1.0, 1.0)}


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


def _run_optimizer(pkg, opt_key, bf16, aggregate, steps=4, mp=None):
    name, make_kw = OPTIMIZERS[opt_key]
    kw = make_kw(jsched if pkg is jmx else tsched)
    if not aggregate:
        kw["aggregate_num"] = 0
    optimizer = pkg.optimizer.create(
        name, rescale_grad=0.25, multi_precision=bf16 if mp is None else mp,
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


@pytest.mark.parametrize("aggregate", [True, False],
                         ids=["fused", "per_param"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_mp"])
@pytest.mark.parametrize("opt_key", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(opt_key, bf16, aggregate):
    want, jopt = _run_optimizer(jmx, opt_key, bf16, aggregate)
    got, topt_ = _run_optimizer(tmx, opt_key, bf16, aggregate)
    for step, ((gw, gs), (ww, ws)) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(gw, ww)):
            assert_close(a, b, bf16, "step %d weight %d" % (step, i))
        assert len(gs) == len(ws)
        for i, (a, b) in enumerate(zip(gs, ws)):
            assert_close(a, b, False, "step %d state %d" % (step, i))
    assert topt_.num_update == jopt.num_update == 4
    assert topt_._index_update_count == jopt._index_update_count


@pytest.mark.parametrize("opt_key", sorted(OPTIMIZERS))
def test_bf16_without_multi_precision_matches_the_reference_per_param(
        opt_key):
    """bf16 weights and states updated in bf16.  The reference's fused
    apply promotes some of them to float32 here (its per-leaf lr is a
    float32 array: plain SGD's, NAG's and AdamW's weights, SGD's
    momentum), where its per-parameter ops keep bf16; the port keeps bf16
    on both of its paths and is held to the reference's per-parameter
    one."""
    want, _ = _run_optimizer(jmx, opt_key, True, False, mp=False)
    for aggregate in (True, False):
        got, _ = _run_optimizer(tmx, opt_key, True, aggregate, mp=False)
        for step, ((gw, gs), (ww, ws)) in enumerate(zip(got, want)):
            for i, (a, b) in enumerate(zip(gw + gs, ww + ws)):
                assert_close(a, b, True, "step %d array %d" % (step, i))


def test_fused_and_per_param_updates_agree_in_the_port():
    fused, _ = _run_optimizer(tmx, "adamw", False, True)
    single, _ = _run_optimizer(tmx, "adamw", False, False)
    for (fw, fs), (sw, ss) in zip(fused, single):
        for a, b in zip(fw + fs, sw + ss):
            assert_close(a, b)


def test_optimizer_registry_and_learning_rate():
    assert sorted(topt.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry)
    sgd = topt.create("SGD", learning_rate=0.3)
    assert isinstance(sgd, topt.SGD) and topt.create(sgd) is sgd
    assert sgd.learning_rate == 0.3 and sgd.aggregate_num == 64
    sgd.set_learning_rate(0.2)
    assert sgd.learning_rate == 0.2
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        topt.create("rmsprop2")
    sched = topt.create("adam", lr_scheduler=tsched.FactorScheduler(1, 0.5),
                        learning_rate=0.4)
    assert sched.learning_rate == 0.4
    with pytest.raises(UserWarning):
        sched.set_learning_rate(0.1)


# ---------------------------------------------------------------------------
# lr schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=3, factor=0.7,
                                       stop_factor_lr=1e-3)),
    "multifactor": ("MultiFactorScheduler", dict(step=[4, 9, 15],
                                                 factor=0.5)),
    "poly": ("PolyScheduler", dict(max_update=25, pwr=2, final_lr=1e-4)),
    "cosine": ("CosineScheduler", dict(max_update=25, final_lr=1e-4)),
}
WARMUPS = {"none": {}, "linear": dict(warmup_steps=5, warmup_begin_lr=0.01),
           "constant": dict(warmup_steps=5, warmup_begin_lr=0.02,
                            warmup_mode="constant")}


@pytest.mark.parametrize("warmup", sorted(WARMUPS))
@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_scheduler_matches_reference(kind, warmup):
    cls, kw = SCHEDULERS[kind]
    kw = dict(kw, base_lr=0.5, **WARMUPS[warmup])
    j, t = getattr(jsched, cls)(**kw), getattr(tsched, cls)(**kw)
    want = [j(n) for n in range(32)]
    assert [t(n) for n in range(32)] == want
    assert len(set(want)) > 2


def test_scheduler_argument_checks():
    with pytest.raises(ValueError):
        tsched.FactorScheduler(step=0)
    with pytest.raises(ValueError):
        tsched.MultiFactorScheduler(step=[3, 2])
    with pytest.raises(ValueError):
        tsched.LRScheduler(warmup_mode="cubic")
    assert torch.tensor(tsched.CosineScheduler(10)(10)).item() == 0.0
