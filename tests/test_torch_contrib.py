"""The port's repaired package surfaces (F3, F4) and the eager path's small
rest against the JAX reference, on the CPU.

F3: ``mx.optimizer`` re-exports the reference's nine other optimizers
(``RMSProp``, ``AdaGrad``, ``AdaDelta``, ``Ftrl``, ``LARS``, ``Signum``,
``SignSGD``, ``DCASGD``, ``Test``); each is the registered class and one
step through an ``Updater`` matches the reference's (float32 within
1e-6 + 1e-5 * |ref|).  F4: ``mx.nd.contrib`` (the same module as
``mx.contrib.nd``, importable by its dotted name) holds every name of the
reference's ``mx.nd.contrib`` whose ``_contrib_*`` op the port registers,
and no other op; ``box_nms`` on a (1, 5, 6) input and ``MultiBoxPrior``
match the reference at 1e-4; the control-flow combinators raise.  Also
``mx.cpu_pinned`` (the CPU under another name), ``base.set_env`` /
``base.environment`` (also at the package's top, with ``mx.kv``, as in
the reference) and the ``Torch`` / ``Caffe`` metrics.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import base as jbase

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.ops import registry as tregistry

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


# ---------------------------------------------------------------------------
# F3: the optimizer package's re-exports
# ---------------------------------------------------------------------------

NINE = {
    "RMSProp": dict(learning_rate=0.01, wd=0.01),
    "AdaGrad": dict(learning_rate=0.1, wd=0.01),
    "AdaDelta": dict(rho=0.9, wd=0.01),
    "Ftrl": dict(learning_rate=0.1, lamda1=0.01),
    "LARS": dict(learning_rate=0.1, momentum=0.9, eta=0.01),
    "Signum": dict(learning_rate=0.01, wd_lh=0.01),
    "SignSGD": dict(learning_rate=0.01),
    "DCASGD": dict(learning_rate=0.1, momentum=0.9),
    "Test": dict(),
}
SHAPES = [(4, 5), (5,)]


def _one_step(pkg, name, kw):
    opt = getattr(pkg.optimizer, name)(rescale_grad=0.5, **kw)
    updater = pkg.optimizer.get_updater(opt)
    rng = np.random.RandomState(3)
    weights = [pkg.nd.array(rng.randn(*s).astype(np.float32))
               for s in SHAPES]
    grads = [pkg.nd.array(rng.randn(*s).astype(np.float32))
             for s in SHAPES]
    updater(list(range(len(weights))), grads, weights)
    return opt, [w.asnumpy() for w in weights]


@pytest.mark.parametrize("name", sorted(NINE))
def test_optimizer_reexport_is_the_registered_class_and_steps_alike(name):
    assert name in tmx.optimizer.__all__
    cls = getattr(tmx.optimizer, name)
    assert cls is type(tmx.optimizer.create(name.lower()))
    assert tmx.optimizer.__all__ == jmx.optimizer.__all__
    topt, got = _one_step(tmx, name, NINE[name])
    jopt, want = _one_step(jmx, name, NINE[name])
    assert type(topt).__name__ == type(jopt).__name__
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# F4: mx.nd.contrib
# ---------------------------------------------------------------------------

_BARE = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "ROIAlign",
         "box_iou", "box_nms")


def _reference_contrib_names():
    """The reference's mx.nd.contrib op names that the port registers
    (under ``_contrib_<name>``, or one of the bare detection names)."""
    ported = set(tregistry.list_ops())
    names = []
    for n in dir(jmx.nd.contrib):
        if n.startswith("_") or not callable(getattr(jmx.nd.contrib, n)):
            continue
        if "_contrib_" + n in ported or (n in _BARE and n in ported):
            names.append(n)
    return sorted(names)


CONTRIB_NAMES = _reference_contrib_names()


@pytest.mark.parametrize("name", CONTRIB_NAMES)
def test_contrib_name_of_the_reference_is_present(name):
    fn = getattr(tmx.nd.contrib, name)
    op = "_contrib_" + name if "_contrib_" + name in \
        tregistry.list_ops() else name
    assert fn.__name__ == op
    assert getattr(tmx.contrib.nd, name) is fn


def test_contrib_holds_no_op_the_reference_lacks():
    mine = {n for n in dir(tmx.nd.contrib)
            if not n.startswith("_") and callable(getattr(tmx.nd.contrib, n))
            and n not in ("invoke", "foreach", "while_loop", "cond")}
    assert len(CONTRIB_NAMES) >= 18
    assert mine == set(CONTRIB_NAMES)


def test_contrib_is_one_module_under_every_name():
    mod = importlib.import_module("mxnet_tpu_torch.ndarray.contrib")
    assert tmx.nd.contrib is mod is tmx.contrib.nd is tmx.contrib.ndarray
    assert tmx.contrib.amp is tmx.amp


@pytest.mark.parametrize("name", ["foreach", "while_loop", "cond"])
def test_control_flow_raises_naming_item_8(name):
    with pytest.raises(NotImplementedError, match="item 8"):
        getattr(tmx.nd.contrib, name)(None, None, None)


def test_box_nms_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.rand(1, 5, 6).astype(np.float32)
    x[..., 0] = np.array([0, 1, 0, 1, 0], np.float32)
    x[..., 2:4] = x[..., 2:4] * 0.5
    x[..., 4:6] = x[..., 2:4] + 0.3 + 0.2 * rng.rand(1, 5, 2)
    got = tmx.nd.contrib.box_nms(tmx.nd.array(x), overlap_thresh=0.3)
    want = jmx.nd.contrib.box_nms(jmx.nd.array(x), overlap_thresh=0.3)
    assert got.shape == want.shape == (1, 5, 6)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                               atol=TOL)


def test_multibox_prior_matches_reference():
    x = np.zeros((1, 3, 5, 7), np.float32)
    kw = dict(sizes=(0.5, 0.25), ratios=(1, 2, 0.5), clip=True)
    got = tmx.nd.contrib.MultiBoxPrior(tmx.nd.array(x), **kw)
    want = jmx.nd.contrib.MultiBoxPrior(jmx.nd.array(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the eager path's small rest: cpu_pinned, set_env / environment, metrics
# ---------------------------------------------------------------------------

def test_cpu_pinned_is_the_cpu_under_another_name():
    for pkg in (tmx, jmx):
        ctx = pkg.cpu_pinned()
        assert repr(ctx) == "cpu_pinned(0)"
        assert ctx.device_type == "cpu_pinned" and ctx.device_typeid == 3
        assert ctx == pkg.cpu(0) and hash(ctx) == hash(pkg.cpu(0))
        assert pkg.cpu_pinned(1) != pkg.cpu(0)
    assert tmx.Context("cpu_pinned", 2) == tmx.cpu_pinned(2)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = tmx.nd.array(x, ctx=tmx.cpu_pinned())
    b = tmx.nd.array(x, ctx=tmx.cpu())
    assert repr(a.context) == repr(jmx.nd.array(x, ctx=jmx.cpu_pinned())
                                   .context) == "cpu_pinned(0)"
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    np.testing.assert_array_equal((a * 2).asnumpy(), x * 2)
    assert (a + b).context == a.context
    assert tmx.device.resolve(tmx.cpu_pinned()) == torch.device("cpu")


@pytest.mark.parametrize("pkg_base", [tbase, jbase], ids=["port", "ref"])
def test_set_env_and_environment_override_get_env(pkg_base, monkeypatch):
    name = "MX_TEST_ENV_OVERRIDE"
    monkeypatch.delenv(name, raising=False)
    seen = []
    try:
        pkg_base.set_env(name, "3")
        seen.append(pkg_base.get_env(name, dtype=int))
        assert os.environ[name] == "3"
        with pkg_base.environment(name, "5"):
            seen.append(pkg_base.get_env(name, dtype=int))
        seen.append(pkg_base.get_env(name, dtype=int))
        with pkg_base.environment({name: None}):
            seen.append(pkg_base.get_env(name, 7, int))
            assert name not in os.environ
        seen.append(pkg_base.get_env(name, dtype=int))
        with pytest.raises(ValueError):
            pkg_base.environment(name, "1", "2")
    finally:
        pkg_base.set_env(name, None)
    assert seen == [3, 5, 3, 7, 3]
    assert pkg_base.get_env(name) is None and name not in os.environ
    # unsetting removes the override: a later direct write is read
    monkeypatch.setenv(name, "9")
    assert pkg_base.get_env(name, dtype=int) == 9


@pytest.mark.parametrize("name", ["set_env", "environment", "kv",
                                  "cpu_pinned", "contrib"])
def test_top_level_name_of_the_reference_is_present(name):
    assert hasattr(jmx, name)
    got = getattr(tmx, name)
    want = {"set_env": tbase.set_env, "environment": tbase.environment,
            "kv": tmx.kvstore, "cpu_pinned": tmx.device.cpu_pinned,
            "contrib": importlib.import_module("mxnet_tpu_torch.contrib")}
    assert got is want[name]


@pytest.mark.parametrize("name", ["Torch", "Caffe"])
def test_torch_and_caffe_are_loss_under_other_names(name):
    preds = [np.array([0.5, 1.5, 2.0], np.float32),
             np.array([[1.0, 3.0]], np.float32)]
    out = []
    for pkg in (tmx, jmx):
        m = getattr(pkg.metric, name)()
        assert m is not None and isinstance(m, pkg.metric.Loss)
        assert type(pkg.metric.create(name.lower())).__name__ == name
        m.update(None, [pkg.nd.array(p) for p in preds])
        out.append(m.get())
    assert out[0][0] == out[1][0] == name.lower()
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-6)
    assert abs(out[0][1] - 8.0 / 5) < 1e-6
