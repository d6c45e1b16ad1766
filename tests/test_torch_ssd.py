"""SSD (BASELINE config 4) in the port against the JAX reference on the
CPU: ``gluon.model_zoo.ssd`` and the VOC mAP metrics.

The reference's ``ssd_toy`` is initialised and called once (its sizes are
deferred), its parameters are carried into the port's ``ssd_toy`` by name
with a strict load, and both run the same seeded batch: the forward's
anchors and predictions, ``targets``, ``SSDMultiBoxLoss``, ``detect`` and
the first ``gluon.Trainer`` steps (SGD, momentum 0.9, the loop of the
reference's ``tests/test_ssd.py``) agree within 1e-4, class targets and
masks exactly.  ``ssd_300_vgg16_voc``'s parameters carry over by name, and
it gives 8,732 anchors at 300 x 300.  ``VOCMApMetric`` and
``VOC07MApMetric`` give the reference's values on its cases and on random
detections.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd, nd as jnd
from mxnet_tpu import metric as jmetric
from mxnet_tpu.gluon.model_zoo import ssd as jssd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd, gluon, nd as tnd
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.block import functionalize
from mxnet_tpu_torch.gluon.model_zoo import ssd as tssd
from mxnet_tpu_torch.ops import registry

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture
def cpu():
    with tmx.cpu():
        yield


def toy_batch(bs=8, edge=32, seed=0):
    """The synthetic one-box task of the reference's ``test_ssd.py``."""
    rng = np.random.RandomState(seed)
    imgs = np.full((bs, 3, edge, edge), 0.1, np.float32)
    labels = np.full((bs, 1, 5), -1.0, np.float32)
    for b in range(bs):
        bw = rng.randint(edge // 4, edge // 2)
        x0 = rng.randint(0, edge - bw)
        y0 = rng.randint(0, edge - bw)
        imgs[b, :, y0:y0 + bw, x0:x0 + bw] = 1.0
        labels[b, 0] = [0, x0 / edge, y0 / edge, (x0 + bw) / edge,
                        (y0 + bw) / edge]
    return imgs, labels


def twin_toy(classes=1, edge=32):
    """The reference's ssd_toy (Xavier, sizes resolved by a first call)
    and the port's with its parameters, loaded strictly by name."""
    jmx.random.seed(0)
    ref = jssd.ssd_toy(classes=classes)
    ref.initialize(jmx.init.Xavier())
    ref(jnd.zeros((1, 3, edge, edge)))
    named = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    port = tssd.ssd_toy(classes=classes)
    params_from_mxnet_tpu(named, port, device="cpu")
    return ref, port, named


def close(a, b, tol=TOL):
    a = a.asnumpy() if hasattr(a, "asnumpy") else a
    b = b.asnumpy() if hasattr(b, "asnumpy") else b
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def test_ssd_toy_forward_targets_and_loss(cpu):
    ref, port, _ = twin_toy(classes=2)
    x, y = toy_batch(4)
    y[1, 0, 0] = 1.0
    outs = {}
    for key, net, nd, ssd in (("jax", ref, jnd, jssd),
                              ("port", port, tnd, tssd)):
        anchors, cls_preds, box_preds = net(nd.array(x))
        loc_t, loc_m, cls_t = net.targets(anchors, cls_preds, nd.array(y))
        loss = ssd.SSDMultiBoxLoss(rho=0.5, lambd=2.0)(
            cls_preds, box_preds, cls_t, loc_t, loc_m)
        outs[key] = [anchors, cls_preds, box_preds, loc_t, loc_m, cls_t,
                     loss]
    assert outs["port"][0].shape == (1, 8 * 8 * 4 + 4 * 4 * 4, 4)
    for i, (a, b) in enumerate(zip(outs["jax"], outs["port"])):
        if i in (4, 5):
            np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
        else:
            close(a, b)
    assert outs["port"][6].shape == (1,)


def test_ssd_toy_forward_through_functionalize_matches_the_call(cpu):
    _, port, _ = twin_toy()
    x, _ = toy_batch(2)
    pure_fn, params = functionalize(port)
    got = pure_fn(params, torch.from_numpy(x))
    want = port(tnd.array(x))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.data, rtol=0, atol=0)


def test_ssd_toy_trainer_steps_match_the_reference(cpu):
    ref, port, named = twin_toy()
    x, y = toy_batch(8)
    runs = {}
    for key, net, nd, autograd, gl, ssd in (
            ("jax", ref, jnd, jautograd, jmx.gluon, jssd),
            ("port", port, tnd, tautograd, gluon, tssd)):
        loss_fn = ssd.SSDMultiBoxLoss()
        trainer = gl.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
        xs, ys = nd.array(x), nd.array(y)
        losses = []
        for _ in range(2):
            with autograd.record():
                anchors, cls_preds, box_preds = net(xs)
                loc_t, loc_m, cls_t = net.targets(anchors, cls_preds, ys)
                loss = loss_fn(cls_preds, box_preds, cls_t, loc_t, loc_m)
            loss.backward()
            trainer.step(8)
            losses.append(float(loss.asnumpy().item()))
        runs[key] = (losses, {n: p.data().asnumpy() for n, p in
                              net.collect_params().items()})
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], rtol=TOL,
                               atol=TOL)
    assert sorted(runs["port"][1]) == sorted(named)
    for n, w in runs["jax"][1].items():
        np.testing.assert_allclose(runs["port"][1][n], w, rtol=TOL,
                                   atol=TOL, err_msg=n)
        assert not np.array_equal(w, named[n]), n      # every one moved


def test_ssd_toy_detect_matches_the_reference(cpu):
    ref, port, _ = twin_toy(classes=2)
    x, _ = toy_batch(3, seed=4)
    dets = {}
    for key, net, nd in (("jax", ref, jnd), ("port", port, tnd)):
        anchors, cls_preds, box_preds = net(nd.array(x))
        dets[key] = net.detect(anchors, cls_preds, box_preds,
                               nms_topk=50).asnumpy()
    assert dets["port"].shape == (3, 320, 6)
    np.testing.assert_array_equal(dets["port"][..., 0], dets["jax"][..., 0])
    close(dets["jax"], dets["port"])
    # the same through tensors
    anchors, cls_preds, box_preds = (t.data for t in port(tnd.array(x)))
    close(dets["jax"], port.detect(anchors, cls_preds, box_preds,
                                   nms_topk=50).numpy())


def test_ssd_toy_detect_with_the_defaults(cpu):
    ref, port, _ = twin_toy(classes=3)
    x, _ = toy_batch(2, seed=5)
    dets = [net.detect(*net(nd.array(x))).asnumpy()
            for net, nd in ((ref, jnd), (port, tnd))]
    np.testing.assert_array_equal(dets[1][..., 0], dets[0][..., 0])
    close(dets[0], dets[1])


def test_ssd_layers_reach_the_registered_ops(cpu, monkeypatch):
    _, port, _ = twin_toy()
    seen = []
    real = registry.dispatch

    def spy(name, *args, **params):
        seen.append(name)
        return real(name, *args, **params)

    monkeypatch.setattr(tssd, "dispatch", spy)
    x, y = toy_batch(2)
    anchors, cls_preds, box_preds = port(torch.from_numpy(x))
    loc_t, loc_m, cls_t = port.targets(anchors, cls_preds,
                                       torch.from_numpy(y))
    tssd.SSDMultiBoxLoss()(cls_preds, box_preds, cls_t, loc_t, loc_m)
    port.detect(anchors, cls_preds, box_preds)
    assert {"MultiBoxPrior", "concat", "MultiBoxTarget", "transpose",
            "log_softmax", "maximum", "zeros_like", "pick", "smooth_l1",
            "softmax", "MultiBoxDetection"} <= set(seen)


def test_ssd_300_carries_the_references_parameters_by_name(cpu):
    jmx.random.seed(0)
    ref = jssd.ssd_300_vgg16_voc(classes=20)
    ref.initialize(jmx.init.Xavier())
    ref(jnd.zeros((1, 3, 300, 300)))
    named = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    port = tssd.ssd_300_vgg16_voc(classes=20)
    # sizes deferred as in the reference: the input channels are unknown
    assert any(p.is_meta for p in port.parameters())
    params_from_mxnet_tpu(named, port, device="cpu")
    got = dict(port.named_parameters())
    assert list(got) == list(named)
    assert {n: tuple(p.shape) for n, p in got.items()} == \
        {n: v.shape for n, v in named.items()}
    assert len(got) == 70
    assert sum(v.size for v in named.values()) == \
        sum(p.numel() for p in got.values())
    extra = dict(named, **{"stages.0.9.weight": named["stages.0.0.0.weight"]})
    with pytest.raises(RuntimeError, match="unexpected"):
        tssd.ssd_300_vgg16_voc(classes=20).load_dict(extra, device="cpu")
    anchors, cls_preds, box_preds = port(tnd.zeros((1, 3, 300, 300)))
    assert anchors.shape == (1, 8732, 4)
    assert cls_preds.shape == (1, 8732, 21)
    assert box_preds.shape == (1, 8732 * 4)


def test_ssd_entry_points_default_to_the_gpu():
    net = tssd.ssd_toy()
    assert all(p.is_meta for p in net.parameters())
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(MXNetError, match="cuda"):
        net.initialize()
    with pytest.raises(MXNetError, match="cuda"):
        tssd.ssd_300_vgg16_voc().initialize(tmx.init.Xavier())


# -- VOC mAP ------------------------------------------------------------------

def _voc(mod, nd, labels, preds, cls="VOCMApMetric", **kw):
    m = getattr(mod, cls)(**kw)
    m.update([nd.array(labels)], [nd.array(preds)])
    return m.get()


LABELS = np.array([[[0, .1, .1, .4, .4], [1, .5, .5, .9, .9]]], np.float32)


@pytest.mark.parametrize("preds", [
    [[0, .95, .1, .1, .4, .4], [1, .9, .5, .5, .9, .9]],      # perfect
    [[1, .95, .1, .1, .4, .4], [0, .9, .5, .5, .9, .9]],      # swapped
    [[0, .95, .1, .1, .4, .4], [1, .9, .0, .0, .2, .2]],      # half
])
@pytest.mark.parametrize("cls", ["VOCMApMetric", "VOC07MApMetric"])
def test_voc_map_cases(preds, cls, cpu):
    preds = np.array([preds], np.float32)
    want = _voc(jmetric, jnd, LABELS, preds, cls)
    got = _voc(tmetric, tnd, LABELS, preds, cls)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], abs=1e-12)


def test_voc_map_values_of_the_references_test(cpu):
    perfect = np.array([[[0, .95, .1, .1, .4, .4], [1, .9, .5, .5, .9, .9]]],
                       np.float32)
    assert _voc(tmetric, tnd, LABELS, perfect)[1] == pytest.approx(1.0)
    swapped = perfect.copy()
    swapped[0, :, 0] = [1, 0]
    assert _voc(tmetric, tnd, LABELS, swapped)[1] == pytest.approx(0.0)
    half = perfect.copy()
    half[0, 1, 2:] = [0, 0, .2, .2]
    name, val = _voc(tmetric, tnd, LABELS, half, "VOC07MApMetric")
    assert 0.0 < val < 1.0 and name == "mAP07"
    assert isinstance(tmetric.create("vocmapmetric"), tmetric.VOCMApMetric)
    assert isinstance(tmetric.create("voc07mapmetric"),
                      tmetric.VOC07MApMetric)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cls", ["VOCMApMetric", "VOC07MApMetric"])
def test_voc_map_on_random_detections_over_batches(seed, cls, cpu):
    rng = np.random.RandomState(seed)
    metrics = {"jax": getattr(jmetric, cls)(iou_thresh=0.4),
               "port": getattr(tmetric, cls)(iou_thresh=0.4)}
    for _ in range(3):
        labels = np.full((4, 5, 5), -1.0, np.float32)
        preds = np.full((4, 12, 6), -1.0, np.float32)
        for b in range(4):
            k = rng.randint(1, 6)
            xy = rng.uniform(0, 0.6, (k, 2))
            labels[b, :k] = np.concatenate(
                [rng.randint(0, 3, (k, 1)), xy,
                 xy + rng.uniform(0.1, 0.4, (k, 2))], 1)
            d = rng.randint(0, 13)
            src = labels[b, rng.randint(0, k, d), 1:]
            boxes = src + rng.normal(0, 0.05, src.shape)
            preds[b, :d] = np.concatenate(
                [rng.randint(0, 3, (d, 1)), rng.uniform(0, 1, (d, 1)),
                 boxes], 1)
        for key, nd in (("jax", jnd), ("port", tnd)):
            metrics[key].update([nd.array(labels)], [nd.array(preds)])
    want, got = metrics["jax"].get(), metrics["port"].get()
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], abs=1e-12)
    metrics["port"].reset()
    assert np.isnan(metrics["port"].get()[1])
