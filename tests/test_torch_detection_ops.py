"""The detection ops of ``mxnet_tpu_torch.ops.detection`` against the JAX
reference on the CPU.

Box IoU, ``box_nms``, ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``box_encode`` and ``box_decode`` run through both
packages' ``invoke`` on the same seeded numpy inputs: every case of the
reference's ``tests/test_contrib.py`` detection tests, random labels
padded with -1, hard-negative mining over tied scores, ground truths that
share a best anchor, ``box_nms`` with each of its options, and SSD-300's
six anchor maps.  Float outputs agree within 1e-4, class targets, masks
and kept rows exactly.  One difference is deliberate and pinned: a
padding label row claims no anchor in the port, where the reference lets
it undo a valid row's claim on anchor 0.
"""
import numpy as np
import pytest

from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from mxnet_tpu_torch.ops import registry

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

TOL = 1e-4
PACKAGES = {"jax": (jnd, jinvoke), "port": (tnd, tinvoke)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def run(name, *inputs, **params):
    """{package: [numpy outputs]} of op ``name`` on numpy ``inputs``."""
    res = {}
    for pkg, (nd, invoke) in PACKAGES.items():
        out = invoke(name, *[nd.array(a, dtype=a.dtype) for a in inputs],
                     **params)
        outs = out if isinstance(out, (list, tuple)) else [out]
        res[pkg] = [o.asnumpy() for o in outs]
    return res


def assert_same(res, exact=(), tol=TOL):
    """Outputs within ``tol``; those whose index is in ``exact`` bitwise."""
    assert len(res["jax"]) == len(res["port"])
    for i, (a, b) in enumerate(zip(res["jax"], res["port"])):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (i, a.shape, b.shape, a.dtype, b.dtype)
        if i in exact:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def prior(h, w, sizes, ratios):
    return run("MultiBoxPrior", np.zeros((1, 2, h, w), np.float32),
               sizes=sizes, ratios=ratios)["port"][0]


def random_labels(b, m, seed, pad_first=False):
    """(b, m, 5) labels with 1..m valid boxes a row, padded with -1."""
    rng = np.random.RandomState(seed)
    out = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        k = rng.randint(1, m + 1)
        x1, y1 = rng.uniform(0, 0.7, k), rng.uniform(0, 0.7, k)
        bw, bh = rng.uniform(0.05, 0.3, k), rng.uniform(0.05, 0.3, k)
        rows = np.stack([rng.randint(0, 4, k), x1, y1, x1 + bw, y1 + bh], 1)
        if pad_first:
            out[i, m - k:] = rows
        else:
            out[i, :k] = rows
    return out


OPS = {"_contrib_box_iou": ["box_iou"], "_contrib_box_nms": ["box_nms"],
       "MultiBoxPrior": ["_contrib_MultiBoxPrior", "multibox_prior"],
       "MultiBoxTarget": ["_contrib_MultiBoxTarget", "multibox_target"],
       "MultiBoxDetection": ["_contrib_MultiBoxDetection",
                             "multibox_detection"],
       "_contrib_box_encode": ["box_encode"],
       "_contrib_box_decode": ["box_decode"]}


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_and_aliases_are_registered_as_in_the_reference(name):
    from mxnet_tpu.ops import registry as jregistry
    op = registry.get_op(name)
    for alias in OPS[name]:
        assert registry.get_op(alias) is op
    assert not op.differentiable
    assert op.num_outputs == jregistry.get_op(name).num_outputs


# -- the cases of tests/test_contrib.py --------------------------------------

def test_box_iou():
    a = np.array([[0.0, 0.0, 2.0, 2.0]], np.float32)
    b = np.array([[1.0, 1.0, 3.0, 3.0], [4.0, 4.0, 5.0, 5.0]], np.float32)
    res = run("box_iou", a, b)
    assert_same(res)
    np.testing.assert_allclose(res["port"][0], [[1.0 / 7.0, 0.0]],
                               rtol=1e-5)
    assert_same(run("box_iou", rnd_boxes(2, 5, 1), rnd_boxes(2, 3, 2),
                    format="center"))


BOXES = np.array([[[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                   [0, 0.8, 0.05, 0.05, 1.0, 1.0],
                   [1, 0.7, 0.5, 0.5, 0.9, 0.9],
                   [0, -1.0, 0.0, 0.0, 0.1, 0.1]]], np.float32)


def test_box_nms_suppression():
    res = run("box_nms", BOXES, overlap_thresh=0.5)
    assert_same(res, exact=(0,))
    out = res["port"][0]
    assert out[0, 0, 1] == pytest.approx(0.9)
    assert (out[0, 1] == -1).all()
    assert (out[0, 3] == -1).all()
    res = run("box_nms", BOXES, overlap_thresh=0.1, force_suppress=True)
    assert_same(res, exact=(0,))
    assert (res["port"][0][0, 2] == -1).all()


def test_box_nms_topk():
    boxes = np.array([[[0.9, 0.0, 0.0, 0.2, 0.2],
                       [0.8, 0.4, 0.4, 0.6, 0.6],
                       [0.7, 0.8, 0.8, 1.0, 1.0]]], np.float32)
    res = run("box_nms", boxes, overlap_thresh=0.5, topk=2, coord_start=1,
              score_index=0, id_index=-1)
    assert_same(res, exact=(0,))
    assert (res["port"][0][0, :, 0] > 0).sum() == 2


def test_multibox_prior_values():
    res = run("MultiBoxPrior", np.zeros((1, 4, 2, 2), np.float32),
              sizes=(0.5,), ratios=(1.0,))
    assert_same(res, exact=(0,))
    assert res["port"][0].shape == (1, 4, 4)
    np.testing.assert_allclose(res["port"][0][0, 0], [0.0, 0.0, 0.5, 0.5],
                               atol=1e-6)


def test_multibox_target_matching():
    anchors = prior(3, 3, (0.4,), (1.0,))
    label = np.array([[[1, 0.3, 0.3, 0.7, 0.7], [-1, 0, 0, 0, 0]]],
                     np.float32)
    res = run("MultiBoxTarget", anchors, label,
              np.zeros((1, 3, 9), np.float32))
    assert_same(res, exact=(1, 2))
    ct = res["port"][2][0]
    assert (ct == 2).sum() >= 1 and (ct == 0).sum() > 0
    lm = res["port"][1].reshape(9, 4)
    assert (lm.sum(axis=1) > 0).sum() == (ct > 0).sum()


def test_multibox_detection_decodes():
    anchors = prior(2, 2, (0.5,), (1.0,))
    n = anchors.shape[1]
    cls_prob = np.tile(np.array([[0.1], [0.8], [0.1]], np.float32),
                       (1, 1, n))
    res = run("MultiBoxDetection", cls_prob, np.zeros((1, n * 4), np.float32),
              anchors, nms_threshold=0.9)
    assert_same(res)
    det = res["port"][0]
    top = det[0, det[0, :, 1].argmax()]
    assert top[0] == 0 and top[1] == pytest.approx(0.8, abs=1e-5)
    np.testing.assert_allclose(top[2:], anchors[0, 0], atol=1e-5)


# -- beyond the reference's cases ---------------------------------------------

def rnd_boxes(b, n, seed):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 0.8, (b, n, 2))
    wh = rng.uniform(0.05, 0.4, (b, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nms_rows(b, n, seed, classes=3):
    """(b, n, 6) rows [id, score, x1, y1, x2, y2] with some invalid
    scores and repeated ones."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, classes, (b, n, 1)).astype(np.float32)
    scores = rng.choice([-1.0, 0.0, 0.2, 0.5, 0.5, 0.7, 0.9, 0.95],
                        (b, n, 1)).astype(np.float32)
    scores += rng.uniform(0, 0.01, (b, n, 1)).astype(np.float32) \
        * (rng.uniform(size=(b, n, 1)) < 0.5)
    return np.concatenate([ids, scores, rnd_boxes(b, n, seed + 1)], -1)


@pytest.mark.parametrize("params", [
    {},
    {"topk": 5},
    {"id_index": 0},
    {"id_index": 0, "background_id": 1},
    {"id_index": 0, "force_suppress": True, "overlap_thresh": 0.2},
    {"id_index": 0, "topk": 7, "valid_thresh": 0.3},
    {"in_format": "center", "overlap_thresh": 0.3},
])
def test_box_nms_options(params):
    res = run("box_nms", nms_rows(3, 40, 5), **params)
    assert_same(res, exact=(0,))


def test_box_nms_keeps_leading_shape_and_a_chain_of_suppressions():
    # each box overlaps the next: greedy keeps every other one, which a
    # single pass of the rule would not
    x = np.arange(8, dtype=np.float32) * 0.1
    rows = np.stack([np.zeros(8), 1.0 - x * 0.5, x, np.zeros(8), x + 0.15,
                     np.ones(8)], -1).astype(np.float32)
    res = run("box_nms", rows[None, None], overlap_thresh=0.1)  # IoU 0.2
    assert_same(res, exact=(0,))
    assert res["port"][0].shape == (1, 1, 8, 6)
    kept = (res["port"][0][0, 0, :, 1] > 0).nonzero()[0]
    np.testing.assert_array_equal(kept, [0, 2, 4, 6])


def test_box_nms_with_no_valid_row():
    rows = nms_rows(2, 10, 3)
    rows[..., 1] = -1.0
    assert_same(run("box_nms", rows), exact=(0,))


@pytest.mark.parametrize("pad_first", [False, True])
def test_multibox_target_on_random_padded_labels(pad_first):
    anchors = np.concatenate([prior(6, 6, (0.2, 0.3), (1, 2, 0.5)),
                              prior(3, 3, (0.5, 0.6), (1, 2, 0.5))], 1)
    n = anchors.shape[1]
    labels = random_labels(4, 5, 11, pad_first=pad_first)
    cls_pred = np.random.RandomState(12).randn(4, 5, n).astype(np.float32)
    port = run("MultiBoxTarget", anchors, labels, cls_pred,
               negative_mining_ratio=3.0)["port"]
    # the reference is right when the padding comes first
    first = random_labels(4, 5, 11, pad_first=True)
    ref = run("MultiBoxTarget", anchors, first, cls_pred,
              negative_mining_ratio=3.0)["jax"]
    assert_same({"jax": ref, "port": port}, exact=(1, 2))


@pytest.mark.parametrize("cls_pred", ["zeros", "repeated"])
def test_multibox_target_hard_negatives_with_tied_scores(cls_pred):
    anchors = prior(5, 5, (0.3,), (1, 2, 0.5))
    n = anchors.shape[1]
    labels = random_labels(3, 3, 21, pad_first=True)
    if cls_pred == "zeros":
        pred = np.zeros((3, 4, n), np.float32)
    else:
        pred = np.random.RandomState(22).choice(
            [-1.0, 0.0, 0.5], (3, 4, n)).astype(np.float32)
    for ratio, minimum in [(3.0, 0), (1.0, 10), (0.5, 0)]:
        res = run("MultiBoxTarget", anchors, labels, pred,
                  negative_mining_ratio=ratio,
                  minimum_negative_samples=minimum, ignore_label=-2.0)
        assert_same(res, exact=(1, 2))


def test_multibox_target_options():
    anchors = prior(4, 4, (0.3, 0.5), (1, 2))
    n = anchors.shape[1]
    labels = random_labels(2, 4, 31, pad_first=True)
    pred = np.random.RandomState(32).randn(2, 3, n).astype(np.float32)
    res = run("MultiBoxTarget", anchors, labels, pred,
              overlap_threshold=0.3, variances=(0.2, 0.2, 0.1, 0.1))
    assert_same(res, exact=(1, 2))


PROBE_ANCHORS = np.array([[[0, 0, .3, .3], [.5, .5, .9, .9],
                           [.2, .2, .6, .6]]], np.float32)
PROBE_GT = [0, 0, 0, .2, .2]      # IoU 0.44 with anchor 0: forced only
PAD = [-1, 0, 0, 0, 0]


def _probe(rows):
    return run("MultiBoxTarget", PROBE_ANCHORS,
               np.array([rows], np.float32),
               np.zeros((1, 2, 3), np.float32))


def test_a_padding_row_claims_no_anchor():
    # the reference's defect: the padding row after the ground truth scatters
    # False onto anchor 0 and drops the forced positive; the port keeps it
    res = _probe([PROBE_GT, PAD])
    np.testing.assert_array_equal(res["jax"][2], [[0, 0, 0]])
    np.testing.assert_array_equal(res["port"][2], [[1, 0, 0]])
    # padding first: the reference is right and the two agree
    res = _probe([PAD, PROBE_GT])
    assert_same(res, exact=(1, 2))
    np.testing.assert_array_equal(res["port"][2], [[1, 0, 0]])
    # and the port's answer does not depend on where the padding sits
    np.testing.assert_array_equal(_probe([PROBE_GT, PAD])["port"][2],
                                  res["port"][2])


def test_the_later_of_two_ground_truths_sharing_an_anchor_wins():
    # both overlap anchor 2 best (below the threshold): the later row's class
    rows = [[0, .25, .25, .5, .5], [1, .3, .3, .6, .55]]
    res = _probe(rows)
    assert_same(res, exact=(1, 2))
    np.testing.assert_array_equal(res["port"][2], [[0, 0, 2]])
    res = _probe(rows[::-1])
    assert_same(res, exact=(1, 2))
    np.testing.assert_array_equal(res["port"][2], [[0, 0, 1]])


@pytest.mark.parametrize("params", [
    {"nms_topk": 20},
    {"nms_threshold": 0.3, "threshold": 0.3},
    {"force_suppress": True},
    {"background_id": 2, "clip": False},
])
def test_multibox_detection_options(params):
    anchors = np.concatenate([prior(5, 5, (0.2, 0.3), (1, 2, 0.5)),
                              prior(2, 2, (0.5,), (1, 2))], 1)
    n = anchors.shape[1]
    rng = np.random.RandomState(41)
    logits = rng.randn(2, 4, n).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = rng.randn(2, n * 4).astype(np.float32) * 0.5
    assert_same(run("MultiBoxDetection", prob.astype(np.float32), loc,
                    anchors, **params))


SSD300_MAPS = [(38, (0.1, 0.141), (1, 2, 0.5)),
               (19, (0.2, 0.272), (1, 2, 0.5, 3, 1.0 / 3)),
               (10, (0.37, 0.447), (1, 2, 0.5, 3, 1.0 / 3)),
               (5, (0.54, 0.619), (1, 2, 0.5, 3, 1.0 / 3)),
               (3, (0.71, 0.79), (1, 2, 0.5)),
               (1, (0.88, 0.961), (1, 2, 0.5))]


@pytest.mark.parametrize("edge,sizes,ratios", SSD300_MAPS)
def test_ssd300_anchor_maps_agree_to_the_bit(edge, sizes, ratios):
    res = run("MultiBoxPrior", np.zeros((1, 1, edge, edge), np.float32),
              sizes=sizes, ratios=ratios)
    assert_same(res, exact=(0,))


def test_multibox_prior_with_steps_offsets_and_clip():
    res = run("MultiBoxPrior", np.zeros((2, 3, 4, 6), np.float32),
              sizes=(0.3, 0.6), ratios=(1.0, 2.0), steps=(0.2, 0.25),
              offsets=(0.3, 0.7), clip=True)
    assert_same(res, exact=(0,))


def test_box_encode_and_decode():
    rng = np.random.RandomState(51)
    anchors = rnd_boxes(2, 6, 52)
    refs = rnd_boxes(2, 3, 53)
    samples = rng.choice([-1.0, 0.0, 1.0], (2, 6)).astype(np.float32)
    matches = rng.randint(0, 3, (2, 6)).astype(np.float32)
    assert_same(run("box_encode", samples, matches, anchors, refs),
                exact=(1,))
    assert_same(run("box_encode", samples, matches, anchors, refs,
                    means=(0.1, 0.0, -0.1, 0.0), stds=(0.2, 0.2, 0.3, 0.3)),
                exact=(1,))
    deltas = rng.randn(2, 6, 4).astype(np.float32) * 0.3
    assert_same(run("box_decode", deltas, anchors))
    assert_same(run("box_decode", deltas, anchors, std0=0.1, std1=0.1,
                    std2=0.2, std3=0.2, clip=0.9))
    assert_same(run("box_decode", deltas, anchors, format="center"))
