"""SSD, the Single Shot MultiBox Detector (BASELINE config 4).

Counterpart of ``mxnet_tpu/gluon/model_zoo/ssd.py``: :class:`SSD` over a
list of feature stages, :class:`SSDMultiBoxLoss`, the VGG16-trunk
:func:`ssd_300_vgg16_voc` (38/19/10/5/3/1 feature maps at 300 x 300,
8,732 anchors) and the two-scale :func:`ssd_toy`.  Parameter names are the
reference's (``stages.0.0.0.weight``, ``class_predictors.0.bias``, ...),
and every convolution's input channels are deferred to the first call, as
in the reference.

The forward runs on tensors: a call on NDArrays is unwrapped and wrapped by
``Block.__call__``, and ``functionalize`` calls it with tensors.  Anchors,
the concatenations and the loss's ops are registered ops reached through
``registry.dispatch``.  :meth:`SSD.targets` and :meth:`SSD.detect` take
the forward's outputs as NDArrays (through ``nd``'s ``invoke``) or as
tensors (through ``dispatch``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ...ndarray.ndarray import NDArray, invoke
from ...ops.registry import dispatch
from .. import nn
from ..block import HybridBlock
from ..loss import Loss

__all__ = ["SSD", "SSDMultiBoxLoss", "ssd_300_vgg16_voc", "ssd_toy"]


def _op(name, *args, **params):
    """Registered op ``name`` on NDArrays (``invoke``) or tensors
    (``dispatch``)."""
    if any(isinstance(a, NDArray) for a in args):
        return invoke(name, *args, **params)
    return dispatch(name, *args, **params)


def _conv_block(channels, num_convs, pool=True):
    blk = nn.HybridSequential()
    for _ in range(num_convs):
        blk.add(nn.Conv2D(channels, 3, padding=1, activation="relu"))
    if pool:
        blk.add(nn.MaxPool2D(2, strides=2))
    return blk


def _down_block(channels, strides=2, padding=1):
    """A 1 x 1 bottleneck, then a 3 x 3 convolution (SSD's extra layers;
    the last two of SSD-300 use stride 1 and no padding to reach 3 x 3 and
    1 x 1 maps)."""
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels // 2, 1, activation="relu"),
            nn.Conv2D(channels, 3, strides=strides, padding=padding,
                      activation="relu"))
    return blk


class SSD(HybridBlock):
    """Multi-scale detector over a list of feature stages.

    ``forward(x)`` gives (anchors (1, A, 4), class predictions (B, A,
    classes + 1), box predictions (B, A * 4)): the triple
    ``MultiBoxTarget`` and ``MultiBoxDetection`` take."""

    def __init__(self, stages: Sequence[HybridBlock], num_classes: int,
                 sizes: Sequence[Tuple[float, float]],
                 ratios: Sequence[Sequence[float]], **kwargs):
        super().__init__(**kwargs)
        if not len(stages) == len(sizes) == len(ratios):
            raise ValueError("stages/sizes/ratios must align per scale")
        self.num_classes = num_classes
        self._sizes = [tuple(s) for s in sizes]
        self._ratios = [tuple(r) for r in ratios]
        self.stages = nn.HybridSequential()
        for s in stages:
            self.stages.add(s)
        self.class_predictors = nn.HybridSequential()
        self.box_predictors = nn.HybridSequential()
        for s, r in zip(self._sizes, self._ratios):
            a = len(s) + len(r) - 1          # anchors per position
            self.class_predictors.add(
                nn.Conv2D(a * (num_classes + 1), 3, padding=1))
            self.box_predictors.add(nn.Conv2D(a * 4, 3, padding=1))

    def forward(self, x):
        anchors, cls_preds, box_preds = [], [], []
        feat = x
        b = x.shape[0]
        for stage, cls_p, box_p, s, r in zip(
                self.stages, self.class_predictors, self.box_predictors,
                self._sizes, self._ratios):
            feat = stage(feat)
            anchors.append(dispatch("MultiBoxPrior", feat, sizes=s,
                                    ratios=r, clip=False))
            # (B, a C, H, W) -> (B, H W a, C): channel-last flatten
            cls_preds.append(cls_p(feat).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes + 1))
            box_preds.append(box_p(feat).permute(0, 2, 3, 1).reshape(b, -1))
        return tuple(dispatch("concat", *parts, dim=1) if len(parts) > 1
                     else parts[0]
                     for parts in (anchors, cls_preds, box_preds))

    def targets(self, anchors, cls_preds, labels,
                negative_mining_ratio=3.0):
        """``MultiBoxTarget`` over this net's outputs: (loc_target,
        loc_mask, cls_target)."""
        return _op("MultiBoxTarget", anchors, labels,
                   _op("transpose", cls_preds, axes=(0, 2, 1)),
                   negative_mining_ratio=negative_mining_ratio)

    def detect(self, anchors, cls_preds, box_preds, nms_threshold=0.45,
               threshold=0.01, nms_topk=400):
        """Decode and suppress: (B, A, 6) rows [class, score, x1, y1, x2,
        y2], dropped rows -1."""
        cls_prob = _op("transpose", _op("softmax", cls_preds, axis=-1),
                       axes=(0, 2, 1))
        return _op("MultiBoxDetection", cls_prob, box_preds, anchors,
                   nms_threshold=nms_threshold, threshold=threshold,
                   nms_topk=nms_topk)


class SSDMultiBoxLoss(Loss):
    """The class loss (softmax cross-entropy over the anchors whose
    ``cls_target`` is not -1, the ignored negatives) plus ``lambd`` times
    the smooth-L1 box loss on the masked offsets, both over the count of
    those anchors (at least 1).  A (1,)-shaped result, as the
    reference's."""

    def __init__(self, rho=1.0, lambd=1.0, **kwargs):
        super().__init__(None, 0, **kwargs)
        self._rho = rho
        self._lambd = lambd

    def forward(self, cls_preds, box_preds, cls_target, loc_target,
                loc_mask):
        logp = dispatch("log_softmax", cls_preds, axis=-1)
        valid = (cls_target >= 0).to(torch.float32)
        tgt = dispatch("maximum", cls_target,
                       dispatch("zeros_like", cls_target))
        picked = dispatch("pick", logp, tgt, axis=-1)
        n_valid = dispatch("maximum", valid.sum(),
                           torch.ones(1, device=valid.device))
        cls_loss = -(picked * valid).sum() / n_valid
        diff = (box_preds - loc_target) * loc_mask
        loc_loss = dispatch("smooth_l1", diff, scalar=self._rho).sum() \
            / n_valid
        return cls_loss + self._lambd * loc_loss


def ssd_300_vgg16_voc(classes: int = 20, **kwargs) -> SSD:
    """SSD-300 on the VGG16 trunk: conv4_3 (38 x 38), conv7 (fc6/fc7 as
    convolutions, 19 x 19) and four extra scales (10, 5, 3, 1)."""
    trunk = nn.HybridSequential()           # -> conv4_3 at 38 x 38
    trunk.add(_conv_block(64, 2), _conv_block(128, 2))
    c3 = nn.HybridSequential()              # pool3 rounds up: 75 -> 38
    for _ in range(3):
        c3.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
    c3.add(nn.MaxPool2D(2, strides=2, ceil_mode=True))
    trunk.add(c3)
    trunk.add(*[nn.Conv2D(512, 3, padding=1, activation="relu")
                for _ in range(3)])
    s2 = nn.HybridSequential()              # conv5, fc6/fc7 at 19 x 19
    s2.add(nn.MaxPool2D(2, strides=2), _conv_block(512, 3, pool=False),
           nn.MaxPool2D(3, strides=1, padding=1),   # SSD's stride-1 pool5
           nn.Conv2D(1024, 3, padding=6, dilation=6, activation="relu"),
           nn.Conv2D(1024, 1, activation="relu"))
    stages: List[HybridBlock] = [
        trunk, s2,
        _down_block(512),                         # 19 -> 10
        _down_block(256),                         # 10 -> 5
        _down_block(256, strides=1, padding=0),   # 5 -> 3
        _down_block(256, strides=1, padding=0),   # 3 -> 1
    ]
    sizes = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961)]
    ratios = [(1, 2, 0.5)] + [(1, 2, 0.5, 3, 1.0 / 3)] * 3 \
        + [(1, 2, 0.5)] * 2
    return SSD(stages, classes, sizes, ratios, **kwargs)


def ssd_toy(classes: int = 2, **kwargs) -> SSD:
    """A tiny two-scale SSD for tests."""
    s1 = nn.HybridSequential()
    s1.add(_conv_block(16, 1), _conv_block(32, 1))
    return SSD([s1, _down_block(64)], classes,
               sizes=[(0.2, 0.3), (0.5, 0.6)],
               ratios=[(1, 2, 0.5)] * 2, **kwargs)
