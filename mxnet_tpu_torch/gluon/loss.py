"""Gluon losses of the port.

Counterpart of ``mxnet_tpu/gluon/loss.py``, every class, with the same
semantics: a number ``weight`` scales the loss, ``sample_weight``
multiplies it with broadcasting, and the result is the mean over every
axis but ``batch_axis``, one value per example (``CTCLoss``,
``TripletLoss`` and ``CosineEmbeddingLoss`` give their per-example values
unreduced, ``PoissonNLLLoss`` the mean over everything, as the reference's
do).  The ops the reference's losses invoke by name (``log_softmax``,
``pick``, ``where``, ``dot``, ``_eye``, ``CTCLoss``) are the registered
ops, reached through ``registry.dispatch``.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from ..ops.registry import dispatch
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


def _apply_weighting(loss: torch.Tensor, weight=None,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise TypeError("weight must be a number, got %r" % (weight,))
        loss = loss * weight
    return loss


def _batch_mean(loss: torch.Tensor, batch_axis: int) -> torch.Tensor:
    """Mean over every axis except ``batch_axis``."""
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    if not axes:
        return loss
    return loss.mean(dim=axes)


class Loss(HybridBlock):
    """Base loss: holds ``weight`` and ``batch_axis``."""

    def __init__(self, weight, batch_axis: int, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return "batch_axis=%s, w=%s" % (self._batch_axis, self._weight)


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2``, label reshaped to pred's shape."""

    def __init__(self, weight=1.0, batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (pred - label) ** 2
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    """``|pred - label|``, label reshaped to pred's shape."""

    def __init__(self, weight=None, batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (pred - label.reshape(pred.shape)).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


def _softplus_neg_abs(x):
    """``log(1 + exp(-|x|))``, the stable tail of the logistic losses."""
    return torch.log(1.0 + torch.exp(-x.abs()))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (of pred itself with
    ``from_sigmoid``) against a 0/1 label, optionally with ``pos_weight``
    on the positive term; the logit form is the stable
    ``max(x, 0) - x z + log(1 + exp(-|x|))``."""

    def __init__(self, from_sigmoid: bool = False, weight=None,
                 batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = pred.relu() - pred * label + _softplus_neg_abs(pred)
            else:
                log_weight = 1.0 + label * (pos_weight - 1.0)
                loss = pred - pred * label + log_weight * (
                    _softplus_neg_abs(pred) + (-pred).relu())
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross-entropy of ``log_softmax(pred)`` along ``axis``: against
    integer class labels (``sparse_label``, picked with clipping) or a
    distribution of pred's shape.  ``from_logits`` takes pred as
    log-probabilities already."""

    def __init__(self, axis: int = -1, sparse_label: bool = True,
                 from_logits: bool = False, weight=None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = dispatch("log_softmax", pred, axis=self._axis)
        if self._sparse_label:
            loss = -dispatch("pick", pred, label, axis=self._axis,
                             keepdims=False)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, pred taken as
    log-probabilities (``from_logits``) or log-softmaxed along ``axis``."""

    def __init__(self, from_logits: bool = True, axis: int = -1,
                 weight=None, batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = dispatch("log_softmax", pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification over the ``CTCLoss`` op:
    pred in ``layout`` 'NTC' or 'TNC', labels in ``label_layout`` 'NT' or
    'TN'; one loss per sequence, unreduced."""

    def __init__(self, layout: str = "NTC", label_layout: str = "NT",
                 weight=None, **kwargs):
        super().__init__(weight, label_layout.find("N"), **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        loss = dispatch("CTCLoss", pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|err| - rho / 2`` where ``|err| > rho``, else ``err^2 / (2
    rho)``."""

    def __init__(self, rho=1.0, weight=None, batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        err = (pred - label.reshape(pred.shape)).abs()
        loss = dispatch("where", err > self._rho, err - 0.5 * self._rho,
                        (0.5 / self._rho) * err ** 2)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` for labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = (self._margin - pred * label.reshape(pred.shape)).relu()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = (self._margin - pred * label.reshape(pred.shape)).relu() ** 2
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """The logistic loss of logits against labels in {-1, 1}
    (``label_format`` 'signed') or {0, 1} ('binary')."""

    def __init__(self, weight=None, batch_axis: int = 0,
                 label_format: str = "signed", **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format must be signed or binary")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = pred.relu() - pred * label + _softplus_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """``max(0, |pred - positive|^2 - |pred - negative|^2 + margin)``,
    the squares summed over every axis but the first."""

    def __init__(self, margin=1, weight=None, batch_axis: int = 0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        dims = tuple(range(1, pred.dim()))
        loss = ((pred - positive) ** 2 - (pred - negative) ** 2).sum(
            dim=dims)
        loss = (loss + self._margin).relu()
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of ``target`` under rate
    ``exp(pred)`` (``from_logits``) or ``pred``; ``compute_full`` adds the
    Stirling term of log(target!) where target > 1.  The mean over every
    entry."""

    def __init__(self, weight=None, from_logits: bool = True,
                 batch_axis: int = 0, compute_full: bool = False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target) - target + \
                0.5 * torch.log(2 * math.pi * target)
            loss = loss + dispatch("where", target <= 1, stirling * 0,
                                   stirling)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, else ``max(0, cos -
    margin)``, the cosine over the last axis; one value per row."""

    def __init__(self, weight=None, batch_axis: int = 0, margin=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input2 = input2.reshape(input1.shape)
        dot = (input1 * input2).sum(dim=-1)
        n1 = (input1 ** 2).sum(dim=-1).sqrt()
        n2 = (input2 ** 2).sum(dim=-1).sqrt()
        cos = dot / (n1 * n2 + 1e-12)
        label = label.reshape(cos.shape)
        loss = dispatch("where", label == 1, 1.0 - cos,
                        (cos - self._margin).relu())
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: the batch (x1[i], x2[i]) as N
    retrieval problems, ``softmax(-distance)`` pulled by KL divergence
    toward the identity smoothed by ``smoothing_parameter``."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0,
                 batch_axis: int = 0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing_parameter
        self._kl = KLDivLoss(from_logits=True)

    def forward(self, x1, x2):
        n = x1.shape[0]
        x1sq = (x1 * x1).sum(dim=1).reshape(n, 1)
        x2sq = (x2 * x2).sum(dim=1).reshape(1, n)
        dist = x1sq + x2sq - 2.0 * dispatch("dot", x1, x2.t())
        log_prob = dispatch("log_softmax", -dist, axis=1)
        eye = dispatch("_eye", N=n, device=x1.device)
        labels = eye * (1.0 - self._smoothing) + \
            (1.0 - eye) * (self._smoothing / max(n - 1, 1))
        return self._kl(log_prob, labels)
