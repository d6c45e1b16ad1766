"""Gluon losses of the port.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (``Loss``, ``L2Loss``,
``SoftmaxCrossEntropyLoss``) with the same semantics: a number ``weight``
scales the loss, ``sample_weight`` multiplies it with broadcasting, and the
result is the mean over every axis but ``batch_axis``, one value per
example.  ``log_softmax`` and ``pick`` are the registered ops, reached
through ``registry.dispatch`` as the reference's loss invokes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.registry import dispatch
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


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
