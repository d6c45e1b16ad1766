"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference: python/mxnet/metric.py):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``NegativeLogLikelihood``, ``PearsonCorrelation``,
``Loss``, ``CustomMetric``, ``VOCMApMetric``, ``VOC07MApMetric``, ``np``
and ``create``.

As in the reference, ``Accuracy``, ``Perplexity``, ``MAE``/``MSE``/
``RMSE``, ``CrossEntropy`` and ``Loss`` keep their running sum and count
as tensors on the device of the predictions when given NDArrays or
tensors: ``update`` never copies to the host, and ``get`` does, once.
Numpy inputs and the other metrics take the host path; the VOC mAP
metrics always do, as in the reference (per-class score sorting and greedy
box matching have no fixed-shape device form).
"""
from __future__ import annotations

import math
from typing import List

import numpy as _np
import torch

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe",
           "CustomMetric", "VOCMApMetric", "VOC07MApMetric", "np", "create",
           "check_label_shapes"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _as_numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return _np.asarray(x)


def _device_val(x):
    """The tensor behind an NDArray or a tensor, else None (the caller then
    takes the host path)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    data = getattr(x, "data", None)
    if isinstance(data, torch.Tensor) and hasattr(x, "asnumpy"):
        return data.detach()
    return None


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def check_label_shapes(labels, preds, shape: bool = False):
    if not shape:
        n_label, n_pred = len(labels), len(preds)
    else:
        n_label, n_pred = labels.shape[0], preds.shape[0]
    if n_label != n_pred:
        raise ValueError("Shape of labels %d does not match shape of "
                         "predictions %d" % (n_label, n_pred))


class EvalMetric:
    """Base accumulator (reference: class EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        pred = [pred[n] for n in self.output_names] \
            if self.output_names is not None else list(pred.values())
        label = [label[n] for n in self.label_names] \
            if self.label_names is not None else list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._dev_sum = None
        self._dev_inst = None

    def _accumulate(self, device, batch_sum, batch_count):
        """Add one batch to the device sums (no host sync); counts one
        dispatch, as the reference's jitted accumulate does."""
        from .engine import engine as _engine
        from . import telemetry as _telemetry
        with _telemetry.phase("metric_update"):
            _engine.count_dispatch()
            if self._dev_sum is None:
                self._dev_sum = torch.zeros((), dtype=torch.float32,
                                            device=device)
                self._dev_inst = torch.zeros((), dtype=torch.int64,
                                             device=device)
            self._dev_sum += batch_sum.to(device=self._dev_sum.device,
                                          dtype=torch.float32)
            self._dev_inst += batch_count.to(self._dev_inst.device) \
                if isinstance(batch_count, torch.Tensor) \
                else int(batch_count)

    def _drain_device(self):
        """The host sync: move the device sums into ``sum_metric`` and
        ``num_inst`` (the ``metric_drain`` phase shows its cost)."""
        if self._dev_sum is not None:
            from . import telemetry as _telemetry
            with _telemetry.phase("metric_drain"):
                self.sum_metric += float(self._dev_sum)
                self.num_inst += int(self._dev_inst)
                self._dev_sum = None
                self._dev_inst = None

    def get(self):
        self._drain_device()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics as one."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                names.append(name)
            else:
                names.extend(name)
            if isinstance(value, list):
                values.extend(value)
            else:
                values.append(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pt, lt = _device_val(pred), _device_val(label)
            if pt is not None and lt is not None:
                n_pred = pt.numel() // (pt.shape[self.axis]
                                        if pt.dim() > lt.dim() else 1)
                if n_pred != lt.numel():
                    raise ValueError(
                        "Shape of labels %d does not match shape of "
                        "predictions %d" % (lt.numel(), n_pred))
                if pt.dim() > lt.dim():
                    pt = pt.argmax(dim=self.axis)
                p = pt.reshape(-1).to(torch.int32)
                l = lt.reshape(-1).to(device=p.device, dtype=torch.int32)
                self._accumulate(p.device, (p == l).sum(), l.numel())
                continue
            pred, label = _as_numpy(pred), _as_numpy(label)
            if pred.ndim > label.ndim:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype(_np.int64).ravel()
            label = label.astype(_np.int64).ravel()
            check_label_shapes(label, pred, shape=True)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert top_k > 1, "use Accuracy for top_k=1"
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(_np.int64)
            assert pred.ndim <= 2, "Predictions should be no more than 2 dims"
            topk = _np.argsort(pred.astype(_np.float64), axis=-1)
            depth = min(self.top_k, pred.shape[-1])
            if pred.ndim == 1:
                self.sum_metric += float((topk[-depth:] == label).any())
                self.num_inst += 1
            else:
                for k in range(1, depth + 1):
                    self.sum_metric += float(
                        (topk[:, -k] == label.ravel()).sum())
                self.num_inst += label.shape[0]


def _binary(label, pred):
    label = _as_numpy(label).astype(_np.int64).ravel()
    pred = _as_numpy(pred)
    if pred.ndim > 1 and pred.shape[-1] > 1:
        pred = _np.argmax(pred, axis=-1).ravel()
    else:
        pred = (pred.ravel() > 0.5).astype(_np.int64)
    return label, pred


@register
class F1(EvalMetric):
    """Binary F1, ``average`` 'macro' (per batch) or 'micro'."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._tp = self._fp = self._fn = 0.0
        self._scores: List[float] = []
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _binary(label, pred)
            tp = float(((pred == 1) & (label == 1)).sum())
            fp = float(((pred == 1) & (label == 0)).sum())
            fn = float(((pred == 0) & (label == 1)).sum())
            if self.average == "micro":
                self._tp += tp
                self._fp += fp
                self._fn += fn
            else:
                prec = tp / (tp + fp) if tp + fp else 0.0
                rec = tp / (tp + fn) if tp + fn else 0.0
                self._scores.append(2 * prec * rec / (prec + rec)
                                    if prec + rec else 0.0)
            self.num_inst += 1

    def reset(self):
        self._tp = self._fp = self._fn = 0.0
        self._scores = []
        super().reset()

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        if self.average == "micro":
            tp, fp, fn = self._tp, self._fp, self._fn
            prec = tp / (tp + fp) if tp + fp else 0
            rec = tp / (tp + fn) if tp + fn else 0
            return (self.name,
                    2 * prec * rec / (prec + rec) if prec + rec else 0.0)
        return (self.name, sum(self._scores) / len(self._scores))


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient."""

    def __init__(self, name="mcc", output_names=None, label_names=None):
        self._tp = self._fp = self._tn = self._fn = 0.0
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _binary(label, pred)
            self._tp += float(((pred == 1) & (label == 1)).sum())
            self._fp += float(((pred == 1) & (label == 0)).sum())
            self._tn += float(((pred == 0) & (label == 0)).sum())
            self._fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)

    def reset(self):
        self._tp = self._fp = self._tn = self._fn = 0.0
        super().reset()

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        tp, fp, tn, fn = self._tp, self._fp, self._tn, self._fn
        denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return (self.name, ((tp * tn) - (fp * fn)) / denom if denom else 0.0)


@register
class Perplexity(EvalMetric):
    """exp(mean negative log-likelihood); ``ignore_label`` skips padding."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss, num = 0.0, 0
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pt, lt = _device_val(pred), _device_val(label)
            if pt is not None and lt is not None:
                p = pt.reshape(-1, pt.shape[-1]).float()
                l = lt.reshape(-1).to(device=p.device, dtype=torch.int64)
                probs = p.gather(1, l[:, None])[:, 0]
                count = torch.tensor(l.shape[0], device=p.device)
                if self.ignore_label is not None:
                    ignore = l == int(self.ignore_label)
                    probs = torch.where(ignore, torch.ones_like(probs),
                                        probs)
                    count = count - ignore.sum()
                self._accumulate(p.device,
                                 -probs.clamp_min(1e-10).log().sum(), count)
                continue
            pred = _as_numpy(pred).astype(_np.float64)
            label = _as_numpy(label).astype(_np.int64).reshape(-1)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        self._drain_device()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


class _RegressionMetric(EvalMetric):
    """MAE and MSE: one mean error per batch."""

    _squared = False

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lt, pt = _device_val(label), _device_val(pred)
            if lt is not None and pt is not None:
                lt = lt.reshape(-1, 1) if lt.dim() == 1 else lt
                pt = pt.reshape(-1, 1) if pt.dim() == 1 else pt
                diff = lt.float().to(pt.device) - pt.float()
                err = (diff * diff).mean() if self._squared \
                    else diff.abs().mean()
                self._accumulate(pt.device, err, 1)
                continue
            label, pred = _as_numpy(label), _as_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            err = ((label - pred) ** 2) if self._squared \
                else _np.abs(label - pred)
            self.sum_metric += float(err.mean())
            self.num_inst += 1


@register
class MAE(_RegressionMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class MSE(_RegressionMetric):
    _squared = True

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        self._drain_device()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lt, pt = _device_val(label), _device_val(pred)
            if lt is not None and pt is not None and pt.dim() == 2:
                l = lt.reshape(-1).to(device=pt.device, dtype=torch.int64)
                assert l.numel() == pt.shape[0]
                prob = pt.float().gather(1, l[:, None])[:, 0]
                self._accumulate(pt.device,
                                 (-(prob + self.eps).log()).sum(),
                                 l.shape[0])
                continue
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), label.astype(_np.int64)]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            self.sum_metric += float(_np.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """The mean of a loss output."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _as_list(preds):
            pt = _device_val(pred)
            if pt is not None:
                self._accumulate(pt.device, pt.float().sum(), pt.numel())
                continue
            pred = _as_numpy(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += int(_np.prod(pred.shape))


@register
class Torch(Loss):
    """The reference's deprecated alias of :class:`Loss` for torch
    criterion outputs."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)


@register
class Caffe(Loss):
    """The reference's deprecated alias of :class:`Loss` for caffe
    criterion outputs."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a
    value or ``(num_inst, sum_metric)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        if name.startswith("<"):
            name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                num_inst, sum_metric = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


@register
class VOCMApMetric(EvalMetric):
    """PASCAL VOC mean average precision over detections.

    ``update(labels, preds)``: labels (B, M, 5+) rows [class, x1, y1, x2,
    y2] padded with class -1; preds (B, N, 6) rows [class, score, x1, y1,
    x2, y2], dropped rows -1 (``MultiBoxDetection``'s output).  A
    detection is a true positive when the ground truth of its class it
    overlaps best (IoU >= ``iou_thresh``) is not matched yet; a second
    detection of a matched ground truth is a false positive.  ``get``
    averages the per-class AP over the classes that have ground truths:
    the area under the precision envelope, or the 11-point interpolation
    with ``use_07_metric``."""

    def __init__(self, iou_thresh=0.5, class_names=None, use_07_metric=False,
                 name="mAP"):
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        self.use_07_metric = use_07_metric
        super().__init__(name)

    def reset(self):
        super().reset()
        self._records = {}      # class -> [(score, is_true_positive)]
        self._n_gt = {}         # class -> count of ground truths

    def update(self, labels, preds):
        for lab, pred in zip(_as_list(labels), _as_list(preds)):
            lab, pred = _as_numpy(lab), _as_numpy(pred)
            for b in range(lab.shape[0]):
                self._update_one(lab[b], pred[b])

    def _update_one(self, lab, pred):
        gts = lab[lab[:, 0] >= 0]
        for c in gts[:, 0].astype(int):
            self._n_gt[c] = self._n_gt.get(c, 0) + 1
        dets = pred[pred[:, 0] >= 0]
        dets = dets[_np.argsort(-dets[:, 1])]
        matched = _np.zeros(len(gts), bool)
        for det in dets:
            c = int(det[0])
            best_iou, best_j = 0.0, -1
            for j, gt in enumerate(gts):
                if int(gt[0]) != c:
                    continue
                iou = self._iou(det[2:6], gt[1:5])
                if iou > best_iou:
                    best_iou, best_j = iou, j
            tp = (best_j >= 0 and best_iou >= self.iou_thresh
                  and not matched[best_j])
            if tp:
                matched[best_j] = True
            self._records.setdefault(c, []).append((float(det[1]), tp))

    @staticmethod
    def _iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        union = ((a[2] - a[0]) * (a[3] - a[1])
                 + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / union if union > 0 else 0.0

    def _average_precision(self, recs, n_gt):
        if not recs or n_gt == 0:
            return 0.0
        recs = sorted(recs, key=lambda r: -r[0])
        tps = _np.cumsum([r[1] for r in recs])
        fps = _np.cumsum([not r[1] for r in recs])
        rec = tps / n_gt
        prec = tps / _np.maximum(tps + fps, 1e-12)
        if self.use_07_metric:
            ap = 0.0
            for t in _np.arange(0.0, 1.1, 0.1):
                ap += (prec[rec >= t].max() if (rec >= t).any() else 0.0) \
                    / 11.0
            return float(ap)
        mrec = _np.concatenate([[0.0], rec, [1.0]])
        mpre = _np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = _np.where(mrec[1:] != mrec[:-1])[0]
        return float(_np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def get(self):
        classes = sorted(self._n_gt)
        if not classes:
            return self.name, float("nan")
        aps = [self._average_precision(self._records.get(c, []),
                                       self._n_gt[c]) for c in classes]
        return self.name, float(_np.mean(aps))


@register
class VOC07MApMetric(VOCMApMetric):
    """The 11-point interpolated VOC2007 mean average precision."""

    def __init__(self, iou_thresh=0.5, class_names=None, name="mAP07"):
        super().__init__(iou_thresh, class_names, use_07_metric=True,
                         name=name)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` from a numpy function."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    """A metric from a name, a callable, a list (composite) or an
    instance."""
    if callable(metric) and not isinstance(metric, type):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        aliases = {"acc": "accuracy", "ce": "crossentropy",
                   "nll_loss": "negativeloglikelihood",
                   "top_k_accuracy": "topkaccuracy",
                   "top_k_acc": "topkaccuracy",
                   "pearson_correlation": "pearsoncorrelation"}
        key = aliases.get(metric.lower(), metric.lower())
        if key in _METRIC_REGISTRY:
            return _METRIC_REGISTRY[key](*args, **kwargs)
    if isinstance(metric, type) and issubclass(metric, EvalMetric):
        return metric(*args, **kwargs)
    raise ValueError("Metric must be a callable, name, or EvalMetric; got %r"
                     % (metric,))
