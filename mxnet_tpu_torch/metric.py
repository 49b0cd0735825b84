"""Streaming evaluation metrics (``mx.metric``).

Port of ``mxnet_tpu/metric.py``, whole: ``EvalMetric`` with the
``update(labels, preds)`` protocol, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MCC``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``NegativeLogLikelihood``, ``PearsonCorrelation``,
``Loss``, ``CompositeEvalMetric``, ``CustomMetric``, ``np``,
``register`` and ``create``.  As in the reference, every update reads
its arrays to the host (``_to_numpy``) and sums there in numpy, so the
values equal the reference's on the same inputs; on the card each such
read is a copy to the host that waits for the device.  ``host_reads()``
counts them (an ``NDArray`` or tensor converted; numpy inputs are not
counted).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .base import MXNetError

__all__ = [
    "EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "Perplexity",
    "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
    "PearsonCorrelation", "Loss", "CompositeEvalMetric", "CustomMetric",
    "create", "np",
]

_HOST_READS = [0]


def host_reads() -> int:
    """Arrays read to the host by metric updates since the process
    started."""
    return _HOST_READS[0]


_REGISTRY: dict = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = metric.lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
               "negativeloglikelihood", "top_k_accuracy": "topkaccuracy",
               "pearsonr": "pearsoncorrelation"}
    name = aliases.get(name, name)
    if name not in _REGISTRY:
        raise MXNetError(f"unknown metric {metric}")
    return _REGISTRY[name](*args, **kwargs)


def _to_numpy(x):
    if hasattr(x, "asnumpy"):
        _HOST_READS[0] += 1
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        _HOST_READS[0] += 1
        return x.detach().float().cpu().numpy() \
            if x.dtype in (torch.bfloat16, torch.float16) \
            else x.detach().cpu().numpy()
    return onp.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def update_dict(self, label, pred):
        lab = list(label.values())
        prd = list(pred.values())
        self.update(lab, prd)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label)
            if pred.shape != label.shape:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(onp.int64).ravel()
            label = label.astype(onp.int64).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(onp.int64)
            topk = onp.argsort(-pred, axis=-1)[..., :self.top_k]
            hit = (topk == label[..., None]).any(axis=-1)
            self.sum_metric += hit.sum()
            self.num_inst += hit.size


@register
class F1(EvalMetric):
    """Binary F1 (reference semantics: preds are class-1 probabilities or
    2-col score arrays; labels 0/1)."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset(self):
        super().reset()
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0
        self._macro_sum = 0.0
        self._macro_n = 0

    @staticmethod
    def _f1(tp, fp, fn):
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        return 2 * precision * recall / (precision + recall) \
            if precision + recall else 0.0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype(onp.int64)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1).ravel()
            else:
                pred = (pred.ravel() > 0.5).astype(onp.int64)
            tp = int(((pred == 1) & (label == 1)).sum())
            fp = int(((pred == 1) & (label == 0)).sum())
            fn = int(((pred == 0) & (label == 1)).sum())
            self.tp += tp
            self.fp += fp
            self.fn += fn
            # macro (reference default): average per-batch F1 scores
            self._macro_sum += self._f1(tp, fp, fn)
            self._macro_n += 1
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        if self.average == "micro":
            return self.name, self._f1(self.tp, self.fp, self.fn)
        return self.name, self._macro_sum / self._macro_n


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.reset_stats()

    def reset(self):
        super().reset()
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = self.tn = 0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype(onp.int64)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1).ravel()
            else:
                pred = (pred.ravel() > 0.5).astype(onp.int64)
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.tn += int(((pred == 0) & (label == 0)).sum())
            self.num_inst += len(label)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        denom = math.sqrt((self.tp + self.fp) * (self.tp + self.fn) *
                          (self.tn + self.fp) * (self.tn + self.fn))
        mcc = (self.tp * self.tn - self.fp * self.fn) / denom if denom else 0.0
        return self.name, mcc


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(onp.int64)
            if self.axis not in (-1, pred.ndim - 1):
                pred = onp.moveaxis(pred, self.axis, -1)
            flat_pred = pred.reshape(-1, pred.shape[-1])
            flat_label = label.ravel()
            probs = flat_pred[onp.arange(len(flat_label)), flat_label]
            if self.ignore_label is not None:
                ignore = flat_label == self.ignore_label
                probs = onp.where(ignore, 1.0, probs)
                num = (~ignore).sum()
            else:
                num = len(flat_label)
            self.sum_metric += -onp.log(onp.maximum(probs, 1e-10)).sum()
            self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            label = label.reshape(pred.shape)
            self.sum_metric += onp.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            label = label.reshape(pred.shape)
            self.sum_metric += ((label - pred) ** 2).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(self.sum_metric / self.num_inst)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel().astype(onp.int64)
            pred = _to_numpy(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[onp.arange(len(label)), label]
            self.sum_metric += (-onp.log(prob + self.eps)).sum()
            self.num_inst += len(label)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels = []
        self._preds = []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_numpy(label).ravel())
            self._preds.append(_to_numpy(pred).ravel())
            self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        x = onp.concatenate(self._labels)
        y = onp.concatenate(self._preds)
        r = onp.corrcoef(x, y)[0, 1]
        return self.name, float(r)


@register
class Loss(EvalMetric):
    """Mean of raw loss values (reference ``mx.metric.Loss``)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            pred = _to_numpy(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.append(name)
            values.append(value)
        return names, values


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            result = self._feval(label, pred)
            if isinstance(result, tuple):
                s, n = result
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += result
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """Wrap a numpy feval as a metric (reference ``mx.metric.np``)."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)
