"""Loss layers.

Port of ``mxnet_tpu/gluon/loss.py``, its fourteen losses as
``HybridBlock``s (``L1Loss``, ``L2Loss``, ``SigmoidBinaryCrossEntropyLoss``,
``SoftmaxCrossEntropyLoss``, ``KLDivLoss``, ``CTCLoss``, ``HuberLoss``,
``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``PoissonNLLLoss``, ``CosineEmbeddingLoss``), with the reference's
formulas, flags and semantics: a loss is per sample, the mean over every axis but
``batch_axis``; ``weight`` is a number the loss is multiplied by, and
``sample_weight`` a tensor broadcast against it.  A loss takes and
returns ``NDArray``s (``Block``'s bridge), or tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..base import MXNetError
from ..ops.nn import CTCLoss as _ctc, log_softmax, pick, sparse_softmax_ce
from .block import HybridBlock

__all__ = [
    "Loss", "L1Loss", "L2Loss", "SigmoidBinaryCrossEntropyLoss",
    "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
    "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
    "LogisticLoss", "TripletLoss", "PoissonNLLLoss", "CosineEmbeddingLoss",
]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"

    def _mean_excl_batch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class L1Loss(Loss):
    """|pred - label|."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


class L2Loss(Loss):
    """0.5 * (pred - label)^2 (the 0.5 matches the reference)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_excl_batch(loss)


def _softrelu_neg_abs(x):
    # the reference's Activation(-|x|, "softrelu"): log(1 + exp(-|x|))
    return TF.softplus(-x.abs())


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (the stable ``max(x, 0) - x z +
    log(1 + exp(-|x|))``) or, with ``from_sigmoid``, on probabilities;
    ``pos_weight`` weights the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softrelu_neg_abs(pred)
            else:
                loss = pred - pred * label + \
                    (1 + (pos_weight - 1) * label) * \
                    (_softrelu_neg_abs(pred) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """``sparse_label=True`` means integer class labels; ``axis`` is the
    class axis.  Sparse labels on logits take the fused ``lse -
    pred[label]`` (f32 inside the reductions, no (N, V) f32 array)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if self._sparse_label and not self._from_logits:
            loss = sparse_softmax_ce(pred, label, axis=self._axis)
        elif self._sparse_label:
            loss = -pick(pred, label, axis=self._axis, keepdims=True)
        else:
            if not self._from_logits:
                pred = log_softmax(pred, axis=self._axis)
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``; ``pred`` are
    log-probabilities, or logits with ``from_logits=False``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


class CTCLoss(Loss):
    """Connectionist temporal classification over the port's ``CTCLoss``
    op, blank last, in the reference's layouts (``NTC``/``TNC`` data,
    ``NT``/``TN`` labels)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"bad layout {layout}")
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = _ctc(pred, label, pred_lengths, label_lengths,
                    use_data_lengths=pred_lengths is not None,
                    use_label_lengths=label_lengths is not None,
                    blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Quadratic below ``rho``, linear above."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` with labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(
            self._margin - pred * label.reshape(pred.shape)).square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


class LogisticLoss(Loss):
    """The logistic loss on logits, labels ``signed`` (-1, 1) or
    ``binary`` (0, 1)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_excl_batch(loss)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)`` over every axis
    but the batch axis."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        axes = tuple(i for i in range(pred.dim()) if i != self._batch_axis)
        loss = ((positive - pred).square() - (negative - pred).square()
                ).sum(dim=axes) + self._margin
        return _apply_weighting(torch.relu(loss), self._weight,
                                sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood on log-rates (``from_logits``) or
    rates, with Stirling's term under ``compute_full``; the mean over
    every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
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
            stirling = target * torch.log(target + epsilon) - target + \
                0.5 * torch.log(2 * math.pi * (target + epsilon))
            stirling = torch.where(target <= 1, torch.zeros_like(target),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, ``max(0, cos - margin)`` otherwise, over
    the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        cos = (input1 * input2).sum(-1) / (
            input1.norm(dim=-1) * input2.norm(dim=-1) + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)
