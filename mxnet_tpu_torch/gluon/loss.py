"""Loss layers.

Port of ``mxnet_tpu/gluon/loss.py`` (``Loss``, ``L2Loss``,
``SoftmaxCrossEntropyLoss``) as ``nn.Module``s, with the reference's
semantics: a loss is per sample, the mean over every axis but
``batch_axis``; ``weight`` is a number the loss is multiplied by, and
``sample_weight`` a tensor broadcast against it.
"""
from __future__ import annotations

from torch import nn

from ..base import MXNetError
from ..ops.nn import log_softmax, pick, sparse_softmax_ce

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise MXNetError("weight must be a number")
        loss = loss * weight
    return loss


class Loss(nn.Module):
    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"

    def _mean_excl_batch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """0.5 * (pred - label)^2 (the 0.5 matches the reference)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_excl_batch(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """``sparse_label=True`` means integer class labels; ``axis`` is the
    class axis.  Sparse labels on logits take the fused ``lse -
    pred[label]`` (f32 inside the reductions, no (N, V) f32 array)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
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
