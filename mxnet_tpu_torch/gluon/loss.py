"""Loss blocks: ``Loss``, ``L2Loss``, ``SoftmaxCrossEntropyLoss``.

Counterpart of the same classes in ``mxnet_tpu/gluon/loss.py``, with its
weighting rules: ``sample_weight`` multiplies the element-wise loss, then
the scalar ``weight``, and the result is averaged over every axis but the
batch axis, so a loss returns one value per sample.
"""
from __future__ import annotations

from typing import Any, Optional

from .. import npx
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight: Optional[float], sample_weight):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis: int):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis % loss.ndim)
    return loss.mean(dim=axes) if axes else loss


class Loss(HybridBlock):
    """Base loss block."""

    def __init__(self, weight: Optional[float] = 1.0, batch_axis: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    """0.5 * (pred - label)^2, mean over non-batch axes."""

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (label - pred).square() * 0.5
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax and cross entropy fused through ``log_softmax``."""

    def __init__(self, axis: int = -1, sparse_label: bool = True,
                 from_logits: bool = False, weight: Optional[float] = 1.0,
                 batch_axis: int = 0, **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -npx.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)
