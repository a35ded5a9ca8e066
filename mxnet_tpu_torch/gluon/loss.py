"""Loss blocks.

Counterpart of ``mxnet_tpu/gluon/loss.py``, every class and alias of it,
with its weighting rules: ``sample_weight`` multiplies the element-wise
loss, then the scalar ``weight``, and the result is averaged over every
axis but the batch axis, so a loss returns one value per sample (but
``TripletLoss`` and ``CosineEmbeddingLoss``, which sum or reduce a sample
themselves, and ``PoissonNLLLoss``, which returns the mean over all).
``CTCLoss`` is the JAX package's log-domain dynamic program over time, in
torch operations on the data's device.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .. import npx
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss", "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss",
           "PoissonNLLLoss", "CTCLoss", "SDMLLoss"]


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


class L1Loss(Loss):
    """|pred - label|, mean over non-batch axes."""

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
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


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of logits (the stable form ``max(x, 0) - x z +
    log(1 + exp(-|x|))``) or, ``from_sigmoid``, of probabilities (with
    1e-12 inside the logs); ``pos_weight`` scales the positive term."""

    def __init__(self, from_sigmoid: bool = False,
                 weight: Optional[float] = 1.0, batch_axis: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            loss = pred.clamp_min(0) - pred * label + \
                torch.log1p(torch.exp(-pred.abs()))
            if pos_weight is not None:
                loss = loss + (pos_weight - 1) * label * (-F.logsigmoid(pred))
        else:
            eps = 1e-12
            pos = (pred + eps).log() * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + (1.0 - pred + eps).log() * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)``, pred log-probabilities
    (``from_logits``) or logits that a log-softmax over ``axis`` turns
    into them."""

    def __init__(self, from_logits: bool = True, axis: int = -1,
                 weight: Optional[float] = 1.0, batch_axis: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=self._axis)
        loss = label * ((label + 1e-12).log() - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HuberLoss(Loss):
    """``|e| - rho / 2`` where ``|e| > rho``, else ``e^2 / (2 rho)``."""

    def __init__(self, rho: float = 1.0, weight: Optional[float] = 1.0,
                 batch_axis: int = 0, **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        err = (label.reshape(pred.shape) - pred).abs()
        rho = self._rho
        loss = torch.where(err > rho, err - 0.5 * rho,
                           (0.5 / rho) * err.square())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    """``max(margin - pred * label, 0)``, labels in {-1, 1}."""

    def __init__(self, margin: float = 1.0, weight: Optional[float] = 1.0,
                 batch_axis: int = 0, **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _hinge(self, pred, label):
        return (self._margin - pred * label.reshape(pred.shape)).clamp_min(0)

    def forward(self, pred, label, sample_weight=None):
        loss = _apply_weighting(self._hinge(pred, label), self._weight,
                                sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(HingeLoss):
    """``max(margin - pred * label, 0)^2``."""

    def forward(self, pred, label, sample_weight=None):
        loss = _apply_weighting(self._hinge(pred, label).square(),
                                self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))``, labels in {-1, 1} ('signed') or
    {0, 1} ('binary')."""

    def __init__(self, label_format: str = "signed",
                 weight: Optional[float] = 1.0, batch_axis: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "binary":
            label = 2 * label - 1
        x = pred * label
        loss = torch.log1p(torch.exp(-x.abs())) + (-x).clamp_min(0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    """``max(|pred - positive|^2 - |pred - negative|^2 + margin, 0)``, the
    squares summed over a sample's axes."""

    def __init__(self, margin: float = 1.0, weight: Optional[float] = 1.0,
                 batch_axis: int = 0, **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        dims = tuple(range(1, pred.ndim))
        d_pos = (pred - positive).square().sum(dim=dims)
        d_neg = (pred - negative).square().sum(dim=dims)
        loss = (d_pos - d_neg + self._margin).clamp_min(0)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos(a, b)`` for label 1, ``max(cos(a, b) - margin, 0)``
    otherwise, each sample flattened."""

    def __init__(self, margin: float = 0.0, weight: Optional[float] = 1.0,
                 batch_axis: int = 0, **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        a = input1.reshape(input1.shape[0], -1)
        b = input2.reshape(input2.shape[0], -1)
        cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                 * torch.linalg.vector_norm(b, dim=-1)
                                 + 1e-12)
        loss = torch.where(label.reshape(-1) > 0, 1 - cos,
                           (cos - self._margin).clamp_min(0))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """``exp(pred) - target * pred`` (``from_logits``) or ``pred - target
    * log(pred + epsilon)``, plus Stirling's ``log(target!)`` where target
    > 1 (``compute_full``); the mean over every element."""

    def __init__(self, from_logits: bool = True,
                 compute_full: bool = False, weight: Optional[float] = 1.0,
                 batch_axis: int = 0, **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None,
                epsilon: float = 1e-8):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = pred.exp() - target * pred
        else:
            loss = pred - target * (pred + epsilon).log()
        if self._compute_full:
            stirling = (target * target.log() - target
                        + 0.5 * (2 * math.pi * target).log())
            loss = loss + torch.where(target > 1, stirling,
                                      torch.zeros_like(target))
        return _apply_weighting(loss, self._weight, sample_weight).mean()


class CTCLoss(Loss):
    """Connectionist temporal classification, blank = class 0.

    pred (N, T, C) for ``layout='NTC'`` or (T, N, C) for 'TNC', logits a
    log-softmax turns into log-probabilities; label (N, L) for
    ``label_layout='NT'`` or (L, N) for 'TN'. Without ``pred_lengths`` every
    sequence is T long and a label's length is its count of non-zero
    entries (padding with 0); with ``pred_lengths`` and no
    ``label_lengths``, L. Returns the per-sample negative log-likelihood by
    the JAX package's log-domain forward recursion over the extended label
    (blanks between and around the labels; -1e30 for log 0), frozen past
    each sequence's length; its gradient is autograd's through the
    recursion. The JAX package reads the label as (N, L) whatever
    ``label_layout`` says."""

    def __init__(self, layout: str = "NTC", label_layout: str = "NT",
                 weight: Optional[float] = 1.0, **kwargs: Any) -> None:
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "TNC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        loss = _ctc_nll(pred, label.long(), pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


def _ctc_nll(logits, labels, pred_lengths, label_lengths):
    """-log p(label | logits) of each sample: logits (N, T, C), labels
    (N, L) int64. Not ``F.ctc_loss``: a label within its length may be the
    blank here, as the JAX package allows, and PyTorch's gradient is wrong
    there (it takes no blank among the targets)."""
    N, T = logits.shape[:2]
    L = labels.shape[1]
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)
    if pred_lengths is None:
        plen = torch.full((N,), T, device=dev)
        llen = (labels != 0).sum(1)
    else:
        plen = pred_lengths.long()
        llen = label_lengths.long() if label_lengths is not None else \
            torch.full((N,), L, device=dev)
    # a negative label (padding) counts from the end, as JAX's gather
    # takes it
    labels = torch.where(labels < 0, labels + logits.shape[2], labels)
    S = 2 * L + 1
    ext = labels.new_zeros((N, S))
    ext[:, 1::2] = labels
    # log-probability of each extended symbol at each step: (T, N, S)
    emit = torch.gather(logp, 2, ext[:, None, :].expand(N, T, S)) \
        .transpose(0, 1)
    neg = torch.tensor(-1e30, dtype=logp.dtype, device=dev)
    skip = torch.cat([torch.zeros((N, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] != ext[:, :-2]], dim=1)
    alpha = torch.cat([emit[0, :, :2], neg.expand(N, S - 2)], dim=1)
    live = torch.arange(T, device=dev)[:, None] < plen[None, :]  # (T, N)
    for t in range(1, T):
        a1 = torch.cat([neg.expand(N, 1), alpha[:, :-1]], dim=1)
        a2 = torch.where(skip, torch.cat([neg.expand(N, 2), alpha[:, :-2]],
                                         dim=1), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + emit[t]
        alpha = torch.where(live[t][:, None], new, alpha)
    end = 2 * llen
    last = alpha.gather(1, end[:, None])[:, 0]
    last2 = alpha.gather(1, (end - 1).clamp_min(0)[:, None])[:, 0]
    return -torch.logaddexp(last, last2)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: two aligned batches x1, x2 (N, d),
    row i of each a positive pair and every other row a negative; the KL
    divergence of smoothed identity labels from the softmax over negative
    squared L2 distances (its value with the labels' entropy, as the
    reference's KLDivLoss-based form gives)."""

    def __init__(self, smoothing_parameter: float = 0.3,
                 weight: float = 1.0, batch_axis: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = float(smoothing_parameter)

    def forward(self, x1, x2):
        N = x1.shape[0]
        dist = x1.square().sum(1).reshape(N, 1) \
            + x2.square().sum(1).reshape(1, N) - 2.0 * (x1 @ x2.T)
        s = self._smoothing
        eye = torch.eye(N, dtype=x1.dtype, device=x1.device)
        labels = eye * (1.0 - s) + (1.0 - eye) * (s / max(N - 1, 1))
        log_prob = npx.log_softmax(-dist, axis=-1)
        entropy = (1.0 - s) * math.log(1.0 - s) + s * math.log(s / (N - 1)) \
            if N > 1 and 0.0 < s < 1.0 else 0.0
        loss = entropy - (labels * log_prob).sum(1)
        loss = _apply_weighting(loss, self._weight, None)
        return _batch_mean(loss, self._batch_axis)
