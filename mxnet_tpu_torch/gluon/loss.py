"""``gluon.loss`` of the port: the losses that the training path uses, as
``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (``Loss``, ``L2Loss``,
``SoftmaxCrossEntropyLoss``), with the same arguments and arithmetic:
each returns the per-sample loss, the mean over every axis but the batch
axis. The other losses are not ported yet.
"""

import torch
from torch import nn

__all__ = ['Loss', 'L2Loss', 'SoftmaxCrossEntropyLoss', 'SoftmaxCELoss']


def _apply_weighting(loss, weight=None, sample_weight=None):
    """Reference loss.py:_apply_weighting."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if label.shape != pred.shape else label


class Loss(nn.Module):
    """Base loss (reference loss.py:Loss)."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``, averaged per sample."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Reference loss.py:SoftmaxCrossEntropyLoss: ``-log_softmax(pred)``
    picked at the label (``sparse_label``) or summed against a dense
    label, averaged per sample."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            idx = label.long().unsqueeze(self._axis)
            loss = -torch.gather(pred, self._axis, idx).squeeze(self._axis)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
