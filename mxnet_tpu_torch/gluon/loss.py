"""``gluon.loss``: the losses as ``HybridBlock``s over NDArrays.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference
python/mxnet/gluon/loss.py), with the same arguments and arithmetic,
through the registered ops. Each returns the per-sample loss (the mean
over every axis but the batch axis) unless the reference says otherwise.

A loss also takes ``torch.Tensor``s and then returns one: a training loop
written on tensors calls ``SoftmaxCrossEntropyLoss()(logits,
labels).mean()`` and runs torch's ``backward``. For tensors the loss
records exactly when torch's autograd would (grad mode on and an input
that requires grad), whatever ``autograd.record()`` says.

``CTCLoss`` needs the fused ``ctc_loss`` op (ROADMAP A11).
"""

import numpy as _np
import torch

from .. import _tape
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from ..ops.registry import invoke
from .block import HybridBlock

__all__ = ['Loss', 'L2Loss', 'L1Loss', 'SigmoidBinaryCrossEntropyLoss',
           'SigmoidBCELoss', 'SoftmaxCrossEntropyLoss', 'SoftmaxCELoss',
           'KLDivLoss', 'CTCLoss', 'HuberLoss', 'HingeLoss',
           'SquaredHingeLoss', 'LogisticLoss', 'TripletLoss', 'PoissonNLLLoss',
           'CosineEmbeddingLoss', 'SDMLLoss']


def _op(name, *args, **kw):
    return invoke(name, args, kw)


def _apply_weighting(loss, weight=None, sample_weight=None):
    """Reference loss.py:_apply_weighting."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    if isinstance(label, NDArray) and label.shape != pred.shape:
        label = label.reshape(pred.shape)
    return label


class Loss(HybridBlock):
    """Base loss (reference loss.py:Loss)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean(self, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return loss.mean(axis=axes) if axes else loss

    def __call__(self, *args, **kwargs):
        if not any(torch.is_tensor(a)
                   for a in (*args, *kwargs.values())):
            return super().__call__(*args, **kwargs)
        wrap = (lambda a: NDArray(a) if torch.is_tensor(a) else a)
        record = torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad
            for a in (*args, *kwargs.values()))
        prev = _tape.set_recording(record)
        try:
            out = self.forward(*map(wrap, args),
                               **{k: wrap(v) for k, v in kwargs.items()})
        finally:
            _tape.set_recording(prev)
        return out._data


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``, averaged per sample."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _op('square', label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean(loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _op('abs', label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Reference loss.py:SigmoidBinaryCrossEntropyLoss (the stable
    log-sum-exp form when ``from_sigmoid=False``)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = _op('relu', pred) - pred * label + \
                    _op('softplus', -_op('abs', pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _op('softplus', -_op('abs', pred)) +
                    _op('relu', -pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(_op('log', pred + eps) * label +
                         _op('log', 1. - pred + eps) * (1. - label))
            else:
                loss = -(_op('log', pred + eps) * label * pos_weight +
                         _op('log', 1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Reference loss.py:SoftmaxCrossEntropyLoss: ``-log_softmax(pred)``
    picked at the label (``sparse_label``) or summed against a dense
    label."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _op('log_softmax', pred, axis=self._axis)
        if self._sparse_label:
            loss = -_op('pick', pred, label, axis=self._axis, keepdims=False)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(axis=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _op('log_softmax', pred, axis=self._axis)
        loss = label * (_op('log', label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class CTCLoss(Loss):
    """Reference loss.py:CTCLoss: needs the fused ``ctc_loss`` op, which
    waits with ``gluon/rnn`` (ROADMAP A11)."""

    def __init__(self, layout='NTC', label_layout='NT', weight=None,
                 **kwargs):
        raise MXNetError('CTCLoss needs the ctc_loss op (ROADMAP A11)')


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _op('abs', label - pred)
        loss = _op('where', loss > self._rho,
                   loss - 0.5 * self._rho,
                   (0.5 / self._rho) * _op('square', loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _op('relu', self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _op('square', _op('relu', self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format='signed',
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == 'signed':
            label = (label + 1.0) / 2.0
        loss = _op('relu', pred) - pred * label + \
            _op('softplus', -_op('abs', pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean(loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = (_op('square', positive - pred) -
                _op('square', negative - pred))
        axes = tuple(range(1, loss.ndim))
        loss = _op('relu', loss.sum(axis=axes) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = _op('exp', pred) - target * pred
        else:
            loss = pred - target * _op('log', pred + epsilon)
        if self._compute_full:
            stirling = target * _op('log', target + 1e-12) - target + \
                0.5 * _op('log', 2 * 3.141592653589793 * target + 1e-12)
            stirling = _op('where', target <= 1, _op('zeros_like', stirling),
                           stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input2 = _reshape_like(input1, input2)
        cos = (input1 * input2).sum(axis=-1) / (
            _op('norm', input1, axis=-1) * _op('norm', input2, axis=-1)
            + 1e-12)
        label = label.reshape((-1,))
        loss = _op('where', label == 1, 1.0 - cos,
                   _op('relu', cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss (reference loss.py:SDMLLoss)."""

    def __init__(self, smoothing_parameter=0.3, weight=1., batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        batch_size = x1.shape[0]
        # pairwise negative L2 distances as logits
        diff = x1.expand_dims(1) - x2.expand_dims(0)
        dist = _op('sqrt', _op('square', diff).sum(axis=-1) + 1e-12)
        logp = _op('log_softmax', -dist, axis=-1)
        labels = _np.eye(batch_size, dtype=_np.float32)
        labels = labels * (1 - self.smoothing_parameter) + \
            (1 - labels) * self.smoothing_parameter / (batch_size - 1)
        return self.kl_loss(logp, array(labels, ctx=x1.context))
