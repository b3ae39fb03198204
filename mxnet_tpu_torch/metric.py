"""``mx.metric``: evaluation metrics (counterpart of
``mxnet_tpu/metric.py``, reference python/mxnet/gluon/metric.py).

Metrics accumulate host-side scalars: each update copies its labels and
predictions to host numpy, as the reference's ``_to_np`` does, and
reduces there.
"""

import numpy as _np

from .base import register as _register_factory, registry_create
from .ndarray.ndarray import NDArray


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


class EvalMetric:
    """Base metric (reference gluon/metric.py:EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        self.update(list(label.values()), list(pred.values()))

    def __str__(self):
        return f'EvalMetric: {dict(self.get_name_value())}'


register = _register_factory(EvalMetric)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return registry_create(EvalMetric, metric, *args, **kwargs)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name='composite', **kw):
        super().__init__(name, **kw)
        self.metrics = metrics or []

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, 'metrics', []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            values.append(value)
        return names, values


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name='accuracy', **kw):
        super().__init__(name, **kw)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label)
            pred = _to_np(pred)
            if pred.shape != label.shape:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype('int32').ravel()
            label = label.astype('int32').ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name='top_k_accuracy', **kw):
        super().__init__(f'{name}_{top_k}', **kw)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype('int32')
            pred = _to_np(pred)
            argsorted = _np.argsort(-pred, axis=-1)[..., :self.top_k]
            correct = (argsorted == label[..., None]).any(axis=-1)
            self.sum_metric += correct.sum()
            self.num_inst += correct.size


@register
class MAE(EvalMetric):
    def __init__(self, name='mae', **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += _np.abs(label - pred.reshape(label.shape)).sum()
            self.num_inst += label.size


@register
class MSE(EvalMetric):
    def __init__(self, name='mse', **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += ((label - pred.reshape(label.shape)) ** 2).sum()
            self.num_inst += label.size


@register
class RMSE(MSE):
    def __init__(self, name='rmse', **kw):
        EvalMetric.__init__(self, name, **kw)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, _np.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name='cross-entropy', **kw):
        super().__init__(name, **kw)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype('int64')
            pred = _to_np(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name='perplexity', **kw):
        super().__init__(name=name, **kw)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        if self.ignore_label is None:
            return super().update(labels, preds)
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype('int64')
            pred = _to_np(pred).reshape(label.shape[0], -1)
            keep = label != self.ignore_label
            prob = pred[_np.arange(label.shape[0]), label][keep]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += int(keep.sum())

    def get(self):
        if self.num_inst == 0:
            return (self.name, float('nan'))
        return (self.name, float(_np.exp(self.sum_metric / self.num_inst)))


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name='nll-loss', **kw):
        super().__init__(eps=eps, name=name, **kw)


@register
class F1(EvalMetric):
    """F1 score. ``average='macro'`` averages per-class F1 over observed
    classes (generalizes the reference, which rejects multiclass input);
    'micro' pools tp/fp/fn; 'binary' scores class 1 only."""

    def __init__(self, name='f1', average='macro', **kw):
        super().__init__(name, **kw)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self._tp, self._fp, self._fn = {}, {}, {}

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype('int32')
            pred = _to_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.ravel().astype('int32')
            for c in _np.union1d(_np.unique(label), _np.unique(pred)):
                c = int(c)
                self._tp[c] = self._tp.get(c, 0) + int(
                    ((pred == c) & (label == c)).sum())
                self._fp[c] = self._fp.get(c, 0) + int(
                    ((pred == c) & (label != c)).sum())
                self._fn[c] = self._fn.get(c, 0) + int(
                    ((pred != c) & (label == c)).sum())
            self.num_inst += 1

    #: F-beta weight; F1 is beta=1, Fbeta overrides (reference Fbeta
    #: subclasses F1 the same way)
    _beta = 1.0

    @staticmethod
    def _fbeta_score(tp, fp, fn, beta):
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        b2 = beta * beta
        return (1 + b2) * prec * rec / max(b2 * prec + rec, 1e-12)

    def _f1_of(self, c):
        return self._fbeta_score(self._tp.get(c, 0), self._fp.get(c, 0),
                                 self._fn.get(c, 0), self._beta)

    def get(self):
        if self.average == 'micro':
            return (self.name, self._fbeta_score(
                sum(self._tp.values()), sum(self._fp.values()),
                sum(self._fn.values()), self._beta))
        if self.average == 'macro':
            classes = sorted(self._tp)
            if not classes:
                return (self.name, 0.0)
            return (self.name,
                    sum(self._f1_of(c) for c in classes) / len(classes))
        # binary (reference default): F1 of the positive class 1
        return (self.name, self._f1_of(1))


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (reference gluon/metric.py:MCC)."""

    def __init__(self, name='mcc', **kw):
        super().__init__(name, **kw)
        self._tp = self._fp = self._tn = self._fn = 0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._tn = self._fn = 0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype('int32')
            pred = _to_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.ravel().astype('int32')
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._tn += ((pred == 0) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self.num_inst += 1

    def get(self):
        tp, fp, tn, fn = self._tp, self._fp, self._tn, self._fn
        denom = _np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        mcc = (tp * tn - fp * fn) / denom if denom else 0.0
        return (self.name, mcc)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name='pearsonr', **kw):
        super().__init__(name, **kw)
        self._labels, self._preds = [], []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_np(label).ravel())
            self._preds.append(_to_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return (self.name, float('nan'))
        lab = _np.concatenate(self._labels)
        pre = _np.concatenate(self._preds)
        return (self.name, float(_np.corrcoef(lab, pre)[0, 1]))


@register
class Loss(EvalMetric):
    def __init__(self, name='loss', **kw):
        super().__init__(name, **kw)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _to_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name='custom', allow_extra_outputs=False, **kw):
        super().__init__(f'{name}({feval.__name__})', **kw)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            reval = self._feval(_to_np(label), _to_np(pred))
            if isinstance(reval, tuple):
                m, n = reval
                self.sum_metric += m
                self.num_inst += n
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name='custom', allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference metric.py:np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class Fbeta(F1):
    """Reference metric.py:815 — harmonic precision/recall mean weighted
    by beta^2."""

    def __init__(self, name='fbeta', beta=1, average='binary', **kw):
        super().__init__(name=name, average=average, **kw)
        self.beta = beta
        self._beta = float(beta)


@register
class BinaryAccuracy(EvalMetric):
    """Reference metric.py:876 — accuracy of thresholded binary/multilabel
    predictions."""

    def __init__(self, name='binary_accuracy', threshold=0.5, **kw):
        super().__init__(name, **kw)
        self.threshold = threshold

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel()
            pred = (_to_np(pred).ravel() > self.threshold)
            self.sum_metric += float((pred == (label > 0.5)).sum())
            self.num_inst += label.size


@register
class MeanPairwiseDistance(EvalMetric):
    """Reference metric.py:1197 — mean p-norm distance over the last axis."""

    def __init__(self, name='mpd', p=2, **kw):
        super().__init__(name, **kw)
        self.p = p

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label)
            pred = _to_np(pred)
            d = (_np.abs(pred - label) ** self.p).sum(axis=-1) ** \
                (1.0 / self.p)
            self.sum_metric += float(d.sum())
            self.num_inst += int(d.size)


@register
class MeanCosineSimilarity(EvalMetric):
    """Reference metric.py:1263 — cosine similarity over the last axis."""

    def __init__(self, name='cos_sim', eps=1e-8, **kw):
        super().__init__(name, **kw)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label)
            pred = _to_np(pred)
            num = (label * pred).sum(axis=-1)
            den = _np.maximum(
                _np.linalg.norm(label, axis=-1) *
                _np.linalg.norm(pred, axis=-1), self.eps)
            sim = num / den
            self.sum_metric += float(sim.sum())
            self.num_inst += int(sim.size)


@register
class PCC(EvalMetric):
    """Reference metric.py:1586 — multiclass Matthews/Pearson correlation
    from the running confusion matrix."""

    def __init__(self, name='pcc', **kw):
        super().__init__(name, **kw)
        self._cm = _np.zeros((0, 0), dtype=_np.int64)

    def reset(self):
        super().reset()
        self._cm = _np.zeros((0, 0), dtype=_np.int64)

    def _grow(self, k):
        if k > self._cm.shape[0]:
            cm = _np.zeros((k, k), dtype=_np.int64)
            n = self._cm.shape[0]
            cm[:n, :n] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype('int64')
            pred = _to_np(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.ravel().astype('int64')
            k = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            self._grow(k)
            _np.add.at(self._cm, (label, pred), 1)
            self.num_inst += label.size

    def get(self):
        c = self._cm.astype(_np.float64)
        n = c.sum()
        if n == 0:
            return (self.name, float('nan'))
        t = c.sum(axis=1)            # true counts per class
        p = c.sum(axis=0)            # predicted counts per class
        cov_tp = (c.trace() * n - (t * p).sum())
        cov_tt = (n * n - (t * t).sum())
        cov_pp = (n * n - (p * p).sum())
        den = _np.sqrt(cov_tt * cov_pp)
        return (self.name, float(cov_tp / den) if den else float('nan'))


@register
class Torch(Loss):
    """Reference metric.py:1734 — dummy metric for torch criterions."""

    def __init__(self, name='torch', **kw):
        super().__init__(name=name, **kw)
