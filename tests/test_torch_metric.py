"""The port's ``mx.metric`` against the JAX package's, on the CPU.

Every metric class, and ``create`` by name, by list and by function, is
updated with the same seeded labels and predictions (as NDArrays of each
package, over two batches) and must report the same names and values
(1e-6 relative: both reduce the same host numpy arrays).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import metric as jmetric
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import metric as tmetric


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(kind, seed):
    """(labels, preds) numpy lists of one batch for a metric kind."""
    rng = np.random.default_rng(seed)
    if kind == 'class':        # 5 classes, probabilities
        return ([rng.integers(0, 5, 8).astype(np.float32)],
                [_softmax(rng.standard_normal((8, 5)))])
    if kind == 'binary':       # 2 classes, probabilities
        return ([rng.integers(0, 2, 10).astype(np.float32)],
                [_softmax(rng.standard_normal((10, 2)))])
    if kind == 'threshold':    # binary labels, scores in [0, 1]
        return ([rng.integers(0, 2, 10).astype(np.float32)],
                [rng.random(10).astype(np.float32)])
    if kind == 'regression':
        return ([rng.standard_normal((6, 3)).astype(np.float32)],
                [rng.standard_normal((6, 3)).astype(np.float32)])
    if kind == 'sequence':     # (batch, time) labels with padding 0
        return ([rng.integers(0, 6, (3, 4)).astype(np.float32)],
                [_softmax(rng.standard_normal((3, 4, 6)))])
    if kind == 'loss':
        return ([None], [rng.random(7).astype(np.float32)])
    raise ValueError(kind)


def _custom(label, pred):
    return float(np.abs(label - pred.argmax(-1)).mean())


# (class name, constructor kwargs, input kind)
METRICS = [
    ('Accuracy', {}, 'class'),
    ('TopKAccuracy', dict(top_k=3), 'class'),
    ('MAE', {}, 'regression'),
    ('MSE', {}, 'regression'),
    ('RMSE', {}, 'regression'),
    ('CrossEntropy', {}, 'class'),
    ('Perplexity', dict(ignore_label=None), 'class'),
    ('Perplexity', dict(ignore_label=0), 'sequence'),
    ('NegativeLogLikelihood', {}, 'class'),
    ('F1', {}, 'binary'),
    ('F1', dict(average='micro'), 'class'),
    ('MCC', {}, 'binary'),
    ('PearsonCorrelation', {}, 'regression'),
    ('Loss', {}, 'loss'),
    ('Torch', {}, 'loss'),
    ('Fbeta', dict(beta=2), 'binary'),
    ('Fbeta', dict(beta=0.5, average='micro'), 'class'),
    ('BinaryAccuracy', dict(threshold=0.4), 'threshold'),
    ('MeanPairwiseDistance', dict(p=3), 'regression'),
    ('MeanCosineSimilarity', {}, 'regression'),
    ('PCC', {}, 'class'),
    ('CustomMetric', dict(feval=_custom), 'class'),
    ('CompositeEvalMetric', dict(metrics=None), 'class'),
]


def _feed(mx, metric, kind, seeds=(0, 1)):
    for seed in seeds:
        labels, preds = _inputs(kind, seed)
        metric.update([None if a is None else mx.np.array(a)
                       for a in labels], [mx.np.array(a) for a in preds])
    return metric.get_name_value()


def _same(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-6)


@pytest.mark.parametrize('name,kw,kind', METRICS,
                         ids=[f'{m[0]}-{i}' for i, m in enumerate(METRICS)])
def test_metric_equals_the_jax_metric(name, kw, kind):
    metrics = [getattr(m, name)(**kw) for m in (jmetric, tmetric)]
    if name == 'CompositeEvalMetric':
        for m in metrics:
            m.add('accuracy')
            m.add('crossentropy')
    want = _feed(jmx, metrics[0], kind)
    got = _feed(tmx, metrics[1], kind)
    _same(got, want)
    for m in metrics:
        m.reset()
    # what each reports with nothing accumulated: NaN or 0
    want, got = (m.get_name_value() for m in metrics)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_array_equal([v for _, v in got], [v for _, v in want])


@pytest.mark.parametrize('spec', ['accuracy', 'TopKAccuracy',
                                  'crossentropy', 'f1', 'perplexity',
                                  'negativeloglikelihood', 'mae', 'rmse',
                                  ['accuracy', 'crossentropy'], _custom])
def test_create_equals_the_jax_create(spec):
    kind = 'regression' if spec in ('mae', 'rmse') else 'binary' \
        if spec == 'f1' else 'class'
    want = _feed(jmx, jmetric.create(spec), kind)
    got = _feed(tmx, tmetric.create(spec), kind)
    _same(got, want)


def test_np_wraps_a_numpy_function_as_the_jax_one_does():
    want = _feed(jmx, jmetric.np(_custom, name='l1'), 'class')
    got = _feed(tmx, tmetric.np(_custom, name='l1'), 'class')
    _same(got, want)


def test_create_of_an_unknown_name_raises():
    with pytest.raises(ValueError, match='Cannot find'):
        tmetric.create('no_such_metric')
