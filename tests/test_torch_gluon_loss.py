"""The port's ``gluon.loss`` against the JAX package's, on the CPU.

Every loss takes the same numpy predictions and labels through both
packages, with no weighting, with ``weight`` and with ``sample_weight``;
the per-sample losses and the gradient of their sum with respect to the
prediction agree within 1e-5 (the same fp32 operations; ``log_softmax``,
``softplus`` and the norms are summed in another order by two libraries).
A loss given ``torch.Tensor``s returns one that torch's ``backward``
differentiates, for a training loop written on tensors.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import loss as jloss
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (4, 6)


def _data(seed, shape=SHAPE, kind='normal'):
    rng = np.random.default_rng(seed)
    if kind == 'sign':
        return rng.choice([-1.0, 1.0], shape).astype(np.float32)
    if kind == 'prob':
        return rng.uniform(0.05, 0.95, shape).astype(np.float32)
    if kind == 'count':
        return rng.integers(0, 5, shape).astype(np.float32)
    if kind == 'class':
        return rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    if kind == 'dist':
        p = rng.uniform(0.1, 1.0, shape)
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


#: name -> (constructor arguments, the kinds of the inputs after pred)
LOSSES = {
    'L2Loss': ({}, ['normal']),
    'L1Loss': ({}, ['normal']),
    'SigmoidBinaryCrossEntropyLoss': ({}, ['prob']),
    'SigmoidBCE_from_sigmoid': ({'from_sigmoid': True}, ['prob']),
    'SoftmaxCrossEntropyLoss': ({}, ['class']),
    'SoftmaxCE_dense': ({'sparse_label': False}, ['dist']),
    'KLDivLoss': ({'from_logits': False}, ['dist']),
    'HuberLoss': ({'rho': 0.7}, ['normal']),
    'HingeLoss': ({'margin': 0.5}, ['sign']),
    'SquaredHingeLoss': ({}, ['sign']),
    'LogisticLoss': ({}, ['sign']),
    'LogisticLoss_binary': ({'label_format': 'binary'}, ['prob']),
    'TripletLoss': ({'margin': 0.3}, ['normal', 'normal']),
    'PoissonNLLLoss': ({'compute_full': True}, ['count']),
    'CosineEmbeddingLoss': ({'margin': 0.2}, ['normal', 'sign1']),
    'SDMLLoss': ({}, ['normal']),
}
_CLASS = {'SigmoidBCE_from_sigmoid': 'SigmoidBinaryCrossEntropyLoss',
          'SoftmaxCE_dense': 'SoftmaxCrossEntropyLoss',
          'LogisticLoss_binary': 'LogisticLoss'}


def _inputs(name):
    _, kinds = LOSSES[name]
    pred = _data(0, kind='prob' if name == 'SigmoidBCE_from_sigmoid'
                 else 'normal')
    args = [pred]
    for i, kind in enumerate(kinds):
        if kind == 'sign1':     # one label a row for the cosine loss
            args.append(_data(5 + i, (SHAPE[0], 1), 'sign'))
        else:
            args.append(_data(5 + i, kind=kind))
    return args


def _run(mod, mx, name, weighting, args):
    kw, _ = LOSSES[name]
    kw = dict(kw)
    if weighting == 'weight' and name != 'SDMLLoss':
        kw['weight'] = 0.7
    loss = getattr(mod, _CLASS.get(name, name))(**kw)
    nds = [mx.np.array(a) for a in args]
    nds[0].attach_grad()
    extra = []
    if weighting == 'sample_weight' and name not in ('SDMLLoss',
                                                      'PoissonNLLLoss'):
        extra = [mx.np.array(_data(9, (SHAPE[0], 1), 'prob')
                             if name not in ('TripletLoss',
                                             'CosineEmbeddingLoss')
                             else _data(9, (SHAPE[0],), 'prob'))]
    with mx.autograd.record():
        out = loss(*nds, *extra)
        total = out.sum()
    total.backward()
    return out.asnumpy(), nds[0].grad.asnumpy()


@pytest.mark.parametrize('weighting', ['none', 'weight', 'sample_weight'])
@pytest.mark.parametrize('name', sorted(LOSSES))
def test_loss_matches_the_jax_loss(name, weighting):
    args = _inputs(name)
    want, want_g = _run(jloss, jmx, name, weighting, args)
    with tmx.cpu():
        got, got_g = _run(tloss, tmx, name, weighting, args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)


@pytest.mark.parametrize('name', ['SoftmaxCrossEntropyLoss', 'L2Loss',
                                  'HuberLoss'])
def test_loss_on_torch_tensors_is_differentiated_by_torch(name):
    args = _inputs(name)
    want, want_g = _run(jloss, jmx, name, 'none', args)
    pred = torch.from_numpy(args[0]).requires_grad_(True)
    rest = [torch.from_numpy(a).long() if a.dtype == np.int32
            else torch.from_numpy(a) for a in args[1:]]
    out = getattr(tloss, name)(**LOSSES[name][0])(pred, *rest)
    assert torch.is_tensor(out) and out.requires_grad
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(pred.grad.numpy(), want_g, **TOL)
    with torch.no_grad():
        assert not tloss.L2Loss()(pred, pred.detach()).requires_grad


def test_ctc_loss_waits_for_its_op():
    with pytest.raises(MXNetError, match='A11'):
        tloss.CTCLoss()
