"""The port's numpy extras and gamma-family samplers against the JAX
package's (the A3 cases of
``tests/test_op_additions.py``, ``test_op_additions_r2.py``,
``test_op_gap_closure.py`` and ``test_op_numeric_sweep*.py`` are the
oracles), forward and, where both packages differentiate the op, the
gradient of ``sum()`` of the first output (harness and tolerances:
``tests/test_torch_linalg.py``'s ``check``). The legacy-name and contrib
ops are in ``tests/test_torch_ops_legacy.py``.

Samplers draw other numbers than JAX's from the same distributions: each
is held at n = 20,000 to its mean and variance within 5 standard errors,
repeats its numbers under one seed, and draws nothing through
``torch._standard_gamma``.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

from test_torch_linalg import _run, check
from torch_a3_cases import EXTRAS, SAMPLERS, _r, moments_ok


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _grad_ok(name):
    return treg.get_op(name).differentiable and \
        jreg.get_op(name).differentiable




@pytest.mark.parametrize('name, args, kw', EXTRAS,
                         ids=[f'{n}{i}' for i, (n, _, _) in
                              enumerate(EXTRAS)])
def test_op_matches_jax(name, args, kw):
    check(name, args, kw, rtol=1e-5, atol=1e-5, grad=_grad_ok(name) and any(
        isinstance(a, np.ndarray) and a.dtype == np.float32 for a in args))


@pytest.mark.parametrize('name', ['partition', 'argpartition'])
def test_partition_meets_its_contract_as_jax_does(name):
    a = _r(3, 7)
    kth = 3
    j = _run(jmx, name, (a,), {'kth': kth})[0]
    t = _run(tmx, name, (a,), {'kth': kth})[0]
    vals = [np.take_along_axis(a, x, -1) if name == 'argpartition' else x
            for x in (j, t)]
    for v in vals:
        np.testing.assert_array_equal(v[:, kth], np.sort(a, -1)[:, kth])
        assert (v[:, :kth] <= v[:, kth:kth + 1]).all()
        assert (v[:, kth + 1:] >= v[:, kth:kth + 1]).all()
    assert t.dtype == j.dtype


# --------------------------------------------------------------- samplers
N = 20_000


def _draw(name, kw, seed):
    tmx.random.seed(seed)
    fn = getattr(tmx.npx, name)
    if name == 'sample_generalized_negative_binomial':
        return fn(shape=(N,), **kw).asnumpy()
    return fn(size=N, **kw).asnumpy()


@pytest.mark.parametrize('name, kw, mean, var', SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_moments_and_seeding(name, kw, mean, var, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('torch._standard_gamma takes no generator')
    monkeypatch.setattr(torch, '_standard_gamma', refuse)
    x = _draw(name, kw, 7)
    assert x.shape == (N,) and x.dtype == np.float32 and np.isfinite(x).all()
    ok, zm, zv = moments_ok(x, mean, var)
    assert ok, (name, x.mean(), mean, x.var(), var, zm, zv)
    np.testing.assert_array_equal(_draw(name, kw, 7), x)
    assert not np.array_equal(_draw(name, kw, 8), x)


def test_np_random_reaches_the_gamma_family():
    for name in ('gamma', 'beta', 'chisquare', 'negative_binomial'):
        assert hasattr(tmx.np.random, name), name
