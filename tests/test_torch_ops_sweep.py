"""The port's registered ops against the JAX package's, driven by the op
rules of ``benchmark/opperf.py`` (imported as ``tests/test_op_sweep.py``
imports it, at its small sizes).

For every op the port registers that has a rule, the same numpy inputs go
through ``mxnet_tpu``'s and ``mxnet_tpu_torch``'s ``npx``/``np`` function
on the CPU. Forward: equal dtypes and shapes; floats within rtol 1e-5 and
atol 1e-6, integers and bools exact. Backward, for ops differentiable in
both packages and not marked ``no_grad`` by their rule: the gradient of
``sum()`` of the first output with respect to every float input, within
rtol 1e-4 and atol 1e-5. The cases are split by op family over
``tests/test_torch_ops_*.py`` (this file holds the machinery and the
family-free checks), so that ``--dist loadfile`` spreads them.
"""

import os
import sys
import zlib

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.ops import registry as treg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'benchmark'))
import opperf  # noqa: E402

opperf._register_rules(np, large=(16, 16), nn_scale=1)

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

#: every ruled op the port registers, by the port module that holds it
FAMILIES = {}
for _n in sorted(opperf._RULES):
    if _n in treg.list_ops() and _n in jreg.list_ops():
        _mod = treg.get_op(_n).fn.__module__.rsplit('.', 1)[-1]
        FAMILIES.setdefault(_mod, []).append(_n)


def ruled(*families):
    """The ruled op names of the given port modules."""
    return [n for f in families for n in FAMILIES.get(f, [])]


def differentiable(name):
    return (treg.get_op(name).differentiable
            and jreg.get_op(name).differentiable
            and not opperf._RULES[name].get('no_grad'))


def _inputs(name):
    spec = opperf._RULES[name]
    np.random.seed(zlib.crc32(name.encode()))
    raw = spec['args']()
    kwargs = spec['kwargs_fn']() if 'kwargs_fn' in spec \
        else spec.get('kwargs', {})
    return raw, kwargs


def _build(mx, raw, name):
    def conv(a):
        if isinstance(a, np.ndarray):
            return mx.np.array(a)
        if isinstance(a, (list, tuple)):
            return [conv(e) for e in a]
        return a
    args = [conv(a) for a in raw]
    fn = getattr(mx.npx, name, None) or getattr(mx.np, name)
    return fn, args


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _float_arrays(args):
    flat = []
    for a in args:
        flat += a if isinstance(a, list) else [a]
    return [a for a in flat if hasattr(a, 'attach_grad')
            and np.issubdtype(a.dtype, np.floating)]


def assert_same(got, want, rtol, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f'{what}: dtype {got.dtype}, JAX ' \
        f'{want.dtype}'
    assert got.shape == want.shape, f'{what}: shape {got.shape}, JAX ' \
        f'{want.shape}'
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def check_forward(name):
    raw, kwargs = _inputs(name)
    jfn, jargs = _build(jmx, raw, name)
    want = _outs(jfn(*jargs, **kwargs))
    with tmx.cpu():
        tfn, targs = _build(tmx, raw, name)
        got = _outs(tfn(*targs, **kwargs))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g.asnumpy(), w.asnumpy(), FWD_RTOL, FWD_ATOL,
                    f'{name} output {i}')


def check_grad(name):
    raw, kwargs = _inputs(name)
    grads = {}
    for mx, ag in ((jmx, jag), (tmx, tag)):
        with tmx.cpu():
            fn, args = _build(mx, raw, name)
            var = _float_arrays(args)
            for a in var:
                a.attach_grad()
            with ag.record():
                loss = _outs(fn(*args, **kwargs))[0].sum()
            loss.backward()
            grads[mx] = [a.grad.asnumpy() for a in var]
    assert grads[tmx], f'{name}: no float input to differentiate'
    for i, (g, w) in enumerate(zip(grads[tmx], grads[jmx])):
        assert_same(g, w, GRAD_RTOL, GRAD_ATOL, f'{name} grad {i}')


def test_every_family_has_ruled_ops():
    # the split files cover these modules; a ruled op in another module
    # would go untested
    covered = {'elemwise', 'reduce', 'manipulation', 'linalg', 'nn',
               'contrib', 'optimizer_ops'}
    assert set(FAMILIES) <= covered, set(FAMILIES) - covered
    assert sum(len(v) for v in FAMILIES.values()) >= 100


def test_every_ruled_op_has_a_frontend():
    for names in FAMILIES.values():
        for n in names:
            assert getattr(tmx.npx, n, None) or getattr(tmx.np, n), n
