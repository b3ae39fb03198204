"""The port's linear algebra ops (``ops/linalg.py``: the products other
than ``dot``/``matmul``, the ``linalg_*`` decompositions and solvers, the
``la_op`` family) against the JAX package's, on the same seeded inputs.
The ruled ones are also swept by ``tests/test_torch_ops_shape.py``.

Tolerances: products and solves rtol 1e-5 / atol 1e-6 (fp32); inverses,
decompositions and their gradients 1e-4, factors unique only up to sign
held by their invariants (reconstruction, orthogonality, sorted
eigenvalues).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag

from torch_a3_cases import LINALG_PRODUCTS, LINALG_SOLVERS, \
    LINALG_TRIANGULAR, _r, _spd


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _fn(mx, name):
    return getattr(mx.npx, name, None) or getattr(mx.np, name)


def _conv(mx, a):
    if isinstance(a, np.ndarray):
        return mx.np.array(a)
    if isinstance(a, list):
        return [_conv(mx, e) for e in a]
    return a


def _outs(o):
    return [x.asnumpy() for x in (o if isinstance(o, (tuple, list))
                                  else [o])]


def _run(mx, name, args, kw):
    return _outs(_fn(mx, name)(*[_conv(mx, a) for a in args], **kw))


def _grads(mx, ag, name, args, kw):
    nds = [_conv(mx, a) for a in args]
    flat = [n for a in nds for n in (a if isinstance(a, list) else [a])
            if hasattr(n, 'attach_grad')
            and np.issubdtype(n.dtype, np.floating)]
    for n in flat:
        n.attach_grad()
    with ag.record():
        out = _fn(mx, name)(*nds, **kw)
        loss = (out[0] if isinstance(out, (tuple, list)) else out).sum()
    loss.backward()
    return [n.grad.asnumpy() for n in flat]


def check(name, args, kw=None, rtol=1e-5, atol=1e-6, grad=True):
    kw = kw or {}
    want = _run(jmx, name, args, kw)
    got = _run(tmx, name, args, kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (name, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
    if grad:
        for g, w in zip(_grads(tmx, tag, name, args, kw),
                        _grads(jmx, jag, name, args, kw)):
            np.testing.assert_allclose(g, w, rtol=10 * rtol,
                                       atol=10 * atol, err_msg=name)




@pytest.mark.parametrize('name, args, kw', LINALG_PRODUCTS,
                         ids=[f'{n}{i}' for i, (n, _, _) in
                              enumerate(LINALG_PRODUCTS)])
def test_products_match_jax(name, args, kw):
    check(name, args, kw)


@pytest.mark.parametrize('name, args, kw', LINALG_TRIANGULAR)
def test_triangular_products_and_solves_match_jax(name, args, kw):
    check(name, args, kw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('name, args, kw', LINALG_SOLVERS)
def test_solvers_and_inverses_match_jax(name, args, kw):
    from mxnet_tpu.ops import registry as jreg
    check(name, args, kw, rtol=1e-4, atol=1e-5,
          grad=jreg.get_op(name).differentiable)


def test_factors_unique_up_to_sign_by_their_invariants():
    """``qr`` (reduced, complete, r), ``eigh``/``syevd``, ``eig``,
    ``eigvals``, ``svd`` and ``gelqf`` held to the JAX package by
    reconstruction, orthogonality and sorted eigenvalues."""
    a = _r(5, 3, seed=7)
    s = _spd(4, 8)
    g = _r(4, 4, seed=9)
    for mode in ('reduced', 'complete'):
        q, r = (x.asnumpy() for x in tmx.np.linalg.qr(
            tmx.np.array(a), mode=mode))
        np.testing.assert_allclose(q @ r, a, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-5)
        jr = jmx.np.linalg.qr(jmx.np.array(a), mode=mode)[1].asnumpy()
        np.testing.assert_allclose(np.abs(r), np.abs(jr), rtol=1e-4,
                                   atol=1e-5)
    r = tmx.np.linalg.qr(tmx.np.array(a), mode='r').asnumpy()
    np.testing.assert_allclose(np.abs(r), np.abs(jr[:3]), rtol=1e-4,
                               atol=1e-5)
    q, r = (x.asnumpy() for x in tmx.npx.linalg_gelqf(tmx.np.array(a)))
    np.testing.assert_allclose(q @ r, a, rtol=1e-4, atol=1e-5)
    for name in ('linalg_eigh', 'linalg_syevd'):
        w, v = (x.asnumpy() for x in _fn(tmx, name)(tmx.np.array(s)))
        jw = _fn(jmx, name)(jmx.np.array(s))[0].asnumpy()
        np.testing.assert_allclose(w, jw, rtol=1e-4)
        np.testing.assert_allclose(v @ np.diag(w) @ v.T, s, rtol=1e-4,
                                   atol=1e-4)
    for name in ('linalg_eig', 'linalg_eigvals'):
        got = _run(tmx, name, (g,), {})[0]
        want = _run(jmx, name, (g,), {})[0]
        assert got.dtype == want.dtype == np.complex64
        np.testing.assert_allclose(np.sort_complex(got),
                                   np.sort_complex(want), rtol=1e-4,
                                   atol=1e-4)
    w, v = (x.asnumpy() for x in tmx.npx.linalg_eig(tmx.np.array(g)))
    np.testing.assert_allclose(g @ v, v * w, rtol=1e-4, atol=1e-4)
    u, sv, vh = (x.asnumpy() for x in tmx.np.linalg.svd(
        tmx.np.array(a), full_matrices=False))
    np.testing.assert_allclose((u * sv) @ vh, a, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sv, jmx.np.linalg.svd(
        jmx.np.array(a), compute_uv=False).asnumpy(), rtol=1e-5)
    np.testing.assert_allclose(tmx.np.linalg.svd(
        tmx.np.array(a), compute_uv=False).asnumpy(), sv, rtol=1e-5)


def test_host_factors_are_the_references_and_carry_torch_gradients():
    """On the host ``eigh`` and ``svd`` return the JAX package's factors
    exactly (the LAPACK routines its CPU backend calls), and their
    gradients are torch's, sign-aligned to them."""
    s = _spd(5, 11)
    check('linalg_eigh', (s,), rtol=1e-6, atol=1e-6, grad=False)
    check('linalg_svd', (_r(6, 4, seed=12),), rtol=1e-6, atol=1e-6,
          grad=False)
    grads = []
    for mx, ag in ((jmx, jag), (tmx, tag)):
        x = mx.np.array(s)
        x.attach_grad()
        with ag.record():
            w, v = mx.np.linalg.eigh(x)
            loss = (w * w).sum() + (v[:, -1] * mx.np.array(
                np.arange(5, dtype='f'))).sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-3, atol=1e-4)


def test_np_linalg_namespace_points_at_the_linalg_ops():
    x = _r(3, 4)
    np.testing.assert_allclose(
        tmx.np.linalg.norm(tmx.np.array(x), ord=1).asnumpy(),
        jmx.np.linalg.norm(jmx.np.array(x), ord=1).asnumpy(), rtol=1e-6)
    for name in ('inv', 'svd', 'eigh', 'solve', 'qr', 'cholesky', 'det',
                 'slogdet', 'pinv', 'lstsq', 'matrix_rank', 'multi_dot',
                 'tensorinv', 'tensorsolve', 'cond', 'eig', 'eigvals',
                 'eigvalsh', 'matrix_power', 'norm'):
        assert hasattr(tmx.np.linalg, name), name
