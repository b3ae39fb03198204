"""The port's sparse storage (row-sparse and CSR arrays, their products,
``retain``, ``add``, slicing) and the kvstore's ``row_sparse_pull``
against the JAX package's (``tests/test_sparse.py`` is the oracle; each
of its cases is run here through both packages on the same seeded
inputs; the optimizer and embedding cases are in
``tests/test_torch_sparse_train.py``).

Tolerances: storage and structure exact; CSR products rtol 2e-5 (rtol
3e-4 / atol 1e-4 for the 100k-row matvec, as the oracle's 10M-row case,
which runs at 100k rows here; its scale is the card's, ``chip_smoke.py``'s
sparse phase).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl
from mxnet_tpu.ndarray import sparse as jsp
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, gluon as tgl
from mxnet_tpu_torch.ndarray import sparse as tsp

from torch_a3_cases import scipy_like_csr

PACKAGES = ((jmx, jag, jgl, jsp), (tmx, tag, tgl, tsp))


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def both(fn):
    """``fn(mx, autograd, gluon, sparse)`` through each package; returns
    (jax, port)."""
    return tuple(fn(*p) for p in PACKAGES)


def _dense_with_zero_rows():
    d = np.zeros((5, 3), dtype='float32')
    d[1] = [1, 2, 3]
    d[3] = [4, 0, 6]
    return d


# ------------------------------------------------------------- storage
def test_row_sparse_roundtrip():
    d = _dense_with_zero_rows()

    def run(mx, ag, gl, sp):
        rsp = sp.row_sparse_array(mx.np.array(d))
        return (rsp.stype, rsp.indices.asnumpy(), rsp.asnumpy(),
                rsp.tostype('default').stype, mx.np.array(d).tostype(
                    'row_sparse').indices.asnumpy()
                if mx is tmx else rsp.indices.asnumpy())
    j, t = both(run)
    assert t[0] == j[0] == 'row_sparse' and t[3] == j[3] == 'default'
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[4], [1, 3])
    np.testing.assert_array_equal(t[2], j[2])


def test_row_sparse_from_components():
    def run(mx, ag, gl, sp):
        return sp.row_sparse_array(
            (np.ones((2, 3), dtype='float32'), [0, 4]),
            shape=(6, 3)).asnumpy()
    j, t = both(run)
    np.testing.assert_array_equal(t, j)


def test_csr_roundtrip():
    d = _dense_with_zero_rows()

    def run(mx, ag, gl, sp):
        csr = sp.csr_matrix(mx.np.array(d))
        csr2 = sp.csr_matrix((csr.data.asnumpy(), csr.indices.asnumpy(),
                              csr.indptr.asnumpy()), shape=(5, 3))
        return (csr.stype, csr.asnumpy(), csr2.asnumpy(),
                csr.indptr.asnumpy(), csr.indices.asnumpy())
    j, t = both(run)
    assert t[0] == j[0] == 'csr'
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a, b)


def test_csr_dot_dense():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((6, 4)).astype('float32')
    d[d < 0.3] = 0
    w = rng.standard_normal((4, 2)).astype('float32')
    j, t = both(lambda mx, ag, gl, sp: sp.dot(
        sp.csr_matrix(mx.np.array(d)), mx.np.array(w)).asnumpy())
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t, d @ w, rtol=1e-5, atol=1e-6)


def test_csr_dot_transpose():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((6, 4)).astype('float32')
    d[abs(d) < 0.5] = 0
    w = rng.standard_normal((6, 3)).astype('float32')
    j, t = both(lambda mx, ag, gl, sp: sp.dot(
        sp.csr_matrix(mx.np.array(d)), mx.np.array(w),
        transpose_a=True).asnumpy())
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_retain():
    def run(mx, ag, gl, sp):
        rsp = sp.row_sparse_array(
            (np.arange(6, dtype='float32').reshape(3, 2), [1, 3, 5]),
            shape=(6, 2))
        kept = sp.retain(rsp, mx.np.array([1, 5]))
        return kept.indices.asnumpy(), kept.asnumpy(), kept.data.shape
    j, t = both(run)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2] == j[2] == (2, 2)


def test_sparse_add():
    def run(mx, ag, gl, sp):
        a = sp.row_sparse_array((np.ones((1, 2), 'float32'), [0]),
                                shape=(3, 2))
        b = sp.row_sparse_array((np.ones((2, 2), 'float32'), [0, 2]),
                                shape=(3, 2))
        c = sp.add(a, b)
        return c.stype, c.asnumpy(), c.indices.asnumpy()
    j, t = both(run)
    assert t[0] == j[0] == 'row_sparse'
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])


def test_sparse_zeros():
    def run(mx, ag, gl, sp):
        z = sp.zeros('row_sparse', (4, 2))
        zc = sp.zeros('csr', (4, 2))
        return z.stype, z.asnumpy(), zc.stype, zc.asnumpy()
    j, t = both(run)
    assert t[0] == 'row_sparse' and t[2] == 'csr'
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[3], j[3])


def test_dense_fallback_ops():
    def run(mx, ag, gl, sp):
        rsp = sp.row_sparse_array(mx.np.array(_dense_with_zero_rows()))
        return (rsp * 2.0).asnumpy()
    j, t = both(run)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, _dense_with_zero_rows() * 2)


# ------------------------------------------------------------- kvstore
def test_kvstore_row_sparse_pull():
    def run(mx, ag, gl, sp):
        kv = mx.kvstore.create('local')
        rsp = sp.row_sparse_array(
            (np.arange(4, dtype='float32').reshape(2, 2), [1, 3]),
            shape=(5, 2))
        kv.init('emb', rsp)
        pulled = kv.row_sparse_pull('emb', row_ids=mx.np.array([3]))
        return type(pulled).__name__, pulled.asnumpy(), pulled.data.shape
    j, t = both(run)
    assert t[0] == j[0] == 'RowSparseNDArray' and t[2] == j[2] == (1, 2)
    np.testing.assert_array_equal(t[1], j[1])


def test_kvstore_row_sparse_pull_dense_backing():
    def run(mx, ag, gl, sp):
        kv = mx.kvstore.create('local')
        kv.init('w', mx.np.array(np.arange(10, dtype='float32')
                                 .reshape(5, 2)))
        pulled = kv.row_sparse_pull('w', row_ids=mx.np.array([0, 4]))
        return type(pulled).__name__, pulled.asnumpy(), pulled.data.shape
    j, t = both(run)
    assert t[0] == j[0] == 'RowSparseNDArray' and t[2] == j[2] == (2, 2)
    np.testing.assert_array_equal(t[1], j[1])


def test_kvstore_sparse_push_updates_components():
    def run(mx, ag, gl, sp):
        kv = mx.kvstore.create('local')
        kv.init('emb', sp.row_sparse_array(
            (np.ones((2, 2), dtype='float32'), [1, 3]), shape=(5, 2)))
        kv.push('emb', mx.np.array(np.full((5, 2), 10.0, dtype='float32')))
        pulled = kv.row_sparse_pull('emb', row_ids=mx.np.array([1]))
        return pulled.asnumpy(), pulled.indices.asnumpy()
    j, t = both(run)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[0][1], [11, 11])
    np.testing.assert_array_equal(t[1], j[1])


@pytest.mark.parametrize('op', ['push', 'pushpull'])
def test_kvstore_sparse_value_under_an_optimizer(op):
    """An updater's step on a row-sparse stored value refreshes its
    components: ``row_sparse_pull`` and ``pull`` read the same rows, and
    an id no step touched comes back as in the JAX package (not at all)."""
    grad = np.zeros((6, 4), dtype='float32')
    grad[1], grad[4] = 1.0, 2.0

    def run(mx, ag, gl, sp):
        kv = mx.kvstore.create('local')
        kv.init('w', sp.row_sparse_array(
            (np.arange(8, dtype='float32').reshape(2, 4) + 1, [1, 3]),
            shape=(6, 4)))
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, momentum=0.9))
        for _ in range(2):
            if op == 'push':
                kv.push('w', mx.np.array(grad))
            else:
                kv.pushpull('w', mx.np.array(grad),
                            out=mx.np.zeros((6, 4)))
        pulled = kv.row_sparse_pull('w', row_ids=mx.np.array([1, 4, 5]))
        dense = mx.np.zeros((6, 4))
        kv.pull('w', out=dense)
        return (pulled.indices.asnumpy(), pulled.data.asnumpy(),
                dense.asnumpy())
    j, t = both(run)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[0], [1, 4])
    np.testing.assert_allclose(t[1], j[1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t[1], t[2][[1, 4]])


def test_kvstore_row_sparse_pull_list_keys():
    def run(mx, ag, gl, sp):
        kv = mx.kvstore.create('local')
        kv.init('a', mx.np.array(np.arange(4, dtype='float32')
                                 .reshape(2, 2)))
        kv.init('b', mx.np.array(np.arange(4, 8, dtype='float32')
                                 .reshape(2, 2)))
        res = kv.row_sparse_pull(['a', 'b'], row_ids=[
            mx.np.array([0]), mx.np.array([1])])
        return [r.asnumpy() for r in res]
    j, t = both(run)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_row_sparse_pull_into_a_row_sparse_out():
    """A row-sparse ``out`` takes the pulled rows as its components."""
    def run(mx, ag, gl, sp):
        kv = mx.kvstore.create('device')
        kv.init('w', mx.np.array(np.arange(12, dtype='float32')
                                 .reshape(6, 2)))
        out = sp.zeros('row_sparse', (6, 2))
        kv.row_sparse_pull('w', out=out, row_ids=mx.np.array([5, 2]))
        return out.asnumpy(), out.data.shape
    j, t = both(run)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1] == j[1] == (2, 2)


# ---------------------------------------------------------------- CSR
def test_csr_cast_storage_vectorized_parity():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((50, 17)).astype('float32')
    dense[dense < 0.5] = 0.0

    def run(mx, ag, gl, sp):
        csr = sp.cast_storage(mx.nd.array(dense), 'csr')
        return csr.asnumpy(), csr.indptr.asnumpy(), csr.indices.asnumpy()
    j, t = both(run)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.diff(t[1]), (dense != 0).sum(axis=1))


def test_csr_matvec_and_matmat():
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((23, 11)).astype('float32')
    dense[dense < 0.3] = 0.0
    v = rng.standard_normal(11).astype('float32')
    m = rng.standard_normal((11, 4)).astype('float32')
    u = rng.standard_normal(23).astype('float32')

    def run(mx, ag, gl, sp):
        csr = sp.cast_storage(mx.nd.array(dense), 'csr')
        return [sp.dot(csr, mx.nd.array(v)).asnumpy(),
                sp.dot(csr, mx.nd.array(m)).asnumpy(),
                sp.dot(csr, mx.nd.array(u), transpose_a=True).asnumpy(),
                sp.dot(csr, mx.nd.array(dense), transpose_a=True).asnumpy()]
    j, t = both(run)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-5)


def test_csr_add_csr_stays_sparse():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((9, 13)).astype('float32')
    b = rng.standard_normal((9, 13)).astype('float32')
    a[a < 0.8] = 0.0
    b[b < 0.8] = 0.0

    def run(mx, ag, gl, sp):
        ca = sp.cast_storage(mx.nd.array(a), 'csr')
        cb = sp.cast_storage(mx.nd.array(b), 'csr')
        out = sp.add(ca, cb)
        return (type(out).__name__, out.data.shape[0],
                ca.data.shape[0] + cb.data.shape[0], out.asnumpy(),
                out.indptr.asnumpy())
    j, t = both(run)
    assert t[0] == j[0] == 'CSRNDArray' and t[1] <= t[2] and t[1] == j[1]
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(t[4], j[4])


def test_csr_row_slice_and_scalar_math():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((12, 7)).astype('float32')
    a[a < 0.6] = 0.0
    d = rng.standard_normal((12, 7)).astype('float32')

    def run(mx, ag, gl, sp):
        csr = sp.cast_storage(mx.nd.array(a), 'csr')
        sl, tw, prod = csr[3:9], csr * 2.0, csr * mx.nd.array(d)
        return ([type(x).__name__ for x in (sl, tw, prod)], sl.shape,
                tw.data.shape == csr.data.shape,
                [x.asnumpy() for x in (sl, tw, prod, -csr, csr / 4.0)])
    j, t = both(run)
    assert t[0] == j[0] == ['CSRNDArray'] * 3
    assert t[1] == j[1] == (6, 7) and t[2] and j[2]
    for x, y in zip(t[3], j[3]):
        np.testing.assert_allclose(x, y, rtol=1e-6)


def test_csr_100k_x_512_matvec_no_densify():
    """The oracle's 10M x 512 case at 100k rows: the dense slot stays
    empty through both products, scalar math and row slicing."""
    R, C = 100_000, 512
    rng = np.random.default_rng(4)
    data, indptr, cols, rows = scipy_like_csr(rng, R, C, 2)
    v = rng.standard_normal(C).astype('float32')
    csr = tsp.CSRNDArray(tmx.nd.array(data), indptr, cols, (R, C))
    out = tsp.dot(csr, tmx.nd.array(v))
    assert out.shape == (R,)
    assert csr.__dict__.get('_dense') is None
    got = out.asnumpy()
    for r in [0, 123, R - 1]:
        lo, hi = indptr[r], indptr[r + 1]
        want = (data[lo:hi] * v[cols[lo:hi]]).sum()
        np.testing.assert_allclose(got[r], want, rtol=3e-4, atol=1e-4)
    out_t = tsp.dot(csr, out, transpose_a=True)
    assert out_t.shape == (C,)
    want_t = np.zeros(C, 'float64')
    np.add.at(want_t, cols, data.astype('float64') * got[rows])
    np.testing.assert_allclose(out_t.asnumpy(), want_t, rtol=3e-4,
                               atol=1e-3)
    assert csr.__dict__.get('_dense') is None
    half = (csr * 0.5)[50_000:50_100]
    assert half.shape == (100, C) and half.data.shape[0] <= 100 * 4
    assert csr.__dict__.get('_dense') is None
