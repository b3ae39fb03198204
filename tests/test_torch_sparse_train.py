"""The port's sparse-gradient embeddings, lazy update and Trainer against
the JAX package's (``tests/test_sparse.py``'s optimizer and embedding
cases are the oracles, run through both packages on the same seeded
inputs; its storage, kvstore and CSR cases are in
``tests/test_torch_sparse.py``).

Tolerances: one update of ``Optimizer.update`` at rtol 1e-6 (bit-equal
where ids repeat); trained weights and slots rtol 1e-5 / atol 1e-6 on the
rows an id touched, and every other row bit-equal to its initial value.
The oracle's 10M-row case runs at 100k rows here; its scale is the card's
(``chip_smoke.py``'s sparse phase).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl
from mxnet_tpu.ndarray import sparse as jsp
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, gluon as tgl
from mxnet_tpu_torch.ndarray import sparse as tsp

PACKAGES = ((jmx, jag, jgl, jsp), (tmx, tag, tgl, tsp))


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def both(fn):
    """``fn(mx, autograd, gluon, sparse)`` through each package; returns
    (jax, port)."""
    return tuple(fn(*p) for p in PACKAGES)


# ----------------------------------------------------- sparse optimizer
def _rsp(sp, mx, vals, ids, shape):
    return sp.RowSparseNDArray(mx.np.array(vals), mx.np.array(ids), shape)


def _slots(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [s for x in state for s in _slots(x)]
    return [np.asarray(state.asnumpy() if hasattr(state, 'asnumpy')
                       else state.numpy())]


@pytest.mark.parametrize('opt, kw, ids, vals', [
    ('SGD', dict(learning_rate=0.5, momentum=0.9, lazy_update=True),
     [1, 3], np.full((2, 2), 2.0, 'f')),
    ('SGD', dict(learning_rate=0.1, wd=0.1), [1], np.full((1, 2), 3.0, 'f')),
    ('AdaGrad', dict(learning_rate=0.5), [2], np.full((1, 2), 2.0, 'f')),
    ('Adam', dict(learning_rate=0.1, lazy_update=True), [0, 3],
     np.full((2, 2), 1.0, 'f')),
], ids=['sgd_lazy_rowwise', 'sgd_std_update_densifies',
        'adagrad_sparse_rowwise', 'adam_lazy_update_rowwise'])
def test_optimizer_row_sparse_update(opt, kw, ids, vals):
    """``Optimizer.update`` with a row-sparse gradient: the lazy update
    leaves absent rows and their slots untouched; without
    ``lazy_update`` SGD densifies (weight decay on every row)."""
    w0 = np.ones((4, 2), 'f')

    def run(mx, ag, gl, sp):
        o = getattr(mx.optimizer, opt)(**kw)
        g = _rsp(sp, mx, vals, np.array(ids), (4, 2))
        if mx is jmx:
            w = mx.np.array(w0)
            st = o.create_state(0, w)
            o.update(0, w, g, st)
            return w.asnumpy(), _slots(st)
        w = torch.tensor(w0)
        st = o.create_state(0, w)
        o.update(0, w, g, st)
        return w.numpy(), _slots(st)
    (jw, js), (tw, ts) = both(run)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=0)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    if kw.get('lazy_update') or opt == 'AdaGrad':
        untouched = np.setdiff1d(np.arange(4), ids)
        assert (tw[untouched] == w0[untouched]).all()
        for s in ts:
            assert (s[untouched] == 0).all()


def test_optimizer_row_sparse_duplicates_merge():
    """A backward-made gradient repeats ids: they are summed before the
    update (at a static size), in the oracle's order of summation."""
    def run(mx, ag, gl, sp):
        o = mx.optimizer.Adam(learning_rate=0.1, lazy_update=True)
        g = _rsp(sp, mx, np.arange(10, dtype='f').reshape(5, 2),
                 np.array([3, 1, 3, 3, 0]), (6, 2))
        g._may_have_duplicates = True
        w = np.linspace(-1, 1, 12, dtype='f').reshape(6, 2)
        if mx is jmx:
            w = mx.np.array(w)
            st = o.create_state(0, w)
            o.update(0, w, g, st)
            return w.asnumpy(), _slots(st)
        w = torch.tensor(w)
        st = o.create_state(0, w)
        o.update(0, w, g, st)
        return w.numpy(), _slots(st)
    (jw, js), (tw, ts) = both(run)
    np.testing.assert_array_equal(tw, jw)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)


def test_merge_rows_is_static_and_sums_repeats():
    ids = torch.tensor([4, 2, 4, 9, 2, 4])
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    rows, merged, valid = tsp.merge_rows(ids, vals)
    assert rows.shape == (6,) and merged.shape == (6, 2)
    assert valid.tolist() == [True, True, True, False, False, False]
    assert rows.tolist() == [2, 4, 9, 2, 2, 2]
    np.testing.assert_array_equal(merged[:3].numpy(),
                                  [[10, 12], [14, 17], [6, 7]])
    assert (merged[3:] == 0).all()


# ------------------------------------------------ Embedding + Trainer
def _train(mx, ag, gl, opt, kw, ids, w0, steps=3, sparse=True):
    net = gl.nn.Embedding(w0.shape[0], w0.shape[1], sparse_grad=sparse)
    net.initialize()
    net.weight.set_data(mx.np.array(w0))
    tr = gl.Trainer(net.collect_params(), opt, kw, kvstore=None)
    x = mx.np.array(ids)
    losses = []
    for _ in range(steps):
        with ag.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asnumpy()))
    return net, tr, losses


@pytest.mark.parametrize('opt, kw', [
    ('sgd', {'learning_rate': 0.1, 'lazy_update': True}),
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9, 'lazy_update': True}),
    ('adam', {'learning_rate': 0.1, 'lazy_update': True}),
    ('adagrad', {'learning_rate': 0.5}),
], ids=['sgd_lazy', 'sgd_momentum_lazy', 'adam_lazy', 'adagrad'])
def test_embedding_trainer_with_duplicate_ids_matches_jax(opt, kw):
    """Three steps with repeated ids against the JAX Trainer: losses and
    touched rows of the weight and of every slot at rtol 1e-5 / atol
    1e-6, the rows no id names bit-equal to their initial values."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((50, 4)).astype('f')
    ids = rng.integers(0, 50, (4, 6)).astype('f')
    (jnet, jtr, jl), (tnet, ttr, tl) = both(
        lambda mx, ag, gl, sp: _train(mx, ag, gl, opt, kw, ids, w0))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    tw, jw = tnet.weight.data().asnumpy(), jnet.weight.data().asnumpy()
    touched = np.isin(np.arange(50), ids.astype(int))
    np.testing.assert_allclose(tw[touched], jw[touched], rtol=1e-5,
                               atol=1e-6)
    assert (tw[~touched] == w0[~touched]).all()
    ts, js = _slots(ttr._states[0]), _slots(jtr._states[0])
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a[touched], b[touched], rtol=1e-5,
                                   atol=1e-6)
        assert (a[~touched] == 0).all()
    assert ttr.sparse_update_count == 3 and ttr.capture_count == 0
    assert isinstance(tnet.weight.grad(), tsp.RowSparseNDArray)


def test_embedding_sparse_grad_trainer():
    def run(mx, ag, gl, sp):
        net = gl.nn.Embedding(10, 4, sparse_grad=True)
        net.initialize(init=mx.initializer.Constant(0.25))
        before = net.weight.data().asnumpy().copy()
        trainer = gl.Trainer(net.collect_params(), 'sgd',
                             {'learning_rate': 1.0, 'lazy_update': True})
        with ag.record():
            loss = net(mx.np.array(np.array([1, 5]))).sum()
        loss.backward()
        trainer.step(1)
        return before, net.weight.data().asnumpy()
    (jb, ja), (tb, ta) = both(run)
    np.testing.assert_array_equal(ta, ja)
    changed = np.any(ta != tb, axis=1)
    assert changed[1] and changed[5] and not changed[0] and not changed[9]


def test_sparse_grad_embedding_no_densify_end_to_end():
    """The oracle's 10M x 8 case at 100k rows: the gradient is (values,
    ids) with one entry a token, the lazy step writes only the named rows
    (no backward or step writes the dense grad buffer), and
    ``row_sparse_pull`` returns row slices."""
    N, D = 100_000, 8
    ids = np.array([[3, N - 1, 3], [7, 3, 12_345]], 'f')

    def run(mx, ag, gl, sp):
        emb = gl.nn.Embedding(N, D, sparse_grad=True)
        emb.initialize(init=mx.initializer.Constant(0.5))
        tr = gl.Trainer(emb.collect_params(), 'sgd',
                        {'learning_rate': 1.0, 'lazy_update': True},
                        kvstore=None)
        with ag.record():
            loss = emb(mx.np.array(ids)).sum()
        loss.backward()
        g = emb.weight.grad()
        got = dict(kind=type(g).__name__, shape=g.data.shape,
                   dup=g._may_have_duplicates,
                   ids=np.sort(g.indices.asnumpy()))
        if mx is tmx:
            buf = emb.weight._info.buf
            got['buf_ptr'] = buf.data_ptr()
        tr.step(1)
        w = emb.weight.data()
        got['rows'] = w.asnumpy()[[3, 7, N - 1, 42]]
        if mx is tmx:
            got['buf_zero'] = bool((emb.weight._info.buf == 0).all())
            got['buf_same'] = emb.weight._info.buf.data_ptr() == \
                got['buf_ptr']
        kv = mx.kvstore.create('device')
        kv.init('emb', w)
        pulled = kv.row_sparse_pull('emb', row_ids=mx.np.array([3.0, 7.0]))
        got['pulled'] = (type(pulled).__name__, pulled.data.shape,
                         pulled.data.asnumpy())
        return got
    j, t = both(run)
    assert t['kind'] == j['kind'] == 'RowSparseNDArray'
    assert t['shape'] == j['shape'] == (6, D) and t['dup'] and j['dup']
    np.testing.assert_array_equal(t['ids'], j['ids'])
    np.testing.assert_array_equal(t['rows'], j['rows'])
    np.testing.assert_allclose(t['rows'][:, 0], [-2.5, -0.5, -0.5, 0.5])
    assert t['buf_zero'] and t['buf_same']
    assert t['pulled'][:2] == j['pulled'][:2] == ('RowSparseNDArray',
                                                  (2, D))
    np.testing.assert_array_equal(t['pulled'][2], j['pulled'][2])


def test_sparse_grad_embedding_matches_dense_path():
    np.random.seed(0)
    ids = np.random.randint(0, 20, (4, 5)).astype('f')
    w0 = np.full((20, 6), 0.3, 'f')
    out = {}
    for sparse in (True, False):
        (jn, _, _), (tn, _, _) = both(lambda mx, ag, gl, sp: _train(
            mx, ag, gl, 'sgd', {'learning_rate': 0.1, 'lazy_update': sparse},
            ids, w0, sparse=sparse))
        out[sparse] = (jn.weight.data().asnumpy(),
                       tn.weight.data().asnumpy())
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out[True][1], out[True][0], rtol=1e-5,
                               atol=1e-6)


def test_sparse_grad_adagrad_duplicates():
    def run(mx, ag, gl, sp):
        net = gl.nn.Embedding(10, 4, sparse_grad=True)
        net.initialize(init=mx.initializer.Constant(1.0))
        tr = gl.Trainer(net.collect_params(), 'adagrad',
                        {'learning_rate': 0.5, 'epsilon': 1e-7},
                        kvstore=None)
        with ag.record():
            loss = net(mx.np.array([[2.0, 2.0]])).sum()
        loss.backward()
        tr.step(1)
        return net.weight.data().asnumpy()
    j, t = both(run)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t[2], 0.5, rtol=1e-5)
    np.testing.assert_array_equal(t[3], 1.0)


def test_sparse_grad_zero_grad_clears_rsp():
    def run(mx, ag, gl, sp):
        net = gl.nn.Embedding(10, 4, sparse_grad=True)
        net.initialize()
        with ag.record():
            loss = net(mx.np.array([[1.0]])).sum()
        loss.backward()
        first = type(net.weight.grad()).__name__
        net.weight.zero_grad()
        g = net.weight.grad()
        return first, type(g).__name__, g.asnumpy()
    j, t = both(run)
    assert t[0] == j[0] == 'RowSparseNDArray'
    assert t[1] == j[1] == 'NDArray'
    np.testing.assert_array_equal(t[2], j[2])


def test_sparse_grad_add_req_densifies_correctly():
    def run(mx, ag, gl, sp):
        net = gl.nn.Embedding(10, 2, sparse_grad=True)
        net.initialize()
        net.weight.grad_req = 'add'
        for _ in range(2):
            with ag.record():
                loss = net(mx.np.array([[3.0]])).sum()
            loss.backward()
        return net.weight.grad().asnumpy()
    j, t = both(run)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[3], 2.0)
    np.testing.assert_array_equal(t[4], 0.0)


def test_autograd_grad_returns_row_sparse():
    def run(mx, ag, gl, sp):
        net = gl.nn.Embedding(10, 3, sparse_grad=True)
        net.initialize(init=mx.initializer.Constant(1.0))
        w = net.weight.data()
        with ag.record():
            loss = net(mx.np.array([[2.0, 2.0]])).sum()
        (g,) = ag.grad(loss, [w])
        return type(g).__name__, g.asnumpy()
    j, t = both(run)
    assert t[0] == j[0] == 'RowSparseNDArray'
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[1][2], 2.0)


def test_hybridized_sparse_embedding_trains_eagerly():
    """A hybridized block with a row-sparse gradient trains as the
    eager one does; on the CPU every call is eager, and the update graph
    is never captured (the sparse update runs outside it)."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((30, 4)).astype('f')
    ids = rng.integers(0, 30, (3, 5)).astype('f')
    runs = []
    for hybrid in (False, True):
        net = tgl.nn.Embedding(30, 4, sparse_grad=True)
        net.initialize()
        net.weight.set_data(tmx.np.array(w0))
        if hybrid:
            net.hybridize()
        tr = tgl.Trainer(net.collect_params(), 'adam',
                         {'learning_rate': 0.05, 'lazy_update': True})
        for _ in range(2):
            with tag.record():
                loss = (net(tmx.np.array(ids)) ** 2).sum()
            loss.backward()
            tr.step(1)
        runs.append(net.weight.data().asnumpy())
        assert tr.capture_count == 0 and tr.sparse_update_count == 2
    np.testing.assert_array_equal(runs[0], runs[1])


def test_sparse_update_runs_beside_the_captured_update_graph():
    """With graphs emulated on the CPU (the card's paths,
    ``_graphs.emulated()``): the dense parameters' update is one captured
    graph, the row-sparse table's lazy update runs eagerly beside it (by
    design: a new sparse gradient keeps no address), the recorded calls
    of a block with a row-sparse gradient run eagerly, counted; the
    weights are the eager run's, bit for bit."""
    import contextlib
    from mxnet_tpu_torch import _graphs
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((40, 4)).astype('f')
    ids = rng.integers(0, 40, (3, 5)).astype('f')
    runs = []
    for graphs in ('eager', 'emulated'):
        net = tgl.nn.HybridSequential()
        net.add(tgl.nn.Embedding(40, 4, sparse_grad=True),
                tgl.nn.Dense(2, in_units=4, flatten=False))
        net.initialize()
        net[0].weight.set_data(tmx.np.array(w0))
        net[1].weight.set_data(tmx.np.array(np.ones((2, 4), 'f') * 0.1))
        net.hybridize()
        tr = tgl.Trainer(net.collect_params(), 'adam',
                         {'learning_rate': 0.05, 'lazy_update': True})
        with _graphs.emulated() if graphs == 'emulated' else \
                contextlib.nullcontext():
            for _ in range(3):
                with tag.record():
                    loss = (net(tmx.np.array(ids)) ** 2).sum()
                loss.backward()
                tr.step(1)
        runs.append([p.data().asnumpy() for p in
                     net.collect_params().values()])
        assert tr.sparse_update_count == 3
        assert tr.capture_count == (1 if graphs == 'emulated' else 0)
        # the block's first call (its deferred initialization) is eager
        # and uncounted; the two after it are the counted eager calls
        assert net.eager_call_count == (2 if graphs == 'emulated' else 0)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    untouched = ~np.isin(np.arange(40), ids.astype(int))
    assert (runs[1][0][untouched] == w0[untouched]).all()


def test_update_on_kvstore_with_row_sparse_warns():
    net = tgl.nn.Embedding(10, 2, sparse_grad=True)
    net.initialize()
    tr = tgl.Trainer(net.collect_params(), 'sgd', {'learning_rate': 0.1},
                     kvstore='device', update_on_kvstore=True)
    with tag.record():
        loss = net(tmx.np.array([[1.0]])).sum()
    loss.backward()
    with pytest.warns(UserWarning, match='densifies row_sparse'):
        tr.step(1)
