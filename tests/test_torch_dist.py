"""Data-parallel training over ``torch.distributed`` on the CPU, against
the JAX package.

- ``tests/nightly/dist_sync_kvstore.py``'s assertions on two gloo ranks
  (``parallel.launch.spawn``), through the port's ``dist_tpu_sync``: sums
  over the ranks, rank 0's broadcast, 2-bit compressed pushpull, the
  optimizer on the store, fused buckets, compressed buckets, ZeRO-1 and
  ``row_sparse_pull`` of a dense table, each exact as there (rtol 1e-6).
- A ``Trainer(kvstore='dist_sync')`` on each of two ranks, each rank with
  its half of the batch (``split_and_load`` over a ``dp`` mesh), against
  the JAX Trainer in one
  process over the whole batch: a small Dense net with SGD-momentum and
  Adam, with and without ``update_on_kvstore`` (ZeRO-1), and the tiny
  BERT of ``tests/test_torch_bert.py`` with Adam. The kvstore sums, so
  each rank's loss is the sum over its samples and ``step`` takes the
  same batch size as the JAX run's. Weights and losses within 1e-5
  (rtol and atol), the JAX tests' bound for one Trainer against another;
  the two ranks' weights bit-equal.
- ``SyncBatchNorm`` on two ranks against JAX ``BatchNorm`` over the whole
  batch: the output, the input gradient, the gamma and beta gradients
  summed over the ranks, and the running statistics, at 1e-5.
- The multi-context ``Parameter`` and ``Trainer`` surface on ``cpu(0)``
  and ``cpu(1)`` against the JAX package's on two virtual CPU devices.
  The JAX package cannot run a forward on a second context (ROADMAP C9:
  ``Parameter.data()`` is the first replica, and the jitted op refuses
  arrays of two devices); ``-s -k C9`` prints its error.
- The ring's q, k and v gradients on four gloo ranks against ``jax.grad``
  of the JAX ``ring_attention`` on four virtual devices, causal and full,
  both ``use_flash`` settings, at 2e-5 (the forward's bound in
  ``tests/test_torch_parallel.py``).

The rank workers import nothing of JAX: a ``spawn`` child imports this
module to find them, so JAX is imported inside the tests only.
"""

import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgl, kvstore as tkv
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.parallel import launch, make_mesh, split_and_load
from mxnet_tpu_torch.parallel import ring_attention as ring

TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=2e-5, atol=2e-5)
EXACT = dict(rtol=1e-6, atol=0)
BATCH, IN, HID, OUT = 8, 6, 16, 4
#: (optimizer, hyperparameters, update_on_kvstore)
DENSE_RUNS = [('sgd', {'learning_rate': 0.1, 'momentum': 0.9}, False),
              ('adam', {'learning_rate': 0.01}, False),
              ('adam', {'learning_rate': 0.01}, True),
              ('sgd', {'learning_rate': 0.1, 'momentum': 0.9}, True)]
STEPS = 2
TINY = dict(vocab_size=200, num_layers=2, units=32, hidden_size=64,
            num_heads=4, max_length=32, dropout=0.0, use_classifier=False)
BN_SHAPE = (4, 3, 5, 5)
B, H, S, D = 1, 2, 64, 32


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ the inputs
def _inputs():
    rng = np.random.default_rng(17)
    dense = dict(x=_randn(rng, BATCH, IN), y=_randn(rng, BATCH, OUT),
                 w=[_randn(rng, HID, IN) * 0.3, _randn(rng, HID) * 0.1,
                    _randn(rng, OUT, HID) * 0.3, _randn(rng, OUT) * 0.1])
    ids = rng.integers(0, 200, (4, 12)).astype(np.int32)
    bert = dict(ids=ids, tt=np.zeros_like(ids),
                labels=rng.integers(0, 200, (4, 12)).astype(np.int32))
    bn = dict(x=_randn(rng, *BN_SHAPE), w=_randn(rng, *BN_SHAPE),
              gamma=1 + 0.1 * _randn(rng, 3), beta=0.1 * _randn(rng, 3))
    return dense, bert, bn


def _bert_weights():
    """The tiny BERT's initial weights, from the JAX net (parent only)."""
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    jnet = jbert.get_bert_model('bert_12_768_12', **TINY)
    jnet.initialize()
    ids = np.zeros((1, 12), np.int32)
    jnet(jmx.np.array(ids), jmx.np.array(ids))
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


# ------------------------------------------------------------ two ranks
def _nightly(rank, size):
    """tests/nightly/dist_sync_kvstore.py's assertions, on the port."""
    mx = tmx
    kv = tkv.create('dist_tpu_sync')
    assert (kv.rank, kv.num_workers) == (rank, size)
    kv.init(3, mx.np.zeros((4, 2)))
    out = mx.np.zeros((4, 2))
    kv.pushpull(3, mx.np.array(np.full((4, 2), rank + 1.0, 'f')), out=out)
    np.testing.assert_allclose(out.asnumpy(), np.full(
        (4, 2), sum(r + 1.0 for r in range(size))), **EXACT)
    got = mx.np.zeros((3,))
    kv.broadcast('w0', mx.np.array(np.full((3,), 100.0 + rank, 'f')),
                 out=got)
    np.testing.assert_allclose(got.asnumpy(), np.full((3,), 100.0), **EXACT)
    kv.barrier()
    kv.set_gradient_compression({'type': '2bit', 'threshold': 0.5})
    cout = mx.np.zeros((4,))
    kv.pushpull(7, mx.np.array(np.array([0.6, -0.7, 0.1, 0.0], 'f')),
                out=cout)
    np.testing.assert_allclose(
        cout.asnumpy(), [0.5 * size, -0.5 * size, 0.0, 0.0], atol=1e-6)
    kv2 = tkv.create('dist_tpu_sync')
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
    kv2.init(0, mx.np.array(np.full((2,), 10.0, 'f')))
    wout = mx.np.zeros((2,))
    kv2.pushpull(0, mx.np.array(np.full((2,), 1.0, 'f')), out=wout)
    np.testing.assert_allclose(wout.asnumpy(),
                               np.full((2,), 10.0 - 0.5 * size), **EXACT)
    fkeys = list(range(20, 27))
    fouts = [mx.np.zeros((5, 3)) for _ in fkeys]
    kv.set_gradient_compression({'type': 'none'})
    kv.fused_pushpull(fkeys, [mx.np.array(np.full(
        (5, 3), (rank + 1.0) * (k - 19), 'f')) for k in fkeys],
        outs=[[o] for o in fouts], priorities=[-i for i in range(7)])
    for k, o in zip(fkeys, fouts):
        np.testing.assert_allclose(o.asnumpy(), np.full(
            (5, 3), sum((r + 1.0) * (k - 19) for r in range(size))),
            **EXACT)
    kvc = tkv.create('dist_tpu_sync')
    kvc.set_gradient_compression({'type': '2bit', 'threshold': 0.5})
    couts = [mx.np.zeros((4,)), mx.np.zeros((2, 2))]
    kvc.fused_pushpull([70, 71], [
        mx.np.array(np.array([0.6, -0.7, 0.1, 0.0], 'f')),
        mx.np.array(np.array([[0.9, -0.1], [0.0, 0.55]], 'f'))], outs=couts)
    np.testing.assert_allclose(
        couts[0].asnumpy(), [0.5 * size, -0.5 * size, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(couts[1].asnumpy(), [[0.5 * size, 0.0],
                                                    [0.0, 0.5 * size]],
                               atol=1e-6)
    kvz = tkv.create('dist_tpu_sync')
    kvz.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
    for k in range(3):
        kvz.init(k, mx.np.array(np.full((3,), 10.0 * (k + 1), 'f')))
    zouts = [mx.np.zeros((3,)) for _ in range(3)]
    kvz.fused_pushpull([0, 1, 2], [mx.np.array(np.full(
        (3,), 1.0 * (k + 1), 'f')) for k in range(3)], outs=zouts)
    for k, o in enumerate(zouts):
        np.testing.assert_allclose(o.asnumpy(), np.full(
            (3,), 10.0 * (k + 1) - 0.5 * size * (k + 1)), **EXACT)
    # each key updated once, on its owner: the counts sum to one a key
    owned = kvz._updater.optimizer._index_update_count
    kv.init('emb', mx.np.array(np.arange(8, dtype='float32').reshape(4, 2)))
    got = kv.row_sparse_pull('emb', row_ids=mx.np.array(
        np.array([rank, 3]))).asnumpy()
    np.testing.assert_allclose(got[rank], [2.0 * rank, 2.0 * rank + 1])
    np.testing.assert_allclose(got[3], [6.0, 7.0])
    return dict(owned=dict(owned))


def _dense_net(weights):
    net = tgl.nn.HybridSequential(
        tgl.nn.Dense(HID, in_units=IN, activation='tanh'),
        tgl.nn.Dense(OUT, in_units=HID))
    net.initialize()
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(tmx.np.array(w))
    return net


def _train_ranks(dense, bert, bert_w, rank):
    """Each rank trains on its half of the batch from the same initial
    weights, as ranks seeded alike start. The Trainer's first
    ``allreduce_grads`` broadcasts rank 0's weights: a net whose rank 1
    starts elsewhere takes rank 0's there."""
    mesh = make_mesh(dp=2)
    out = {}
    x = split_and_load(tmx.np.array(dense['x']), mesh=mesh)
    y = split_and_load(tmx.np.array(dense['y']), mesh=mesh)
    out['shard'] = x.asnumpy()
    net = _dense_net([w + 0.5 * rank for w in dense['w']])
    tgl.Trainer(net.collect_params(), 'sgd', kvstore='dist_sync'
                ).allreduce_grads()
    out['broadcast'] = [p.data().asnumpy()
                        for p in net.collect_params().values()]
    for run, (opt, hyper, on_kv) in enumerate(DENSE_RUNS):
        net = _dense_net(dense['w'])
        tr = tgl.Trainer(net.collect_params(), opt, dict(hyper),
                         kvstore='dist_sync', update_on_kvstore=on_kv)
        losses = []
        for _ in range(STEPS):
            with tmx.autograd.record():
                loss = ((net(x) - y) ** 2).sum()
            loss.backward()
            tr.step(BATCH // 2)
            losses.append(float(loss.asnumpy()))
        out['dense', run] = ([p.data().asnumpy()
                              for p in net.collect_params().values()],
                             losses)
        if on_kv:
            out['owned', run] = dict(
                tr._kvstore._updater.optimizer._index_update_count)
    net = tbert.get_bert_model('bert_12_768_12', **TINY)
    net.initialize()
    ids = split_and_load(tmx.np.array(bert['ids']), mesh=mesh)
    tt = split_and_load(tmx.np.array(bert['tt']), mesh=mesh)
    labels = split_and_load(tmx.np.array(bert['labels']), mesh=mesh)
    net(ids, tt)
    net.load_dict(bert_w)
    net.hybridize()
    tr = tgl.Trainer(net.collect_params(), 'adam', {'learning_rate': 1e-3},
                     kvstore='dist_sync')
    loss_fn = tgl.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(STEPS):
        with tmx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).sum()
        loss.backward()
        tr.step(2)
        losses.append(float(loss.asnumpy()))
    out['bert'] = ({k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}, losses)
    return out


def _sync_bn_rank(bn, rank):
    sl = slice(rank * 2, rank * 2 + 2)
    layer = tgl.nn.SyncBatchNorm(in_channels=3)
    layer.initialize()
    layer.gamma.set_data(tmx.np.array(bn['gamma']))
    layer.beta.set_data(tmx.np.array(bn['beta']))
    x = tmx.np.array(bn['x'][sl])
    x.attach_grad()
    with tmx.autograd.record():
        y = layer(x)
        loss = (y * tmx.np.array(bn['w'][sl])).sum()
    loss.backward()
    return dict(y=y.asnumpy(), dx=x.grad.asnumpy(),
                dgamma=layer.gamma.grad().asnumpy(),
                dbeta=layer.beta.grad().asnumpy(),
                mean=layer.running_mean.data().asnumpy(),
                var=layer.running_var.data().asnumpy(),
                syncs=layer.syncs())


def _two_ranks(dense, bert, bert_w, bn):
    import torch.distributed as dist
    rank, size = dist.get_rank(), dist.get_world_size()
    with tmx.cpu():
        out = {'nightly': _nightly(rank, size)}
        out.update(_train_ranks(dense, bert, bert_w, rank))
        out['bn'] = _sync_bn_rank(bn, rank)
    return out


def _jax_dense(dense, opt, hyper, on_kv):
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    net = jgl.nn.HybridSequential()
    net.add(jgl.nn.Dense(HID, in_units=IN, activation='tanh'),
            jgl.nn.Dense(OUT, in_units=HID))
    net.initialize()
    for p, w in zip(net.collect_params().values(), dense['w']):
        p.set_data(jmx.np.array(w))
    tr = jgl.Trainer(net.collect_params(), opt, dict(hyper),
                     update_on_kvstore=on_kv)
    x, y = jmx.np.array(dense['x']), jmx.np.array(dense['y'])
    losses = []
    for _ in range(STEPS):
        with jmx.autograd.record():
            loss = ((net(x) - y) ** 2).sum()
        loss.backward()
        tr.step(BATCH // 2)
        losses.append(float(loss.asnumpy()))
    return [p.data().asnumpy() for p in net.collect_params().values()], \
        losses


def _jax_bert(bert, bert_w):
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    net = jbert.get_bert_model('bert_12_768_12', **TINY)
    net.initialize()
    ids, tt, labels = (jmx.np.array(bert[k]) for k in ('ids', 'tt',
                                                       'labels'))
    net(ids, tt)
    for k, p in net.collect_params().items():
        p.set_data(jmx.np.array(bert_w[k]))
    tr = jgl.Trainer(net.collect_params(), 'adam', {'learning_rate': 1e-3})
    loss_fn = jgl.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(STEPS):
        with jmx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).sum()
        loss.backward()
        tr.step(2)
        losses.append(float(loss.asnumpy()))
    return {k: p.data().asnumpy()
            for k, p in net.collect_params().items()}, losses


def _jax_bn(bn):
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    layer = jgl.nn.BatchNorm(in_channels=3)
    layer.initialize()
    layer.gamma.set_data(jmx.np.array(bn['gamma']))
    layer.beta.set_data(jmx.np.array(bn['beta']))
    x = jmx.np.array(bn['x'])
    x.attach_grad()
    with jmx.autograd.record():
        y = layer(x)
        loss = (y * jmx.np.array(bn['w'])).sum()
    loss.backward()
    return dict(y=y.asnumpy(), dx=x.grad.asnumpy(),
                dgamma=layer.gamma.grad().asnumpy(),
                dbeta=layer.beta.grad().asnumpy(),
                mean=layer.running_mean.data().asnumpy(),
                var=layer.running_var.data().asnumpy())


def _in_thread(fn, *args, **kwargs):
    box = {}

    def run():
        try:
            box['out'] = fn(*args, **kwargs)
        except BaseException as e:   # raised in the test
            box['error'] = e

    th = threading.Thread(target=run)
    th.start()
    return th, box


def _joined(th, box):
    th.join()
    if 'error' in box:
        raise box['error']
    return box['out']


@pytest.fixture(scope='module')
def two_ranks():
    """The port's two ranks (in a thread) and the JAX runs here, on the
    same numpy inputs."""
    dense, bert, bn = _inputs()
    bert_w = _bert_weights()
    th, box = _in_thread(launch.spawn, _two_ranks, 2, dense, bert, bert_w,
                         bn, timeout=300)
    want = {('dense', i): _jax_dense(dense, *run)
            for i, run in enumerate(DENSE_RUNS)}
    want['bert'] = _jax_bert(bert, bert_w)
    want['bn'] = _jax_bn(bn)
    want['x'], want['w0'] = dense['x'], dense['w']
    return _joined(th, box), want


def test_nightly_dist_sync_kvstore_assertions_on_two_ranks(two_ranks):
    ranks, _ = two_ranks
    # ZeRO-1: keys 0, 1, 2 each updated on one rank only
    owned = [r['nightly']['owned'] for r in ranks]
    assert sorted(k for o in owned for k in o) == [0, 1, 2]
    assert all(set(o.values()) <= {1} for o in owned)


def test_the_trainer_broadcasts_rank_0s_weights(two_ranks):
    ranks, want = two_ranks
    for r in ranks:
        for a, b in zip(r['broadcast'], want['w0']):
            np.testing.assert_array_equal(a, b)


def test_split_and_load_over_a_dp_mesh_gives_each_rank_its_shard(two_ranks):
    ranks, want = two_ranks
    got = np.concatenate([r['shard'] for r in ranks])
    np.testing.assert_array_equal(got, want['x'])


@pytest.mark.parametrize('run', range(len(DENSE_RUNS)),
                         ids=[f'{o}{"-on-kvstore" if k else ""}'
                              for o, _, k in DENSE_RUNS])
def test_dist_sync_trainer_matches_the_jax_trainer(two_ranks, run):
    ranks, want = two_ranks
    jw, jl = want['dense', run]
    for r in ranks:
        tw, tl = r['dense', run]
        for a, b in zip(tw, jw):
            np.testing.assert_allclose(a, b, **TOL)
    # the ranks' losses are their halves of the JAX loss
    np.testing.assert_allclose(
        [a + b for a, b in zip(ranks[0]['dense', run][1],
                               ranks[1]['dense', run][1])], jl, **TOL)
    for a, b in zip(ranks[0]['dense', run][0], ranks[1]['dense', run][0]):
        np.testing.assert_array_equal(a, b)
    if DENSE_RUNS[run][2]:      # ZeRO-1: every key on one owner
        counts = [r['owned', run] for r in ranks]
        assert sorted(k for c in counts for k in c) == [0, 1, 2, 3]
        assert all(set(c.values()) == {STEPS} for c in counts)


def test_dist_sync_trainer_trains_tiny_bert_as_the_jax_trainer(two_ranks):
    ranks, want = two_ranks
    jw, jl = want['bert']
    for r in ranks:
        tw, _ = r['bert']
        assert sorted(tw) == sorted(jw)
        for k in jw:
            np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **TOL)
    np.testing.assert_allclose(
        [a + b for a, b in zip(ranks[0]['bert'][1], ranks[1]['bert'][1])],
        jl, **TOL)
    for k in jw:
        np.testing.assert_array_equal(ranks[0]['bert'][0][k],
                                      ranks[1]['bert'][0][k])


def test_sync_batch_norm_is_batch_norm_over_the_whole_batch(two_ranks):
    ranks, want = two_ranks
    bn = [r['bn'] for r in ranks]
    assert all(b['syncs'] for b in bn)
    want = want['bn']
    for k in ('y', 'dx'):
        np.testing.assert_allclose(np.concatenate([b[k] for b in bn]),
                                   want[k], err_msg=k, **TOL)
    for k in ('dgamma', 'dbeta'):
        np.testing.assert_allclose(bn[0][k] + bn[1][k], want[k],
                                   err_msg=k, **TOL)
    for k in ('mean', 'var'):
        for b in bn:
            np.testing.assert_allclose(b[k], want[k], err_msg=k, **TOL)


# ------------------------------------------------- several contexts
def _contexts_run(mx, gl, opt, on_kv, weights, x, g1):
    """A Dense net on two contexts: a forward on the first replica, a
    hand-written gradient on the second, two steps."""
    ctxs = [mx.cpu(0), mx.cpu(1)]
    net = gl.nn.Dense(OUT, in_units=IN)
    net.initialize(ctx=ctxs)
    net.weight.set_data(mx.np.array(weights[0]))
    net.bias.set_data(mx.np.array(weights[1]))
    tr = gl.Trainer(net.collect_params(), opt, {'learning_rate': 0.1},
                    update_on_kvstore=on_kv)
    for _ in range(STEPS):
        with mx.autograd.record():
            loss = (net(mx.np.array(x)) ** 2).sum()
        loss.backward()
        net.weight.grad(ctxs[1])[:] = mx.np.array(g1)
        tr.step(x.shape[0])
    return dict(
        ctx=[str(c) for c in net.weight.list_ctx()],
        n=(len(net.weight.list_data()), len(net.weight.list_grad())),
        w=[d.asnumpy() for d in net.weight.list_data()],
        b=[net.bias.data(c).asnumpy() for c in ctxs],
        g=[g.asnumpy() for g in net.weight.list_grad()])


@pytest.mark.parametrize('opt,on_kv', [('sgd', False), ('adam', False),
                                       ('adam', True)])
def test_parameters_on_two_contexts_train_as_in_jax(opt, on_kv):
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    rng = np.random.default_rng(5)
    weights = [_randn(rng, OUT, IN), _randn(rng, OUT)]
    x, g1 = _randn(rng, 3, IN), _randn(rng, OUT, IN)
    want = _contexts_run(jmx, jgl, opt, on_kv, weights, x, g1)
    got = _contexts_run(tmx, tgl, opt, on_kv, weights, x, g1)
    assert got['ctx'] == want['ctx'] == ['cpu(0)', 'cpu(1)']
    assert got['n'] == want['n'] == (2, 2)
    for k in ('w', 'b', 'g'):
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)
    np.testing.assert_array_equal(got['w'][0], got['w'][1])


def test_set_data_and_reset_ctx_on_two_contexts():
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    for mx, gl in ((jmx, jgl), (tmx, tgl)):
        p = gl.Parameter('w', shape=(2, 3))
        p.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
        p.set_data(mx.np.array(v))
        for d in p.list_data():
            np.testing.assert_array_equal(d.asnumpy(), v)
        p.reset_ctx([mx.cpu(1), mx.cpu(0)])
        assert p.list_ctx() == [mx.cpu(1), mx.cpu(0)]
        np.testing.assert_array_equal(p.data(mx.cpu(0)).asnumpy(), v)
        with pytest.raises(RuntimeError, match='not initialized on'):
            p.data(mx.cpu(2))


def test_C9_jax_forward_on_a_second_context_raises():
    """ROADMAP C9's witness: the JAX layers read the first replica
    (``Parameter.data()``), so a forward on the second context's slice
    raises in the jitted op. The port's blocks read the first replica
    too; no port test depends on a forward on a second context."""
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    net = jgl.nn.Dense(2, in_units=3)
    net.initialize(ctx=[jmx.cpu(0), jmx.cpu(1)])
    parts = jgl.utils.split_and_load(jmx.np.ones((4, 3)),
                                     [jmx.cpu(0), jmx.cpu(1)])
    net(parts[0])
    with pytest.raises(ValueError, match='incompatible devices') as info:
        net(parts[1])
    print(f'C9: JAX Dense on the second context: {str(info.value)[:160]}')


# ------------------------------------------------ the ring's gradients
def _ring_grads(q, k, v, w):
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(sp=world)
    sl = S // world
    out = {}
    for causal in (False, True):
        for flash in (False, True):
            shards = [torch.tensor(a[:, :, rank * sl:(rank + 1) * sl],
                                   requires_grad=True) for a in (q, k, v)]
            y = ring.ring_attention(*shards, mesh, causal=causal,
                                    use_flash=flash)
            (y * torch.from_numpy(
                w[:, :, rank * sl:(rank + 1) * sl])).sum().backward()
            out[causal, flash] = [s.grad for s in shards]
    return out


@pytest.fixture(scope='module')
def ring_grads():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from mxnet_tpu.parallel.ring_attention import ring_attention
    rng = np.random.default_rng(23)
    q, k, v, w = (_randn(rng, B, H, S, D) for _ in range(4))
    th, box = _in_thread(launch.spawn, _ring_grads, 4, q, k, v, w,
                         timeout=180)
    mesh = Mesh(np.array(jax.devices()[:4]), ('sp',))
    want = {}
    for causal in (False, True):
        for flash in (False, True):
            def loss(q_, k_, v_, causal=causal, flash=flash):
                return (ring_attention(q_, k_, v_, mesh, causal=causal,
                                       use_flash=flash) * w).sum()
            want[causal, flash] = [np.asarray(g) for g in jax.grad(
                loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                           for a in (q, k, v)))]
    return _joined(th, box), want


@pytest.mark.parametrize('flash', [False, True], ids=['plain', 'flash'])
@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
def test_ring_gradients_match_jax_grad_over_four_ranks(ring_grads, causal,
                                                       flash):
    ranks, want = ring_grads
    for i, name in enumerate('qkv'):
        got = torch.cat([r[causal, flash][i] for r in ranks], dim=2)
        np.testing.assert_allclose(got.numpy(), want[causal, flash][i],
                                   err_msg=f'd{name}', **RING_TOL)
