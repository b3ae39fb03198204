"""The port's pipeline schedules (``parallel.pipeline``) and
``PipelineTrainer`` (``parallel.gluon_pipeline``) against the JAX package,
on the CPU.

The functional cases of ``tests/test_parallel.py`` at their sizes and
seeds: the GPipe forward over four stages against running the stages in
turn and against the JAX ``pipeline_apply``; its backward over two stages
(the reverse schedule inside the port's autograd) against ``jax.grad``;
1F1B over four stages against the sequential model's loss and gradients;
1F1B over pp 2 x sp 2 (the sequence axis sharded too) whose gradients sum
over ``sp``, against the JAX GPipe ``value_and_grad``; the statistics and
the divisibility check; and each stage holding only its ``n_micro / S``
interleaved microbatches of the feed and of the outputs.

The Gluon cases of ``tests/test_pipeline_gluon.py`` (``D 8, MB 2``, four
microbatches, two stages): the port's stages take the JAX stages' weights
by name, and the 1F1B step's loss, gradients and SGD-updated weights meet
the JAX ``PipelineTrainer``'s; the loss falls over six steps; GPipe and
1F1B update alike; a split four-layer net's pipelined forward equals the
whole net; a BatchNorm stage is refused. Tolerances: rtol 1e-4 / atol
1e-5 for gradients, losses and updated weights (the JAX tests' own), 1e-5
/ 1e-6 for forward values.

One ``parallel.launch.spawn`` of four gloo ranks runs every port case (the
two-stage ones on ranks 0-1, in a group of their own); JAX runs on
conftest's virtual CPU devices. The rank worker imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.parallel import launch

D, MB, NMICRO = 8, 2, 4
GRAD = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ inputs
def _inputs():
    """The numpy inputs of the functional cases, drawn as
    ``tests/test_parallel.py`` draws them."""
    out = {}
    np.random.seed(1)
    out['seq'] = dict(
        w=[np.random.randn(8, 8).astype('f') * 0.3 for _ in range(4)],
        xs=np.random.randn(8, 3, 8).astype('f'))
    np.random.seed(2)
    out['grad'] = dict(
        w=[np.random.randn(4, 4).astype('f') * 0.5 for _ in range(2)],
        xs=np.random.randn(4, 2, 4).astype('f'))
    np.random.seed(3)
    w = [np.random.randn(6, 6).astype('f') * 0.4 for _ in range(4)]
    out['1f1b'] = dict(w=w, xs=np.random.randn(8, 3, 6).astype('f'),
                       ys=np.random.randn(8, 3, 6).astype('f'))
    np.random.seed(5)
    w = [np.random.randn(6, 6).astype('f') * 0.4 for _ in range(2)]
    out['sp'] = dict(w=w, xs=np.random.randn(4, 2, 8, 6).astype('f'),
                     ys=np.random.randn(4, 2, 8, 6).astype('f'))
    rng = np.random.default_rng(0)
    out['gluon_xs'] = rng.standard_normal((NMICRO, MB, D)).astype('f')
    out['gluon_ys'] = rng.standard_normal((NMICRO, MB, D)).astype('f')
    return out


def _jax_stage_weights(seed):
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon import nn as jnn
    jmx.random.seed(seed)
    s = jnn.Dense(D, activation='tanh', in_units=D)
    s.initialize()
    s(jmx.np.zeros((MB, D)))
    return s, {n: p.data().asnumpy().copy()
               for n, p in s.collect_params().items()}


# ------------------------------------------------------------- port ranks
def _tanh_affine(p, x):
    return torch.tanh(x @ p['w'] + p['b'])


def _tanh_linear(p, x):
    return torch.tanh(x @ p['w'])


def _sq_loss_grad(y, t):
    return ((y - t) ** 2).sum(), 2.0 * (y - t)


def _port_stages(mx, nn, weights):
    stages = []
    for w in weights:
        s = nn.Dense(D, activation='tanh', in_units=D)
        s.initialize(ctx=mx.cpu())
        for n, p in s.collect_params().items():
            p.set_data(w[n])
        stages.append(s)
    return stages


def _gluon_cases(data, ctx2):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import nn
    xs, ys = mx.np.array(data['gluon_xs']), mx.np.array(data['gluon_ys'])
    ex = mx.np.zeros((MB, D))
    out = {}

    def weights(stages):
        return [{n: p.data().asnumpy().copy()
                 for n, p in st.collect_params().items()} for st in stages]

    stages = _port_stages(mx, nn, data['w12'])
    tr = parallel.PipelineTrainer(stages, ctx2, example=ex,
                                  optimizer='sgd',
                                  optimizer_params={'learning_rate': 0.1})
    k = tr.stage
    out['loss'] = tr.step(xs, ys)
    out['grads'] = {n: p.grad().asnumpy().copy()
                    for n, p in stages[k].collect_params().items()}
    out['updated'] = weights(stages)[k]

    stages = _port_stages(mx, nn, data['w34'])
    tr = parallel.PipelineTrainer(stages, ctx2, example=ex,
                                  optimizer='sgd',
                                  optimizer_params={'learning_rate': 0.5})
    out['losses'] = [tr.step(xs, ys) for _ in range(6)]

    for sched in ('1f1b', 'gpipe'):
        stages = _port_stages(mx, nn, data['w56'])
        tr = parallel.PipelineTrainer(
            stages, ctx2, example=ex, optimizer='sgd',
            optimizer_params={'learning_rate': 0.2}, schedule=sched)
        tr.step(xs, ys)
        out['sched_' + sched] = weights(stages)[k]

    net = nn.HybridSequential()
    for w in data['w_net']:
        layer = nn.Dense(D, activation='tanh', in_units=D)
        net.add(layer)
    net.initialize(ctx=mx.cpu())
    for layer, w in zip(net._children.values(), data['w_net']):
        for n, p in layer.collect_params().items():
            p.set_data(w[n])
    stages = parallel.split_sequential(net, 2)
    tr = parallel.PipelineTrainer(stages, ctx2, example=ex)
    fwd = tr.forward(xs)
    out['fwd_local'] = tuple(fwd._data.shape)
    out['fwd'] = fwd.asnumpy()
    return out


def _pipe_rank(data):
    torch.set_num_threads(1)
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import pipeline as pl
    from mxnet_tpu_torch.sharding import ShardingContext
    from mxnet_tpu_torch.sharding.context import local_group
    from mxnet_tpu_torch.sharding.rules import PartitionSpec as P
    rank = dist.get_rank()
    out = {}
    t = torch.from_numpy
    ctx4 = ShardingContext({'pp': 4}, group=local_group([0, 1, 2, 3]))
    with mx.cpu():
        # GPipe forward over four stages
        d = data['seq']
        params = pl.stack_stage_params(
            [{'w': t(w), 'b': torch.zeros(8)} for w in d['w']])
        y = parallel.pipeline_apply(_tanh_affine, params, t(d['xs']), ctx4)
        out['seq_local'] = tuple(y._data.shape)
        out['seq'] = y.asnumpy()
        # 1F1B over four stages
        d = data['1f1b']
        params = pl.stack_stage_params(
            [{'w': t(w), 'b': torch.zeros(6)} for w in d['w']])
        grads, loss = parallel.pipeline_train_1f1b(
            _tanh_affine, _sq_loss_grad, params, t(d['xs']), t(d['ys']),
            ctx4)
        out['1f1b'] = ({k: g._data[0].numpy() for k, g in grads.items()},
                       float(loss), {k: g.asnumpy()
                                     for k, g in grads.items()})
        # 1F1B over pp 2 x sp 2
        d = data['sp']
        ctx22 = ShardingContext({'pp': 2, 'sp': 2},
                                group=local_group([0, 1, 2, 3]))
        params = pl.stack_stage_params(
            [{'w': t(w), 'b': torch.zeros(6)} for w in d['w']])
        grads, loss = parallel.pipeline_train_1f1b(
            _tanh_affine, _sq_loss_grad, params, t(d['xs']), t(d['ys']),
            ctx22, param_specs={'w': P('pp', None, None), 'b': P('pp', None)},
            data_spec=P('pp', None, 'sp', None),
            target_spec=P(None, None, 'sp', None), loss_axes=('pp', 'sp'))
        out['sp'] = ({k: g._data[0].numpy() for k, g in grads.items()},
                     float(loss), ctx22.coord('pp'))
        if rank >= 2:
            return out
        ctx2 = ShardingContext({'pp': 2}, group=local_group([0, 1]))
        # GPipe backward over two stages
        d = data['grad']
        w = t(np.stack(d['w'])).requires_grad_(True)
        y = parallel.pipeline_apply(_tanh_linear, {'w': w}, t(d['xs']),
                                    ctx2)
        (y._data ** 2).sum().backward()
        out['grad'] = w.grad[rank].numpy()
        out.update(_gluon_cases(data, ctx2))
    return out


@pytest.fixture(scope='module')
def ranks():
    data = _inputs()
    for key, seeds in (('w12', (1, 2)), ('w34', (3, 4)), ('w56', (5, 6))):
        data[key] = [_jax_stage_weights(s)[1] for s in seeds]
    data['w_net'] = _jax_net()[1]
    return data, launch.spawn(_pipe_rank, 4, data, timeout=150)


def _jax_net():
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon import nn as jnn
    jmx.random.seed(7)
    net = jnn.HybridSequential()
    for _ in range(4):
        net.add(jnn.Dense(D, activation='tanh', in_units=D))
    net.initialize()
    net(jmx.np.zeros((MB, D)))
    return net, [{n: p.data().asnumpy().copy()
                  for n, p in layer.collect_params().items()}
                 for layer in net._children.values()]


# -------------------------------------------------------- functional cases
def test_pipeline_matches_sequential(ranks):
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.pipeline import pipeline_apply
    data, got = ranks
    d = data['seq']
    want = d['xs']
    for w in d['w']:
        want = np.tanh(want @ w)
    jp = {'w': jnp.asarray(np.stack(d['w'])), 'b': jnp.zeros((4, 8))}
    jout = np.asarray(pipeline_apply(
        lambda p, x: jnp.tanh(x @ p['w'] + p['b']), jp,
        jnp.asarray(d['xs']), jpar.make_mesh(pp=4)))
    for r in got:
        # each stage holds n_micro / S = 2 interleaved output slots
        assert r['seq_local'] == (2, 3, 8)
        np.testing.assert_allclose(r['seq'], want, **FWD)
        np.testing.assert_allclose(r['seq'], jout, **FWD)


def test_pipeline_grad(ranks):
    import jax
    import jax.numpy as jnp
    data, got = ranks
    d = data['grad']
    xs = jnp.asarray(d['xs'])

    def loss_seq(ws):
        h = xs
        for w in ws:
            h = jnp.tanh(h @ w)
        return jnp.sum(h ** 2)

    g = jax.grad(loss_seq)([jnp.asarray(w) for w in d['w']])
    for k in range(2):
        np.testing.assert_allclose(got[k]['grad'], np.asarray(g[k]), **GRAD)


def test_pipeline_1f1b_grads_match_sequential(ranks):
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.pipeline import (onef1b_stats,
                                             pipeline_train_1f1b)
    data, got = ranks
    d = data['1f1b']
    jp = {'w': jnp.asarray(np.stack(d['w'])), 'b': jnp.zeros((4, 6))}
    jg, jl = pipeline_train_1f1b(
        lambda p, x: jnp.tanh(x @ p['w'] + p['b']),
        lambda y, t: (jnp.sum((y - t) ** 2), 2.0 * (y - t)), jp,
        jnp.asarray(d['xs']), jnp.asarray(d['ys']), jpar.make_mesh(pp=4))
    for k, r in enumerate(got):
        local, loss, gathered = r['1f1b']
        np.testing.assert_allclose(loss, float(jl), rtol=1e-4)
        for key in ('w', 'b'):
            np.testing.assert_allclose(local[key], np.asarray(jg[key][k]),
                                       rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(gathered[key], np.asarray(jg[key]),
                                       rtol=2e-4, atol=2e-5)
    st = onef1b_stats(n_micro=64, n_stages=4)
    from mxnet_tpu_torch.parallel import onef1b_stats as port_stats
    assert port_stats(64, 4) == st


def test_pipeline_1f1b_grads_reduce_over_extra_data_axes(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.pipeline import pipeline_apply
    data, got = ranks
    d = data['sp']
    mesh = jpar.make_mesh(pp=2, sp=2)
    xs, ys = jnp.asarray(d['xs']), jnp.asarray(d['ys'])
    pspecs = {'w': JP('pp', None, None), 'b': JP('pp', None)}
    jp = {'w': jnp.asarray(np.stack(d['w'])), 'b': jnp.zeros((2, 6))}

    def ref_loss(p):
        outs = pipeline_apply(lambda p, x: jnp.tanh(x @ p['w'] + p['b']),
                              p, xs, mesh, param_specs=pspecs,
                              data_spec=JP('pp', None, 'sp', None))
        return jnp.sum((outs - ys) ** 2)

    want_loss, want = jax.value_and_grad(ref_loss)(jp)
    for r in got:
        local, loss, k = r['sp']
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        for key in ('w', 'b'):
            np.testing.assert_allclose(local[key], np.asarray(want[key][k]),
                                       **GRAD)


def test_pipeline_stats_and_divisibility():
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.pipeline import pipeline_stats as jstats
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.sharding import ShardingContext
    s = parallel.pipeline_stats(8, 4)
    assert s == jstats(8, 4)
    assert s['ticks'] == 13
    assert abs(s['bubble_fraction'] - 5 / 13) < 1e-9
    assert abs(s['gpipe_bubble_fraction'] - 3 / 11) < 1e-9
    assert s['feed_microbatches_per_stage'] == 2
    assert parallel.pipeline_stats(4, 1)['ticks'] == 4
    del jpar
    with pytest.raises(ValueError, match='divisible'):
        parallel.pipeline_apply(lambda p, x: x, {'w': torch.zeros((2, 1))},
                                torch.zeros((3, 2, 4)),
                                ShardingContext({'pp': 2}))
    with pytest.raises(ValueError, match='targets'):
        parallel.pipeline_train_1f1b(
            lambda p, x: x, _sq_loss_grad, {'w': torch.zeros((2, 1))},
            torch.zeros((4, 2, 4)), torch.zeros((3, 2, 4)),
            ShardingContext({'pp': 2}))


# ---------------------------------------------------------- Gluon cases
def _jax_trainer(seeds, lr, sched='1f1b'):
    import mxnet_tpu as jmx
    from mxnet_tpu import parallel as jpar
    stages = [_jax_stage_weights(s)[0] for s in seeds]
    tr = jpar.PipelineTrainer(
        stages, jpar.make_mesh(pp=2), example=jmx.np.zeros((MB, D)),
        optimizer='sgd', optimizer_params={'learning_rate': lr},
        schedule=sched)
    return stages, tr


def test_pipeline_trainer_1f1b_meets_the_jax_trainer(ranks):
    import mxnet_tpu as jmx
    data, got = ranks
    stages, tr = _jax_trainer((1, 2), 0.1)
    xs, ys = jmx.np.array(data['gluon_xs']), jmx.np.array(data['gluon_ys'])
    loss = tr.step(xs, ys)
    for k in range(2):
        r = got[k]
        assert r['loss'] == pytest.approx(loss, rel=1e-4)
        for n, p in stages[k].collect_params().items():
            np.testing.assert_allclose(r['grads'][n], p.grad().asnumpy(),
                                       **GRAD)
            np.testing.assert_allclose(r['updated'][n], p.data().asnumpy(),
                                       **GRAD)


def test_pipeline_trainer_loss_decreases(ranks):
    _, got = ranks
    for r in got[:2]:
        assert r['losses'][-1] < r['losses'][0] * 0.8, r['losses']
        assert r['losses'] == got[0]['losses']


def test_pipeline_trainer_gpipe_matches_1f1b(ranks):
    import mxnet_tpu as jmx
    data, got = ranks
    stages, tr = _jax_trainer((5, 6), 0.2, 'gpipe')
    tr.step(jmx.np.array(data['gluon_xs']), jmx.np.array(data['gluon_ys']))
    for k in range(2):
        r = got[k]
        for n, p in stages[k].collect_params().items():
            np.testing.assert_allclose(r['sched_1f1b'][n],
                                       r['sched_gpipe'][n], **GRAD)
            np.testing.assert_allclose(r['sched_gpipe'][n],
                                       p.data().asnumpy(), **GRAD)


def test_split_sequential_and_forward(ranks):
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag
    data, got = ranks
    net, _ = _jax_net()
    for r in got[:2]:
        assert r['fwd_local'] == (2, MB, D)
        for i in range(NMICRO):
            with jag.predict_mode():
                want = net(jmx.np.array(data['gluon_xs'][i])).asnumpy()
            np.testing.assert_allclose(r['fwd'][i], want, **FWD)


def test_pipeline_trainer_rejects_batchnorm_stage():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.sharding import ShardingContext
    with mx.cpu():
        sbn = nn.HybridSequential()
        sbn.add(nn.Dense(D, in_units=D), nn.BatchNorm())
        sbn.initialize(ctx=mx.cpu())
        sbn(mx.np.zeros((MB, D)))
        with pytest.raises(ValueError, match='aux state'):
            parallel.PipelineTrainer([sbn, sbn], ShardingContext({'pp': 2}),
                                     example=mx.np.zeros((MB, D)))
        with pytest.raises(ValueError, match='equal stages'):
            parallel.split_sequential(sbn, 3)
