"""The port's expert-parallel MoE (``parallel.moe``) against the JAX package,
on the CPU.

The cases of ``tests/test_parallel.py`` at their sizes and seeds:

* ``T 32, D 8, F 16, E 8`` over ep = 4: the output meets the JAX
  ``moe_ffn`` on four virtual devices, and (as the JAX test holds its own)
  each rank's tokens run through ep = 1 in one process, which pins the
  exchange's round trip; the auxiliary loss is the JAX one, averaged over
  ``'ep'``;
* ``T 32, D 4, F 8, E 4`` over ep = 4: the gradients of ``mean(y ** 2) +
  0.01 * aux`` with respect to the experts and the router are finite, not
  all zero, and the JAX ``jax.grad``'s (each rank's loss is its share of
  the global one: its tokens' squares over the global count, and the
  auxiliary term over ep; the router's gradient sums over the ranks);
* ``top2_gating`` and the capacity rule alone, against the JAX function.

Tolerances: rtol 1e-5 / atol 1e-6 (the JAX test's own). One
``parallel.launch.spawn`` of four gloo ranks; the rank worker imports
nothing of JAX.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.parallel import launch

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs():
    out = {}
    np.random.seed(3)
    T, D, F, E = 32, 8, 16, 8
    out['fwd'] = dict(x=np.random.randn(T, D).astype('f'),
                      wg=np.random.randn(D, E).astype('f') * 0.1,
                      w_in=np.random.randn(E, D, F).astype('f') * 0.2,
                      w_out=np.random.randn(E, F, D).astype('f') * 0.2)
    np.random.seed(4)
    T, D, F, E = 32, 4, 8, 4
    out['grad'] = dict(x=np.random.randn(T, D).astype('f'),
                       wg=np.random.randn(D, E).astype('f') * 0.1,
                       w_in=np.random.randn(E, D, F).astype('f') * 0.2,
                       w_out=np.random.randn(E, F, D).astype('f') * 0.2)
    return out


def _moe_rank(data):
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.kvstore.fusion import CrossProcess
    from mxnet_tpu_torch.sharding import ShardingContext
    from mxnet_tpu_torch.sharding.context import local_group
    t = torch.from_numpy
    out = {}
    ctx = ShardingContext({'ep': 4}, group=local_group([0, 1, 2, 3]))
    with mx.cpu():
        d = data['fwd']
        y, aux = parallel.moe_ffn(t(d['x']), t(d['wg']), t(d['w_in']),
                                  t(d['w_out']), ctx)
        out['local'] = tuple(y._data.shape)
        out['y'] = y.asnumpy()
        out['aux'] = float(aux)
        d = data['grad']
        ws = {k: t(d[k]).requires_grad_(True)
              for k in ('wg', 'w_in', 'w_out')}
        y, aux = parallel.moe_ffn(t(d['x']), ws['wg'], ws['w_in'],
                                  ws['w_out'], ctx)
        n = d['x'].size
        loss = (y._data ** 2).sum() / n + 0.01 * aux / 4
        loss.backward()
        g = {k: v.grad for k, v in ws.items()}
        comm = CrossProcess.get(ctx.group('ep'))
        g['wg'] = comm.psum(g['wg'].reshape(-1).clone()).view(
            g['wg'].shape)
        out['grads'] = {k: v.numpy() for k, v in g.items()}
    return out


@pytest.fixture(scope='module')
def ranks():
    data = _inputs()
    return data, launch.spawn(_moe_rank, 4, data, timeout=120)


def test_moe_expert_parallel(ranks):
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.moe import moe_ffn as jmoe
    from mxnet_tpu_torch import parallel
    data, got = ranks
    d = data['fwd']
    jy, jaux = jmoe(*(jnp.asarray(d[k]) for k in ('x', 'wg', 'w_in',
                                                  'w_out')),
                    jpar.make_mesh(ep=4))
    # each token shard through ep = 1, in this process
    one = []
    for i in range(4):
        yi, _ = parallel.moe_ffn(torch.from_numpy(d['x'][i * 8:(i + 1) * 8]),
                                 *(torch.from_numpy(d[k])
                                   for k in ('wg', 'w_in', 'w_out')), None)
        one.append(yi.asnumpy())
    one = np.concatenate(one)
    for r in got:
        assert r['local'] == (8, 8)
        assert np.isfinite(r['y']).all() and r['aux'] > 0
        np.testing.assert_allclose(r['y'], one, **TOL)
        np.testing.assert_allclose(r['y'], np.asarray(jy), **TOL)
        np.testing.assert_allclose(r['aux'], float(jaux), **TOL)


def test_moe_grads_finite_and_meet_jax(ranks):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.parallel.moe import moe_ffn as jmoe
    data, got = ranks
    d = data['grad']
    mesh = jpar.make_mesh(ep=4)
    x = jnp.asarray(d['x'])

    def loss(w_in, w_out, wg):
        y, aux = jmoe(x, wg, w_in, w_out, mesh)
        return jnp.mean(y ** 2) + 0.01 * aux

    g = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(d['w_in']), jnp.asarray(d['w_out']),
        jnp.asarray(d['wg']))
    want = dict(zip(('w_in', 'w_out', 'wg'), (np.asarray(a) for a in g)))
    full = {k: sum(r['grads'][k] for r in got) for k in ('w_in', 'w_out')}
    full['wg'] = got[0]['grads']['wg']
    for k, v in full.items():
        assert np.isfinite(v).all() and np.abs(v).sum() > 0
        np.testing.assert_allclose(v, want[k], **TOL)


def test_top2_gating_and_capacity_meet_jax():
    import jax.numpy as jnp
    from mxnet_tpu.parallel.moe import top2_gating as jgate
    from mxnet_tpu_torch.parallel import moe
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((20, 4)).astype('f')
    C = moe.capacity(20, 4)
    assert C == int(1.25 * 20 * 2 / 4) + 1
    got = moe.top2_gating(torch.from_numpy(logits), C)
    want = jgate(jnp.asarray(logits), C)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
