"""The port's Trainer state against the JAX Trainer, on the CPU.

The device vectors of a step (each live parameter's ``lr``, ``wd`` and
update count ``t``) are held to the JAX Trainer's ``_hyper_cache`` and
``_t_cache`` under a ``FactorScheduler`` and per-parameter
``lr_mult``/``wd_mult``, step by step, with the weights at 1e-5, eagerly
and through the emulated update graph (``_graphs.emulated``: a schedule
must change the update of a replayed graph). ``save_states`` files cross
between the packages both ways: the next step equals the uninterrupted
JAX run, and a load writes the port's slots in place.
"""

import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgl, lr_scheduler as jlrs
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _graphs, gluon as tgl, lr_scheduler as tlrs

TOL = dict(rtol=1e-5, atol=1e-5)
OPTS = {'adam': {'learning_rate': 0.01, 'wd': 1e-2},
        'sgd': {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-2}}


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype('f')


def _net(mx, nn, weights=None):
    net = nn.HybridSequential(nn.Dense(6, in_units=4), nn.Dense(3,
                                                                in_units=6))
    net.initialize()
    params = net.collect_params()
    params['0.weight'].lr_mult = 0.5
    params['1.bias'].wd_mult = 0.0
    params['1.weight'].lr_mult, params['1.weight'].wd_mult = 2.0, 3.0
    for k, (name, p) in enumerate(params.items()):
        p.set_data(_x(p.shape, k) * 0.5 if weights is None
                   else weights[name])
    net.hybridize()
    return net


def _trainer(mx, gl, lrs, net, opt):
    kwargs = dict(OPTS[opt], lr_scheduler=lrs.FactorScheduler(
        step=2, factor=0.5))
    return gl.Trainer(net.collect_params(), opt, kwargs)


def _step(mx, net, tr, i):
    with mx.autograd.record():
        loss = (net(mx.np.array(_x((5, 4), 50 + i))) ** 2).mean()
    loss.backward()
    tr.step(1)
    return float(loss.asnumpy())


def _weights(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


@pytest.mark.parametrize('graphs', ['eager', 'emulated'])
@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_device_vectors_match_the_jax_trainer(opt, graphs):
    jnet = _net(jmx, jgl.nn)
    tnet = _net(tmx, tgl.nn, _weights(jnet))
    jtr = _trainer(jmx, jgl, jlrs, jnet, opt)
    ttr = _trainer(tmx, tgl, tlrs, tnet, opt)
    with _graphs.emulated() if graphs == 'emulated' else \
            contextlib.nullcontext():
        for i in range(4):
            jl, tl = _step(jmx, jnet, jtr, i), _step(tmx, tnet, ttr, i)
            np.testing.assert_allclose(tl, jl, **TOL)
            (vec,) = ttr._vectors.values()
            (_, lrs, wds), (ts_vals, ts) = jtr._hyper_cache, jtr._t_cache
            np.testing.assert_array_equal(vec.hyper[:, 0].numpy(),
                                          np.asarray(lrs))
            np.testing.assert_array_equal(vec.hyper[:, 1].numpy(),
                                          np.asarray(wds))
            np.testing.assert_array_equal(vec.ts.numpy(), np.asarray(ts))
            assert vec.t_vals == ts_vals == (i + 1,) * 4
            for name, w in _weights(jnet).items():
                np.testing.assert_allclose(_weights(tnet)[name], w, **TOL,
                                           err_msg=name)
    # the schedule moved lr as the JAX one did
    assert ttr.learning_rate == jtr.learning_rate < \
        OPTS[opt]['learning_rate']
    assert ttr.capture_count == (1 if graphs == 'emulated' else 0)


def _slots(tr):
    return [t for st in tr._states.values()
            for t in (st if isinstance(st, tuple) else (st,))]


@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_states_cross_between_the_packages(opt, tmp_path):
    """JAX trains two steps and saves; the port loads them into slots it
    already has (in place) and takes the third step, equal to the
    uninterrupted JAX run's. Then the reverse: the port saves after its
    third step, a fresh JAX trainer loads, and its fourth step equals the
    uninterrupted run's."""
    jnet = _net(jmx, jgl.nn)
    jtr = _trainer(jmx, jgl, jlrs, jnet, opt)
    for i in range(2):
        _step(jmx, jnet, jtr, i)
    jtr.save_states(str(tmp_path / 'jax.states'))
    mid = _weights(jnet)

    tnet = _net(tmx, tgl.nn, mid)
    ttr = _trainer(tmx, tgl, tlrs, tnet, opt)
    with _graphs.emulated():
        _step(tmx, tnet, ttr, 7)            # slots of its own first
        ptrs = [t.data_ptr() for t in _slots(ttr)]
        ttr.load_states(str(tmp_path / 'jax.states'))
        assert [t.data_ptr() for t in _slots(ttr)] == ptrs
        tnet.load_dict(mid)
        _step(jmx, jnet, jtr, 2)
        _step(tmx, tnet, ttr, 2)
    schedule = dict(jtr._optimizer.lr_scheduler.__dict__)
    for name, w in _weights(jnet).items():
        np.testing.assert_allclose(_weights(tnet)[name], w, **TOL,
                                   err_msg=name)
    assert ttr.optimizer._index_update_count == \
        jtr._optimizer._index_update_count
    assert ttr.optimizer.num_update == jtr._optimizer.num_update == 3

    ttr.save_states(str(tmp_path / 'port.states'))
    jnet2 = _net(jmx, jgl.nn, _weights(tnet))
    jtr2 = _trainer(jmx, jgl, jlrs, jnet2, opt)
    jtr2.load_states(str(tmp_path / 'port.states'))
    _step(jmx, jnet, jtr, 3)
    _step(jmx, jnet2, jtr2, 3)
    for name, w in _weights(jnet).items():
        np.testing.assert_allclose(_weights(jnet2)[name], w, **TOL,
                                   err_msg=name)
    assert ttr.state_dict()['lr_scheduler'] == schedule


def test_legacy_states_tuple_and_a_state_dict_round_trip(tmp_path):
    import pickle
    net = _net(tmx, tgl.nn)
    tr = _trainer(tmx, tgl, tlrs, net, 'adam')
    _step(tmx, net, tr, 0)
    sd = tr.state_dict()
    with open(tmp_path / 'legacy', 'wb') as f:
        pickle.dump((sd['states'], 5), f)
    tr.load_states(str(tmp_path / 'legacy'))
    assert tr.optimizer.num_update == 5
    for a, b in zip(_slots(tr), [t for st in sd['states'].values()
                                 for t in st]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(sd['states'][0][0], np.ndarray)
    assert torch.is_tensor(_slots(tr)[0])
