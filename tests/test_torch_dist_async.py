"""``dist_async`` across processes and under the Gluon Trainer on the CPU,
against the JAX package.

- Two ranks through ``parallel.launch.spawn`` (its loopback server ports):
  the assertions of ``tests/nightly/dist_async_kvstore.py`` (pushes applied
  at once, ``set_optimizer`` on the server, the values after a barrier)
  and of ``tests/nightly/dist_async_faults.py`` (resets after the server
  applied and a seeded lossy link: the fault-free weights, every push
  applied exactly once), each part on servers of its own; then a small
  Dense net trained by both ranks through ``Trainer(kvstore='dist_async',
  update_on_kvstore=True)`` on two servers with its two weight matrices
  split between them: the servers' ``push_applied`` summed is ranks x
  steps x (keys + the split keys' extra chunks), and after a final
  barrier both ranks pull bit-equal weights.
- Tiny BERT trained three steps by one worker through
  ``Trainer(kvstore='dist_async', update_on_kvstore=True)``, against the
  JAX Trainer (losses and weights within 1e-5, the JAX tests' bound for
  one Trainer against another), and bit-equal to the port's
  ``kvstore=None`` Trainer from the same weights: the server runs the
  same update on the same gradient, so the optimizer's per-index state
  must have survived its pickling to the server. The JAX Trainer cannot
  take these settings itself: its ``set_optimizer`` pickles the
  optimizer with its parameters, whose JAX devices do not pickle
  (ROADMAP C11; ``-s -k C11`` prints the error). With one worker the
  server's update is the local one, so the JAX oracle is its Trainer
  without a kvstore.
- ``update_on_kvstore`` left to its default (``None``) or ``False`` on
  ``dist_async``: the JAX Trainer takes it as ``False``
  (``mxnet_tpu/gluon/trainer.py:103``), and then pushes each gradient
  into the server's copy of the weights and pulls that sum back as the
  gradient its local optimizer applies (ROADMAP C10). The port does the
  same, and is held to the JAX Trainer's weights at 1e-5.

The rank workers import nothing of JAX: a ``spawn`` child imports this
module to find them, so JAX is imported inside the tests only.
"""

import os
import socket
from contextlib import closing

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgl, kvstore as tkv
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.kvstore import dist_async, faults
from mxnet_tpu_torch.parallel import launch

TOL = dict(rtol=1e-5, atol=1e-5)
ROUNDS = 6
BATCH, IN, HID, OUT = 8, 6, 16, 4
STEPS = 3
TINY = dict(vocab_size=200, num_layers=2, units=32, hidden_size=64,
            num_heads=4, max_length=32, dropout=0.0, use_classifier=False)


def _free_port():
    with closing(socket.socket()) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _dense_inputs():
    rng = np.random.default_rng(23)
    return dict(x=_randn(rng, BATCH, IN), y=_randn(rng, BATCH, OUT),
                w=[_randn(rng, HID, IN) * 0.3, _randn(rng, HID) * 0.1,
                   _randn(rng, OUT, HID) * 0.3, _randn(rng, OUT) * 0.1])


# ------------------------------------------------------------ two ranks
def _nightly_kvstore(rank, size):
    """tests/nightly/dist_async_kvstore.py's assertions."""
    kv = tkv.create('dist_async')
    assert kv.type == 'dist_async' and kv.num_workers == size
    kv.init('w', torch.zeros(4))
    kv.barrier()
    kv.push('w', torch.ones(4) * (rank + 1))
    kv.barrier()
    want = sum(r + 1.0 for r in range(size))
    np.testing.assert_allclose(kv.pull('w').asnumpy(), np.full(4, want),
                               rtol=1e-6)
    kv.barrier()
    out = torch.zeros(4)
    kv.pushpull('w', torch.ones(4), out=out)
    assert (out.numpy() >= want + 1.0 - 1e-5).all()
    kv.barrier()
    np.testing.assert_allclose(kv.pull('w').asnumpy(),
                               np.full(4, want + size), rtol=1e-6)
    kv2 = tkv.create('dist_async')
    if rank == 0:
        kv2.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5))
    kv2.barrier()
    kv2.init('x', torch.ones(3) * 10.0)
    kv2.barrier()
    kv2.push('x', torch.ones(3))             # w <- w - 0.5 * 1, per push
    kv2.barrier()
    got = kv2.pull('x').asnumpy()
    np.testing.assert_allclose(got, np.full(3, 10.0 - 0.5 * size),
                               rtol=1e-6)
    return dict(got=got, stats=kv.server_health()[0]['counters'])


def _nightly_faults(rank, size):
    """tests/nightly/dist_async_faults.py's assertions."""
    kv = tkv.create('dist_async')
    kv.init('w', torch.zeros(8))
    kv.barrier()
    faults.configure(f'reset_every:push:3;drop:push:0.3:seed={rank}')
    for _ in range(ROUNDS):
        kv.push('w', torch.ones(8) * (rank + 1))
        kv.pull('w')
    kv.barrier()
    injected = faults.injected()
    faults.clear()
    want = ROUNDS * sum(r + 1.0 for r in range(size))
    np.testing.assert_allclose(kv.pull('w').asnumpy(), np.full(8, want),
                               rtol=1e-6)
    health = kv.server_health()[0]
    assert health['counters']['push_applied'] == ROUNDS * size, health
    assert injected['reset'] >= 1, injected
    ts = kv.transport_stats()
    assert ts['retries'] >= 1 and ts['giveups'] == 0, ts
    return dict(injected=injected, transport=ts)


def _dense_net(mx, gl, weights):
    net = gl.nn.HybridSequential()
    net.add(gl.nn.Dense(HID, in_units=IN, activation='tanh'),
            gl.nn.Dense(OUT, in_units=HID))
    net.initialize()
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(mx.np.array(w))
    return net


def _async_trainer(rank, size, dense):
    """Both ranks train the Dense net on their halves of the batch, two
    servers, the weight matrices (16 x 6 and 4 x 16 fp32, 384 and 256
    bytes) split between them by a 256-byte bound."""
    net = _dense_net(tmx, tgl, dense['w'])
    half = BATCH // size
    x = tmx.np.array(dense['x'][rank * half:(rank + 1) * half])
    y = tmx.np.array(dense['y'][rank * half:(rank + 1) * half])
    tr = tgl.Trainer(net.collect_params(), 'adam', {'learning_rate': 0.01},
                     kvstore='dist_async', update_on_kvstore=True)
    losses = []
    for _ in range(STEPS):
        with tmx.autograd.record():
            loss = ((net(x) - y) ** 2).sum()
        loss.backward()
        tr.step(half)
        losses.append(float(loss.asnumpy()))
    kv = tr._kvstore
    kv.barrier()
    params = list(net.collect_params().values())
    for i, p in enumerate(params):
        kv.pull(i, out=p.data()._data)
    health = kv.server_health()
    return dict(losses=losses, weights=[p.data().asnumpy() for p in params],
                applied=sum(h['counters']['push_applied']
                            for h in health.values()),
                layout=kv.server_stats())


def _ranks(base, dense):
    import torch.distributed as dist
    rank, size = dist.get_rank(), dist.get_world_size()
    out = {}
    with tmx.cpu():
        for part, (name, fn, env) in enumerate((
                ('nightly', _nightly_kvstore, {}),
                ('faults', _nightly_faults,
                 {'MXNET_KVSTORE_RPC_BACKOFF_S': '0.01'}),
                ('trainer', lambda r, s: _async_trainer(r, s, dense),
                 {'MXNET_KVSTORE_NUM_SERVERS': '2',
                  'MXNET_KVSTORE_BIGARRAY_BOUND': '256'}))):
            os.environ['MXNET_KVSTORE_ASYNC_PORT'] = str(base + 2 * part)
            os.environ.update(env)
            out[name] = fn(rank, size)
    return out


@pytest.fixture(scope='module')
def two_ranks():
    dense = _dense_inputs()
    base = launch.free_ports(6)
    return launch.spawn(_ranks, 2, base, dense, timeout=120), dense


@pytest.mark.timeout(120)
def test_nightly_dist_async_kvstore_assertions_on_two_ranks(two_ranks):
    ranks, _ = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r['nightly']['got'], [9.0] * 3)
    assert ranks[0]['nightly']['stats']['push_applied'] == 2 * 3


@pytest.mark.timeout(120)
def test_nightly_dist_async_faults_on_two_ranks(two_ranks):
    ranks, _ = two_ranks
    for r in ranks:
        assert r['faults']['injected']['reset'] >= 1
        assert r['faults']['transport']['retries'] >= 1


@pytest.mark.timeout(120)
def test_two_workers_train_through_two_servers(two_ranks):
    """Every push of both workers applied once (4 keys + the split
    keys' second chunks, a step, a worker), each split key's two chunks
    one a server, and the weights pulled after the barrier bit-equal."""
    ranks, _ = two_ranks
    for r in ranks:
        assert r['trainer']['applied'] == 2 * STEPS * (4 + 2)
        layout = r['trainer']['layout']
        assert sorted(layout[0] + layout[1]) == ['0#c0', '0#c1', '1',
                                                 '2#c0', '2#c1', '3']
        assert {'0#c0', '2#c0'} <= set(layout[0])
        assert {'0#c1', '2#c1'} <= set(layout[1])
        assert all(np.isfinite(r['trainer']['losses']))
    for a, b in zip(ranks[0]['trainer']['weights'],
                    ranks[1]['trainer']['weights']):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ one worker
def _one_worker(monkeypatch):
    monkeypatch.setenv('MX_COORDINATOR', f'127.0.0.1:{_free_port()}')
    monkeypatch.setenv('MXNET_KVSTORE_ASYNC_PORT', str(_free_port()))
    monkeypatch.setenv('MXNET_KVSTORE_HEARTBEAT_S', '3600')
    monkeypatch.setenv('MX_PROC_ID', '0')
    monkeypatch.setenv('MX_NPROC', '1')


def _stop_servers(*modules):
    for module in modules:
        for port in list(module._SERVERS):
            module._SERVERS.pop(port).stop()


def _bert_inputs():
    rng = np.random.default_rng(29)
    ids = rng.integers(0, 200, (4, 12)).astype(np.int32)
    return dict(ids=ids, tt=np.zeros_like(ids),
                labels=rng.integers(0, 200, (4, 12)).astype(np.int32))


def _bert_run(mx, gl, bert_mod, batch, weights, kvstore, on_kv):
    net = bert_mod.get_bert_model('bert_12_768_12', **TINY)
    net.initialize()
    ids, tt, labels = (mx.np.array(batch[k]) for k in ('ids', 'tt',
                                                       'labels'))
    net(ids, tt)
    if weights is None:
        weights = {k: p.data().asnumpy()
                   for k, p in net.collect_params().items()}
    for k, p in net.collect_params().items():
        p.set_data(mx.np.array(weights[k]))
    net.hybridize()
    tr = gl.Trainer(net.collect_params(), 'adam', {'learning_rate': 1e-3},
                    kvstore=kvstore, update_on_kvstore=on_kv)
    loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(STEPS):
        with mx.autograd.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).sum()
        loss.backward()
        tr.step(4)
        losses.append(float(loss.asnumpy()))
    return weights, {k: p.data().asnumpy()
                     for k, p in net.collect_params().items()}, losses


def test_one_worker_trains_tiny_bert_as_the_jax_trainer(monkeypatch):
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    from mxnet_tpu.kvstore import dist_async as jda
    batch = _bert_inputs()
    try:
        init, want, jl = _bert_run(jmx, jgl, jbert, batch, None, None,
                                   None)
        _one_worker(monkeypatch)
        _, got, tl = _bert_run(tmx, tgl, tbert, batch, init, 'dist_async',
                               True)
        _, local, ll = _bert_run(tmx, tgl, tbert, batch, init, None, None)
    finally:
        _stop_servers(dist_async, jda)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # the server's update is the local Trainer's, bit for bit
    assert tl == ll
    for k in local:
        np.testing.assert_array_equal(got[k], local[k], err_msg=k)
    assert any(not np.array_equal(got[k], init[k]) for k in got)


def test_C11_jax_dist_async_trainer_cannot_send_its_optimizer(monkeypatch):
    """ROADMAP C11: the JAX ``Trainer(kvstore='dist_async',
    update_on_kvstore=True)`` fails at its first step, where
    ``set_optimizer`` pickles the optimizer with its ``param_dict``; the
    port's optimizer leaves its parameters behind."""
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    from mxnet_tpu.kvstore import dist_async as jda
    dense = _dense_inputs()
    try:
        _one_worker(monkeypatch)
        with pytest.raises(TypeError, match='pickle') as ei:
            _dense_run(jmx, jgl, dense, True)
        _one_worker(monkeypatch)
        _, got = _dense_run(tmx, tgl, dense, True)
    finally:
        _stop_servers(dist_async, jda)
    print(f'C11: the JAX Trainer raises {ei.value!r}')
    assert all(np.isfinite(w).all() for w in got)


def _dense_run(mx, gl, dense, on_kv):
    net = _dense_net(mx, gl, dense['w'])
    tr = gl.Trainer(net.collect_params(), 'sgd',
                    {'learning_rate': 0.05, 'momentum': 0.9},
                    kvstore='dist_async', update_on_kvstore=on_kv)
    x, y = mx.np.array(dense['x']), mx.np.array(dense['y'])
    for _ in range(2):
        with mx.autograd.record():
            loss = ((net(x) - y) ** 2).sum()
        loss.backward()
        tr.step(BATCH)
    return tr, [p.data().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize('on_kv', [None, False])
def test_update_on_kvstore_default_follows_the_jax_trainer(monkeypatch,
                                                          on_kv):
    """``None`` and ``False`` on ``dist_async``: no optimizer on the
    server, each gradient pushed into its copy of the weights and the sum
    pulled back as the gradient, as the JAX Trainer does."""
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgl
    from mxnet_tpu.kvstore import dist_async as jda
    dense = _dense_inputs()
    try:
        _one_worker(monkeypatch)
        jtr, want = _dense_run(jmx, jgl, dense, on_kv)
        _one_worker(monkeypatch)
        ttr, got = _dense_run(tmx, tgl, dense, on_kv)
        applied = ttr._kvstore.server_health()[0]['counters']
    finally:
        _stop_servers(dist_async, jda)
    assert ttr._update_on_kvstore is jtr._update_on_kvstore is False
    assert applied['push_applied'] == 2 * 4 and applied['init_applied'] == 4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_the_pickled_optimizer_carries_no_tensor_and_keeps_mults():
    """What ``set_optimizer`` sends: no parameter, no tensor, each
    parameter's ``lr_mult``/``wd_mult`` by index, the counts as they
    are."""
    import pickle
    net = _dense_net(tmx, tgl, _dense_inputs()['w'])
    params = net.collect_params()
    list(params.values())[1].lr_mult = 0.5
    tr = tgl.Trainer(params, 'adam', {'learning_rate': 0.01})
    opt = tr.optimizer
    opt._index_update_count = {0: 3}
    blob = pickle.dumps(opt)
    back = pickle.loads(blob)
    assert back.param_dict == {}
    assert not any(torch.is_tensor(v) for v in vars(back).values())
    assert back._get_lr(1) == pytest.approx(0.005)
    assert back._get_lr(0) == pytest.approx(0.01)
    assert back._index_update_count == {0: 3}


def test_launches_tally_by_stream():
    """What a graph capture takes back is the tally of its own stream: a
    launch counted on another stream (a server thread's) stays out of it,
    and every launch is counted on the wrapper's counters."""
    from types import SimpleNamespace
    from mxnet_tpu_torch.ops.kernels import _build, fused_optimizer as fo
    before = (fo.adam_step.launches, fo.sgd_mom_step.plain_updates)
    with _build.tally(SimpleNamespace(cuda_stream=7)) as mine:
        _build.count(fo.adam_step, stream=7)
        _build.count(fo.adam_step, stream=8)
        _build.count(fo.sgd_mom_step, stream=7, plain=True)
        _build.count(fo.adam_step, torch.device('cpu'))
    _build.count(fo.adam_step, stream=7)
    assert mine == {(fo.adam_step, None, False): 1,
                    (fo.sgd_mom_step, None, True): 1}
    assert (fo.adam_step.launches, fo.sgd_mom_step.plain_updates) == (
        before[0] + 4, before[1] + 1)
    assert not _build._tallies


def test_profile_check_names_each_port_kernel():
    """``chip_smoke.py`` holds each profiler event to the port kernel whose
    launch counter it must match: by symbol, flash attention's two forms
    by their Stats template argument, other kernels to none."""
    import chip_smoke
    name = 'void (anonymous namespace)::{}'
    cases = {'flash_fwd_kernel<float, 64, false>(float const*)':
             'flash_attention',
             'flash_fwd_kernel<__nv_bfloat16, 128, true>(float*)':
             'flash_attention_stats',
             'fused_norm_cluster_kernel<float, float, 8, 32, 4>(float)':
             'fused_norm',
             'adam_kernel(float*, float const*)': 'adam',
             'sgd_mom_kernel(float*)': 'sgd_mom',
             'int8_wgmma_kernel<128, 2, true>(CUtensorMap)': 'int8_matmul',
             'paged_decode_kernel<float, 128, 4>(float const*)':
             'paged_attention_decode'}
    for key, kernel in cases.items():
        assert chip_smoke._kernel_of(name.format(key)) == kernel, key
    assert chip_smoke._kernel_of('ampere_sgemm_128x64_nn') is None
    assert chip_smoke._kernel_of(
        'void at::native::vectorized_elementwise_kernel<4>(int)') is None
