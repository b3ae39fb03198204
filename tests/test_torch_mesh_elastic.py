"""Host-failure-tolerant FSDP training of the port (``MeshElasticTrainer``)
against its own planned scale-down and the JAX package, on the CPU.

The cases of ``tests/test_mesh_elastic.py``, with processes where the JAX
test has threads: four gloo ranks (``parallel.launch.spawn``), one a host
(``MeshGroup(4, devices=[0, 1, 2, 3])``), each with its own ``dist_async``
store on rank 0's server, train ``Dense(48, in_units=8)`` with SGD at lr 0.1
for four steps under FSDP, and hosts die on exact count-based fault rules:

* rank 3 at its fifth ``elastic_barrier`` send (the barrier before step 2,
  steps 0 and 1 committed): the survivors eject it within
  ``MXNET_KVSTORE_DEADLINE_S``, re-form on three ranks at the committed
  step and finish; bit-equal to the planned scale-down (four ranks to
  step 1, a checkpoint, three ranks from it);
* rank 3, then rank 2 at its tenth send (the barrier before step 3 on the
  re-formed mesh): two re-formations, bit-equal to four ranks to step 1,
  three to step 2, two to the end;
* rank 3 inside the second collective of step 2: the survivors' gloo
  collective fails or, waiting on a live peer, is given up when the mesh
  generation moves; they re-form as after the first death, bit-equal;
* ``MXNET_ELASTIC_MIN_WORKERS=4``: every survivor raises ``ElasticHalted``.

The planned scale-down itself meets the JAX package's Dense trained on the
whole batch by its Trainer from the same weights at rtol 1e-6 (a sharded
step sums its gradients in another order). The checkpoint repair's witness:
with world rank 0 gone, ranks 1-3 commit through a group of their own.

The six runs go three at a time, in threads, each in its own world; the
rank workers import nothing of JAX (a ``spawn`` child imports this
module).
"""

import os
import threading

import numpy as np
import pytest

from mxnet_tpu_torch.parallel import launch

N_STEPS = 4
LR = 0.1
BATCH = 24
ENV = {'MXNET_KVSTORE_DEADLINE_S': '5', 'MXNET_KVSTORE_HEARTBEAT_S': '0.2'}


def _init():
    rng = np.random.default_rng(5)
    return {'weight': (rng.standard_normal((48, 8)) * 0.3).astype('f'),
            'bias': (rng.standard_normal(48) * 0.1).astype('f')}


def _data(s):
    return (np.random.RandomState(s).randn(BATCH, 8).astype('f'),
            np.random.RandomState(1000 + s).randn(BATCH, 48).astype('f'))


def _one_step(mx, net, tr, s):
    from mxnet_tpu_torch import autograd
    x, y = _data(s)
    with autograd.record():
        loss = ((net(mx.np.array(x)) - mx.np.array(y)) ** 2).mean()
    loss.backward()
    tr.step(BATCH)


def _build(ctx):
    """The ``build(ctx)`` contract: parameters placed on the mesh by a
    warm-up step, then set back to the initial values (the sharded
    ``set_data`` keeps the placement), and a Trainer that has not
    stepped."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    del ctx
    init = _init()
    net = gluon.nn.Dense(48, in_units=8)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    params = dict(net.collect_params())
    tr = gluon.Trainer(params, 'sgd', {'learning_rate': LR})
    _one_step(mx, net, tr, 0)
    for n, p in params.items():
        p.set_data(init[n])
    tr = gluon.Trainer(params, 'sgd', {'learning_rate': LR})
    return {'params': params, 'trainer': tr,
            'step': lambda s: _one_step(mx, net, tr, s)}


def _setup():
    import torch
    torch.set_num_threads(1)
    os.environ.update(ENV)


def _pod_rank(spec, ckpt, min_workers, kill_in_step):
    """One rank of a faulted pod run; returns what the tests read (None
    for a rank that died)."""
    _setup()
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.kvstore import faults
    from mxnet_tpu_torch.sharding.context import MeshGroup
    from mxnet_tpu_torch.train import ElasticHalted, MeshElasticTrainer
    rank = dist.get_rank()

    def build(ctx):
        st = _build(ctx)
        step = st['step']

        def run(s):
            if kill_in_step is not None and s == kill_in_step[0] and \
                    rank == kill_in_step[1]:
                # the step's first collective passes, its second kills
                faults.configure(f'kill_host:collective:2:rank={rank}')
            step(s)
        st['step'] = run
        return st

    with mx.cpu():
        store = kvstore.create('dist_async', device='cpu')
        if spec:
            faults.configure(spec)
        d = MeshElasticTrainer(store, MeshGroup(4, devices=[0, 1, 2, 3]),
                               build, ckpt, min_workers=min_workers,
                               name='pod')
        dist.barrier()
        try:
            done = d.run(N_STEPS)
        except faults.InjectedHostDeath:
            launch.die()
        except ElasticHalted as e:
            return {'halted': str(e)}
        out = {'done': done, 'committed': d.committed,
               'group': d.group.describe(), 'table': store.mesh_table(),
               'timings': d.timings,
               'local': {n: tuple(p.data()._data.shape)
                         for n, p in d.state['params'].items()},
               'weights': {n: p.data().asnumpy()
                           for n, p in d.state['params'].items()}}
        d.close()
        return out


def _planned_rank(ckpt):
    """The planned scale-down, every rank in one world: four ranks train
    to step 1 and save; ranks 0-2 restore it in a group of their own and
    train step 2, save, and step 3 (weights ``three``); ranks 0-1 restore
    step 2 and train step 3 (weights ``two``)."""
    _setup()
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.checkpoint import SharedCheckpointManager
    from mxnet_tpu_torch.sharding.context import (MeshGroup, local_group,
                                                  use)
    from mxnet_tpu_torch.train import ElasticTrainer
    rank = dist.get_rank()
    out = {}

    def formation(live, start, stop, save_at=None):
        g = MeshGroup(4, devices=[0, 1, 2, 3], live=live)
        ctx = g.context(group=local_group(g.live_devices()))
        with mx.cpu(), use(ctx):
            st = _build(ctx)
            et = ElasticTrainer(st['params'], st['trainer'],
                                SharedCheckpointManager(ckpt),
                                name=f'plan{len(live)}', async_save=False)
            restored = et.restore(start - 1) if start else -1
            for s in range(start, stop):
                st['step'](s)
                if s == save_at:
                    et.save(s, block=True)
            w = {n: p.data().asnumpy() for n, p in st['params'].items()}
            et.close()
        return restored, w

    out['four'] = formation([0, 1, 2, 3], 0, 2, save_at=1)
    if rank < 3:
        out['three'] = formation([0, 1, 2], 2, 4, save_at=2)
    if rank < 2:
        out['two'] = formation([0, 1], 3, 4)
    return out


def _witness_rank(ckpt):
    """World rank 0 is gone; ranks 1-3 save and commit through a group
    of their own, with world rank 1 as the primary."""
    _setup()
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel.checkpoint import SharedCheckpointManager
    from mxnet_tpu_torch.sharding.context import local_group
    rank = dist.get_rank()
    if rank == 0:
        launch.die()
    g = local_group([1, 2, 3])
    mgr = SharedCheckpointManager(ckpt, group=g)
    mgr.save(7, {'w': torch.arange(6.0) * rank,
                 'step': torch.tensor(7)})
    return {'group_rank': dist.get_rank(g), 'latest': mgr.latest_step()}


RUNS = {
    'single': ('kill_host:elastic_barrier:5:rank=3', None, None),
    'double': ('kill_host:elastic_barrier:5:rank=3;'
               'kill_host:elastic_barrier:10:rank=2', None, None),
    'halt': ('kill_host:elastic_barrier:5:rank=3', 4, None),
    'collective': ('', None, (2, 3)),
}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('pod')
    out, errors = {}, {}

    def go(key, fn, *args):
        try:
            out[key] = launch.spawn(fn, 4, *args, timeout=150,
                                    may_die=True)
        except BaseException as e:       # reported by the test that reads it
            errors[key] = e

    jobs = [(k, _pod_rank, spec, str(root / k), mw, kill)
            for k, (spec, mw, kill) in RUNS.items()]
    jobs += [('planned', _planned_rank, str(root / 'planned')),
             ('witness', _witness_rank, str(root / 'witness'))]
    # three worlds at a time: twelve ranks on the host's cores keep every
    # heartbeat well inside the deadline
    for i in range(0, len(jobs), 3):
        ts = [threading.Thread(target=go, args=j) for j in jobs[i:i + 3]]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return out, errors, root


def _get(runs, key):
    out, errors, _ = runs
    if key in errors:
        raise errors[key]
    return out[key]


def _survivors(ranks, n):
    assert ranks[n:] == [None] * (4 - n), 'the killed ranks did not die'
    return ranks[:n]


def _bit_equal(got, want):
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_mesh_group_host_of_and_formation_context():
    from mxnet_tpu_torch.sharding.context import MeshGroup
    g = MeshGroup(2, devices=[0, 1, 2, 3])
    assert [g.host_of(d) for d in range(4)] == [0, 0, 1, 1]
    g1 = g.eject(1)
    assert g1.live_devices() == [0, 1] and g1.generation == 1
    assert g1.context().axis_sizes == {'dp': 2}


def test_single_death_reforms_bit_exact(runs):
    ranks = _survivors(_get(runs, 'single'), 3)
    planned = _get(runs, 'planned')
    assert ranks[0]['committed'] == N_STEPS - 1   # the leader's commit
    for r in ranks:
        assert r['done'] == N_STEPS
        assert r['group']['live'] == [0, 1, 2]
        # four joins and one ejection, mirrored in every survivor
        assert r['table'] == {'gen': 5, 'members': [0, 1, 2]}
        assert r['group']['generation'] == 5
        assert r['local']['weight'] == (16, 8)     # re-sharded on three
        assert len(r['timings']) == 1
        _bit_equal(r['weights'], planned[0]['three'][1])


def test_double_death_converges(runs):
    ranks = _survivors(_get(runs, 'double'), 2)
    planned = _get(runs, 'planned')
    assert ranks[0]['committed'] == N_STEPS - 1
    for r in ranks:
        assert r['done'] == N_STEPS
        assert r['group']['live'] == [0, 1]
        # four joins and two ejections
        assert r['table'] == {'gen': 6, 'members': [0, 1]}
        assert r['local']['weight'] == (24, 8)
        assert len(r['timings']) == 2
        _bit_equal(r['weights'], planned[0]['two'][1])


def test_below_min_workers_halts_typed(runs):
    ranks = _survivors(_get(runs, 'halt'), 3)
    for r in ranks:
        assert 'MXNET_ELASTIC_MIN_WORKERS=4' in r['halted']


def test_death_inside_a_collective_reforms_bit_exact(runs):
    ranks = _survivors(_get(runs, 'collective'), 3)
    planned = _get(runs, 'planned')
    assert ranks[0]['committed'] == N_STEPS - 1
    for r in ranks:
        assert r['done'] == N_STEPS
        assert r['group']['live'] == [0, 1, 2]
        # at least the ejection's bump past the four joins (each rank that
        # saw the collective fail bumped once more)
        assert r['table']['members'] == [0, 1, 2]
        assert r['table']['gen'] >= 5
        assert r['local']['weight'] == (16, 8)
        # the re-formation waited for the ejection (the deadline), not
        # for the collective's own 600 s timeout
        t = r['timings'][0]
        assert sum(t.values()) < 60, t
        _bit_equal(r['weights'], planned[0]['three'][1])


def test_planned_scale_down_matches_the_jax_trainer(runs):
    """The planned run restored what it saved (steps 1 and 2), and its
    weights meet the JAX Dense trained on the whole batch (rtol 1e-6)."""
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag, gluon as jgl
    planned = _get(runs, 'planned')
    assert [r['three'][0] for r in planned[:3]] == [1, 1, 1]
    assert [r['two'][0] for r in planned[:2]] == [2, 2]
    init = _init()
    net = jgl.nn.Dense(48, in_units=8)
    net.initialize()
    for n, p in net.collect_params().items():
        p.set_data(jmx.np.array(init[n]))
    tr = jgl.Trainer(net.collect_params(), 'sgd', {'learning_rate': LR})
    want = {}
    for s in range(N_STEPS):
        x, y = _data(s)
        with jag.record():
            loss = ((net(jmx.np.array(x)) - jmx.np.array(y)) ** 2).mean()
        loss.backward()
        tr.step(BATCH)
        if s == 1:
            want['four'] = {n: p.data().asnumpy().copy()
                            for n, p in net.collect_params().items()}
    want['end'] = {n: p.data().asnumpy()
                   for n, p in net.collect_params().items()}
    for r in planned:
        for n in init:
            np.testing.assert_allclose(r['four'][1][n], want['four'][n],
                                       rtol=1e-6, atol=1e-7)
    for r in planned[:3]:
        for n in init:
            np.testing.assert_allclose(r['three'][1][n], want['end'][n],
                                       rtol=1e-6, atol=1e-7)
    for r in planned[:2]:
        for n in init:
            np.testing.assert_allclose(r['two'][1][n], want['end'][n],
                                       rtol=1e-6, atol=1e-7)


def test_group_commit_without_world_rank_zero(runs):
    import torch
    from mxnet_tpu_torch import parallel
    ranks = _get(runs, 'witness')
    assert ranks[0] is None
    assert [r['group_rank'] for r in ranks[1:]] == [0, 1, 2]
    assert [r['latest'] for r in ranks[1:]] == [7, 7, 7]
    path = str(runs[2] / 'witness')
    assert parallel.SharedCheckpointManager(path).latest_step() == 7
    got = parallel.SharedCheckpointManager(path).restore(7)
    # the unsharded leaves are the primary's: world rank 1, group rank 0
    np.testing.assert_array_equal(np.asarray(got['w']),
                                  torch.arange(6.0).numpy())
    assert int(np.asarray(got['step'])) == 7


# ------------------------------------------------------------------ C14
def _free_port():
    import socket
    from contextlib import closing
    with closing(socket.socket()) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _released_then_late(kvstore, dist_async, monkeypatch, **create):
    """Three in-process stores on a fake liveness clock. Ranks 0 and 1 wait
    at a barrier while rank 2 is silent; the clock passes the deadline
    (as it does while the survivors wait for a dead peer's ejection), so
    rank 2 is ejected and the barrier releases 0 and 1. Rank 0 reaches the
    next barrier first; rank 1 follows 0.2 s later. Returns what rank 1's
    barrier said (a verdict, or the error of an ejected member)."""
    import time
    port = _free_port()
    monkeypatch.setenv('MX_COORDINATOR', f'127.0.0.1:{_free_port()}')
    monkeypatch.setenv('MXNET_KVSTORE_ASYNC_PORT', str(port))
    monkeypatch.setenv('MXNET_KVSTORE_HEARTBEAT_S', '3600')
    monkeypatch.setenv('MXNET_KVSTORE_DEADLINE_S', '60')
    monkeypatch.setenv('MX_NPROC', '3')
    stores = []
    for r in range(3):
        monkeypatch.setenv('MX_PROC_ID', str(r))
        stores.append(kvstore.create('dist_async', **create))
    stores[0]._ensure_connected()
    srv = dist_async._SERVERS[port]
    clk = [1000.0]
    srv.set_clock(lambda: clk[0])
    try:
        for s in stores:
            s.elastic_join()
        got = {}

        def at(r, phase):
            try:
                got[(r, phase)] = stores[r].elastic_barrier(phase, 0)
            except Exception as e:
                got[(r, phase)] = e

        def parked(phase, ranks, stop=None):
            for _ in range(500):
                with srv._elastic_cv:
                    if srv._elastic_arrivals.get((phase, 0), set()) == ranks:
                        return True
                if stop is not None and not stop.is_alive():
                    return False
                time.sleep(0.01)
            return False

        ts = [threading.Thread(target=at, args=(r, 'pre')) for r in (0, 1)]
        for t in ts:
            t.start()
        assert parked('pre', {0, 1})
        clk[0] += 100.0                 # rank 2 is past the deadline
        for t in ts:
            t.join(30)
        assert got[(0, 'pre')]['live'] == [0, 1]
        t0 = threading.Thread(target=at, args=(0, 'reform'))
        t0.start()
        # rank 0 waits there for rank 1, or was released alone at once
        parked('reform', {0}, stop=t0)
        time.sleep(0.2)
        at(1, 'reform')
        t0.join(30)
        return got[(0, 'reform')], got[(1, 'reform')]
    finally:
        for s in stores:
            try:
                s.close()
            except Exception:
                pass
        srv = dist_async._SERVERS.pop(port, None)
        if srv is not None:
            srv.stop()


def test_C14_jax_barrier_ejects_a_member_it_just_released(monkeypatch):
    """The JAX package's elastic barrier judges a member that has not yet
    arrived by its last heartbeat; a member that waited at the previous
    barrier sent none (its beats wait behind the barrier call on the one
    socket), so the first survivor at the next barrier ejects the others
    whenever the previous barrier outlasted the deadline: after every
    host death. ``-s`` prints what rank 1 is told."""
    from mxnet_tpu import kvstore
    from mxnet_tpu.kvstore import dist_async
    first, late = _released_then_late(kvstore, dist_async, monkeypatch)
    print('C14: rank 0 released with', first, '; rank 1 told', late)
    assert first['live'] == [0]
    assert isinstance(late, Exception) and 'not an elastic member' in \
        str(late)


def test_the_port_keeps_a_member_released_by_the_last_barrier(monkeypatch):
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.kvstore import dist_async
    first, late = _released_then_late(kvstore, dist_async, monkeypatch,
                                      device='cpu')
    assert first['live'] == [0, 1] and late['live'] == [0, 1]
