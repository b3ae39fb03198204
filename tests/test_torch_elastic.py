"""The port's ``mx.train.ElasticTrainer`` against its own uninterrupted runs
and the JAX package's, on the CPU.

The cases of ``tests/test_elastic_train.py`` that exercise the trainer
(the random-stream, Trainer-state and ``DataLoader.resumable()`` pieces it
stands on have their own tests): the asynchronous daemon's latest-wins
coalescing, its survival of a failed save, the ``MXNET_CKPT_EVERY_S``
throttle with ``block=True`` bypassing it, a cold start, the stall bound
(an asynchronous save blocks the step loop for well under a synchronous
save) with the checkpoint-stats provider, histograms and counters, the
``train.ckpt`` lock level under the race checker, and the SIGKILL parity
run (``tests/torch_elastic_worker.py``: a Dropout net, a shuffled
resumable loader, Adam and a FactorScheduler, killed inside the daemon's
save of step 3 and resumed from step 2; weights, slots and the update
count bit-equal to a run that never died).

Against the JAX package: ``Dense(48, in_units=8)`` trained by SGD at lr
0.1 for four steps from the same weights, checkpointed after step 2 and
restored into a fresh net and Trainer: the port's resumed run is bit-equal
to its straight run, and both meet the JAX package's resumed run (its
``ElasticTrainer`` over its own manager) at rtol 1e-6.

A sharded Adam run: four gloo ranks train the Dense under FSDP, save
(each rank its shards and its slots' pieces), and ranks 0-1 restore it
re-sharded in a group of their own and train on; bit-equal to a two-rank
run restored from the same checkpoint, and within rtol 1e-6 of one
process.
"""

import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, gluon as tgl, parallel
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.parallel import launch
from mxnet_tpu_torch.telemetry import metrics as tmetrics
from mxnet_tpu_torch.train import ElasticTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.1
BATCH = 24
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


# ------------------------------------------------------------- the daemon
class _GatedManager:
    """A manager whose save waits on an event: the daemon is busy for as
    long as the test wants."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.saved = []

    def save(self, step, tree):
        self.entered.set()
        assert self.release.wait(20)
        self.saved.append(int(step))


class _FlakyManager:
    def __init__(self, fail_steps):
        self._fail = set(fail_steps)
        self.saved = []

    def save(self, step, tree):
        if step in self._fail:
            raise RuntimeError(f'disk full at step {step}')
        self.saved.append(int(step))


def test_async_daemon_coalesces_latest_wins():
    mgr = _GatedManager()
    et = ElasticTrainer({}, None, mgr, async_save=True, name='coal0')
    try:
        assert et.save(0)
        assert mgr.entered.wait(20)     # the daemon is inside save(0)
        assert et.save(1)
        assert et.save(2)               # overwrites the pending 1
        mgr.release.set()
        assert et.flush(timeout=20)
        assert mgr.saved == [0, 2]
        s = et.stats()
        assert s['saves'] == 2 and s['async_saves'] == 2
        assert s['coalesced'] == 1 and s['errors'] == 0
        assert s['last_step'] == 2
    finally:
        mgr.release.set()
        et.close()


def test_async_daemon_survives_save_errors():
    mgr = _FlakyManager({0})
    et = ElasticTrainer({}, None, mgr, async_save=True, name='flaky0')
    try:
        et.save(0, block=True)
        et.save(1, block=True)
        s = et.stats()
        assert mgr.saved == [1]
        assert s['errors'] == 1 and 'disk full' in s['last_error']
        assert s['saves'] == 1 and s['last_step'] == 1
    finally:
        et.close()


def test_every_s_throttle_and_block_bypass(monkeypatch):
    monkeypatch.setenv('MXNET_CKPT_EVERY_S', '10')
    clk = [100.0]
    mgr = _FlakyManager(())
    et = ElasticTrainer({}, None, mgr, async_save=False,
                        clock=lambda: clk[0], name='thr0')
    try:
        assert et.save(0)
        assert not et.save(1)           # inside the window
        assert et.save(2, block=True)   # block bypasses the throttle
        clk[0] += 11
        assert et.save(3)
        assert mgr.saved == [0, 2, 3]
        assert et.stats()['throttled'] == 1
    finally:
        et.close()


def test_restore_cold_start_returns_minus_one(tmp_path):
    mgr = parallel.SharedCheckpointManager(str(tmp_path / 'empty'))
    et = ElasticTrainer({}, None, mgr, name='cold0')
    try:
        assert et.restore() == -1
    finally:
        et.close()


def test_daemon_lock_is_train_ckpt_under_the_race_checker():
    from mxnet_tpu_torch.analysis import race
    race.enable()
    try:
        race.reset()
        mgr = _FlakyManager(())
        et = ElasticTrainer({}, None, mgr, async_save=True, name='race0')
        try:
            assert et._daemon._cv.name == 'train.ckpt'
            for s in range(3):
                et.save(s)
            assert et.flush(timeout=20)
        finally:
            et.close()
        race.assert_clean()
    finally:
        race.disable()


# ------------------------------------------- the Dense against the JAX one
def _init():
    rng = np.random.default_rng(5)
    return {'weight': (rng.standard_normal((48, 8)) * 0.3).astype('f'),
            'bias': (rng.standard_normal(48) * 0.1).astype('f')}


def _data(s):
    return (np.random.RandomState(s).randn(BATCH, 8).astype('f'),
            np.random.RandomState(1000 + s).randn(BATCH, 48).astype('f'))


def _port_dense(opt='sgd', opt_params=None):
    net = tgl.nn.Dense(48, in_units=8)
    net.initialize(ctx=tmx.cpu())
    for n, p in net.collect_params().items():
        p.set_data(_init()[n])
    tr = tgl.Trainer(net.collect_params(), opt,
                     opt_params or {'learning_rate': LR})
    return net, tr


def _port_step(net, tr, s):
    x, y = _data(s)
    with tag.record():
        loss = ((net(tmx.np.array(x)) - tmx.np.array(y)) ** 2).mean()
    loss.backward()
    tr.step(BATCH)


def _weights(net):
    return {n: p.data().asnumpy().copy()
            for n, p in net.collect_params().items()}


def test_dense_resume_bit_equal_and_meets_the_jax_package(tmp_path):
    net, tr = _port_dense()
    for s in range(4):
        _port_step(net, tr, s)
    straight = _weights(net)

    net, tr = _port_dense()
    mgr = parallel.SharedCheckpointManager(str(tmp_path / 'port'))
    et = ElasticTrainer(dict(net.collect_params()), tr, mgr, name='d48a')
    for s in range(2):
        _port_step(net, tr, s)
    et.save(1, block=True)
    _port_step(net, tr, 2)              # diverge past the checkpoint
    et.close()
    net, tr = _port_dense()
    et = ElasticTrainer(dict(net.collect_params()), tr, mgr, name='d48b')
    assert et.restore() == 1
    for s in range(2, 4):
        _port_step(net, tr, s)
    et.close()
    resumed = _weights(net)
    for n in straight:
        np.testing.assert_array_equal(resumed[n], straight[n], err_msg=n)

    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag, gluon as jgl
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.train import ElasticTrainer as JET

    def jax_dense():
        jnet = jgl.nn.Dense(48, in_units=8)
        jnet.initialize()
        for n, p in jnet.collect_params().items():
            p.set_data(jmx.np.array(_init()[n]))
        return jnet, jgl.Trainer(jnet.collect_params(), 'sgd',
                                 {'learning_rate': LR})

    def jax_step(jnet, jtr, s):
        x, y = _data(s)
        with jag.record():
            loss = ((jnet(jmx.np.array(x)) - jmx.np.array(y)) ** 2).mean()
        loss.backward()
        jtr.step(BATCH)

    jnet, jtr = jax_dense()
    jmgr = jpar.SharedCheckpointManager(str(tmp_path / 'jax'))
    jet = JET(dict(jnet.collect_params()), jtr, jmgr, name='j48a')
    for s in range(2):
        jax_step(jnet, jtr, s)
    jet.save(1, block=True)
    jet.close()
    jnet, jtr = jax_dense()
    jet = JET(dict(jnet.collect_params()), jtr, jmgr, name='j48b')
    assert jet.restore() == 1
    for s in range(2, 4):
        jax_step(jnet, jtr, s)
    jet.close()
    for n, p in jnet.collect_params().items():
        np.testing.assert_allclose(resumed[n], p.data().asnumpy(), **TOL)


# ------------------------------------------ stall bound and the statistics
def test_async_save_stall_well_under_sync_save(tmp_path):
    """With the daemon the step loop pays only the snapshot's copy: the
    measured ``blocked_ms`` stays well under a synchronous save of the
    same tree; the checkpoint stats, histograms and counters report it."""
    net = tgl.nn.Dense(1024, in_units=1024)     # ~4 MB of parameters
    net.initialize(ctx=tmx.cpu())
    params = dict(net.collect_params())
    et_sync = ElasticTrainer(params, None, parallel.SharedCheckpointManager(
        str(tmp_path / 'sync')), async_save=False, name='stall_sync')
    try:
        for s in range(3):
            et_sync.save(s, block=True)
        sync = et_sync.stats()
    finally:
        et_sync.close()
    min_sync = min(sync['serialize_ms_avg'], sync['serialize_ms_max'])

    et = ElasticTrainer(params, None, parallel.SharedCheckpointManager(
        str(tmp_path / 'async')), async_save=True, name='stall_async')
    try:
        for s in range(3):
            et.save(s)
            assert et.flush(timeout=60)
        got = tprof.checkpoint_stats()
        assert 'stall_async' in got and got['stall_async']['saves'] == 3
        s = et.stats()
        samples = {k: v for kind, k, labels, v in
                   et._collect() if kind == 'counter'}
        assert samples['mx_ckpt_async_saves_total'] == 3
        assert tmetrics.histogram('mx_ckpt_blocked_ms',
                                  trainer='stall_async').count == 3
        assert tmetrics.histogram('mx_ckpt_serialize_ms',
                                  trainer='stall_async').count == 3
    finally:
        et.close()
    assert s['async_saves'] == 3
    assert 0.0 < s['blocked_ms_max'] < 0.5 * min_sync, \
        (s['blocked_ms_max'], min_sync)
    assert 'stall_async' not in tprof.checkpoint_stats()   # detached


def test_save_is_one_span(tmp_path):
    from mxnet_tpu_torch.telemetry import trace
    trace.configure(enabled=True, sample=1.0)
    trace.clear()
    try:
        net, tr = _port_dense()
        et = ElasticTrainer(dict(net.collect_params()), tr,
                            parallel.SharedCheckpointManager(
                                str(tmp_path / 'span')), name='span0')
        et.save(4, block=True)
        et.close()
        spans = [e for e in trace.events() if e['name'] == 'ckpt.save']
        assert len(spans) == 1 and spans[0]['attrs']['step'] == 4
    finally:
        trace.configure(enabled=False)
        trace.clear()


# -------------------------------------------------------- SIGKILL parity
def _run_worker(mode, ckpt, out, extra_env=None, expect_kill=False):
    env = dict(os.environ)
    env.update(extra_env or {})
    res = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, 'tests', 'torch_elastic_worker.py'),
         '--mode', mode, '--ckpt-dir', ckpt, '--out', out,
         '--steps', '6', '--kill-at', '3'],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    tail = (res.stdout + res.stderr)[-4000:]
    if expect_kill:
        assert res.returncode == -signal.SIGKILL, tail
    else:
        assert res.returncode == 0, tail


def test_sigkill_resume_parity(tmp_path):
    straight = str(tmp_path / 'straight.npz')
    resumed = str(tmp_path / 'resumed.npz')
    ckpt = str(tmp_path / 'ckpt')
    _run_worker('straight', str(tmp_path / 'unused'), straight)
    _run_worker('crash', ckpt, str(tmp_path / 'crash.npz'),
                extra_env={'MXNET_CKPT_ASYNC': '1'}, expect_kill=True)
    # the kill inside step 3's save left step 2 committed and whole
    mgr = parallel.SharedCheckpointManager(ckpt)
    assert mgr.latest_step() == 2
    assert not any(n.startswith('.staging') for n in os.listdir(ckpt))
    _run_worker('resume', ckpt, resumed)
    a, b = np.load(straight), np.load(resumed)
    assert sorted(a.files) == sorted(b.files)
    assert any(k.startswith('slot') for k in a.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k


# ------------------------------------------------------- sharded Adam
ADAM = {'learning_rate': 0.01}


def _sharded_rank(ckpt):
    """Four ranks: FSDP Dense with Adam, two steps, save; ranks 0-1 restore
    it at dp 2 in a group of their own and train two more steps (twice:
    once resuming the four-rank run, once a fresh two-rank restore)."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from mxnet_tpu_torch import sharding
    from mxnet_tpu_torch.sharding.context import local_group, use
    rank = dist.get_rank()
    out = {}
    with tmx.cpu():
        with sharding.mesh(dp=4):
            net, tr = _port_dense('adam', ADAM)
            net.hybridize()
            net(tmx.np.array(_data(0)[0]))     # places the parameters
            et = ElasticTrainer(dict(net.collect_params()), tr,
                                parallel.SharedCheckpointManager(ckpt),
                                name='fsdp4', async_save=True)
            for s in range(2):
                _port_step(net, tr, s)
            out['slot_shape'] = tuple(tr._states[0][0].shape)
            et.save(1, block=True)
            et.close()
        if rank >= 2:
            return out
        ctx = sharding.ShardingContext({'dp': 2}, group=local_group([0, 1]))
        for key in ('a', 'b'):
            with use(ctx):
                net, tr = _port_dense('adam', ADAM)
                net.hybridize()
                net(tmx.np.array(_data(0)[0]))
                et = ElasticTrainer(dict(net.collect_params()), tr,
                                    parallel.SharedCheckpointManager(ckpt),
                                    name=f'fsdp2{key}', async_save=False)
                assert et.restore() == 1
                out['slot_shape2'] = tuple(tr._states[0][0].shape)
                for s in range(2, 4):
                    _port_step(net, tr, s)
                out[key] = _weights(net)
                et.close()
    return out


def test_sharded_adam_restores_re_sharded(tmp_path):
    ranks = launch.spawn(_sharded_rank, 4, str(tmp_path / 'fsdp'),
                         timeout=120)
    assert ranks[0]['slot_shape'] == (12, 8)     # 48 rows over dp 4
    assert ranks[0]['slot_shape2'] == (24, 8)    # the slots re-cut at dp 2
    for r in ranks[:2]:
        for n in r['a']:
            np.testing.assert_array_equal(r['a'][n], r['b'][n])
            np.testing.assert_array_equal(r['a'][n], ranks[0]['a'][n])
    net, tr = _port_dense('adam', ADAM)
    for s in range(4):
        _port_step(net, tr, s)
    for n, w in _weights(net).items():
        np.testing.assert_allclose(ranks[0]['a'][n], w, **TOL)
