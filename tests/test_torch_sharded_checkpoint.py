"""Sharded checkpoints of the port (``parallel.checkpoint``): the eleven
cases of ``tests/test_sharded_checkpoint.py`` against the port, and a
checkpoint written at dp 2 x tp 2 read back bit for bit at dp 4 and in
one process.

The JAX package writes through orbax; the port writes one ``torch.save``
file a rank and ``meta.json``, so the cases hold the port to the same
contract rather than to the JAX package's files: a round trip of sharded
and unsharded leaves, a new sharding on restore, host numpy, rotation,
a Gluon block's parameters, a kill at every point of the commit protocol
(``ckpt.staged``, ``ckpt.cleared``, ``ckpt.renamed``, ``ckpt.committed``),
the scan of step directories without a manifest, and ``restore_or_init``.
The sharded cases run in one world of four gloo ranks on the CPU
(``parallel.launch.spawn``); the values are exact (bit-equal), as a
checkpoint must be.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import checkpoint as C, launch
from mxnet_tpu_torch.sharding.rules import PartitionSpec as P


def _tree():
    rng = np.random.default_rng(0)
    return {'w1': rng.standard_normal((8, 16)).astype(np.float32),
            'b1': rng.standard_normal(16).astype(np.float32),
            'w2': np.arange(32, dtype=np.float32).reshape(8, 4),
            'qkv': rng.standard_normal((12, 4)).astype(np.float32)}


def _world(path):
    """dp 2 x tp 2: save sharded leaves (one laid out in three blocks, as
    BERT's fused qkv), restore them with the template, with new specs,
    then under a dp 4 mesh of the same ranks."""
    from mxnet_tpu_torch import sharding
    from mxnet_tpu_torch.sharding.dispatch import Layout, cut, shard
    torch.set_num_threads(1)    # four ranks beside the other test workers
    tree = _tree()
    out = {}
    with tmx.cpu(), sharding.mesh(dp=2, tp=2) as ctx:
        def placed(name, spec, blocks=None):
            t = torch.from_numpy(tree[name])
            lay = Layout(ctx, spec, t.shape, blocks=blocks)
            return shard(cut(t, lay), lay)
        saved = {'w1': placed('w1', P(None, 'tp')),
                 'b1': tmx.np.array(tree['b1']),
                 'nested': {'w2': placed('w2', P('dp', None))},
                 'qkv': placed('qkv', P('tp', None), {0: 3})}
        parallel.save_sharded(path, saved)
        back = parallel.restore_sharded(path, template=saved)
        out['template'] = {
            'w1': (back['w1']._layout.pspec(), back['w1'].asnumpy()),
            'b1': (back['b1']._layout, back['b1'].asnumpy()),
            'w2': (back['nested']['w2']._layout.pspec(),
                   back['nested']['w2'].asnumpy()),
            'qkv': (tuple(back['qkv']._data.shape), back['qkv'].asnumpy(),
                    torch.equal(back['qkv']._data, saved['qkv']._data))}
        new = parallel.restore_sharded(
            path, mesh=ctx, specs={'w1': P('dp', None), 'b1': P('tp'),
                                   'nested': {'w2': P(None, 'tp')},
                                   'qkv': P()})
        out['new'] = {'w2': (new['nested']['w2']._layout.pspec(),
                             tuple(new['nested']['w2']._data.shape),
                             new['nested']['w2'].asnumpy()),
                      'b1': (new['b1']._layout.pspec(),
                             new['b1'].asnumpy())}
    with tmx.cpu(), sharding.mesh(dp=4) as ctx4:
        got = parallel.restore_sharded(
            path, mesh=ctx4, specs={'w1': P('dp'), 'b1': P('dp'),
                                    'nested': {'w2': P('dp')},
                                    'qkv': P('dp')})
        out['dp4'] = {k: (v._layout.pspec(), v.asnumpy())
                      for k, v in (('w1', got['w1']), ('b1', got['b1']),
                                   ('w2', got['nested']['w2']),
                                   ('qkv', got['qkv']))}
    return out


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ck') / 'dp2tp2')
    return path, launch.spawn(_world, 4, path, timeout=120)


def test_save_restore_roundtrip_sharded(world):
    _, ranks = world
    tree = _tree()
    for r in ranks:
        t = r['template']
        assert t['w1'][0] == P(None, 'tp')
        np.testing.assert_array_equal(t['w1'][1], tree['w1'])
        assert t['b1'][0] is None
        np.testing.assert_array_equal(t['b1'][1], tree['b1'])
        assert t['w2'][0] == P('dp')
        np.testing.assert_array_equal(t['w2'][1], tree['w2'])
        # the blocked layout: a rank's shard holds a part of each block
        assert t['qkv'][0] == (6, 4) and t['qkv'][2]
        np.testing.assert_array_equal(t['qkv'][1], tree['qkv'])


def test_restore_with_new_sharding(world):
    _, ranks = world
    tree = _tree()
    for r in ranks:
        spec, local, full = r['new']['w2']
        assert spec == P(None, 'tp') and local == (8, 2)
        np.testing.assert_array_equal(full, tree['w2'])
        assert r['new']['b1'][0] == P('tp')
        np.testing.assert_array_equal(r['new']['b1'][1], tree['b1'])


def test_dp2_tp2_checkpoint_restores_bit_equal_at_dp4_and_one_process(
        world):
    path, ranks = world
    tree = _tree()
    for r in ranks:
        for k, (spec, full) in r['dp4'].items():
            assert spec == P('dp'), k
            np.testing.assert_array_equal(full, tree[k])
    one = parallel.restore_sharded(path)
    for k in ('w1', 'b1', 'qkv'):
        np.testing.assert_array_equal(one[k], tree[k])
    np.testing.assert_array_equal(one['nested']['w2'], tree['w2'])


def test_restore_to_host_numpy(tmp_path):
    tree = {'a': torch.ones((3, 3)), 'nested': {'b': torch.zeros(4)}}
    path = str(tmp_path / 'ckpt3')
    parallel.save_sharded(path, tree)
    out = parallel.restore_sharded(path)
    np.testing.assert_array_equal(np.asarray(out['a']), np.ones((3, 3)))
    np.testing.assert_array_equal(np.asarray(out['nested']['b']),
                                  np.zeros(4))


def test_checkpoint_manager_rotation(tmp_path):
    mgr = parallel.SharedCheckpointManager(str(tmp_path / 'mgr'),
                                           max_to_keep=2)
    try:
        for step in range(4):
            mgr.save(step, {'w': torch.full((2,), float(step))})
        steps = mgr.all_steps()
        assert mgr.latest_step() == 3
        assert len(steps) <= 2 and 3 in steps
        assert sorted(n for n in os.listdir(str(tmp_path / 'mgr'))
                      if n.isdigit()) == ['2', '3']
        np.testing.assert_array_equal(np.asarray(mgr.restore()['w']),
                                      np.full((2,), 3.0))
    finally:
        mgr.close()


def test_block_params_sharded_roundtrip(tmp_path):
    from mxnet_tpu_torch.parallel.checkpoint import (save_params_sharded,
                                                     load_params_sharded)
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(8, in_units=4)
        net.initialize()
        before = {k: v.data().asnumpy()
                  for k, v in net.collect_params().items()}
        path = str(tmp_path / 'blk')
        save_params_sharded(path, net)
        for _, p in net.collect_params().items():
            p.set_data(tmx.np.zeros(p.shape))
        load_params_sharded(path, net)
        after = {k: v.data().asnumpy()
                 for k, v in net.collect_params().items()}
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


class _Killed(BaseException):
    """Stands in for SIGKILL at an exact commit-protocol point."""


def _kill_at(point):
    def hook(name):
        if name == point:
            raise _Killed(point)
    return C.install_crash_hook(hook)


def _saved_tree(v):
    return {'w': torch.full((2,), float(v))}


@pytest.mark.parametrize('point', ['ckpt.staged', 'ckpt.renamed'])
def test_kill_mid_save_keeps_previous_checkpoint(tmp_path, point):
    d = str(tmp_path / 'crash')
    mgr = parallel.SharedCheckpointManager(d, max_to_keep=3)
    mgr.save(0, _saved_tree(0))
    prev = _kill_at(point)
    try:
        with pytest.raises(_Killed):
            mgr.save(1, _saved_tree(1))
    finally:
        C.install_crash_hook(prev)
    assert mgr.latest_step() == 0
    mgr2 = parallel.SharedCheckpointManager(d, max_to_keep=3)
    assert mgr2.latest_step() == 0
    assert not any(n.startswith('.staging-') or n == '.MANIFEST.tmp'
                   for n in os.listdir(d))
    np.testing.assert_array_equal(np.asarray(mgr2.restore()['w']),
                                  np.zeros(2))
    mgr2.save(1, _saved_tree(1))
    assert mgr2.latest_step() == 1
    np.testing.assert_array_equal(np.asarray(mgr2.restore()['w']),
                                  np.ones(2))


def test_kill_after_manifest_commit_keeps_new_checkpoint(tmp_path):
    d = str(tmp_path / 'crash2')
    mgr = parallel.SharedCheckpointManager(d, max_to_keep=3)
    mgr.save(0, _saved_tree(0))
    prev = _kill_at('ckpt.committed')
    try:
        with pytest.raises(_Killed):
            mgr.save(1, _saved_tree(1))
    finally:
        C.install_crash_hook(prev)
    mgr2 = parallel.SharedCheckpointManager(d, max_to_keep=3)
    assert mgr2.latest_step() == 1
    np.testing.assert_array_equal(np.asarray(mgr2.restore()['w']),
                                  np.ones(2))


def test_kill_at_every_point_never_corrupts_latest(tmp_path):
    d = str(tmp_path / 'sweep')
    mgr = parallel.SharedCheckpointManager(d, max_to_keep=2)
    mgr.save(0, _saved_tree(0))
    committed = 0
    for step, point in enumerate(
            ['ckpt.staged', 'ckpt.cleared', 'ckpt.renamed',
             'ckpt.committed'], start=1):
        prev = _kill_at(point)
        try:
            with pytest.raises(_Killed):
                mgr.save(step, _saved_tree(step))
        finally:
            C.install_crash_hook(prev)
        if point == 'ckpt.committed':
            committed = step
        fresh = parallel.SharedCheckpointManager(d, max_to_keep=2)
        assert fresh.latest_step() == committed
        got = np.asarray(fresh.restore()['w'])
        np.testing.assert_array_equal(got, np.full((2,), float(committed)))
        mgr = fresh


def test_kill_while_resaving_committed_step_never_tears_manifest(tmp_path):
    d = str(tmp_path / 'resave')
    mgr = parallel.SharedCheckpointManager(d, max_to_keep=3)
    mgr.save(0, _saved_tree(0))
    mgr.save(1, _saved_tree(1))
    prev = _kill_at('ckpt.cleared')
    try:
        with pytest.raises(_Killed):
            mgr.save(1, _saved_tree(41))
    finally:
        C.install_crash_hook(prev)
    mgr2 = parallel.SharedCheckpointManager(d, max_to_keep=3)
    assert mgr2.latest_step() == 0
    np.testing.assert_array_equal(np.asarray(mgr2.restore()['w']),
                                  np.zeros(2))
    mgr2.save(1, _saved_tree(41))
    assert mgr2.latest_step() == 1
    np.testing.assert_array_equal(np.asarray(mgr2.restore()['w']),
                                  np.full((2,), 41.0))


def test_manifest_missing_falls_back_to_legacy_scan(tmp_path):
    d = str(tmp_path / 'legacy')
    mgr = parallel.SharedCheckpointManager(d)
    mgr.save(3, _saved_tree(3))
    os.remove(os.path.join(d, 'MANIFEST.json'))
    mgr2 = parallel.SharedCheckpointManager(d)
    assert mgr2.latest_step() == 3
    np.testing.assert_array_equal(np.asarray(mgr2.restore()['w']),
                                  np.full((2,), 3.0))


def test_restore_or_init(tmp_path):
    from mxnet_tpu_torch.parallel.checkpoint import restore_or_init
    mgr = parallel.SharedCheckpointManager(str(tmp_path / 'el'),
                                           max_to_keep=2)
    try:
        state, step = restore_or_init(mgr, lambda: {'w': torch.zeros(2)})
        assert step == -1 and float(state['w'][0]) == 0.0
        mgr.save(5, {'w': torch.full((2,), 7.0)})
        state, step = restore_or_init(mgr, lambda: {'w': torch.zeros(2)})
        assert step == 5
        np.testing.assert_array_equal(np.asarray(state['w']),
                                      np.full((2,), 7.0))
        tmpl = {'w': tmx.np.zeros((2,), ctx=tmx.cpu())}
        state, _ = restore_or_init(mgr, lambda: tmpl, template=tmpl)
        assert isinstance(state['w'], tmx.NDArray)
        np.testing.assert_array_equal(state['w'].asnumpy(),
                                      np.full((2,), 7.0))
    finally:
        mgr.close()
