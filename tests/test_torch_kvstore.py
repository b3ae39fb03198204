"""The port's ``mx.kvstore`` in one process, against the JAX package.

Every single-process case of ``tests/test_kvstore.py`` runs through both
packages on the same numpy inputs, and the port must give the JAX
package's values: exactly where the values are sums of small integers or
the 2-bit codes, at rtol 1e-6 (the JAX tests' own bound) where an
optimizer computes them. The bucket, ZeRO-1 and owner plans must equal
the JAX functions' for the same sizes, and the 2-bit words must be the
JAX ``GradientCompression.quantize``'s bit for bit (the JAX words are
``uint32``, the port's ``int32`` with the same bits). The named-axis
forms (``zero1_update_in_axis``, ``bucketed_allreduce_in_axis``) run over
an ``mx.sharding`` axis and are held to the JAX package in
``tests/test_torch_sharding.py``; ``dist_async`` has its own files, ``tests/test_torch_kvstore_async.py``
and ``tests/test_torch_dist_async.py``.

The horovod/byteps delegation cases inject the same duck-typed mocks as
the JAX tests, whose world is ``size`` identical ranks: their allreduce is
the value times ``size`` here (the JAX mocks psum over virtual devices).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkv

RTOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _both(fn):
    """``fn(mx, kvstore)`` through both packages; returns (jax, port)."""
    return fn(jmx, jkv), fn(tmx, tkv)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(e) for e in x]
    return np.asarray(x.asnumpy() if hasattr(x, 'asnumpy') else x)


def _same(fn, want=None, rtol=0.0):
    j, t = _both(fn)
    js, ts = _np(j), _np(t)
    if not isinstance(js, list):
        js, ts = [js], [ts]
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=0)
    if want is not None:
        np.testing.assert_allclose(np.asarray(_np(t), np.float64),
                                   np.asarray(want, np.float64), rtol=rtol,
                                   atol=1e-6)
    return t


@pytest.mark.parametrize('name', ['local', 'device', 'dist_sync',
                                  'dist_tpu_sync', 'horovod', 'byteps',
                                  'nccl', 'dist', 'dist_sync_device',
                                  'dist_device_sync', 'local_allreduce_cpu',
                                  'local_allreduce_device'])
def test_create_types_and_aliases(name):
    j, t = jkv.create(name), tkv.create(name)
    assert (t.rank, t.num_workers) == (j.rank, j.num_workers) == (0, 1)
    assert t.type == j.type
    assert type(t).__name__ == type(j).__name__


def test_create_refuses_what_jax_refuses():
    for kv in (jkv, tkv):
        with pytest.raises(ValueError):
            kv.create('bogus_type')
        with pytest.raises(TypeError):
            kv.create(3)


def test_mx_kvstore_is_exported():
    assert tmx.kvstore.create is tkv.create


def test_init_push_pull():
    def run(mx, kv):
        store = kv.create('local')
        store.init(3, mx.np.ones((2, 3)))
        out = mx.np.zeros((2, 3))
        store.pull(3, out=out)
        return out
    _same(run, np.ones((2, 3)))


def test_push_aggregation():
    def run(mx, kv):
        store = kv.create('local')
        store.init('a', mx.np.zeros((2,)))
        store.push('a', [mx.np.ones((2,)), mx.np.ones((2,)) * 2])
        out = mx.np.zeros((2,))
        store.pull('a', out=out)
        return out
    _same(run, [3., 3.])


def test_pushpull_allreduce():
    def run(mx, kv):
        store = kv.create('dist_sync')
        vals = [mx.np.ones((4,)), mx.np.ones((4,)) * 3]
        store.pushpull(0, vals)
        return vals
    got = _same(run)
    for v in got:
        np.testing.assert_array_equal(v, np.full((4,), 4.0))


def test_pushpull_with_out():
    def run(mx, kv):
        store = kv.create('device')
        out = mx.np.zeros((2, 2))
        store.pushpull('k', mx.np.ones((2, 2)), out=out)
        return out
    _same(run, np.ones((2, 2)))


def test_broadcast():
    def run(mx, kv):
        store = kv.create('local')
        outs = [mx.np.zeros((3,)), mx.np.zeros((3,))]
        store.broadcast('b', mx.np.array([1., 2., 3.]), outs)
        return outs
    for o in _same(run):
        np.testing.assert_array_equal(o, [1., 2., 3.])


def test_updater():
    def run(mx, kv):
        store = kv.create('local')
        store.init(0, mx.np.ones((2,)))

        def updater(key, grad, weight):
            weight._rebind((weight - 0.1 * grad)._data)

        store.set_updater(updater)
        store.push(0, mx.np.ones((2,)))
        out = mx.np.zeros((2,))
        store.pull(0, out=out)
        return out
    _same(run, [0.9, 0.9], rtol=RTOL)


def test_set_optimizer():
    def run(mx, kv):
        store = kv.create('local')
        store.init(0, mx.np.ones((2,)))
        store.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
        store.pushpull(0, mx.np.ones((2,)))
        out = mx.np.zeros((2,))
        store.pull(0, out=out)
        return out
    _same(run, [0.5, 0.5], rtol=RTOL)


def test_row_sparse_pull_fallback():
    def run(mx, kv):
        store = kv.create('local')
        store.init('w', mx.np.ones((4, 2)))
        out = mx.np.zeros((4, 2))
        store.row_sparse_pull('w', out=out)
        return out
    _same(run, np.ones((4, 2)))


def test_row_sparse_pull_rows_of_a_dense_table():
    """The dense-table branch with row ids: into ``out``'s rows, and with
    no out the rows in an array of the table's shape (the value of JAX's
    RowSparseNDArray, which the port does not have: A3 rest)."""
    table = np.arange(8, dtype=np.float32).reshape(4, 2)

    def run(mx, kv):
        store = kv.create('local')
        store.init('e', mx.np.array(table))
        out = mx.np.zeros((4, 2))
        store.row_sparse_pull('e', out=out, row_ids=mx.np.array([1, 3]))
        return out, store.row_sparse_pull('e', row_ids=mx.np.array([0, 3]))
    (j_out, j_rows), (t_out, t_rows) = _both(run)
    np.testing.assert_array_equal(t_out.asnumpy(), j_out.asnumpy())
    np.testing.assert_array_equal(t_rows.asnumpy(), j_rows.asnumpy())


def test_optimizer_states_save_load(tmp_path):
    def run(mx, kv):
        store = kv.create('local')
        store.init(0, mx.np.ones((2,)))
        store.set_optimizer(mx.optimizer.Adam())
        store.pushpull(0, mx.np.ones((2,)))
        f = str(tmp_path / f'{mx.__name__}.states')
        store.save_optimizer_states(f)
        store.load_optimizer_states(f)
        store.pushpull(0, mx.np.ones((2,)))
        out = mx.np.zeros((2,))
        store.pull(0, out=out)
        return out
    _same(run, rtol=RTOL)


def test_barrier_and_dead_nodes():
    def run(mx, kv):
        store = kv.create('dist_sync')
        store.barrier()
        return store.get_num_dead_node(), store.type
    assert _both(run) == ((0, 'dist_tpu_sync'), (0, 'dist_tpu_sync'))


def test_dist_tpu_sync_push_accumulates_like_local():
    def run(mx, kv):
        store = kv.create('dist_tpu_sync')
        store.init(3, mx.np.array(np.array([1.0, 2.0], 'f')))
        store.push(3, mx.np.array(np.array([0.5, 0.5], 'f')))
        out = mx.np.zeros((2,))
        store.pull(3, out=out)
        return out
    _same(run, [1.5, 2.5])


# ---------------------------------------------------------------- 2-bit
def _gc(gcmod):
    gc = gcmod.GradientCompression()
    gc.set_params({'type': '2bit', 'threshold': 0.5})
    return gc


def _jax_gc():
    from mxnet_tpu.kvstore import gradient_compression
    return _gc(gradient_compression)


def _port_gc():
    from mxnet_tpu_torch.kvstore import gradient_compression
    return _gc(gradient_compression)


def _words(w):
    """Words of either package as numpy uint32 bits."""
    a = np.asarray(w) if not torch.is_tensor(w) else w.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.mark.parametrize('size', [1, 7, 16, 17, 33, 1000])
@pytest.mark.parametrize('steps', [1, 3])
def test_two_bit_words_are_the_jax_words(size, steps):
    """Seeded gradients large enough to hit all three codes, over a few
    steps of error feedback: the words bit-equal, the residuals equal."""
    import jax.numpy as jnp
    rng = np.random.default_rng(size * 10 + steps)
    jgc, tgc = _jax_gc(), _port_gc()
    for _ in range(steps):
        g = rng.standard_normal(size).astype(np.float32) * 0.6
        jw = jgc.quantize('k', jnp.asarray(g))
        tw = tgc.quantize('k', torch.from_numpy(g))
        assert tw.dtype == torch.int32
        np.testing.assert_array_equal(_words(tw), _words(jw))
        np.testing.assert_array_equal(tgc._residuals['k'].numpy(),
                                      np.asarray(jgc._residuals['k']))
        np.testing.assert_array_equal(
            tgc.dequantize(tw, (size,)).numpy(),
            np.asarray(jgc.dequantize(jw, (size,))))


def test_gradient_compression_roundtrip():
    import jax.numpy as jnp
    g = np.array([0.7, -0.9, 0.2, -0.2, 0.0, 5.0, -5.0], np.float32)
    jgc, tgc = _jax_gc(), _port_gc()
    assert tgc.get_compression_factor() == jgc.get_compression_factor() == 16
    for n in (16, 17):
        assert tgc.get_compressed_size(n) == jgc.get_compressed_size(n)
    tw, jw = tgc.quantize('k', torch.from_numpy(g)), \
        jgc.quantize('k', jnp.asarray(g))
    np.testing.assert_array_equal(_words(tw), _words(jw))
    np.testing.assert_array_equal(tgc.dequantize(tw, g.shape).numpy(),
                                  [0.5, -0.5, 0.0, 0.0, 0.0, 0.5, -0.5])
    np.testing.assert_allclose(tgc._residuals['k'].numpy(),
                               [0.2, -0.4, 0.2, -0.2, 0.0, 4.5, -4.5],
                               atol=1e-6)


def test_gradient_compression_error_feedback():
    tgc = _port_gc()
    total = np.zeros(4, 'f')
    for _ in range(5):
        total += tgc.dequantize(tgc.quantize(
            'k', torch.full((4,), 0.2)), (4,)).numpy()
    np.testing.assert_allclose(total, np.full(4, 1.0), atol=1e-6)
    np.testing.assert_allclose(tgc._residuals['k'].numpy(), np.zeros(4),
                               atol=1e-6)


def test_gradient_compression_params_validation():
    from mxnet_tpu_torch.kvstore.gradient_compression import \
        GradientCompression
    gc = GradientCompression()
    for bad in ({'type': '1bit'}, {'type': '2bit', 'threshold': -1},
                {'type': '2bit', 'bogus': 1}):
        with pytest.raises(ValueError):
            gc.set_params(bad)


def test_gradient_compression_dequantize_sum():
    import jax.numpy as jnp
    g1 = np.array([0.7, -0.9, 0.2, 5.0, 0.0], np.float32)
    g2 = np.array([-0.6, 0.6, 0.6, -0.6, 0.0], np.float32)
    jgc, tgc = _jax_gc(), _port_gc()
    jw = [jgc.quantize(str(i), jnp.asarray(g)) for i, g in enumerate((g1,
                                                                       g2))]
    tw = [tgc.quantize(str(i), torch.from_numpy(g))
          for i, g in enumerate((g1, g2))]
    want = np.asarray(jgc.dequantize_sum(jnp.stack(jw), (5,)))
    got = tgc.dequantize_sum(torch.stack(tw), (5,)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dist_kvstore_compressed_pushpull():
    def run(mx, kv):
        store = kv.create('dist_tpu_sync')
        store.set_gradient_compression({'type': '2bit', 'threshold': 0.5})
        store.init(7, mx.np.zeros((4,)))
        g = mx.np.array(np.array([0.6, -0.6, 0.1, 0.0], 'f'))
        out = mx.np.zeros((4,))
        store.pushpull(7, g, out=out)
        first = out.asnumpy()
        store.pushpull(7, g, out=out)
        return first, out
    j, t = _both(run)
    for a, b in zip(_np(j), _np(t)):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, [0.5, -0.5, 0.0, 0.0])


def test_local_store_warns_that_compression_is_a_no_op():
    kv = tkv.create('device')
    with pytest.warns(UserWarning, match='no-op'):
        kv.set_gradient_compression({'type': '2bit', 'threshold': 0.5})


def test_trainer_accepts_compression_params():
    """A Dense(2) stepped once with 2-bit compression on dist_tpu_sync:
    the JAX Trainer's weights, from the same initial weights."""
    x = np.ones((4, 3), np.float32)

    def run(mx, kv):
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        net.weight.set_data(mx.np.array(
            np.arange(6, dtype=np.float32).reshape(2, 3) * 0.1))
        trainer = mx.gluon.Trainer(
            net.collect_params(), 'sgd', {'learning_rate': 0.1},
            kvstore='dist_tpu_sync',
            compression_params={'type': '2bit', 'threshold': 0.5})
        with mx.autograd.record():
            loss = net(mx.np.array(x)).sum()
        loss.backward()
        trainer.step(4)
        return net.weight.data(), net.bias.data()
    _same(run, rtol=RTOL)


# ------------------------------------------------------------ fused path
def test_fused_pushpull_local_replicas():
    def run(mx, kv):
        store = kv.create('device')
        vals = [[mx.np.ones((3, 2)) * (k + 1) for _ in range(4)]
                for k in range(3)]
        outs = [mx.np.zeros((3, 2)) for _ in range(3)]
        store.fused_pushpull([0, 1, 2], vals, outs=[[o] for o in outs],
                             priorities=[0, -1, -2])
        return outs
    for k, o in enumerate(_same(run)):
        np.testing.assert_array_equal(o, np.full((3, 2), 4.0 * (k + 1)))


def test_fused_pushpull_sums_into_tensor_targets_in_place():
    """Tensor targets (the Trainer's grad buffers) keep their storage: the
    sum is written into them, and NDArray targets are rebound."""
    kv = tkv.create('device')
    reps = [torch.full((5,), float(r + 1)) for r in range(4)]
    target, ptr = torch.zeros(5), None
    ptr = target.data_ptr()
    kv.fused_pushpull([0], [reps], outs=[[target]])
    assert target.data_ptr() == ptr
    np.testing.assert_array_equal(target.numpy(), np.full(5, 10.0))
    np.testing.assert_array_equal(reps[1].numpy(), np.full(5, 2.0))
    # without outs the replicas themselves are the targets, in place
    ptrs = [r.data_ptr() for r in reps]
    kv.fused_pushpull([0], [reps])
    assert [r.data_ptr() for r in reps] == ptrs
    for r in reps:
        np.testing.assert_array_equal(r.numpy(), np.full(5, 10.0))


def test_fused_pushpull_rebinds_values_without_out():
    def run(mx, kv):
        store = kv.create('local')
        vals = [[mx.np.ones((4,)), mx.np.ones((4,)) * 3]]
        store.fused_pushpull([9], vals)
        return vals[0]
    for v in _same(run):
        np.testing.assert_array_equal(v, np.full((4,), 4.0))


def test_an_ndarray_target_keeps_value_semantics():
    """A view taken from an NDArray target keeps its value after the
    target is written, as the JAX package's rebinding keeps it."""
    kv = tkv.create('local')
    out = tmx.np.zeros((4,))
    view = out[1:3]
    kv.pushpull(0, [tmx.np.ones((4,)), tmx.np.ones((4,))], out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full(4, 2.0))
    np.testing.assert_array_equal(view.asnumpy(), np.zeros(2))


def test_fused_pushpull_with_updater():
    def run(mx, kv):
        store = kv.create('device')
        store.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
        store.init(0, mx.np.ones((2,)) * 10)
        store.init(1, mx.np.ones((3,)) * 20)
        outs = [mx.np.zeros((2,)), mx.np.zeros((3,))]
        store.fused_pushpull([0, 1], [mx.np.ones((2,)),
                                      mx.np.ones((3,)) * 2], outs=outs)
        return outs
    got = _same(run, rtol=RTOL)
    np.testing.assert_allclose(got[0], np.full((2,), 9.5), rtol=RTOL)
    np.testing.assert_allclose(got[1], np.full((3,), 19.0), rtol=RTOL)


def test_fused_pushpull_updater_requires_init():
    for mx, kv in ((jmx, jkv), (tmx, tkv)):
        store = kv.create('local')
        store.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
        with pytest.raises(ValueError):
            store.fused_pushpull([99], [mx.np.ones((2,))])


def test_fused_pushpull_dist_single_process():
    def run(mx, kv):
        store = kv.create('dist_tpu_sync')
        vals = [mx.np.ones((7,)) * (k + 1) for k in range(5)]
        outs = [mx.np.zeros((7,)) for _ in range(5)]
        store.fused_pushpull(list(range(5)), vals, outs=outs,
                             priorities=[-k for k in range(5)])
        return outs
    for k, o in enumerate(_same(run)):
        np.testing.assert_array_equal(o, np.full((7,), float(k + 1)))


def test_fused_pushpull_dist_compressed_single_process():
    def run(mx, kv):
        store = kv.create('dist_tpu_sync')
        store.set_gradient_compression({'type': '2bit', 'threshold': 0.5})
        out = mx.np.zeros((4,))
        store.fused_pushpull(
            [7], [mx.np.array(np.array([0.6, -0.7, 0.1, 0.0], 'f'))],
            outs=[out])
        return out
    _same(run, [0.5, -0.5, 0.0, 0.0])


# --------------------------------------------------------------- the plans
def test_fusion_bucketing_units():
    from mxnet_tpu.kvstore import fusion as jf
    from mxnet_tpu_torch.kvstore import fusion as tf
    for sizes, limit in (([10, 10, 10], 25), ([30, 10], 25), ([], 25)):
        assert tf.make_buckets(sizes, limit) == jf.make_buckets(sizes, limit)
    for sizes, n in (([100, 1, 1, 1], 2), ([5, 9, 3, 3, 7, 1], 3)):
        assert tf.assign_owners(sizes, n) == jf.assign_owners(sizes, n)
    assert tf.assign_owners([4, 4], 2, load=[10, 0]) == \
        jf.assign_owners([4, 4], 2, load=[10, 0])


#: shapes and dtypes of a bucket plan: mixed dtypes interleaved, a key
#: larger than the cap, a 0-d key, and sizes across the 65536 padding
PLAN_CASES = [
    ([((33,), 'float32'), ((5, 7), 'float32'), ((128,), 'float16'),
      ((2, 3, 4), 'float32'), ((513,), 'float16'), ((), 'float32')], 256),
    ([((70000,), 'float32'), ((3,), 'float32'), ((65536,), 'float32'),
      ((1, 65537), 'float32')], 300000),
    ([((1024, 1024), 'float32')] * 3 + [((768,), 'float32')], 4 * 2 ** 20),
]


class _Spec:
    def __init__(self, shape, dtype, to):
        self.shape = shape
        self.dtype = to(dtype)


@pytest.mark.parametrize('case', range(len(PLAN_CASES)))
@pytest.mark.parametrize('reverse', [False, True])
def test_plan_buckets_equals_jax(case, reverse):
    from mxnet_tpu.kvstore import fusion as jf
    from mxnet_tpu_torch.kvstore import fusion as tf
    specs, limit = PLAN_CASES[case]
    order = list(range(len(specs)))[::-1 if reverse else 1]
    j = list(jf.plan_buckets([_Spec(s, d, np.dtype) for s, d in specs],
                             order, limit))
    t = list(tf.plan_buckets(
        [_Spec(s, d, lambda n: getattr(torch, n)) for s, d in specs],
        order, limit))
    assert t == j


@pytest.mark.parametrize('sizes,nproc', [([17, 20, 129, 9], 2),
                                         ([17, 20, 129, 9], 8),
                                         ([70000, 3, 65536, 1], 3),
                                         ([5], 4)])
@pytest.mark.parametrize('with_order', [False, True])
def test_zero1_layout_equals_jax(sizes, nproc, with_order):
    from mxnet_tpu.kvstore import fusion as jf
    from mxnet_tpu_torch.kvstore import fusion as tf
    order = list(range(len(sizes)))[::-1] if with_order else None
    assert tf.zero1_layout(sizes, nproc, order=order) == \
        jf.zero1_layout(sizes, nproc, order=order)


def test_pack_and_split_match_jax():
    import jax.numpy as jnp
    from mxnet_tpu.kvstore import fusion as jf
    from mxnet_tpu_torch.kvstore import fusion as tf
    rng = np.random.default_rng(3)
    shapes = [(17,), (4, 5), (129,), (3, 3)]
    raws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sizes = [int(np.prod(s)) for s in shapes]
    _, _, lmax, layout = tf.zero1_layout(sizes, 3)
    np.testing.assert_array_equal(
        tf._pack_segments([torch.from_numpy(r) for r in raws],
                          layout).numpy(),
        np.asarray(jf._pack_segments([jnp.asarray(r) for r in raws],
                                     layout)))
    flat = tf._concat_flat([torch.from_numpy(r) for r in raws], 65536)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jf._concat_flat(
            [jnp.asarray(r) for r in raws], 65536)))
    offs = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
    for t, j in zip(tf._split_flat(flat, shapes, offs),
                    jf._split_flat(jnp.asarray(flat.numpy()), tuple(shapes),
                                   offs)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------- horovod/byteps delegation
class _MockHvd:
    """The duck-typed horovod.mxnet surface of the JAX tests; a world of
    ``size`` identical ranks, whose allreduce is ``size`` times the
    value."""

    def __init__(self, size=4):
        self._size = size
        self.calls = []

    def init(self):
        self.calls.append(('init',))

    def rank(self):
        return 0

    def local_rank(self):
        return 0

    def size(self):
        return self._size

    def broadcast(self, tensor, root_rank=0, name=None, priority=0):
        self.calls.append(('broadcast', name, root_rank, priority))
        return tensor

    def allreduce(self, tensor, average=False, name=None, priority=0):
        self.calls.append(('allreduce', name, average, priority))
        return tensor * self._size

    def allreduce_(self, tensor, average=False, name=None, priority=0):
        self.calls.append(('allreduce_', name, average, priority))
        tensor[:] = tensor * self._size
        return tensor


class _MockBps:
    """The duck-typed byteps.mxnet surface of the JAX tests."""

    def __init__(self, size=4, rank=0):
        self._size, self._rank = size, rank
        self.calls = []

    def init(self):
        self.calls.append(('init',))

    def rank(self):
        return self._rank

    def local_rank(self):
        return self._rank

    def size(self):
        return self._size

    def byteps_declare_tensor(self, name):
        self.calls.append(('declare', name))

    def byteps_push_pull(self, tensor, version=0, priority=0, name=None,
                         is_average=False):
        self.calls.append(('push_pull', name, version, is_average))
        tensor[:] = tensor * self._size


def test_horovod_byteps_alias_surface():
    for name in ('horovod', 'byteps'):
        kv = tkv.create(name)
        assert kv.num_workers == 1 and kv.rank == 0
        out = tmx.np.zeros((3,))
        kv.init(0, tmx.np.zeros((3,)))
        kv.pushpull(0, tmx.np.ones((3,)) * 2, out=out)
        np.testing.assert_array_equal(out.asnumpy(), 2.0)
    hv = tkv.create('horovod')
    assert hv.local_rank == 0
    assert 'COMPAT ALIAS' in type(hv).__doc__


def test_horovod_delegation_pushpull_broadcast():
    from mxnet_tpu_torch.kvstore.plugins import Horovod
    hvd = _MockHvd(size=4)
    Horovod.set_backend(hvd)
    try:
        kv = tkv.create('horovod')
        assert kv.type == 'horovod'
        assert kv.num_workers == 4 and kv.rank == 0 and kv.local_rank == 0
        assert ('init',) in hvd.calls
        a = tmx.np.ones((2, 3))
        kv.pushpull('g0', a)
        np.testing.assert_array_equal(a.asnumpy(), 4.0)
        assert ('allreduce_', 'g0', False, 0) in hvd.calls
        v, o = tmx.np.ones((3,)) * 2, tmx.np.zeros((3,))
        kv.pushpull('g1', v, out=o)
        np.testing.assert_array_equal(o.asnumpy(), 8.0)
        np.testing.assert_array_equal(v.asnumpy(), 2.0)
        assert ('allreduce', 'g1', False, 0) in hvd.calls
        w, bo = tmx.np.arange(4), tmx.np.zeros((4,))
        kv.broadcast('p0', w, out=bo)
        np.testing.assert_array_equal(bo.asnumpy(), w.asnumpy())
        assert ('broadcast', 'p0', 0, 0) in hvd.calls
        kv.set_optimizer(tmx.optimizer.SGD())
    finally:
        Horovod.set_backend(None)
    kv = tkv.create('horovod')
    assert kv.num_workers == 1 and kv.type == 'dist_tpu_sync'


def test_byteps_delegation_pushpull_broadcast():
    from mxnet_tpu_torch.kvstore.plugins import BytePS
    bps = _MockBps(size=4)
    BytePS.set_backend(bps)
    try:
        kv = tkv.create('byteps')
        assert kv.type == 'byteps' and kv.num_workers == 4 and kv.rank == 0
        a = tmx.np.ones((5,))
        kv.pushpull('k0', a)
        np.testing.assert_array_equal(a.asnumpy(), 4.0)
        assert ('declare', 'k0') in bps.calls
        assert ('push_pull', 'k0', 0, False) in bps.calls
        v, o = tmx.np.ones((2,)), tmx.np.zeros((2,))
        kv.pushpull('k1', v, out=o)
        np.testing.assert_array_equal(o.asnumpy(), 4.0)
        np.testing.assert_array_equal(v.asnumpy(), 1.0)
        w, bo = tmx.np.ones((3,)) * 0.25, tmx.np.zeros((3,))
        kv.broadcast('p1', w, out=bo)
        np.testing.assert_array_equal(bo.asnumpy(), 1.0)
    finally:
        BytePS.set_backend(None)
    assert tkv.create('byteps').num_workers == 1


def test_byteps_broadcast_nonroot_zeroes_contribution():
    from mxnet_tpu_torch.kvstore.plugins import BytePS
    BytePS.set_backend(_MockBps(size=4, rank=2))
    try:
        kv = tkv.create('byteps')
        w, bo = tmx.np.ones((3,)) * 7, tmx.np.zeros((3,))
        kv.broadcast('p2', w, out=bo)
        np.testing.assert_array_equal(bo.asnumpy(), 0.0)
        np.testing.assert_array_equal(w.asnumpy(), 7.0)
    finally:
        BytePS.set_backend(None)


def test_delegation_replica_lists_sum_before_collective():
    from mxnet_tpu_torch.kvstore.plugins import Horovod
    hvd = _MockHvd(size=2)
    Horovod.set_backend(hvd)
    try:
        kv = tkv.create('horovod')
        v0, v1 = tmx.np.ones((3,)), tmx.np.ones((3,)) * 10
        o0, o1 = tmx.np.zeros((3,)), tmx.np.zeros((3,))
        kv.pushpull('rl', [v0, v1], out=[o0, o1])
        np.testing.assert_array_equal(o0.asnumpy(), 22.0)
        np.testing.assert_array_equal(o1.asnumpy(), 22.0)
        assert sum(1 for c in hvd.calls if c[0] == 'allreduce') == 1
        v, oa, ob = tmx.np.ones((2,)), tmx.np.zeros((2,)), \
            tmx.np.zeros((2,))
        kv.pushpull('rs', v, out=[oa, ob])
        np.testing.assert_array_equal(oa.asnumpy(), 2.0)
        np.testing.assert_array_equal(ob.asnumpy(), 2.0)
        w, bo = tmx.np.arange(3), tmx.np.zeros((3,))
        kv.broadcast('rb', [w], out=[bo])
        np.testing.assert_array_equal(bo.asnumpy(), w.asnumpy())
    finally:
        Horovod.set_backend(None)


def test_horovod_broadcast_replica_list_first_wins():
    from mxnet_tpu_torch.kvstore.plugins import Horovod
    Horovod.set_backend(_MockHvd(size=2))
    try:
        kv = tkv.create('horovod')
        w = tmx.np.ones((3,)) * 5
        o0, o1 = tmx.np.zeros((3,)), tmx.np.zeros((3,))
        kv.broadcast('bw', [w, w.copy()], out=[o0, o1])
        np.testing.assert_array_equal(o0.asnumpy(), 5.0)
        np.testing.assert_array_equal(o1.asnumpy(), 5.0)
    finally:
        Horovod.set_backend(None)


def test_byteps_broadcast_multi_replica_list_raises():
    from mxnet_tpu_torch.kvstore.plugins import BytePS
    bps = _MockBps(size=2)
    BytePS.set_backend(bps)
    try:
        kv = tkv.create('byteps')
        w = tmx.np.ones((3,))
        with pytest.raises(ValueError, match='single tensor'):
            kv.broadcast('bw', [w, w.copy()], out=[tmx.np.zeros((3,))])
        assert not any(c[0] == 'push_pull' for c in bps.calls)
        bo = tmx.np.zeros((3,))
        kv.broadcast('bw1', [w], out=[bo])
        np.testing.assert_array_equal(bo.asnumpy(), 2.0)
        v0, v1 = tmx.np.ones((3,)), tmx.np.ones((3,)) * 10
        o0, o1 = tmx.np.zeros((3,)), tmx.np.zeros((3,))
        kv.pushpull('bl', [v0, v1], out=[o0, o1])
        np.testing.assert_array_equal(o0.asnumpy(), 22.0)
        np.testing.assert_array_equal(o1.asnumpy(), 22.0)
        np.testing.assert_array_equal(v0.asnumpy(), 1.0)
    finally:
        BytePS.set_backend(None)
