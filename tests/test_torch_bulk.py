"""``mx.engine`` and the bulking engine of the port against the JAX
package's, on the CPU.

Each test is one of ``tests/test_bulk.py``'s or ``tests/test_engine_exc.py``'s
oracles, run in both packages on the same numpy inputs: values and
gradients equal (1e-6 relative, or the oracle's own tolerance). Where an
oracle reads the engine's internals (a lazy array's ``_lazy``, the
segment's ``out_refs``, ``stats()['compiles']``, ``_MAX_SIBLINGS``) each
package is held to its own: on the CPU the port's segments run through
``_graphs.emulated()`` graphs, so ``compiles`` counts captured segment
shapes, and a second identical segment replays its capture. Threads
enter the CPU context themselves (a context is per thread).
"""

import gc
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import _bulk as jbulk, _tape as jtape
from mxnet_tpu import autograd as jag, engine as jengine, gluon as jgl

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _bulk as tbulk, _tape as ttape
from mxnet_tpu_torch import autograd as tag, engine as tengine, gluon as tgl
from mxnet_tpu_torch.ops import registry as treg

J = dict(mx=jmx, bulk=jbulk, ag=jag, engine=jengine, gl=jgl, tape=jtape,
         cpu=None)
T = dict(mx=tmx, bulk=tbulk, ag=tag, engine=tengine, gl=tgl, tape=ttape,
         cpu=tmx.cpu)
RTOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _both(case):
    """``case(**pkg)`` in each package; the results agree."""
    want, got = case(**J), case(**T)
    _close(got, want)
    return got


def _close(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape
        assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    else:
        assert got == want


# --------------------------------------------------------- tests/test_bulk
def test_lazy_until_sync_point():
    def case(mx, bulk, engine, **_):
        with engine.bulk(100):
            a = mx.np.ones((3, 3))
            b = a * 2 + 1
            assert b._lazy is not None and b._lazy.value is None
            info = [b.shape, str(b.dtype), b.ndim]
            assert b._lazy.value is None        # no flush for those
            got = b.asnumpy()
        return info + [got]
    got = _both(case)
    np.testing.assert_allclose(got[-1], np.full((3, 3), 3.0))


def test_chain_parity_and_cache_reuse():
    def case(mx, bulk, engine, **_):
        bulk.reset()

        def run():
            with engine.bulk(100):
                a = mx.np.arange(12).reshape(3, 4).astype('float32')
                b = mx.np.tanh(a) @ mx.np.ones((4, 2))
                return float((b * b).sum())
        v1 = run()
        compiles = bulk.stats()['compiles']
        v2 = run()                  # the same segment: a trie and plan hit
        assert bulk.stats()['compiles'] == compiles
        return [v1, v2]
    got = _both(case)
    assert got[0] == got[1]


def test_autograd_matches_eager():
    def case(mx, ag, engine, **_):
        def grads(bulked):
            x = mx.np.array([[1., 2.], [3., 4.]])
            x.attach_grad()
            with (engine.bulk(1000) if bulked else engine.naive_engine()):
                with ag.record():
                    y = (x * x).sum() + (3 * x).sum()
                y.backward()
            return x.grad.asnumpy()
        return [grads(True), grads(False)]
    got = _both(case)
    np.testing.assert_allclose(got[0], got[1], rtol=RTOL)


def test_pause_blocks_gradient_inside_segment():
    def case(mx, ag, engine, **_):
        x = mx.np.array([2.0])
        x.attach_grad()
        with engine.bulk(100):
            with ag.record():
                y = x * 3
                with ag.pause():
                    z = y * 10
                w = (y + z).sum()
            w.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], [3.0])


def test_out_kwarg_stays_in_segment():
    def case(mx, engine, **_):
        with engine.bulk(100):
            a = mx.np.ones((4,))
            out = mx.np.zeros((4,))
            mx.np.add(a, a, out=out)
            assert out._lazy is not None and out._lazy.value is None
            return [out.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], np.full((4,), 2.0))


def test_cross_segment_chaining():
    def case(mx, engine, **_):
        with engine.bulk(100):
            a = mx.np.ones((2, 2)) * 4
            first = a.asnumpy()             # a flush mid-stream
            b = a + 1                       # a new segment takes its value
            return [first, b.asnumpy()]
    np.testing.assert_allclose(_both(case)[1], np.full((2, 2), 5.0))


def test_size_cap_flushes():
    def case(mx, engine, **_):
        with engine.bulk(2):
            a = mx.np.ones((2,))
            b = a + 1
            c = b + 1                       # the cap is reached: a flush
            assert c._lazy is None or c._lazy.value is not None
            return [c.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], np.full((2,), 3.0))


def test_varying_scalar_marks_unstable_not_compile_storm():
    def case(mx, bulk, engine, **_):
        compiles0 = bulk.stats()['compiles']
        vals = []
        for i in range(40):
            with engine.bulk(100):
                b = mx.np.ones((2,)) * float(i)
                vals.append(float(b.asnumpy()[0]))
        grown = bulk.stats()['compiles'] - compiles0
        assert grown <= bulk._MAX_SIBLINGS + 6
        return [vals, bulk._MAX_SIBLINGS]
    got = _both(case)
    assert got[0] == [float(i) for i in range(40)]


def test_training_loop_parity_with_trainer():
    xs = np.random.default_rng(0).standard_normal((8, 3)).astype('f')
    ys = (xs @ np.array([[1.], [2.], [3.]], 'f')).astype('f')
    w0 = np.random.default_rng(1).standard_normal((1, 3)).astype('f')

    def case(mx, ag, engine, gl, **_):
        def train(bulked):
            net = gl.nn.Dense(1, in_units=3)
            net.initialize()
            net.weight.set_data(mx.np.array(w0))
            net.bias.set_data(mx.np.zeros((1,)))
            trainer = gl.Trainer(net.collect_params(), 'sgd',
                                 {'learning_rate': 0.1, 'momentum': 0.9})
            with (engine.bulk(4096) if bulked else engine.naive_engine()):
                for _ in range(5):
                    x, y = mx.np.array(xs), mx.np.array(ys)
                    with ag.record():
                        loss = ((net(x) - y) ** 2).mean()
                    loss.backward()
                    trainer.step(1)
            return [net.weight.data().asnumpy(), net.bias.data().asnumpy()]
        return [train(True), train(False)]
    got = _both(case)
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_second_iteration_no_retrace():
    def case(mx, ag, engine, gl, bulk, **_):
        # a fresh trie: a position an earlier test made unstable re-admits
        # every _RETRY-th attempt, which would capture in iteration 2
        bulk.reset()
        net = gl.nn.Dense(4, in_units=4)
        net.initialize()
        net.weight.set_data(mx.np.array(np.eye(4, dtype='f') * 0.5))

        def step():
            with engine.bulk(4096):
                x = mx.np.ones((2, 4)) * (1.0 + 0.0)
                with ag.record():
                    y = (net(x) ** 2).sum()
                y.backward()
                return float(y.asnumpy())

        v0 = step()
        s = bulk.stats()
        v1 = step()
        s2 = bulk.stats()
        assert s2['compiles'] == s['compiles'], 'iteration 2 recompiled'
        assert s2['misses'] == s['misses'], 'iteration 2 missed the trie'
        return [v0, v1, net.weight.grad().asnumpy()]
    _both(case)


def test_dead_intermediates_not_materialized():
    def case(mx, bulk, engine, **_):
        bulk.reset()
        with engine.bulk(100):
            a = mx.np.ones((4, 4))
            b = a * 2
            tmp = a * 3
            del tmp
            gc.collect()
            seg = bulk._st.segment
            n_live = sum(1 for e in seg.entries for w in e.out_refs
                         if w() is not None)
            return [n_live, b.asnumpy()]
    assert _both(case)[0] == 1


def test_nondifferentiable_op_detached():
    def case(mx, ag, engine, **_):
        x = mx.np.array([1.5, 2.5])
        x.attach_grad()
        with engine.bulk(100):
            with ag.record():
                s = (mx.np.round(x) * x).sum()
            s.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], np.round([1.5, 2.5]))


def test_higher_order_through_segment():
    def case(mx, ag, engine, **_):
        x = mx.np.array([2.0])
        x.attach_grad()
        with engine.bulk(100):
            with ag.record():
                y = (x ** 3).sum()
                gx, = ag.grad(y, [x], create_graph=True)
                gy = gx.sum()
            gy.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], [12.0])


def test_stochastic_op_bulks_with_fresh_keys():
    def case(mx, engine, **_):
        with engine.bulk(100):
            a = mx.np.random.uniform(size=(64,))
            b = mx.np.random.uniform(size=(64,))
            va, vb = a.asnumpy(), b.asnumpy()
        assert not np.allclose(va, vb)
        return [va.shape, str(va.dtype)]
    _both(case)


def test_naive_engine_bypasses_bulk():
    def case(mx, engine, **_):
        with engine.naive_engine():
            a = mx.np.ones((2,)) + 1
            assert a._lazy is None
        return [a.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], [2.0, 2.0])


def test_set_bulk_size_toggles():
    def case(mx, engine, bulk, **_):
        prev_size = bulk._size
        try:
            engine.set_bulk_size(16)
            a = mx.np.ones((2,)) * 5
            assert a._lazy is not None
            engine.set_bulk_size(0)
            b = mx.np.ones((2,)) * 5
            assert b._lazy is None
            return [a.asnumpy(), b.asnumpy()]
        finally:
            bulk._enabled = None
            bulk._size = prev_size
    _both(case)


def test_bulk_stats_surface():
    def case(engine, **_):
        return [sorted(engine.bulk_stats())]
    assert {'hits', 'misses', 'flushes', 'compiles'} <= set(_both(case)[0])


def test_detach_blocks_gradient_inside_segment():
    def case(mx, ag, engine, **_):
        def run(bulked):
            x = mx.np.array([1.0, 2.0, 3.0])
            w = mx.np.array([1.0, 1.0, 1.0])
            x.attach_grad()
            w.attach_grad()
            with (engine.bulk(100) if bulked else engine.naive_engine()):
                with ag.record():
                    y = x * 2
                    z = y.detach() * w
                    loss = (y + z).sum()
                loss.backward()
            return [x.grad.asnumpy(), w.grad.asnumpy()]
        return [run(True), run(False)]
    got = _both(case)
    _close(got[0], got[1])


def test_detached_boundary_alias_keeps_tracked_gradient():
    def case(mx, ag, engine, **_):
        def run(bulked):
            x = mx.np.array([1.0, 2.0, 3.0])
            x.attach_grad()
            with (engine.bulk(100) if bulked else engine.naive_engine()):
                with ag.record():
                    a = x.detach() + 0.0
                    b = x * 3.0
                    loss = (a + b).sum()
                loss.backward()
            return x.grad.asnumpy()
        return [run(True), run(False)]
    got = _both(case)
    np.testing.assert_allclose(got[0], [3.0, 3.0, 3.0])


def test_scalar_type_distinguishes_cache_keys():
    def case(mx, engine, **_):
        with engine.bulk(100):
            x = mx.np.array(np.array([1, 2, 3], 'int32'))
            a = (x ** 2).asnumpy()
            b = (x ** 2.0).asnumpy()
        assert str(b.dtype).startswith('float')
        return [a, b]
    _both(case)


def test_aliased_lineages_get_distinct_boundary_slots():
    def case(mx, ag, engine, **_):
        def run(bulked):
            x = mx.np.array([2.0, 3.0])
            x.attach_grad()
            y = x.detach()
            y.attach_grad()
            with (engine.bulk(100) if bulked else engine.naive_engine()):
                with ag.record():
                    z = (x * 3 + y * 5).sum()
                z.backward()
            return [x.grad.asnumpy(), y.grad.asnumpy()]
        return [run(True), run(False)]
    got = _both(case)
    _close(got[0], got[1])


def test_aliased_lineages_pending_value():
    def case(mx, ag, engine, **_):
        def run(bulked):
            a = mx.np.array([2.0, 3.0])
            a.attach_grad()
            with (engine.bulk(100) if bulked else engine.naive_engine()):
                with ag.record():
                    x = a * 1.0
                    y = x.detach()
                    y.attach_grad()
                    z = (x * 3 + y * 5).sum()
                z.backward()
            return [a.grad.asnumpy(), y.grad.asnumpy()]
        return [run(True), run(False)]
    got = _both(case)
    _close(got[0], got[1])


def test_marked_pending_alias_dispatches_eagerly():
    def case(mx, ag, engine, tape, **_):
        def run(bulked):
            a = mx.np.array([2.0, 3.0])
            a.attach_grad()
            with (engine.bulk(100) if bulked else engine.naive_engine()):
                with ag.record():
                    x = a * 1.0
                    y = x.detach()
                    tape.mark_variables([y], [mx.np.zeros((2,))])
                    z = (x * 3 + y * 5).sum()
                z.backward()
            return [a.grad.asnumpy(), y.grad.asnumpy()]
        return [run(True), run(False)]
    got = _both(case)
    _close(got[0], got[1])


def test_hashable_slice_recurses():
    """An unhashable member of a slice makes the key raise (the op runs
    eagerly); numpy-integer members tokenize by the scalar rules, as the
    JAX package's do."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    import torch
    with pytest.raises(jreg._Unkeyable):
        jreg._hashable(slice(jnp.ones((2,)), None, None))
    with pytest.raises(treg._Unkeyable):
        treg._hashable(slice(torch.ones(2), None, None))
    for reg in (jreg, treg):
        t_np = reg._hashable(slice(np.int32(2), None, None))
        t_py = reg._hashable(slice(2, None, None))
        assert t_np != t_py
        assert t_py == ('__slice__', ('i', 2), None, None)
    assert treg._hashable(slice(np.int32(2), None, None)) == \
        jreg._hashable(slice(np.int32(2), None, None))


def test_foreign_thread_settle_interleaving():
    """Another thread flushes the recording thread's segment between two
    of its records: the second record starts a fresh segment."""
    def case(mx, engine, cpu, **_):
        out, errs = {}, []
        e_recorded, e_settled = threading.Event(), threading.Event()

        def recorder():
            try:
                with (cpu() if cpu else _Null()), engine.bulk(64):
                    a = mx.np.ones((4,))
                    out['y'] = a + 1
                    seg1 = out['y']._lazy.seg
                    e_recorded.set()
                    assert e_settled.wait(10)
                    b = mx.np.ones((4,)) * 3
                    out['w'] = b + 1
                    assert out['w']._lazy is not None
                    assert out['w']._lazy.seg is not seg1
                    assert seg1.flushed
            except Exception as e:
                errs.append(e)
                e_recorded.set()

        t = threading.Thread(target=recorder)
        t.start()
        assert e_recorded.wait(10)
        assert not errs
        y = out['y'].asnumpy()           # settled from this thread
        e_settled.set()
        t.join(10)
        assert not errs, errs
        return [y, out['w'].asnumpy()]
    got = _both(case)
    np.testing.assert_allclose(got[1], 4.0)


def test_foreign_settle_stress():
    """A thread keeps settling the freshest lazy output of another that
    records: every settled value is right, and so is every value at the
    end."""
    def case(mx, engine, cpu, **_):
        rounds = 30
        # one (array, round) pair, published in one store: the oracle's two
        # stores could be read between them, an array with the round before
        latest = {'pair': (None, -1)}
        stop = threading.Event()
        errs = []

        def settler():
            try:
                with (cpu() if cpu else _Null()):
                    while not stop.is_set():
                        nd, rnd = latest['pair']
                        if nd is not None:
                            np.testing.assert_allclose(nd.asnumpy(),
                                                       float(rnd + 2))
            except Exception as e:
                errs.append(e)

        t = threading.Thread(target=settler)
        t.start()
        try:
            finals = []
            with engine.bulk(8):
                for i in range(rounds):
                    y = mx.np.ones((4,)) * (i + 1) + 1
                    latest['pair'] = (y, i)
                    finals.append(y)
            vals = [y.asnumpy() for y in finals]
        finally:
            stop.set()
            t.join(10)
        assert not errs, errs
        return vals
    got = _both(case)
    for i, v in enumerate(got):
        np.testing.assert_allclose(v, float(i + 2))


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# --------------------------------------------------- tests/test_engine_exc
def test_async_dispatch_and_sync_points():
    def case(mx, **_):
        a = mx.np.ones((64, 64))
        b = a @ a
        b.wait_to_read()
        mx.nd.waitall()
        return [float(b.asnumpy()[0, 0])]
    assert _both(case) == [64.0]


def test_shape_errors_raise_eagerly():
    def case(mx, engine, **_):
        a, b = mx.np.ones((2, 3)), mx.np.ones((4, 5))
        raised = []
        for scope in (_Null, lambda: engine.bulk(16)):
            with scope():
                try:
                    a @ b
                    raised.append(False)
                except Exception:
                    raised.append(True)
        return raised
    assert _both(case) == [True, True]


def test_nonfinite_values_do_not_raise():
    def case(mx, **_):
        x = mx.np.array(np.array([1.0, 0.0], 'f'))
        y = mx.np.array(np.array([0.0, 0.0], 'f'))
        out = (x / y).asnumpy()
        return [bool(np.isinf(out[0])), bool(np.isnan(out[1]))]
    assert _both(case) == [True, True]


def test_exception_inside_record_leaves_tape_usable():
    def case(mx, ag, **_):
        x = mx.np.ones((2, 2))
        x.attach_grad()
        with ag.record():
            y = (x * 2).sum()
            try:
                x @ mx.np.ones((3, 3))
            except Exception:
                pass
        y.backward()
        return [x.grad.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], np.full((2, 2), 2.0))


def test_naive_engine_scope():
    def case(mx, engine, gl, **_):
        with engine.naive_engine():
            a = mx.np.ones((8, 8))
            out = float((a * 3).sum().asnumpy())
            net = gl.nn.Dense(2, in_units=8)
            net.initialize()
            net.weight.set_data(mx.np.array(np.ones((2, 8), 'f')))
            net.hybridize()
            net(a)
            y = net(a).asnumpy()
        return [out, y]
    got = _both(case)
    assert got[0] == 192.0
    # the port's naive engine replays no graph: no capture there
    with tengine.naive_engine():
        from mxnet_tpu_torch import _graphs
        assert not _graphs.can_capture('cuda')
        assert tengine.engine_type() == 'NaiveEngine'
    assert tengine.engine_type() == jengine.engine_type()


def test_bulk_scope_is_transparent():
    def case(mx, engine, **_):
        with engine.bulk(16):
            x = mx.np.ones((4,))
            for _ in range(5):
                x = x + 1
        return [x.asnumpy()]
    np.testing.assert_allclose(_both(case)[0], np.full((4,), 6.0))


def test_waitall_after_many_async_ops():
    def case(mx, **_):
        xs = [mx.np.ones((32, 32)) * i for i in range(10)]
        ys = [x @ x for x in xs]
        mx.nd.waitall()
        return [float(y.asnumpy()[0, 0]) for y in ys]
    assert _both(case) == [32.0 * i * i for i in range(10)]


def test_autograd_state_is_thread_local():
    def case(ag, **_):
        flags = {}
        ev_main, ev_worker = threading.Event(), threading.Event()

        def worker():
            with ag.record():
                flags['worker_inside'] = ag.is_recording()
                ev_main.set()
                ev_worker.wait(5)
            flags['worker_after'] = ag.is_recording()

        t = threading.Thread(target=worker)
        t.start()
        ev_main.wait(5)
        flags['main_during'] = ag.is_recording()
        ev_worker.set()
        t.join()
        return [sorted(flags.items())]
    assert _both(case) == [[('main_during', False), ('worker_after', False),
                            ('worker_inside', True)]]


def test_concurrent_eager_ops():
    def case(mx, cpu, **_):
        results = [None] * 4

        def worker(i):
            with (cpu() if cpu else _Null()):
                x = mx.np.full((64, 64), float(i + 1))
                results[i] = float((x @ x).sum().asnumpy())

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return results
    assert _both(case) == [64.0 * 64 * 64 * (i + 1) ** 2 for i in range(4)]


def test_multithreaded_hybridized_inference():
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal((8, 32)).astype('float32') for _ in range(8)]
    w1 = rng.standard_normal((16, 32)).astype('f') * 0.1
    w2 = rng.standard_normal((4, 16)).astype('f') * 0.1

    def case(mx, gl, cpu, **_):
        net = gl.nn.HybridSequential()
        net.add(gl.nn.Dense(16, activation='relu', in_units=32))
        net.add(gl.nn.Dense(4, in_units=16))
        net.initialize()
        for k, v in {'0.weight': w1, '0.bias': np.zeros(16, 'f'),
                     '1.weight': w2, '1.bias': np.zeros(4, 'f')}.items():
            net.collect_params()[k].set_data(mx.np.array(v))
        net.hybridize(static_alloc=True)
        xs = [mx.np.array(x) for x in inputs]
        net(xs[0]).wait_to_read()
        expected = [net(x).asnumpy() for x in xs]
        results, errors = [None] * len(xs), []

        def worker(idx):
            try:
                with (cpu() if cpu else _Null()):
                    for _ in range(5):
                        results[idx] = net(xs[idx]).asnumpy()
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        for got, want in zip(results, expected):
            np.testing.assert_allclose(got, want, rtol=1e-6)
        return expected
    _both(case)
