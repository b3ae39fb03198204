"""The port's NDArray against the JAX package's on the CPU: value
semantics over torch's views, ``out=``, the dtypes of ``array()`` and of
the ops (JAX's 32-bit results and weak scalars), gathers out of range,
the sync points, and the context of arrays. Values compare exactly unless
a tolerance is stated."""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def both(fn):
    """``fn(mx)`` for each package, as numpy."""
    out = []
    for mx in (jmx, tmx):
        r = fn(mx)
        out.append(r.asnumpy() if hasattr(r, 'asnumpy') else r)
    return out


def same(fn, rtol=0.0):
    j, t = both(fn)
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape
    if rtol:
        np.testing.assert_allclose(t, j, rtol=rtol)
    else:
        np.testing.assert_array_equal(t, j)


# ----------------------------------------------------------- value semantics
def test_a_slice_keeps_its_values_after_the_source_is_written():
    x = tmx.np.array(np.arange(6, dtype='float32'))
    y = x[1:3]
    x[:] = 0
    np.testing.assert_array_equal(y.asnumpy(), [1, 2])
    x2 = tmx.np.array(np.arange(6, dtype='float32'))
    z = x2[::2]
    x2 += 10
    np.testing.assert_array_equal(z.asnumpy(), [0, 2, 4])
    w = x2.reshape((2, 3))
    x2[1] = -1
    np.testing.assert_array_equal(w.asnumpy()[0], [10, 11, 12])


def test_setitem_and_inplace_ops_match_jax():
    def prog(mx):
        x = mx.np.array(np.arange(12, dtype='float32').reshape(3, 4))
        x[1] = 5
        x[:, 2] = mx.np.array(np.array([7, 8, 9], dtype='float32'))
        x[0, ::-1] = mx.np.array(np.arange(4, dtype='float32'))
        x *= 2
        x -= 1
        x[x > 10] = 0
        return x
    same(prog)


def test_getitem_forms_match_jax():
    a = np.arange(24, dtype='float32').reshape(2, 3, 4)
    keys = [1, -1, (slice(None), 1), (Ellipsis, 2), (None, 0),
            (0, slice(None, None, -1)), (1, slice(1, 3), slice(None, None, 2))]
    for key in keys:
        same(lambda mx, k=key: mx.np.array(a)[k])
    same(lambda mx: mx.np.array(a)[mx.np.array(np.array([1, 0, 1],
                                                        'int32'))])
    same(lambda mx: mx.np.array(a)[mx.np.array(a) > 5])


def test_out_writes_into_the_given_array_and_drops_recording():
    for mx in (jmx, tmx):
        x = mx.np.array(np.array([1., 2.], dtype='float32'))
        o = mx.np.zeros((2,))
        x.attach_grad()
        with mx.autograd.record():
            r = mx.np.multiply(x, 3, out=o)
        assert r is o
        np.testing.assert_array_equal(o.asnumpy(), [3, 6])


def test_copyto_and_copy_are_independent_values():
    x = tmx.np.array(np.array([1., 2.], dtype='float32'))
    c = x.copy()
    d = tmx.np.zeros((2,), dtype='int32')
    x.copyto(d)
    x[:] = 9
    np.testing.assert_array_equal(c.asnumpy(), [1, 2])
    np.testing.assert_array_equal(d.asnumpy(), [1, 2])
    assert d.dtype == np.int32


def test_asnumpy_is_a_copy():
    x = tmx.np.array(np.array([1., 2.], dtype='float32'))
    a = x.asnumpy()
    a[0] = 5
    np.testing.assert_array_equal(x.asnumpy(), [1, 2])
    src = np.array([3., 4.], dtype='float32')
    y = tmx.np.array(src)
    src[0] = 0
    np.testing.assert_array_equal(y.asnumpy(), [3, 4])


def test_a_variable_stays_a_variable_across_writes():
    x = tmx.np.array(np.array([1., 2.], dtype='float32'))
    x.attach_grad()
    x += 1
    x[0] = 5
    with tmx.autograd.record():
        y = (x * x).sum()
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [10, 6])


# -------------------------------------------------------------------- dtypes
@pytest.mark.parametrize('src,dtype', [
    (np.arange(3, dtype='float64'), None), (np.arange(3, dtype='int64'), None),
    ([1, 2], None), ([1.5, 2], None), ([True, False], None),
    (np.arange(3, dtype='uint8'), None), (np.arange(3, dtype='float16'), None),
    (np.arange(3), 'float64'), (np.arange(3), 'int64'), ([1, 2], 'float32'),
    (3.0, None), (np.arange(4, dtype='int16'), None)])
def test_array_dtypes_match_jax(src, dtype):
    same(lambda mx: mx.np.array(src, dtype=dtype))


INT = np.array([3, -1, 4, 1, 5], dtype='int32')
F32 = np.array([0.5, -1.5, 2.0, 3.25], dtype='float32')


@pytest.mark.parametrize('prog', [
    lambda mx: mx.np.array(INT).sum(),
    lambda mx: mx.np.array(INT).argmax(),
    lambda mx: mx.np.argsort(mx.np.array(INT)),
    lambda mx: mx.np.cumsum(mx.np.array(INT)),
    lambda mx: mx.np.array(INT).mean(),
    lambda mx: mx.np.arange(5),
    lambda mx: mx.np.arange(0.0, 1.0, 0.25),
    lambda mx: mx.npx.topk(mx.np.array(F32), k=2),
    lambda mx: mx.npx.topk(mx.np.array(F32), k=2, dtype='int32'),
    lambda mx: mx.np.prod(mx.np.array(INT)),
    lambda mx: mx.np.array(INT) * 2.5,
    lambda mx: mx.np.array(INT) * 2,
    lambda mx: mx.np.array(F32) + np.float64(1.5),
    lambda mx: mx.np.array(INT) + np.float64(1.5),
    lambda mx: mx.np.array(np.array([1, 2], 'uint8')) + np.int64(3),
    lambda mx: mx.np.array(np.array([1, 2], 'uint8')) + 3,
    lambda mx: mx.np.array(INT) / mx.np.array(INT),
    lambda mx: mx.np.array(INT) // 2,
    lambda mx: mx.np.array(INT) > 1,
    lambda mx: mx.np.array(np.array([1., 2.], 'float16')) * 2.0,
    lambda mx: mx.np.array(np.array([1, 2], 'int8')) + mx.np.array(
        np.array([3, 4], 'uint8')),
    lambda mx: mx.np.array(np.array([True, False])) + 1,
    lambda mx: mx.np.sqrt(mx.np.array(np.array([4, 9], 'int32'))),
    lambda mx: mx.np.full((2,), 7),
    lambda mx: mx.np.full((2,), 7.5),
    lambda mx: mx.np.bincount(mx.np.array(np.array([0, 2, 2], 'int32'))),
    lambda mx: mx.np.count_nonzero(mx.np.array(INT)),
    lambda mx: mx.npx.shape_array(mx.np.array(F32)),
])
def test_op_dtypes_match_jax(prog):
    same(prog, rtol=1e-6)


# ------------------------------------------------------- indices out of range
W = np.arange(12, dtype='float32').reshape(4, 3)


@pytest.mark.parametrize('prog', [
    lambda mx: mx.np.take(mx.np.array(W), mx.np.array(
        np.array([0, 5, -1, -9], 'int32')), axis=0),
    lambda mx: mx.np.take(mx.np.array(W), mx.np.array(
        np.array([0, 5, -1], 'int32')), axis=0, mode='wrap'),
    lambda mx: mx.npx.embedding(mx.np.array(np.array([0, 5, -1], 'int32')),
                                mx.np.array(W)),
    lambda mx: mx.npx.pick(mx.np.array(W), mx.np.array(
        np.array([0, 4, -1, 2], 'int32'))),
    lambda mx: mx.npx.gather_nd(mx.np.array(W), mx.np.array(
        np.array([[0, 7, -1]], 'int32'))),
    lambda mx: mx.np.take_along_axis(mx.np.array(W), mx.np.array(
        np.array([[0], [5], [-1], [2]], 'int32')), axis=1),
    lambda mx: mx.np.array(W)[mx.np.array(np.array([9, -1, -7], 'int32'))],
])
def test_gathers_out_of_range_match_jax(prog):
    j, t = both(prog)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


# ------------------------------------------------------------ kernel-backed
def test_fused_adam_step_leaves_its_inputs_unchanged():
    rng = np.random.default_rng(0)
    w, g, m, v = (rng.standard_normal((5, 7)).astype('float32')
                  for _ in range(4))
    v = np.abs(v)
    res = {}
    for mx in (jmx, tmx):
        arrs = [mx.np.array(a) for a in (w, g, m, v)]
        out = mx.npx.fused_adam_step(*arrs, lr=0.01, wd=0.1, t=3)
        for a, src in zip(arrs, (w, g, m, v)):
            np.testing.assert_array_equal(a.asnumpy(), src)
        res[mx] = [o.asnumpy() for o in out]
    for a, b in zip(res[tmx], res[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    arrs = [tmx.np.array(a) for a in (w, g, m)]
    out = tmx.npx.fused_sgd_mom_step(*arrs, lr=0.1, momentum=0.9)
    for a, src in zip(arrs, (w, g, m)):
        np.testing.assert_array_equal(a.asnumpy(), src)
    want = jmx.npx.fused_sgd_mom_step(*[jmx.np.array(a) for a in (w, g, m)],
                                      lr=0.1, momentum=0.9)
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)


def test_tensor_functions_stay_in_place_for_the_trainer():
    from mxnet_tpu_torch.ops.optimizer_ops import fused_adam_step
    w, g, m, v = (torch.ones(4) for _ in range(4))
    out = fused_adam_step(w, g, m, v, lr=0.1)
    assert out[0] is w and not torch.equal(w, torch.ones(4))


def test_flash_attention_ignores_tpu_tiles():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 8, 16)).astype('float32')
               for _ in range(3))
    j = jmx.npx.flash_attention(*[jmx.np.array(a) for a in (q, k, v)],
                                causal=True, block_q=8, block_k=8)
    t = tmx.npx.flash_attention(*[tmx.np.array(a) for a in (q, k, v)],
                                causal=True, block_q=8, block_k=8)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------- sync points, devices
def test_sync_points_and_context():
    x = tmx.np.ones((2, 2))
    x.wait_to_read()
    tmx.waitall()
    assert tmx.np.array([3.0]).item() == 3.0
    assert x.context == tmx.cpu() and x.ctx == tmx.cpu()
    assert x._data.device.type == 'cpu'
    assert (x + 1).context == tmx.cpu()
    assert x.as_in_context(tmx.cpu()) is x


def test_no_card_and_no_context_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with tmx.gpu(0):
        with pytest.raises(MXNetError):
            tmx.np.ones((2, 3))
        with pytest.raises(MXNetError):
            tmx.np.array([1.0, 2.0])
        with pytest.raises(MXNetError):
            tmx.np.random.uniform(size=(2,))


def test_random_ops_reproduce_under_seed_and_keep_their_moments():
    tmx.random.seed(7)
    a = tmx.np.random.normal(1.0, 2.0, size=(20000,)).asnumpy()
    u = tmx.np.random.uniform(-1, 3, size=(20000,)).asnumpy()
    tmx.random.seed(7)
    b = tmx.np.random.normal(1.0, 2.0, size=(20000,)).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32 and a.shape == (20000,)
    # moments within 5 standard errors
    assert abs(a.mean() - 1.0) < 5 * 2.0 / np.sqrt(20000)
    assert abs(a.std() - 2.0) < 0.05
    assert u.min() >= -1 and u.max() < 3 and abs(u.mean() - 1.0) < 0.05
    r = tmx.np.random.randint(0, 5, size=(1000,))
    assert r.dtype == np.int32 and r.asnumpy().max() == 4
    x = tmx.np.ones((1000,))
    d = tmx.npx.dropout(x, p=0.5).asnumpy()
    assert set(np.unique(d)) <= {0.0, 2.0} and 0.4 < d.mean() < 1.6
    st = tmx.random.get_state()
    c = tmx.np.random.rand(5).asnumpy()
    tmx.random.set_state(st)
    np.testing.assert_array_equal(tmx.np.random.rand(5).asnumpy(), c)


def test_numpy_on_the_left_and_the_host_fallback():
    a = tmx.np.ones((2,))
    assert isinstance(np.float64(2) * a, tmx.NDArray)
    assert isinstance(np.ones(2, 'float32') + a, tmx.NDArray)
    j = jmx.np.intersect1d(np.array([1, 0, 2]), np.array([2, 1, 5]))
    t = tmx.np.intersect1d(np.array([1, 0, 2]), np.array([2, 1, 5]))
    assert isinstance(t, tmx.NDArray) and t.context == tmx.cpu()
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
