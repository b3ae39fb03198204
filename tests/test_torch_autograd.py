"""The port's ``mx.autograd`` against the JAX package's on the CPU: the
cases of ``tests/test_autograd.py`` run through both packages, and the
semantics around them (``grad_req`` write/add/null, head gradients, a
second ``backward()``, ``pause``/``predict_mode``, ``autograd.grad``
with ``create_graph``, custom ``Function``, and the kernel-backed ops'
gradients under ``record()``). Gradients agree within rtol 1e-5 and atol
1e-6 unless stated."""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = pytest.mark.parametrize('mx', [jmx, tmx], ids=['jax', 'torch'])


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def both(prog):
    return [prog(mx) for mx in (jmx, tmx)]


def agree(prog, rtol=1e-5, atol=1e-6):
    j, t = both(prog)
    for a, b in zip(t, j):
        close(a, b, rtol, atol)


def test_basic_backward():
    def prog(mx):
        x = mx.np.array([1., 2., 3.])
        x.attach_grad()
        with mx.autograd.record():
            y = (x * x * 2).sum()
        y.backward()
        return [x.grad.asnumpy()]
    agree(prog)
    close(prog(tmx)[0], [4, 8, 12])


def test_chain_rule():
    def prog(mx):
        x = mx.np.array([0.5, -0.5])
        x.attach_grad()
        with mx.autograd.record():
            y = mx.np.exp(mx.np.sin(x)).sum()
        y.backward()
        return [x.grad.asnumpy()]
    agree(prog)


def test_out_grad_and_non_scalar_heads():
    def prog(mx):
        x = mx.np.array([1., 2.])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 3
        y.backward(mx.np.array([10., 100.]))
        g1 = x.grad.asnumpy()
        with mx.autograd.record():
            z = x * x            # non-scalar head, no head gradient: ones
        z.backward()
        return [g1, x.grad.asnumpy()]
    agree(prog)
    close(prog(tmx)[0], [30, 300])


@PKGS
def test_grad_req_add_accumulates_across_backwards(mx):
    x = mx.np.array([1., 1.])
    x.attach_grad(grad_req='add')
    for _ in range(3):
        with mx.autograd.record():
            y = (x * 2).sum()
        y.backward()
    close(x.grad.asnumpy(), [6., 6.])
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    y.backward()         # a second backward over the same graph adds again
    close(x.grad.asnumpy(), [10., 10.])


@PKGS
def test_grad_req_write_and_null(mx):
    x = mx.np.array([3.])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
    y.backward(retain_graph=True)
    close(x.grad.asnumpy(), [6.])
    y.backward()            # write replaces
    close(x.grad.asnumpy(), [6.])
    y.backward()            # and the graph is still there, as in the tape
    close(x.grad.asnumpy(), [6.])
    n = mx.np.array([2.])
    n.attach_grad(grad_req='null')
    with mx.autograd.record():
        z = (n * x).sum()
    z.backward()
    close(n.grad.asnumpy(), [0.])
    close(x.grad.asnumpy(), [2.])


def test_multiple_variables():
    def prog(mx):
        a = mx.np.array([2.])
        b = mx.np.array([3.])
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = a * b + a
        y.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]
    agree(prog)


def test_grad_function_leaves_buffers():
    def prog(mx):
        x = mx.np.array([1., 2., 3.])
        x.attach_grad()
        with mx.autograd.record():
            y = (x ** 3).sum()
        g = mx.autograd.grad(y, x)
        return [g.asnumpy(), x.grad.asnumpy()]
    agree(prog)
    close(prog(tmx)[1], np.zeros(3))


def test_grad_with_create_graph_is_differentiable():
    def prog(mx):
        x = mx.np.array([0.5, -1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = (x ** 3).sum()
            gx = mx.autograd.grad(y, x, create_graph=True)
            z = (gx * gx).sum()
        z.backward()
        return [gx.asnumpy(), x.grad.asnumpy()]
    agree(prog, rtol=1e-5)
    close(prog(tmx)[1], 36 * np.array([0.5, -1.0, 2.0]) ** 3)


def test_create_graph_through_the_fused_norm():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((4, 16)).astype('float32')
    gamma = rng.uniform(0.5, 1.5, 16).astype('float32')

    def prog(mx):
        x = mx.np.array(data)
        g = mx.np.array(gamma)
        x.attach_grad()
        with mx.autograd.record():
            y = (mx.npx.rms_norm(x, g) ** 2 * 0.5).sum()
            gx = mx.autograd.grad(y, x, create_graph=True)
            z = (gx * gx).sum()
        z.backward()
        return [gx.asnumpy(), x.grad.asnumpy()]
    agree(prog, rtol=1e-4, atol=1e-5)


def test_detach_and_stop_gradient():
    def prog(mx):
        x = mx.np.array([2.])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            z = y.detach() * x
        z.backward()
        x2 = mx.np.array([2.])
        x2.attach_grad()
        with mx.autograd.record():
            w = mx.nd.stop_gradient(x2 * x2) * x2
        w.backward()
        return [x.grad.asnumpy(), x2.grad.asnumpy()]
    agree(prog)
    close(prog(tmx)[0], [4.])


@PKGS
def test_pause_and_modes(mx):
    x = mx.np.array([1.])
    x.attach_grad()
    assert not mx.autograd.is_recording()
    with mx.autograd.record():
        assert mx.autograd.is_recording() and mx.autograd.is_training()
        with mx.autograd.pause():
            assert not mx.autograd.is_recording()
            y_nograd = x * 5
        y = x * 2
    y.backward()
    close(x.grad.asnumpy(), [2.])
    with mx.autograd.record(train_mode=False):
        assert not mx.autograd.is_training()
    with mx.autograd.predict_mode():
        assert not mx.autograd.is_training()
    with mx.autograd.train_mode():
        assert mx.autograd.is_training()
    with pytest.raises(ValueError):
        y_nograd.backward()
    if mx is tmx:
        assert not y_nograd._data.requires_grad
        assert not (x * 5)._data.requires_grad      # outside record()


def test_custom_function():
    def prog(mx):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = mx.np.array(1.0 / (1.0 + np.exp(-x.asnumpy())))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

        x = mx.np.array([0.0, 1.0, -1.0])
        x.attach_grad()
        with mx.autograd.record():
            y = Sigmoid()(x)
            z = (y * mx.np.array([1.0, 2.0, 3.0])).sum()
        z.backward()
        return [y.asnumpy(), x.grad.asnumpy()]
    agree(prog)


def test_grad_through_matmul_and_mark_variables():
    a = np.random.default_rng(2).standard_normal((3, 4)).astype('float32')
    wv = np.random.default_rng(3).standard_normal((4, 2)).astype('float32')

    def prog(mx):
        w = mx.np.array(wv)
        w.attach_grad()
        with mx.autograd.record():
            out = (mx.np.dot(mx.np.array(a), w)).sum()
        out.backward()
        x = mx.np.array([1.])
        g = mx.np.zeros((1,))
        mx.autograd.mark_variables(x, g)
        with mx.autograd.record():
            y = x * 7
        y.backward()
        return [w.grad.asnumpy(), x.grad.asnumpy(), g.asnumpy()]
    agree(prog)


def test_kernel_ops_record_only_under_record():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 8, 16)).astype('float32')
               for _ in range(3))
    x = tmx.np.array(q)
    x.attach_grad()
    out = tmx.npx.flash_attention(x, tmx.np.array(k), tmx.np.array(v),
                                  causal=True)
    assert not out._data.requires_grad
    n = tmx.npx.rms_norm(x, tmx.np.ones((16,)))
    assert not n._data.requires_grad

    def prog(mx):
        xs = [mx.np.array(a) for a in (q, k, v)]
        for a in xs:
            a.attach_grad()
        with mx.autograd.record():
            o = mx.npx.flash_attention(*xs, causal=True)
            y = (mx.npx.layer_norm(o, mx.np.ones((16,)),
                                   mx.np.zeros((16,))) ** 2).sum()
        y.backward()
        return [a.grad.asnumpy() for a in xs]
    agree(prog, rtol=1e-4, atol=1e-5)
