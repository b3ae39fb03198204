"""The port's FFT ops (``mx.np.fft``, ``npx.contrib_fft``/``contrib_ifft``)
and control flow (``npx.foreach``, ``while_loop``, ``cond``, also under
``mx.nd.contrib``) against the JAX package's. The oracles are the FFT
cases of ``tests/test_fft_detection.py`` and ``tests/test_control_flow.py``.

Tolerances: FFT outputs within 1e-5 of the input's norm (complex outputs
compared as real and imaginary parts); control-flow outputs and gradients
at rtol 1e-6 (the bodies are elementwise).
"""

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, gluon as tgl

from torch_a3_cases import FFT


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _close_to_norm(got, want, x):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    tol = 1e-5 * max(float(np.linalg.norm(x)), 1.0)
    assert float(np.abs(got - want).max()) <= tol


# -------------------------------------------------------------------- FFT
def test_np_fft_parity():
    x = np.random.default_rng(0).uniform(size=16).astype('f')
    got = tmx.np.fft.fft(tmx.np.array(x)).asnumpy()
    want = jmx.np.fft.fft(jmx.np.array(x)).asnumpy()
    _close_to_norm(got, want, x)
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-4, atol=1e-4)


def test_np_fft_rfft_irfft_roundtrip():
    x = np.random.default_rng(1).uniform(size=(3, 16)).astype('f')
    spec = tmx.np.fft.rfft(tmx.np.array(x))
    _close_to_norm(spec.asnumpy(), jmx.np.fft.rfft(jmx.np.array(x))
                   .asnumpy(), x)
    back = tmx.np.fft.irfft(spec, n=16).asnumpy()
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-5)


def test_np_fft2_and_shift():
    x = np.random.default_rng(2).uniform(size=(4, 4)).astype('f')
    got = tmx.np.fft.fftshift(tmx.np.fft.fft2(tmx.np.array(x))).asnumpy()
    want = jmx.np.fft.fftshift(jmx.np.fft.fft2(jmx.np.array(x))).asnumpy()
    _close_to_norm(got, want, x)


def test_contrib_fft_interleaved_roundtrip():
    x = np.random.default_rng(3).uniform(size=(2, 8)).astype('f')
    spec = tmx.npx.contrib_fft(tmx.np.array(x))
    assert spec.shape == (2, 16)
    _close_to_norm(spec.asnumpy(),
                   jmx.npx.contrib_fft(jmx.np.array(x)).asnumpy(), x)
    want = np.fft.fft(x)
    np.testing.assert_allclose(spec.asnumpy()[:, 0::2], want.real,
                               rtol=1e-4, atol=1e-4)
    back = tmx.npx.contrib_ifft(spec).asnumpy()
    _close_to_norm(back, jmx.npx.contrib_ifft(
        jmx.npx.contrib_fft(jmx.np.array(x))).asnumpy(), x)
    np.testing.assert_allclose(back / 8.0, x, rtol=1e-4, atol=1e-4)
    # the aliases are the same ops
    np.testing.assert_array_equal(tmx.npx.fft(tmx.np.array(x)).asnumpy(),
                                  spec.asnumpy())


@pytest.mark.parametrize('name, x, kw', FFT)
def test_np_fft_functions_match_jax(name, x, kw):
    got = getattr(tmx.np.fft, name)(tmx.np.array(x), **kw).asnumpy()
    want = getattr(jmx.np.fft, name)(jmx.np.array(x), **kw).asnumpy()
    _close_to_norm(got, want, x)


def test_fft_frequencies_match_jax():
    for name, args in (('fftfreq', (8, 0.5)), ('rfftfreq', (9, 2.0))):
        got = getattr(tmx.np.fft, name)(*args).asnumpy()
        want = getattr(jmx.np.fft, name)(*args).asnumpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_contrib_fft_gradient_matches_jax():
    x = np.random.default_rng(6).standard_normal((3, 8)).astype('f')
    w = np.random.default_rng(7).standard_normal((3, 16)).astype('f')
    grads = []
    for mx, ag in ((jmx, jag), (tmx, tag)):
        a = mx.np.array(x)
        a.attach_grad()
        with ag.record():
            loss = (mx.npx.contrib_fft(a) * mx.np.array(w)).sum()
        loss.backward()
        grads.append(a.grad.asnumpy())
    _close_to_norm(grads[1], grads[0], w)


# ----------------------------------------------------------- control flow
def _cumsum_body(x, states):
    (acc,) = states
    acc = acc + x
    return acc, [acc]


@pytest.mark.parametrize('mx', [jmx, tmx], ids=['jax', 'port'])
def test_foreach_cumsum(mx):
    data = mx.np.array([[1.0], [2.0], [3.0]])
    outs, states = mx.npx.foreach(_cumsum_body, data, [mx.np.zeros((1,))])
    np.testing.assert_array_equal(outs.asnumpy(), [[1], [3], [6]])
    np.testing.assert_array_equal(states[0].asnumpy(), [6])


def test_foreach_grad():
    grads = []
    for mx, ag in ((jmx, jag), (tmx, tag)):
        data = mx.np.array([[1.0], [2.0], [3.0]])
        data.attach_grad()

        def body(x, states):
            (acc,) = states
            acc = acc + x * x
            return acc, [acc]
        with ag.record():
            outs, states = mx.npx.foreach(body, data, [mx.np.zeros((1,))])
            loss = states[0].sum() + outs.sum()
        loss.backward()
        grads.append(data.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
    np.testing.assert_allclose(grads[1], [[8], [12], [12]])


def test_while_loop():
    res = []
    for mx in (jmx, tmx):
        outs, (i_fin, s_fin) = mx.npx.while_loop(
            lambda i, s: i < 5, lambda i, s: (s, (i + 1, s + i)),
            (mx.np.array(0), mx.np.array(0)), max_iterations=10)
        res.append((outs.asnumpy(), int(i_fin.asnumpy()),
                    int(s_fin.asnumpy())))
    (jo, ji, js), (to, ti, ts) = res
    assert (ti, ts) == (ji, js) == (5, 10)
    assert to.shape == jo.shape == (10,)
    np.testing.assert_array_equal(to, jo)      # zeros past the exit


def test_while_loop_nan_past_the_exit_keeps_the_gradient_finite():
    """The body divides by ``3 - i``: past the exit (i = 3) it would give
    inf and NaN. The port stops on the host and never runs it there; the
    gradient is finite and the JAX package's."""
    grads, outs = [], []
    for mx, ag in ((jmx, jag), (tmx, tag)):
        x = mx.np.array([2.0])
        x.attach_grad()
        with ag.record():
            out, (i, y) = mx.npx.while_loop(
                lambda i, y: i < 3,
                lambda i, y: (y / (3.0 - i), (i + 1.0, y * y / (3.0 - i))),
                (mx.np.array([0.0]), x), max_iterations=6)
            loss = out.sum() + y.sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
        outs.append(out.asnumpy())
    assert np.isfinite(grads[1]).all() and np.isfinite(outs[1]).all()
    np.testing.assert_array_equal(outs[1][3:], 0)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)


def _closure_loop(mx, ag):
    """A ``while_loop`` whose body multiplies by ``x`` from outside the
    loop vars: ``y`` goes ``x``, ``x²/3``, ``x³/6``, ``x⁴/6``."""
    x = mx.np.array([2.0])
    x.attach_grad()
    with ag.record():
        out, (_, y) = mx.npx.while_loop(
            lambda i, y: i < 3,
            lambda i, y: (y / (3.0 - i), (i + 1.0, y * x / (3.0 - i))),
            (mx.np.array([0.0]), x), max_iterations=6)
        loss = out.sum() + y.sum()
    loss.backward()
    return float(x.grad.asnumpy()[0])


def test_the_port_differentiates_a_loop_body_through_its_closure():
    # d/dx (x/3 + x²/6 + x³/6 + x⁴/6) at x = 2
    np.testing.assert_allclose(_closure_loop(tmx, tag),
                               1 / 3 + 2 / 3 + 2 + 16 / 3, rtol=1e-6)


def test_C15_jax_control_flow_drops_the_gradient_of_a_closure():
    """The JAX package traces a loop body with the tape off and its
    closure's arrays as constants: an array the body reads from outside
    its loop vars gets no gradient through the body (MXNet's subgraph
    ops make such a free variable an input). ``-s`` prints both."""
    j, t = _closure_loop(jmx, jag), _closure_loop(tmx, tag)
    print(f'C15: d loss / dx, JAX package {j}, port {t}')
    # the derivative with x held at 2 inside the body: 1/3 + (2 + 4 + 8)/6
    np.testing.assert_allclose(j, 1 / 3 + 14 / 6, rtol=1e-6)
    assert abs(j - t) > 1


def test_cond():
    for pred, want in ((True, [2, 4]), (False, [0, 1])):
        for mx in (jmx, tmx):
            out = mx.npx.cond(mx.np.array(pred), lambda a: a * 2.0,
                              lambda a: a - 1.0, [mx.np.array([1.0, 2.0])])
            np.testing.assert_array_equal(out.asnumpy(), want)


def test_cond_callable_pred_and_grad():
    grads = []
    for mx, ag in ((jmx, jag), (tmx, tag)):
        x = mx.np.array([3.0])
        x.attach_grad()
        with ag.record():
            out = mx.npx.cond(lambda a: (a > 0).sum() > 0,
                              lambda a: a * a, lambda a: -a, [x])
            loss = out.sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1], [6.0])


def test_nd_contrib_namespace():
    for name in ('foreach', 'while_loop', 'cond'):
        assert hasattr(tmx.nd.contrib, name) and hasattr(tmx.npx, name)
    assert tmx.nd.contrib.foreach is tmx.npx.foreach
    assert hasattr(tmx.nd.contrib, 'index_copy')


class _Loops(tgl.HybridBlock):
    """A block whose forward runs all three control-flow ops."""

    def __init__(self, host_stop):
        super().__init__()
        self.host_stop = host_stop
        self.dense = tgl.nn.Dense(3, in_units=3)

    def forward(self, x):
        h = self.dense(x)
        outs, (acc,) = tmx.npx.foreach(_cumsum_body, h, [h[0] * 0])
        if not self.host_stop:
            return outs
        y = tmx.npx.cond(acc.sum() > -1e9, lambda a: a * 2.0,
                         lambda a: a, [outs])
        _, (i, z) = tmx.npx.while_loop(
            lambda i, z: i < 2, lambda i, z: (z, (i + 1, z + 1.0)),
            (tmx.np.array(0), y), max_iterations=4)
        return z


@pytest.mark.parametrize('graphs', ['eager', 'emulated'])
@pytest.mark.parametrize('host_stop', [False, True], ids=['foreach',
                                                         'while_cond'])
def test_control_flow_in_a_hybridized_block(host_stop, graphs):
    """Hybridized and eager calls agree. With graphs emulated on the CPU
    (the card's capture paths, ``_graphs.emulated()``) ``foreach`` is
    captured, and a block whose ``cond``/``while_loop`` decide on the host
    runs every call eagerly, counted (two predict and two recorded)."""
    import contextlib
    from mxnet_tpu_torch import _graphs
    x = tmx.np.array(np.random.default_rng(8).standard_normal((4, 3))
                     .astype('f'))
    net = _Loops(host_stop)
    net.initialize()
    eager = net(x).asnumpy()
    net.hybridize()
    with _graphs.emulated() if graphs == 'emulated' else \
            contextlib.nullcontext():
        for _ in range(2):
            np.testing.assert_array_equal(net(x).asnumpy(), eager)
            with tag.record():
                got = net(x)
                loss = got.sum()
            loss.backward()
            np.testing.assert_array_equal(got.asnumpy(), eager)
    emulated = graphs == 'emulated'
    assert net.eager_call_count == (4 if emulated and host_stop else 0)
    assert (net.capture_count > 0) == (emulated and not host_stop)
    assert np.isfinite(net.dense.weight.grad().asnumpy()).all()
