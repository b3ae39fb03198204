"""Gluon beyond the core (A5 rest) in the port, against the JAX package.

- ``tests/test_higher_order_grad.py``'s seven cases through a hybridized
  block whose recorded calls replay (``_graphs.emulated()`` runs the
  graphed bookkeeping on the CPU; each case's second call is a replay):
  the replayed node, asked for ``create_graph=True``, runs its forward
  again eagerly under autograd, so the second and third derivatives are
  the JAX package's eager ones (the tolerances of the JAX tests). The
  fused norm's and flash attention's ``autograd.Function``s have
  backwards written in differentiable PyTorch ops: their second
  derivatives meet autograd through the plain formulas at 1e-4 (two fp32
  second-order graphs of other formulas).
- ``hybridize(backend=...)`` is kept and the whole graph captured, as the
  JAX package keeps it; ``hybridize(donate_inputs=True)`` keys calls that
  are not recorded apart (the JAX package's ``donate_argnums`` term:
  ``compile_count`` equal to the JAX net's) and deletes the caller's input
  arrays, whose next read raises.
"""

import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _graphs
from mxnet_tpu_torch.gluon import nn as tnn


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _lambda(fn):
    """``fn`` (of ``(np, x...)``) as a hybridized port block, warm: its
    first recorded call captured (emulated), so that the next one
    replays."""
    net = tnn.HybridLambda(lambda *xs: fn(tmx.np, tmx.npx, *xs))
    net.hybridize()
    return net


def _warm(net, xs):
    with tmx.autograd.record():
        out = net(*xs)
    out.backward(tmx.np.ones(out.shape))


# ------------------------------------- tests/test_higher_order_grad.py
def _second_order_both(fn, x0):
    """``d/dx (dy/dx)`` summed, through the JAX package eagerly and the
    port's replayed hybridized call."""
    x = jmx.np.array(np.asarray(x0, 'f'))
    x.attach_grad()
    with jag.record():
        y = fn(jmx.np, jmx.npx, x)
        gx = jag.grad(y, x, create_graph=True)
    gx.backward()
    want = x.grad.asnumpy()
    net = _lambda(fn)
    t = tmx.np.array(np.asarray(x0, 'f'))
    t.attach_grad()
    with _graphs.emulated():
        _warm(net, [t])
        with tmx.autograd.record():
            y = net(t)
            gx = tmx.autograd.grad(y, t, create_graph=True)
        gx.backward()
    assert net.capture_count == 2 and net.eager_call_count == 0
    return t.grad.asnumpy(), want


@pytest.mark.parametrize('case', ['sin', 'log', 'sigmoid'])
def test_second_order_through_a_replayed_call(case):
    fn, x0, d2 = {
        'sin': (lambda np, npx, x: np.sin(x), [0.3, 1.1, 2.0],
                lambda x: -np.sin(x)),
        'log': (lambda np, npx, x: np.log(x), [0.5, 1.5, 3.0],
                lambda x: -1.0 / x ** 2),
        'sigmoid': (lambda np, npx, x: npx.sigmoid(x), [-1.0, 0.2, 2.0],
                    lambda x: (1 / (1 + np.exp(-x))) * (1 - 1 / (1 + np.exp(
                        -x))) * (1 - 2 / (1 + np.exp(-x))))}[case]
    got, want = _second_order_both(fn, x0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, d2(np.asarray(x0, 'f')), rtol=1e-4,
                               atol=1e-5)


def test_second_order_through_product():
    got, want = _second_order_both(lambda np, npx, x: x * x * x,
                                   [2.0, -1.0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, 6 * np.array([2.0, -1.0]), rtol=1e-5,
                               atol=1e-6)


def test_third_order():
    x = jmx.np.array(np.array([2.0], 'f'))
    x.attach_grad()
    with jag.record():
        y = x ** 4
        g1 = jag.grad(y, x, create_graph=True)
        g2 = jag.grad(g1, x, create_graph=True)
    g2.backward()
    net = _lambda(lambda np, npx, x: x ** 4)
    t = tmx.np.array(np.array([2.0], 'f'))
    t.attach_grad()
    with _graphs.emulated():
        _warm(net, [t])
        with tmx.autograd.record():
            y = net(t)
            g1 = tmx.autograd.grad(y, t, create_graph=True)
            g2 = tmx.autograd.grad(g1, t, create_graph=True)
        g2.backward()
    np.testing.assert_allclose(t.grad.asnumpy(), x.grad.asnumpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.grad.asnumpy(), [48.0], rtol=1e-4,
                               atol=1e-4)


def test_grad_of_grad_multivariate():
    # f = x^2 y; df/dx = 2xy; d/dy(df/dx) = 2x
    x, y = (jmx.np.array(np.array([v], 'f')) for v in (3.0, 5.0))
    x.attach_grad()
    y.attach_grad()
    with jag.record():
        f = x * x * y
        gx = jag.grad(f, x, create_graph=True)
        gxy = jag.grad(gx, y, create_graph=False)
    net = _lambda(lambda np, npx, a, b: a * a * b)
    a, b = (tmx.np.array(np.array([v], 'f')) for v in (3.0, 5.0))
    a.attach_grad()
    b.attach_grad()
    with _graphs.emulated():
        _warm(net, [a, b])
        with tmx.autograd.record():
            f = net(a, b)
            ga = tmx.autograd.grad(f, a, create_graph=True)
            gab = tmx.autograd.grad(ga, b, create_graph=False)
    np.testing.assert_allclose(gab.asnumpy(), gxy.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gab.asnumpy(), [6.0], rtol=1e-5, atol=1e-6)


def test_first_order_grad_api_unchanged():
    """Without ``create_graph`` the replayed node's backward is its
    graph's, as before; plain ``backward()`` still writes the buffers."""
    x = jmx.np.array(np.array([1.0, 2.0], 'f'))
    x.attach_grad()
    with jag.record():
        y = (x ** 2).sum()
    want = jag.grad(y, x).asnumpy()
    with jag.record():
        y = (x ** 3).sum()
    y.backward()
    want_buf = x.grad.asnumpy()
    sq, cube = _lambda(lambda np, npx, v: (v ** 2).sum()), \
        _lambda(lambda np, npx, v: (v ** 3).sum())
    t = tmx.np.array(np.array([1.0, 2.0], 'f'))
    t.attach_grad()
    with _graphs.emulated():
        _warm(sq, [t])
        with tmx.autograd.record():
            y = sq(t)
        g = tmx.autograd.grad(y, t)
        _warm(cube, [t])
        with tmx.autograd.record():
            y = cube(t)
        y.backward()
    np.testing.assert_allclose(g.asnumpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.asnumpy(), want_buf, rtol=1e-5,
                               atol=1e-6)
    assert sq.capture_count == cube.capture_count == 2


def test_norm_and_flash_functions_differentiate_twice():
    """The fused norm's and flash attention's ``autograd.Function``s: the
    gradient of a gradient penalty through them meets autograd through
    the plain formulas."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import \
        FlashAttentionFunction, flash_attention_plain
    from mxnet_tpu_torch.ops.kernels.fused_norms import FusedNormFunction
    g = torch.Generator().manual_seed(0)

    def penalty_grads(f, *xs):
        xs = [x.clone().requires_grad_(True) for x in xs]
        out = f(*xs)
        gr = torch.autograd.grad((out * out).sum(), xs, create_graph=True)
        return torch.autograd.grad(sum((t ** 2).sum() for t in gr), xs)

    x = torch.randn(3, 5, 16, generator=g)
    w = torch.rand(16, generator=g) + 0.5
    b = torch.randn(16, generator=g)

    def rms_plain(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * w

    def ln_plain(x, w, b):
        m = x.mean(-1, keepdim=True)
        v = ((x - m) ** 2).mean(-1, keepdim=True)
        return (x - m) * torch.rsqrt(v + 1e-5) * w + b
    for got, want in (
            (penalty_grads(lambda x, w: FusedNormFunction.apply(
                x, w, None, 1e-5, True), x, w), penalty_grads(rms_plain, x, w)),
            (penalty_grads(lambda x, w, b: FusedNormFunction.apply(
                x, w, b, 1e-5, False), x, w, b),
             penalty_grads(ln_plain, x, w, b))):
        for a, c in zip(got, want):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    q, k, v = (torch.randn(2, 6, 8, generator=g) for _ in range(3))
    for causal in (True, False):
        got = penalty_grads(lambda q, k, v: FlashAttentionFunction.apply(
            q, k, v, 0.35, causal), q, k, v)
        want = penalty_grads(lambda q, k, v: flash_attention_plain(
            q, k, v, 0.35, causal), q, k, v)
        for a, c in zip(got, want):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


# ------------------------------------------ hybridize's backend, donation
def _dense(nn, mx):
    net = nn.Dense(3, in_units=4)
    net.initialize()
    net.weight.set_data(mx.np.array(np.arange(12, dtype='f').reshape(3, 4)
                                    / 10))
    return net


def test_hybridize_backend_is_kept_and_the_whole_graph_captured():
    x = np.ones((2, 4), 'f')
    want = _dense(jnn, jmx)
    want.hybridize(backend='MKLDNN')
    net = _dense(tnn, tmx)
    plain = net(tmx.np.array(x)).asnumpy()
    net.hybridize(backend='MKLDNN', backend_opts={'dedup': True})
    assert net._cached_graph.backend == want._cached_graph.backend \
        == 'MKLDNN'
    with _graphs.emulated():
        for _ in range(2):
            np.testing.assert_array_equal(net(tmx.np.array(x)).asnumpy(),
                                          plain)
    for _ in range(2):
        jout = want(jmx.np.array(x)).asnumpy()
    assert net.compile_count == want.compile_count == 1
    np.testing.assert_allclose(plain, jout, rtol=1e-6)
    with pytest.raises(NotImplementedError, match='A11'):
        net.hybridize(check=True)


def test_donate_inputs_deletes_the_callers_arrays_and_keys_apart():
    """Calls that are not recorded donate their inputs (their own key,
    as the JAX package's ``donate_argnums``; the same ``compile_count``);
    a donated array raises on its next read, and a recorded call donates
    nothing."""
    x = np.arange(8, dtype='f').reshape(2, 4)
    counts = {}
    for mx, nn in ((jmx, jnn), (tmx, tnn)):
        net = _dense(nn, mx)
        net(mx.np.array(x))
        net.hybridize(donate_inputs=True)
        a = mx.np.array(x)
        out = net(a).asnumpy()
        with mx.autograd.record():
            net(mx.np.array(x))
        net(mx.np.array(x))
        counts[mx] = net.compile_count
        if mx is tmx:
            with pytest.raises(RuntimeError, match='deleted'):
                a.asnumpy()
            kept = mx.np.array(x)
            with mx.autograd.record():
                net(kept)
            np.testing.assert_array_equal(kept.asnumpy(), x)
            np.testing.assert_allclose(out, x @ np.arange(12, dtype='f')
                                       .reshape(3, 4).T / 10, rtol=1e-6)
    assert counts[tmx] == counts[jmx] == 2


# ------------------------------------------------------ remat with Dropout
def _drop_net(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu', in_units=5), nn.Dropout(0.3),
            nn.Dense(8, activation='relu', in_units=16), nn.Dropout(0.3),
            nn.Dense(4, in_units=8))
    return net


def _remat_runs(mx, nn, weights, x0, graphed, calls=2):
    """Per ``hybridize(remat=...)``: each call's input and parameter
    gradients, the generator seeded alike before each call."""
    out = {}
    for remat in (False, True):
        net = _drop_net(nn)
        net.initialize()
        for k, p in net.collect_params().items():
            p.set_data(mx.np.array(weights[k]))
        x = mx.np.array(x0)
        net(x)
        net.hybridize(remat=remat)
        x.attach_grad()
        runs = []
        ctx = _graphs.emulated() if graphed else contextlib.nullcontext()
        with ctx:
            for call in range(calls):
                mx.random.seed(11 + call)
                with mx.autograd.record():
                    loss = (net(x) ** 2).sum()
                loss.backward()
                runs.append([x.grad.asnumpy()] + [
                    p.grad().asnumpy() for p in net.collect_params().values()])
        out[remat] = runs
    return out


@pytest.mark.parametrize('graphed', [False, True], ids=['eager', 'graphed'])
def test_remat_with_dropout_gives_the_gradients_without_remat(graphed):
    """``tests/test_gluon.py``'s remat case (:288-310) with Dropout added:
    at the same seed the gradients with and without ``remat`` are equal,
    in the JAX package (its recomputation takes the forward's key) and in
    the port, eagerly (``torch.utils.checkpoint`` from the generator's
    state before the forward) and graphed (the second call replays; its
    backward's recomputation draws the forward's masks again)."""
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (3, 5)).astype('f')
    jnet = _drop_net(jnn)
    jnet.initialize()
    jnet(jmx.np.array(x0))
    weights = {k: (rng.standard_normal(p.shape) * 0.5).astype('f')
               for k, p in jnet.collect_params().items()}
    want = _remat_runs(jmx, jnn, weights, x0, graphed=False, calls=1)
    for a, b in zip(want[True][0], want[False][0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    got = _remat_runs(tmx, tnn, weights, x0, graphed)
    for call in range(2):
        for a, b in zip(got[True][call], got[False][call]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # the two calls drew other masks: the seed moved them
    assert not np.array_equal(got[False][0][1], got[False][1][1])


# ----------------------------------------------- gluon.contrib but rnn
# tests/test_gluon_contrib.py's cases outside contrib/rnn, the image
# transforms and the libsvm reader, each against the JAX package. Those
# wait with gluon/rnn, the image transforms and io (ROADMAP A11):
# test_conv_cells_unroll_shapes, test_conv_lstm_matches_dense_lstm_with_
# 1x1_input, test_variational_dropout_mask_reused_across_steps,
# test_lstmp_cell_shapes_and_unroll, test_variational_dropout_fresh_mask_
# per_unroll, test_conv_cell_rejects_bad_layout, test_bbox_utils,
# test_image_bbox_transform_blocks, test_libsvm_iter and
# test_libsvm_separate_label_file.
from mxnet_tpu.gluon import contrib as jcontrib  # noqa: E402
from mxnet_tpu_torch.gluon import contrib as tcontrib  # noqa: E402


def _set_like(tnet, jnet):
    """The JAX net's values in the port net's parameters, by name."""
    for k, p in tnet.collect_params().items():
        p.set_data(jnet.collect_params()[k].data().asnumpy())


def test_concurrent_and_identity():
    outs = {}
    x = np.random.default_rng(4).standard_normal((2, 4)).astype('f')
    nets = {}
    for mx, nn, contrib in ((jmx, jnn, jcontrib), (tmx, tnn, tcontrib)):
        net = contrib.nn.HybridConcurrent(axis=-1)
        net.add(nn.Dense(3, in_units=4), nn.Dense(2, in_units=4),
                contrib.nn.Identity())
        net.initialize()
        nets[mx] = net
    _set_like(nets[tmx], nets[jmx])
    for mx, contrib in ((jmx, jcontrib), (tmx, tcontrib)):
        outs[mx] = nets[mx](mx.np.array(x)).asnumpy()
        net2 = contrib.nn.Concurrent(axis=1)
        net2.add(contrib.nn.Identity(), contrib.nn.Identity())
        assert net2(mx.np.ones((2, 4))).shape == (2, 8)
    assert outs[tmx].shape == (2, 3 + 2 + 4)
    np.testing.assert_allclose(outs[tmx], outs[jmx], rtol=1e-6, atol=1e-6)


def test_sparse_embedding_row_sparse_grad():
    grads = {}
    embs = {}
    for mx, contrib in ((jmx, jcontrib), (tmx, tcontrib)):
        emb = contrib.nn.SparseEmbedding(50, 8)
        emb.initialize()
        assert emb.weight._grad_stype == 'row_sparse'
        embs[mx] = emb
    _set_like(embs[tmx], embs[jmx])
    for mx in (jmx, tmx):
        x = mx.np.array([[1.0, 3.0], [1.0, 7.0]])
        with mx.autograd.record():
            loss = (embs[mx](x) ** 2).sum()
        loss.backward()
        g = embs[mx].weight.grad()
        assert g is not None
        grads[mx] = g.asnumpy() if hasattr(g, 'asnumpy') else np.asarray(g)
    np.testing.assert_allclose(grads[tmx], grads[jmx], rtol=1e-6, atol=1e-6)
    assert set(np.nonzero(grads[tmx].any(1))[0]) == {1, 3, 7}


@pytest.mark.parametrize('dims', [1, 2, 3])
def test_pixel_shuffle(dims):
    f = 2
    spatial = (4, 3, 2)[:dims]
    C = 5 * (f ** dims)
    x = np.random.RandomState(0).randn(2, C, *spatial).astype('f')
    outs = {}
    for mx, contrib in ((jmx, jcontrib), (tmx, tcontrib)):
        cls = {1: contrib.nn.PixelShuffle1D, 2: contrib.nn.PixelShuffle2D,
               3: contrib.nn.PixelShuffle3D}[dims]
        outs[mx] = cls(f)(mx.np.array(x)).asnumpy()
    assert outs[tmx].shape == (2, 5) + tuple(s * f for s in spatial)
    np.testing.assert_array_equal(outs[tmx], outs[jmx])


def test_pixel_shuffle_2d_known_layout():
    x = tmx.np.arange(4).reshape(1, 4, 1, 1)
    out = tcontrib.nn.PixelShuffle2D(2)(x)
    np.testing.assert_allclose(out.asnumpy()[0, 0], [[0, 1], [2, 3]])
    want = jcontrib.nn.PixelShuffle2D(2)(jmx.np.arange(4).reshape(
        1, 4, 1, 1))
    np.testing.assert_array_equal(out.asnumpy(), want.asnumpy())


def test_interval_sampler():
    for args in ((10, 3), (10, 3, False), (7, 7), (9, 2)):
        got = tcontrib.data.IntervalSampler(*args)
        want = jcontrib.data.IntervalSampler(*args)
        assert list(got) == list(want) and len(got) == len(want)
    assert list(tcontrib.data.IntervalSampler(10, 3))[:4] == [0, 3, 6, 9]
    with pytest.raises(ValueError):
        tcontrib.data.IntervalSampler(3, 4)


def test_wikitext_local_file(tmp_path):
    root = tmp_path / 'wikitext-2'
    root.mkdir()
    text = ' '.join(f'w{i % 7}' for i in range(100)) + '\nw3 w9 w9\n'
    (root / 'wiki.train.tokens').write_text(text)
    got = tcontrib.data.text.WikiText2(root=str(root), seq_len=10)
    want = jcontrib.data.text.WikiText2(root=str(root), seq_len=10)
    assert len(got) == len(want) == 10
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    data, target = got[0]
    np.testing.assert_array_equal(data[1:], target[:-1])
    assert got.vocabulary.idx_to_token == want.vocabulary.idx_to_token
    with pytest.raises(FileNotFoundError):
        tcontrib.data.text.WikiText103(root=str(tmp_path / 'nope'))


def test_wikitext_shared_vocab(tmp_path):
    root = tmp_path / 'wikitext-2'
    root.mkdir()
    (root / 'wiki.train.tokens').write_text('a b c a b a ' * 20)
    (root / 'wiki.validation.tokens').write_text('c b a c c b d ' * 20)
    for contrib in (jcontrib, tcontrib):
        train = contrib.data.text.WikiText2(root=str(root), seq_len=5)
        val = contrib.data.text.WikiText2(
            root=str(root), seq_len=5, segment='validation',
            vocab=train.vocabulary)
        assert val.vocabulary is train.vocabulary
        if contrib is jcontrib:
            want = [val[i][0].tolist() for i in range(len(val))]
    assert [val[i][0].tolist() for i in range(len(val))] == want


def test_estimator_batch_processor():
    """The Estimator's fit and evaluate through a custom BatchProcessor:
    the calls counted, and the weights after one epoch of Adam those of
    the JAX Estimator from the same weights and batches."""
    nets, calls = {}, {}
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 4).astype('f')
    ys = (np.arange(16) % 2).astype('f')
    for mx, nn in ((jmx, jnn), (tmx, tnn)):
        nets[mx] = nn.Dense(2, in_units=4)
        nets[mx].initialize()
    _set_like(nets[tmx], nets[jmx])
    for mx, contrib in ((jmx, jcontrib), (tmx, tcontrib)):
        from importlib import import_module
        bp = import_module(contrib.__name__ + '.estimator.batch_processor')
        gdata = import_module(mx.__name__ + '.gluon.data')
        gloss = import_module(mx.__name__ + '.gluon.loss')
        count = calls[mx] = {'fit': 0, 'eval': 0}

        class Counting(bp.BatchProcessor):
            def fit_batch(self, estimator, batch, batch_axis=0,
                          _count=count):
                _count['fit'] += 1
                return super().fit_batch(estimator, batch, batch_axis)

            def evaluate_batch(self, estimator, batch, batch_axis=0,
                               _count=count):
                _count['eval'] += 1
                return super().evaluate_batch(estimator, batch, batch_axis)

        loader = gdata.DataLoader(gdata.ArrayDataset(
            mx.np.array(xs), mx.np.array(ys)), batch_size=8)
        est = contrib.estimator.Estimator(
            nets[mx], gloss.SoftmaxCrossEntropyLoss(),
            batch_processor=Counting())
        est.fit(loader, val_data=loader, epochs=1)
    assert calls[tmx] == calls[jmx] == {'fit': 2, 'eval': 2}
    for k, p in nets[tmx].collect_params().items():
        np.testing.assert_allclose(
            p.data().asnumpy(), nets[jmx].collect_params()[k].data()
            .asnumpy(), rtol=1e-5, atol=1e-6)


def test_deformable_convolution_matches_the_jax_layer():
    """``DeformableConvolution`` over the registered op: at
    initialization (zero offsets, the plain convolution) and with every
    tap shifted by 0.25 of a pixel, the output and the input, weight, bias
    and offset-layer gradients of ``sum(out ** 2)`` against the JAX
    layer's, at 1e-5. Every sample's four corners lie inside the padded
    input here (stride 2 over 8 rows and columns): beyond its last row or
    column the JAX layer extrapolates (ROADMAP C18)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 8, 8)).astype('f')
    for shift in (0.0, 0.25):
        res = {}
        nets = {}
        for mx, contrib in ((jmx, jcontrib), (tmx, tcontrib)):
            net = contrib.cnn.DeformableConvolution(
                4, kernel_size=3, strides=2, padding=1, in_channels=3)
            net.initialize()
            net(mx.np.array(x))
            nets[mx] = net
        jp = nets[jmx].collect_params()
        jp['offset_conv.bias'].set_data(jmx.np.full(
            jp['offset_conv.bias'].shape, shift, dtype='float32'))
        _set_like(nets[tmx], nets[jmx])
        for mx in (jmx, tmx):
            xx = mx.np.array(x)
            xx.attach_grad()
            with mx.autograd.record():
                out = nets[mx](xx)
                loss = (out ** 2).sum()
            loss.backward()
            ps = nets[mx].collect_params()
            res[mx] = [out.asnumpy(), xx.grad.asnumpy()] + [
                ps[k].grad().asnumpy() for k in (
                    'weight', 'bias', 'offset_conv.weight',
                    'offset_conv.bias')]
        assert res[tmx][0].shape == (2, 4, 4, 4)
        assert np.abs(res[tmx][-1]).max() > 0
        for a, b in zip(res[tmx], res[jmx]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_c18_jax_deformable_convolution_extrapolates_past_the_edge():
    """ROADMAP C18's witness: a 1 x 1 deformable convolution of a (3, 3)
    ramp with every sample shifted by half a pixel down and right. The
    JAX package's registered ``deformable_convolution`` op reads a corner
    past the last row or column as the edge pixel (clamped), and the
    port's layer, over the port's copy of that op, gives its values; the
    JAX layer clamps the lower corner to the second-last row or column
    instead and extrapolates, so its last row and column part from its
    own op's."""
    import jax.numpy as jnp
    from mxnet_tpu.ops.legacy_ops import deformable_convolution as jdc
    x = np.arange(9, dtype='f').reshape(1, 1, 3, 3) + 1.0
    want = np.asarray(jdc(jnp.asarray(x), jnp.full((1, 2, 3, 3), 0.5),
                          jnp.ones((1, 1, 1, 1)), kernel=(1, 1),
                          num_filter=1, no_bias=True))[0, 0]
    outs = {}
    for mx, contrib in ((jmx, jcontrib), (tmx, tcontrib)):
        net = contrib.cnn.DeformableConvolution(1, kernel_size=1,
                                                in_channels=1,
                                                use_bias=False)
        net.initialize()
        net(mx.np.array(x))
        ps = net.collect_params()
        ps['weight'].set_data(mx.np.ones((1, 1, 1, 1)))
        ps['offset_conv.bias'].set_data(mx.np.full((2,), 0.5))
        outs[mx] = net(mx.np.array(x)).asnumpy()[0, 0]
    np.testing.assert_allclose(outs[tmx], want, rtol=1e-6)
    np.testing.assert_allclose(outs[jmx][:2, :2], want[:2, :2], rtol=1e-6)
    assert not np.allclose(outs[jmx][2], want[2])
    assert not np.allclose(outs[jmx][:, 2], want[:, 2])
    print('C18: last row, JAX layer', outs[jmx][2], 'JAX op', want[2])
