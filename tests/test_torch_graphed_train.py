"""Graphed training in the port's Gluon against the JAX package, on the CPU.

``HybridBlock.pure_function`` (outputs, new running statistics,
gradients through ``torch.autograd.grad`` against ``jax.grad``, and a
20-step SGD loop against the JAX package's ``lax.scan``), ``prewarm``,
``register_op_hook``, ``hybridize(remat=True)``, ``compile_count`` over
record, train and predict calls, and the grad buffers written in place
(their addresses, ``'write'``/``'add'`` values, a write through
``p.grad()``) are held to the JAX package on the same numpy inputs.

The CUDA graphs themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here ``_graphs.emulated()`` runs their bookkeeping on
the CPU: a key's first call answers from its warm-up, later calls go
through the static buffers and the replayed autograd node, and the
Trainer's update through its captured body and device vectors. Those runs
must equal the eager runs bit for bit (the same CPU operations), and the
graphed node's guards (two recorded calls of one key before one backward)
and its ``create_graph`` backward are checked there.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, _graphs, gluon as tgl
from mxnet_tpu_torch.gluon import nn as tnn

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _mlp_bn(nn):
    """tests/test_gluon.py:366's pure-function net."""
    return nn.HybridSequential(nn.Dense(8, in_units=4), nn.BatchNorm(),
                               nn.Dense(2, in_units=8))


def _feats():
    feats = _x((16, 4))
    feats[::2] += 2.0                      # separable classes
    return feats


def _pair(make=_mlp_bn, x=None, seed=1):
    """The JAX net and the port's, run once on ``x`` and given the same
    seeded weights (running variances and gammas positive)."""
    x = _feats() if x is None else x
    jnet, tnet = make(jgl.nn), make(tnn)
    jnet.initialize()
    jnet(jmx.np.array(x))
    tnet.initialize(ctx=tmx.cpu())
    tnet(tmx.np.array(x))
    rng = np.random.default_rng(seed)
    weights = {}
    for name, p in jnet.collect_params().items():
        w = (rng.standard_normal(p.shape) * 0.5).astype(np.float32)
        if name.endswith(('running_var', 'gamma')):
            w = np.abs(w) + 0.5
        p.set_data(w)
        weights[name] = w
    tnet.load_dict(weights)
    return jnet, tnet


def _jax_nll(outs, labels):
    logp = jax.nn.log_softmax(outs[0].astype(jnp.float32))
    return -logp[jnp.arange(outs[0].shape[0]), labels].mean()


def _torch_nll(outs, labels):
    logp = torch.log_softmax(outs[0], -1)
    return -logp[torch.arange(outs[0].shape[0]), labels].mean()


# ------------------------------------------------------------ pure_function
@pytest.mark.parametrize('train', [True, False], ids=['train', 'predict'])
def test_pure_function_outputs_aux_and_gradients_match_jax(train):
    jnet, tnet = _pair()
    x = _feats()
    jfn, jin, jmain, jaux = jnet.pure_function(jmx.np.array(x), train=train)
    tfn, tin, tmain, taux = tnet.pure_function(tmx.np.array(x), train=train)
    assert [tuple(t.shape) for t in tmain] == [m.shape for m in jmain]
    assert [tuple(t.shape) for t in taux] == [a.shape for a in jaux]
    key = jax.random.PRNGKey(0)
    jouts, jnew = jfn(key, jin, jmain, jaux)
    touts, tnew = tfn(torch.Generator().manual_seed(0), tin, tmain, taux)
    np.testing.assert_allclose(touts[0].numpy(), np.asarray(jouts[0]),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(tnew, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    if not train:                   # the statistics pass through unchanged
        for a, b in zip(tnew, taux):
            assert torch.equal(a, b)
    labels = np.arange(16) % 2
    jgrads = jax.grad(lambda ps: _jax_nll(
        jfn(key, jin, ps, jaux)[0], jnp.asarray(labels)))(jmain)
    mains = [t.clone().requires_grad_() for t in tmain]
    tgrads = torch.autograd.grad(
        _torch_nll(tfn(None, tin, mains, taux)[0], torch.as_tensor(labels)),
        mains)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the pure function wrote no parameter
    for p, t in zip([p for p in tnet.collect_params().values()
                     if p.grad_req == 'null'], taux):
        assert torch.equal(p.data()._data, t)


def test_pure_function_sgd_loop_matches_jax_scan():
    """tests/test_gluon.py:366's 20-step loop: ``lax.scan`` over the JAX
    pure function against a Python loop over the port's."""
    jnet, tnet = _pair()
    x = _feats()
    labels = np.arange(16) % 2
    jfn, jin, jmain, jaux = jnet.pure_function(jmx.np.array(x), train=True)
    key = jax.random.PRNGKey(0)

    def step(carry, i):
        ps, aux_s = carry

        def loss_of(ps_):
            outs, new_aux = jfn(jax.random.fold_in(key, i), jin, ps_, aux_s)
            return _jax_nll(outs, jnp.asarray(labels)), new_aux

        (loss, new_aux), grads = jax.value_and_grad(loss_of,
                                                    has_aux=True)(ps)
        return (jax.tree.map(lambda w, g: w - 0.1 * g, ps, grads),
                tuple(new_aux)), loss

    (_, jaux1), jlosses = jax.jit(
        lambda c: lax.scan(step, c, jnp.arange(20)))((jmain, jaux))
    tfn, tin, tmain, taux = tnet.pure_function(tmx.np.array(x), train=True)
    mains = [t.clone().requires_grad_() for t in tmain]
    auxs, losses = taux, []
    for _ in range(20):
        outs, auxs = tfn(None, tin, mains, auxs)
        loss = _torch_nll(outs, torch.as_tensor(labels))
        grads = torch.autograd.grad(loss, mains)
        with torch.no_grad():
            for w, g in zip(mains, grads):
                w.sub_(0.1 * g)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, np.asarray(jlosses), **TOL)
    assert losses[-1] < losses[0]
    for a, b in zip(auxs, jaux1):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------ prewarm, hooks, compile
def test_prewarm_and_op_hook_counts_match_jax():
    got = {}
    for name, mx, nn in (('jax', jmx, jgl.nn), ('torch', tmx, tnn)):
        net = nn.HybridSequential(nn.Dense(3, in_units=5), nn.BatchNorm())
        net.initialize()
        net.hybridize()
        seen = []
        net.register_op_hook(lambda block, out: seen.append(out.shape))
        new = [net.prewarm([(2, 5), (3, 5)]), net.prewarm([(2, 5)]),
               net.prewarm([((4, 5), 'float32')])]
        net(mx.np.ones((3, 5)))
        with mx.autograd.record():
            net(mx.np.ones((3, 5)))
        got[name] = (new, net.compile_count, seen)
    assert got['torch'] == got['jax']
    assert got['torch'][0] == [2, 0, 1]


def _calls(mx, net, xs):
    """Predict, train-mode and recorded calls at two shapes."""
    a, b = (mx.np.array(x) for x in xs)
    outs = [net(a), net(b), net(a)]
    with mx.autograd.train_mode():
        outs += [net(a), net(b)]
    with mx.autograd.record():
        outs += [net(a), net(a), net(b)]
    with mx.autograd.record(train_mode=False):
        outs.append(net(b))
    outs.append(net(a))
    return outs


@pytest.mark.parametrize('graphs', ['eager', 'emulated'])
def test_compile_count_over_record_train_and_predict_matches_jax(graphs):
    xs = (_x((3, 4), 2), _x((5, 4), 3))
    jnet, tnet = _pair(x=xs[0])
    jnet.hybridize()
    tnet.hybridize()
    jouts = _calls(jmx, jnet, xs)
    with _graphs.emulated() if graphs == 'emulated' else \
            contextlib.nullcontext():
        touts = _calls(tmx, tnet, xs)
    assert tnet.compile_count == jnet.compile_count == 6
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    # four keys' calls that are not recorded, one graph each; the three
    # recorded ones (one shares its key with predict calls), two each
    assert tnet.capture_count == (0 if graphs == 'eager' else 4 + 3 * 2)


def _remat_grads(mx, nn, gl, remat, x):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu', in_units=5),
            nn.Dense(8, activation='relu', in_units=16),
            nn.Dense(4, in_units=8), nn.BatchNorm(in_channels=4))
    net.initialize()
    rng = np.random.default_rng(3)
    for p in net.collect_params().values():
        p.set_data(np.abs(rng.standard_normal(p.shape)).astype('f') * 0.5
                   + (0.5 if p.name.endswith('running_var') else 0.0))
    net(mx.np.array(x))
    net.hybridize(remat=remat)
    xs = mx.np.array(x)
    xs.attach_grad()
    for _ in range(2):                  # a key's first call, then a hit
        with mx.autograd.record():
            loss = (net(xs) ** 2).sum()
        loss.backward()
    stats = [p.data().asnumpy() for n, p in net.collect_params().items()
             if n.endswith(('running_mean', 'running_var'))]
    return (xs.grad.asnumpy(), net.collect_params()['0.weight'].grad()
            .asnumpy(), stats)


@pytest.mark.parametrize('graphs', ['eager', 'emulated'])
def test_remat_gradients_match_jax_remat(graphs):
    """tests/test_gluon.py:287 ported: remat changes memory, not math;
    the recomputed forward moves no running statistic a second time."""
    x = _x((3, 5), 4)
    jax_remat = _remat_grads(jmx, jgl.nn, jgl, True, x)
    with _graphs.emulated() if graphs == 'emulated' else \
            contextlib.nullcontext():
        port = _remat_grads(tmx, tnn, tgl, True, x)
    for got, want in zip(port[:2], jax_remat[:2]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for got, want in zip(port[2], jax_remat[2]):
        np.testing.assert_allclose(got, want, **TOL)


def test_remat_redraws_dropout_masks_eagerly():
    """An eager remat recomputation draws the forward's Dropout mask again
    (the port's generator state is restored around it)."""
    net = tnn.HybridSequential(tnn.Dense(64, in_units=8), tnn.Dropout(0.5))
    net.initialize(ctx=tmx.cpu())
    x = tmx.np.array(_x((4, 8), 5))
    net(x)
    net.hybridize(remat=True)
    x.attach_grad()
    with tmx.autograd.record():
        out = net(x)
        loss = out.sum()
    loss.backward()
    mask = out.asnumpy() != 0
    w = net.collect_params()['0.weight'].data().asnumpy()
    np.testing.assert_allclose(x.grad.asnumpy(), (mask * 2.0) @ w,
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- grad buffers
def _grad_runs(mx, nn, req, x):
    net = nn.Dense(3, in_units=4)
    net.initialize()
    net.weight.set_data(_x((3, 4), 6))
    net.bias.set_data(_x((3,), 7))
    net.collect_params().setattr('grad_req', req)
    grads, ptrs = [], []
    for scale in (1.0, 2.0):
        with mx.autograd.record():
            loss = (net(mx.np.array(x)) * scale).sum()
        loss.backward()
        grads.append(net.weight.grad().asnumpy().copy())
        ptrs.append(getattr(net.weight.grad(), '_data', None))
    net.weight.zero_grad()
    grads.append(net.weight.grad().asnumpy().copy())
    return grads, net


@pytest.mark.parametrize('req', ['write', 'add'])
def test_grad_buffers_are_written_in_place_as_jax_writes_them(req):
    x = _x((2, 4), 8)
    jgrads, _ = _grad_runs(jmx, jgl.nn, req, x)
    tnet = tnn.Dense(3, in_units=4)
    tnet.initialize(ctx=tmx.cpu())
    tnet.weight.set_data(_x((3, 4), 6))
    tnet.bias.set_data(_x((3,), 7))
    tnet.collect_params().setattr('grad_req', req)
    buf = tnet.weight.grad()._data
    addr = buf.data_ptr()
    tgrads = []
    for scale in (1.0, 2.0):
        with tmx.autograd.record():
            loss = (tnet(tmx.np.array(x)) * scale).sum()
        loss.backward()
        assert tnet.weight.grad()._data is buf
        tgrads.append(tnet.weight.grad().asnumpy().copy())
    tnet.weight.zero_grad()
    tgrads.append(tnet.weight.grad().asnumpy().copy())
    assert tnet.weight.grad()._data.data_ptr() == addr
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, b, **TOL)


def test_a_write_through_the_grad_handle_reaches_the_next_update():
    """``p.grad()[:] = v`` rebinds the handle; the Trainer's next update
    (and an emulated captured one) reads ``v`` from the buffer, as the JAX
    Trainer reads the rebound grad."""
    results = []
    for mx, nn, gl, ctx in ((jmx, jgl.nn, jgl, contextlib.nullcontext),
                            (tmx, tnn, tgl, contextlib.nullcontext),
                            (tmx, tnn, tgl, _graphs.emulated)):
        net = nn.Dense(3, in_units=4)
        net.initialize()
        net.weight.set_data(_x((3, 4), 6))
        net.bias.set_data(np.zeros(3, 'f'))
        tr = gl.Trainer(net.collect_params(), 'sgd',
                        {'learning_rate': 0.5, 'momentum': 0.9})
        with ctx():
            for step in range(3):
                with mx.autograd.record():
                    loss = net(mx.np.array(_x((2, 4), 9 + step))).sum()
                loss.backward()
                if step == 1:
                    net.weight.grad()[:] = 0.25
                tr.step(1)
        results.append(net.weight.data().asnumpy())
    np.testing.assert_allclose(results[1], results[0], **TOL)
    np.testing.assert_array_equal(results[2], results[1])


# --------------------------------------------- the graphed path, emulated
def _train(opt, kwargs, graphed, steps=4, dropout=False):
    tmx.random.seed(0)
    net = _mlp_bn(tnn)
    if dropout:
        net.add(tnn.Dropout(0.5))
    net.initialize(ctx=tmx.cpu())
    x0 = tmx.np.array(_feats())
    net(x0)
    rng = np.random.default_rng(1)
    net.load_dict({n: np.abs(rng.standard_normal(p.shape)).astype('f')
                   * 0.5 + 0.1 for n, p in net.collect_params().items()})
    net.hybridize()
    tr = tgl.Trainer(net.collect_params(), opt, dict(kwargs))
    loss_fn = tgl.loss.SoftmaxCrossEntropyLoss()
    y = tmx.np.array((np.arange(16) % 2).astype('f'))
    losses, xgrads = [], []
    with _graphs.emulated() if graphed else contextlib.nullcontext():
        for i in range(steps):
            x = tmx.np.array(_feats() * (1 + 0.1 * i))
            x.attach_grad()
            with tmx.autograd.record():
                loss = loss_fn(net(x), y).mean()
            loss.backward()
            tr.step(1)
            losses.append(loss.item())
            xgrads.append(x.grad.asnumpy())
    state = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    return losses, xgrads, state, net, tr


@pytest.mark.parametrize('opt,kwargs', [
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9}),
    ('adam', {'learning_rate': 0.01, 'wd': 1e-3}),
    ('sgd', {'learning_rate': 0.1, 'lr_scheduler': None})],
    ids=['sgd_mom', 'adam', 'sgd'])
def test_emulated_graphed_training_equals_eager(opt, kwargs):
    eager = _train(opt, kwargs, False)
    graphed = _train(opt, kwargs, True)
    assert graphed[0] == eager[0]
    for a, b in zip(graphed[1], eager[1]):
        np.testing.assert_array_equal(a, b)
    for k in eager[2]:
        np.testing.assert_array_equal(graphed[2][k], eager[2][k])
    net, tr = graphed[3], graphed[4]
    assert (net.compile_count, net.capture_count, tr.capture_count,
            net.eager_call_count) == (1, 2, 1, 0)


def test_two_recorded_calls_of_one_key_before_one_backward():
    """The second call would overwrite the activations the first call's
    backward reads: it runs eagerly, is counted, and both gradients equal
    eager's."""
    grads = {}
    for graphed in (False, True):
        tmx.random.seed(0)
        net = _mlp_bn(tnn)
        net.initialize(ctx=tmx.cpu())
        x1, x2 = tmx.np.array(_feats()), tmx.np.array(_x((16, 4), 11))
        net(x1)
        net.hybridize()
        for x in (x1, x2):
            x.attach_grad()
        with _graphs.emulated() if graphed else contextlib.nullcontext():
            with tmx.autograd.record():          # the key's first call
                out = net(x1).sum()
            out.backward()
            with tmx.autograd.record():
                loss = (net(x1) ** 2).sum() + (net(x2) * 3).sum()
            loss.backward()
        grads[graphed] = [x1.grad.asnumpy(), x2.grad.asnumpy()] + [
            p.grad().asnumpy() for p in net.collect_params().values()
            if p.grad_req != 'null']
        if graphed:
            assert net.eager_call_count == 1
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_create_graph_through_a_replayed_call_raises():
    """``create_graph=True`` through a replayed recorded call gives the
    gradient graph an unhybridized net gives (the node runs the forward
    again eagerly under autograd): a gradient penalty's second-order
    gradients equal ``hybridize(False)``'s. A replayed call that draws
    random numbers raises there: an eager run would draw other numbers."""
    x0 = _feats()
    grads = {}
    for graphed in (True, False):
        net = _mlp_bn(tnn)
        net.initialize(ctx=tmx.cpu())
        x = tmx.np.array(x0)
        net(x)
        for k, p in net.collect_params().items():
            p.set_data(np.abs(_x(p.shape, 3)) + 0.5 if 'gamma' in k
                       or 'var' in k else _x(p.shape, 4))
        if graphed:
            net.hybridize()
        x.attach_grad()
        with _graphs.emulated() if graphed else contextlib.nullcontext():
            for _ in range(2):      # the second call is a replay
                with tmx.autograd.record():
                    out = (net(x) ** 2).sum()
                    g = tmx.autograd.grad(out, [x], create_graph=True)[0]
                    penalty = (g ** 2).sum()
                penalty.backward()
        grads[graphed] = [x.grad.asnumpy()] + [
            p.grad().asnumpy() for p in net.collect_params().values()
            if p.grad_req != 'null']
    # fp32 second-order graphs summed in another order, values in the
    # thousands; a gradient that is 0 in exact arithmetic (the first
    # bias's, which BatchNorm removes) is rounding noise of that size
    scale = max(float(np.abs(b).max()) for b in grads[False])
    assert np.abs(grads[False][0]).max() > 0
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * scale)
    drop = tnn.HybridSequential(tnn.Dense(8, in_units=4), tnn.Dropout(0.5))
    drop.initialize(ctx=tmx.cpu())
    x = tmx.np.array(x0)
    drop(x)
    drop.hybridize()
    x.attach_grad()
    with _graphs.emulated():
        for _ in range(2):
            with tmx.autograd.record():
                out = (drop(x) ** 2).sum()
        with pytest.raises(MXNetError, match='random'):
            tmx.autograd.grad(out, [x], create_graph=True)
        # without create_graph the same node differentiates
        g = tmx.autograd.grad(out, [x])[0]
    assert g.shape == x.shape


def test_emulated_dropout_draws_a_new_mask_each_replay():
    net = tnn.HybridSequential(tnn.Dense(256, in_units=8), tnn.Dropout(0.5))
    net.initialize(ctx=tmx.cpu())
    x = tmx.np.array(_x((64, 8), 12))
    net(x)
    net.hybridize()
    masks = []
    with _graphs.emulated():
        for _ in range(3):
            x.attach_grad()
            with tmx.autograd.record():
                out = net(x)
            out.backward(tmx.np.ones(out.shape))
            masks.append(out.asnumpy() != 0)
    assert not np.array_equal(masks[1], masks[2])
    assert abs(masks[2].mean() - 0.5) < 0.02
