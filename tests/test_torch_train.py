"""The port's training path against the JAX package's, on ``llama_tiny``.

Both nets start from the same numpy weights (carried across by
``from_jax_params``) and train on the same numpy tokens, the loop of
tests/test_llama.py:77-91 with the JAX net hybridized (see ``_jax_net``):
``SoftmaxCrossEntropyLoss().mean()`` over ``tok[:, 1:]`` under
``autograd.record()``, ``backward()``, ``Trainer(net.collect_params())``'s
``step(1)``, and no ``zero_grad`` in either loop (MXNet's
``grad_req='write'``: each backward overwrites the grad buffers). Per-step
losses are held at rtol =
1e-4; weights and optimizer slots at rtol = atol = 1e-4: the two
frameworks sum the projections and their gradients in another order.
"""

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon as jax_gluon
from mxnet_tpu import lr_scheduler as jax_lr
from mxnet_tpu.gluon.model_zoo import llama as jax_llama

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd as tautograd, lr_scheduler
from mxnet_tpu_torch.gluon import Trainer, loss as torch_loss
from mxnet_tpu_torch.gluon.model_zoo import llama as torch_llama
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.ops import kernels

TOL = dict(rtol=1e-4, atol=1e-4)
ADAM = ('adam', {'learning_rate': 5e-3})
SGD = ('sgd', {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-4})
#: Adam's first update is about lr * sign(g): where |g| is this small, the
#: two frameworks' gradients, which differ in their last bits, may give
#: opposite signs, and the weights differ by up to 2 lr there
TINY_GRAD = 1e-6


def _weights(seed=0):
    """numpy weights for every parameter of llama_tiny, keyed by the JAX
    package's names: N(0, 0.1), the norms 1 + N(0, 0.1)."""
    rng = onp.random.default_rng(seed)
    net = _jax_net(None)
    out = {}
    for name, p in net.collect_params().items():
        w = rng.standard_normal(p.shape).astype(onp.float32) * 0.1
        out[name] = w + 1.0 if name.endswith('norm.weight') else w
    return out


def _jax_net(params):
    """The JAX llama_tiny with ``params``, hybridized: its eager
    attention computes on raw arrays outside the autograd tape, so eager
    training gives the q/k/v projections and the input norms no gradient
    (ROADMAP queue C). Hybridized, one ``jax.vjp`` covers the whole net,
    through the norm's and flash attention's ``custom_vjp``s."""
    net = jax_llama.llama_tiny()
    net.initialize()
    net(mx.np.zeros((1, 2)))
    if params is not None:
        for name, p in net.collect_params().items():
            p.set_data(params[name])
        net.hybridize()
    return net


def _torch_net(params):
    return torch_llama.from_jax_params(torch_llama.llama_tiny(), params,
                                       ctx=tmx.cpu())


def _tokens(seed=1):
    return onp.random.default_rng(seed).integers(0, 256, (4, 16))


def _jax_train(net, trainer, toks, steps):
    """Per step: the loss and every gradient (JAX names), then step."""
    loss_fn = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    tok = mx.np.array(toks.astype(onp.int32))
    losses, grads = [], []
    for _ in range(steps):
        with autograd.record():
            l = loss_fn(net(tok[:, :-1]), tok[:, 1:]).mean()
        l.backward()
        grads.append({n: p.grad().asnumpy()
                      for n, p in net.collect_params().items()})
        trainer.step(1)
        losses.append(float(l.asnumpy()))
    return losses, grads


def _torch_train(net, trainer, toks, steps):
    """The same loop in the port, with no zero_grad; gradients by name."""
    loss_fn = torch_loss.SoftmaxCrossEntropyLoss()
    tok = NDArray(torch.from_numpy(toks))
    losses, grads = [], []
    for _ in range(steps):
        with tautograd.record():
            l = loss_fn(net(tok[:, :-1]), tok[:, 1:]).mean()
        l.backward()
        grads.append({n: p.grad().asnumpy().copy()
                      for n, p in net.collect_params().items()})
        trainer.step(1)
        losses.append(float(l.asnumpy()))
    return losses, grads


_NAMES = []


def _weights_names():
    if not _NAMES:
        _NAMES.extend(_jax_net(None).collect_params())
    return _NAMES


def _jax_state(jtrainer):
    """The JAX Trainer's slots and update counts as numpy, by name."""
    names = list(_weights_names())
    states, counts = {}, {}
    for i, st in jtrainer._states.items():
        if isinstance(st, tuple):
            states[names[i]] = tuple(s.asnumpy() for s in st)
        else:
            states[names[i]] = None if st is None else st.asnumpy()
    for i, t in jtrainer._optimizer._index_update_count.items():
        counts[names[i]] = t
    return states, counts


def _torch_state(ttrainer, tnet):
    names = list(tnet.collect_params())
    return {names[i]: st for i, st in ttrainer._states.items()}


def _close(got, want, mask=None, what=''):
    got, want = onp.asarray(got), onp.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    onp.testing.assert_allclose(got, want, err_msg=what, **TOL)


def _check_weights(jnet, tnet, tiny=None):
    tparams = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        keep = None if tiny is None else ~tiny[name]
        _close(tparams[name].data().asnumpy(), p.data().asnumpy(), keep,
               name)


def _check_slots(jtrainer, ttrainer, tnet):
    tstates = _torch_state(ttrainer, tnet)
    jstates, jcounts = _jax_state(jtrainer)
    assert len(tstates) == len(jstates) == 21
    for name, st in jstates.items():
        got = tstates[name]
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        st if isinstance(st, tuple) else (st,)):
            _close(a.numpy(), b, what=name)
    names = list(_weights_names())
    assert {names[i]: t for i, t in
            ttrainer.optimizer._index_update_count.items()} == jcounts


def _tiny_grads(*grad_runs):
    """Per parameter, the elements where any step's gradient, in either
    framework, is nonzero but below TINY_GRAD."""
    out = {}
    for run in grad_runs:
        for step in run:
            for name, g in step.items():
                a = onp.abs(g)
                hit = (a > 0) & (a < TINY_GRAD)
                out[name] = out.get(name, False) | hit
    return out


def _both(opt, steps=3, params=None, toks=None):
    params = _weights() if params is None else params
    toks = _tokens() if toks is None else toks
    jnet, tnet = _jax_net(params), _torch_net(params)
    jtr = jax_gluon.Trainer(jnet.collect_params(), opt[0], dict(opt[1]))
    ttr = Trainer(tnet.collect_params(), opt[0], dict(opt[1]))
    jl, jg = _jax_train(jnet, jtr, toks, steps)
    tl, tg = _torch_train(tnet, ttr, toks, steps)
    return (jnet, jtr, jl, jg), (tnet, ttr, tl, tg)


@pytest.mark.parametrize('opt', [ADAM, SGD], ids=['adam', 'sgd-momentum'])
def test_three_steps_match_the_jax_trainer(opt):
    """Three steps with no zero_grad between them: losses, weights and
    slots (Adam's m and v, SGD's momentum) as in the JAX Trainer."""
    (jnet, jtr, jl, jg), (tnet, ttr, tl, tg) = _both(opt)
    onp.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    tiny = _tiny_grads(jg, tg) if opt is ADAM else None
    if tiny is not None:      # it leaves out under 1 element in 1000
        left_out = sum(int(m.sum()) for m in tiny.values())
        assert left_out < 1e-3 * sum(m.size for m in tiny.values())
    _check_weights(jnet, tnet, tiny)
    _check_slots(jtr, ttr, tnet)


def test_plain_sgd_two_steps_without_zero_grad():
    """``momentum=0`` (the plain path, no kernel) over two steps: the
    second backward writes a fresh gradient, as ``grad_req='write'``
    does, instead of adding to the first."""
    opt = ('sgd', {'learning_rate': 0.1, 'wd': 1e-3, 'clip_gradient': 0.05})
    (jnet, _, jl, jg), (tnet, ttr, tl, tg) = _both(opt, steps=2)
    onp.testing.assert_allclose(tl, jl, rtol=1e-4)
    for name in jg[1]:
        _close(tg[1][name], jg[1][name], what=name)
    _check_weights(jnet, tnet)
    assert ttr._states == {i: None for i in range(21)}


def test_adam_from_a_carried_over_state_at_t5():
    """Four JAX steps, then the state (weights, m, v, update counts)
    carried to the port by ``from_jax_params`` and
    ``Trainer.load_jax_state``; the fifth step, whose bias correction
    reads t = 5, matches in both."""
    params, toks = _weights(), _tokens()
    jnet = _jax_net(params)
    jtr = jax_gluon.Trainer(jnet.collect_params(), *ADAM)
    _jax_train(jnet, jtr, toks, 4)
    mid = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = _torch_net(mid)
    ttr = Trainer(tnet.collect_params(), *ADAM)
    states, counts = _jax_state(jtr)
    assert set(counts.values()) == {4}
    ttr.load_jax_state(states, counts)
    jl, jg = _jax_train(jnet, jtr, toks, 1)
    tl, tg = _torch_train(tnet, ttr, toks, 1)
    onp.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert set(ttr.optimizer._index_update_count.values()) == {5}
    _check_weights(jnet, tnet, _tiny_grads(jg, tg))
    _check_slots(jtr, ttr, tnet)


def test_factor_scheduler_gives_the_reference_lr_sequence():
    jopt = ('sgd', {'momentum': 0.9, 'learning_rate': 0.2,
                    'lr_scheduler': jax_lr.FactorScheduler(step=1,
                                                           factor=0.5)})
    topt = ('sgd', {'momentum': 0.9, 'learning_rate': 0.2,
                    'lr_scheduler': lr_scheduler.FactorScheduler(
                        step=1, factor=0.5)})
    params, toks = _weights(), _tokens()
    jnet, tnet = _jax_net(params), _torch_net(params)
    jtr = jax_gluon.Trainer(jnet.collect_params(), *jopt)
    ttr = Trainer(tnet.collect_params(), *topt)
    jlrs, tlrs = [], []
    for _ in range(3):
        _jax_train(jnet, jtr, toks, 1)
        _torch_train(tnet, ttr, toks, 1)
        jlrs.append(jtr.learning_rate)
        tlrs.append(ttr.learning_rate)
    assert tlrs == jlrs == [0.2, 0.1, 0.05]
    _check_weights(jnet, tnet)


@pytest.mark.parametrize('sparse', [True, False], ids=['sparse', 'dense'])
def test_softmax_cross_entropy_matches_the_jax_loss(sparse):
    rng = onp.random.default_rng(2)
    pred = rng.standard_normal((3, 5, 11)).astype(onp.float32) * 3
    if sparse:
        label = rng.integers(0, 11, (3, 5))
    else:
        label = onp.abs(rng.standard_normal((3, 5, 11))).astype(onp.float32)
    w = rng.random((3, 1)).astype(onp.float32)
    want = jax_gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        mx.np.array(pred), mx.np.array(label), mx.np.array(w)).asnumpy()
    got = torch_loss.SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(w))
    assert got.shape == (3,)
    _close(got.numpy(), want)


def test_l2_loss_matches_the_jax_loss():
    rng = onp.random.default_rng(3)
    pred = rng.standard_normal((4, 6)).astype(onp.float32)
    label = rng.standard_normal((4, 6)).astype(onp.float32)
    want = jax_gluon.loss.L2Loss()(mx.np.array(pred),
                                   mx.np.array(label)).asnumpy()
    got = torch_loss.L2Loss()(torch.from_numpy(pred),
                              torch.from_numpy(label))
    _close(got.numpy(), want)


def test_trainer_refuses_what_one_device_cannot_do():
    net = torch_llama.llama_tiny()
    net.initialize(ctx=tmx.cpu())
    params = net.collect_params()
    # dist_sync is taken; with one process it is the local store, and the
    # step reduces nothing (tests/test_torch_dist.py has two ranks)
    dist_tr = Trainer(params, 'sgd', kvstore='dist_sync')
    dist_tr.allreduce_grads()
    assert dist_tr._kvstore.type == 'dist_tpu_sync'
    assert dist_tr._kvstore.num_workers == 1
    with pytest.raises(ValueError, match='Unknown KVStore'):
        Trainer(params, 'sgd', kvstore='bogus').allreduce_grads()
    with pytest.raises(ValueError):
        Trainer([torch.zeros(3)], 'sgd')
    with pytest.raises(ValueError):     # a torch.nn leaf is no Parameter
        Trainer([torch.nn.Parameter(torch.zeros(3))], 'sgd')
    # multi_precision is accepted and kept, as the reference keeps it, and
    # makes no fp32 master copy: an fp32 weight's state is its two moments
    mp = Trainer(params, 'adam', {'multi_precision': True})
    assert mp.optimizer.multi_precision is True
    w = next(iter(params.values())).data()._data
    st = mp.optimizer.create_state_multi_precision(0, w.detach())
    assert len(st) == 2 and all(t.shape == w.shape for t in st)
    tr = Trainer(list(params.values()), 'adam')
    with pytest.raises(MXNetError, match='named'):
        tr.load_jax_state({}, {})
    tr = Trainer(params, 'adam')
    with pytest.raises(KeyError):
        tr.load_jax_state({'model.nope': None}, {})


def test_step_without_a_fresh_gradient_raises_unless_told():
    """A second step with no backward between: as in the JAX Trainer, every
    parameter whose ``grad_req`` is ``'write'`` updates again with what its
    grad buffer holds (MXNet's buffers outlive the backward), so nothing
    raises and ``ignore_stale_grad`` changes nothing; the weights follow
    the JAX Trainer's three SGD-momentum steps."""
    opt = ('sgd', {'learning_rate': 0.1, 'momentum': 0.9})
    params, toks = _weights(), _tokens()
    jnet, tnet = _jax_net(params), _torch_net(params)
    jtr = jax_gluon.Trainer(jnet.collect_params(), *opt)
    tr = Trainer(tnet.collect_params(), *opt)
    _jax_train(jnet, jtr, toks, 1)
    kernels.reset_launch_counts()
    _torch_train(tnet, tr, toks, 1)
    jtr.step(1)
    jtr.step(1, ignore_stale_grad=True)
    tr.step(1)
    tr.step(1, ignore_stale_grad=True)
    _check_weights(jnet, tnet)
    assert kernels.launch_counts()['sgd_mom'] == 0        # CPU: plain
