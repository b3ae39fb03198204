"""The imperative program of ``chip_smoke.py``'s ndarray phase
(``frontend_loss``: a one-block Llama written only with ``mx.np``/
``mx.npx`` calls, recorded with ``mx.autograd`` and stepped with
``npx.fused_adam_step``) at ``llama_tiny``'s widths, through both
packages on the CPU from the same numpy weights and tokens; the JAX
package's Pallas ops run as its own tests run them on the CPU. The losses
of both steps agree within rtol 1e-5, every gradient of the first step
and every weight after two Adam steps within atol 1e-5 (rtol 1e-5). The
port's module path (the Gluon ``LlamaForCausalLM``, ``mx.autograd`` and the
in-place tensor functions) meets the port's imperative program at the same
tolerances, as the chip phase holds them on the card.

Adam runs at lr 1e-4, where two steps move the weights by about 2e-4, 20
times the tolerance. Its step ``lr * g / (|g| + eps)`` turns a gradient
difference at the rounding level into a large one where ``|g|`` is near
``eps``: at lr 1e-3 one entry in 16384 of the LM head parts by 3.1e-5.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

W = cs.FRONTEND_WIDTHS['llama_tiny']
RTOL, ATOL = 1e-5, 1e-5
HYPER = {'lr': 1e-4}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {}
    for n, shape in cs.frontend_shapes(W).items():
        params[n] = (rng.uniform(0.8, 1.2, shape) if len(shape) == 1 else
                     rng.normal(0.0, 0.02, shape)).astype('float32')
    tokens = rng.integers(0, W['vocab'], (2, 17)).astype('int32')
    return params, tokens


def _run(mx, params, tokens, steps=2):
    p = {n: mx.np.array(a) for n, a in params.items()}
    for a in p.values():
        a.attach_grad()
    toks = mx.np.array(tokens)
    slots = cs.frontend_slots(mx, p, 'adam')
    losses, grads = [], None
    for t in range(1, steps + 1):
        loss = cs.frontend_backward(mx, p, toks, W)
        losses.append(float(loss.asnumpy()))
        if grads is None:
            grads = {n: a.grad.asnumpy() for n, a in p.items()}
        cs.frontend_update(mx, p, slots, 'adam', HYPER, t)
    return losses, grads, {n: a.asnumpy() for n, a in p.items()}


@pytest.fixture(scope='module')
def runs():
    params, tokens = _inputs()
    jax_run = _run(jmx, params, tokens)
    with tmx.cpu():
        port_run = _run(tmx, params, tokens)
    return params, tokens, jax_run, port_run


def test_losses_agree_with_jax(runs):
    _, _, (jl, _, _), (tl, _, _) = runs
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[1] < tl[0]


def test_every_gradient_agrees_with_jax(runs):
    _, _, (_, jg, _), (_, tg, _) = runs
    assert set(tg) == set(jg)
    for n in jg:
        assert np.abs(jg[n]).max() > 0, f'{n}: no gradient in the reference'
        np.testing.assert_allclose(tg[n], jg[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_weights_after_two_adam_steps_agree_with_jax(runs):
    params, _, (_, _, jw), (_, _, tw) = runs
    for n in jw:
        assert np.abs(tw[n] - params[n]).max() > 10 * ATOL, \
            f'{n} did not move'
        np.testing.assert_allclose(tw[n], jw[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_the_module_path_meets_the_imperative_program(runs):
    params, tokens, _, (tl, _, tw) = runs
    with tmx.cpu():
        p = {n: tmx.np.array(a) for n, a in params.items()}
        net = cs.module_net(torch, W, p, 'cpu')
    toks = torch.tensor(tokens).long()
    slots = {n: (torch.zeros_like(q), torch.zeros_like(q))
             for n, q in cs.module_params(net).items()}
    losses = [float(cs.module_step(torch, net, toks, 'adam', HYPER, slots,
                                   t)) for t in (1, 2)]
    np.testing.assert_allclose(losses, tl, rtol=RTOL)
    for n, prm in cs.module_params(net).items():
        np.testing.assert_allclose(prm.detach().numpy(), tw[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_the_program_dispatches_through_the_registry():
    params, tokens = _inputs(1)
    from mxnet_tpu_torch.ops import registry
    with tmx.cpu():
        p = {n: tmx.np.array(a) for n, a in params.items()}
        for a in p.values():
            a.attach_grad()
        before = registry.dispatch_count()
        cs.frontend_backward(tmx, p, tmx.np.array(tokens), W)
        assert registry.dispatch_count() - before > 30
