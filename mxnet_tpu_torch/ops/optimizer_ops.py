"""Optimizer update ops of the port: the fused Adam and SGD-momentum steps.

Counterpart of ``fused_adam_step`` and ``fused_sgd_mom_step`` in
``mxnet_tpu/ops/optimizer_ops.py``. The tensor functions go through their
hand-written kernel (:mod:`.kernels.fused_optimizer`) and, like the TPU
kernel with its aliased buffers, update the weight and the slots IN PLACE
and return them, each building the kernel's hyperparameter vector for its
one call (``Adam.step`` and ``SGD.step`` call the kernels with a row of
the Trainer's device vectors instead). The registered ops (``npx.fused_adam_step``, ``npx.fused_sgd_mom_step``) keep
the reference's meaning instead: they return new arrays and leave their
inputs as they were, so the kernel runs on copies of the weight and the
slots. They carry no gradient. The other update ops of that module
(``sgd_update``, the ``multi_*`` and ``preloaded_*`` families, ...) are
not ported yet (``ops/ledger.py``, ROADMAP A6 rest).
"""

from .kernels.fused_optimizer import adam_step, hyper_vector, sgd_mom_step
from .registry import register

__all__ = ['fused_adam_step', 'fused_sgd_mom_step']


def fused_adam_step(weight, grad, mean, var, lr=0.001, wd=0.0, t=1,
                    beta1=0.9, beta2=0.999, epsilon=1e-8,
                    rescale_grad=1.0, clip_gradient=None,
                    correct_bias=True):
    """One Adam step at update count ``t``, in place on ``weight``,
    ``mean`` and ``var``; returns them. The kernel's hyperparameter
    vector ``(lr, wd, bc1, bc2)`` is built for this one call: the bias
    corrections ``1 - beta**t`` of a Python ``t`` are taken on the host in
    double and rounded to fp32, as the reference's ``adam_step`` stacks
    them."""
    if correct_bias:
        bc1, bc2 = 1.0 - beta1 ** t, 1.0 - beta2 ** t
    else:
        bc1 = bc2 = 1.0
    return adam_step(weight, grad, mean, var,
                     hyper_vector((lr, wd, bc1, bc2), weight.device),
                     beta1=beta1,
                     beta2=beta2, epsilon=epsilon, rescale_grad=rescale_grad,
                     clip_gradient=clip_gradient)


def fused_sgd_mom_step(weight, grad, mom, lr=0.01, wd=0.0, momentum=0.0,
                       rescale_grad=1.0, clip_gradient=None):
    """One SGD-momentum step, in place on ``weight`` and ``mom``; returns
    them. The kernel's hyperparameter vector ``(lr, wd)`` is built for
    this one call."""
    return sgd_mom_step(weight, grad, mom,
                        hyper_vector((lr, wd), weight.device),
                        momentum=momentum, rescale_grad=rescale_grad,
                        clip_gradient=clip_gradient)


@register('fused_adam_step', differentiable=False)
def _fused_adam_step_op(weight, grad, mean, var, lr=0.001, wd=0.0, t=1,
                        beta1=0.9, beta2=0.999, epsilon=1e-8,
                        rescale_grad=1.0, clip_gradient=None,
                        correct_bias=True):
    """One Adam step, ``(w, g, m, v) -> (w', m', v')``; the inputs keep
    their values."""
    return fused_adam_step(
        weight.contiguous().clone(), grad.contiguous(),
        mean.contiguous().clone(), var.contiguous().clone(), lr, wd, t,
        beta1, beta2, epsilon, rescale_grad, clip_gradient, correct_bias)


@register('fused_sgd_mom_step', differentiable=False)
def _fused_sgd_mom_step_op(weight, grad, mom, lr=0.01, wd=0.0, momentum=0.0,
                           rescale_grad=1.0, clip_gradient=None):
    """One SGD-momentum step, ``(w, g, mom) -> (w', mom')``; the inputs
    keep their values."""
    return fused_sgd_mom_step(
        weight.contiguous().clone(), grad.contiguous(),
        mom.contiguous().clone(), lr, wd, momentum, rescale_grad,
        clip_gradient)
