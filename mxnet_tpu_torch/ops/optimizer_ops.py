"""Optimizer update ops of the port: the fused Adam and SGD-momentum steps
that ``Adam.step`` and ``SGD.step`` call.

Counterpart of ``fused_adam_step`` and ``fused_sgd_mom_step`` in
``mxnet_tpu/ops/optimizer_ops.py``. Each goes through its hand-written
kernel (:mod:`.kernels.fused_optimizer`) and, like the TPU kernel with its
aliased buffers, updates the weight and the slots IN PLACE and returns
them; the reference's XLA fallback returns new arrays instead. The other
update ops of that module (``sgd_update``, the ``multi_*`` and
``preloaded_*`` families, ...) are not ported yet.
"""

from .kernels.fused_optimizer import adam_step, sgd_mom_step

__all__ = ['fused_adam_step', 'fused_sgd_mom_step']


def fused_adam_step(weight, grad, mean, var, lr=0.001, wd=0.0, t=1,
                    beta1=0.9, beta2=0.999, epsilon=1e-8,
                    rescale_grad=1.0, clip_gradient=None,
                    correct_bias=True):
    """One Adam step at update count ``t``, in place on ``weight``,
    ``mean`` and ``var``; returns them. The bias corrections ``1 -
    beta**t`` are taken on the host in double and reach the kernel as
    fp32, as the reference's hyperparameter vector carries them."""
    if correct_bias:
        bc1, bc2 = 1.0 - beta1 ** t, 1.0 - beta2 ** t
    else:
        bc1 = bc2 = 1.0
    return adam_step(weight, grad, mean, var, lr, wd, bc1, bc2,
                     beta1=beta1, beta2=beta2, epsilon=epsilon,
                     rescale_grad=rescale_grad, clip_gradient=clip_gradient)


def fused_sgd_mom_step(weight, grad, mom, lr=0.01, wd=0.0, momentum=0.0,
                       rescale_grad=1.0, clip_gradient=None):
    """One SGD-momentum step, in place on ``weight`` and ``mom``; returns
    them."""
    return sgd_mom_step(weight, grad, mom, lr, wd, momentum=momentum,
                        rescale_grad=rescale_grad,
                        clip_gradient=clip_gradient)
