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
slots. They carry no gradient.

The module's other ops (``sgd_update``, ``adam_update``, the ``mp_*``
master-weight, ``multi_*`` and ``preloaded_multi_*`` multi-tensor families,
``multi_sum_sq``, ``multi_all_finite``, ``multi_lars``, the LAMB phases,
``reset_arrays``, the dense-input ``sparse_adagrad_update``, ...) are the
reference's functions in plain PyTorch, as the reference leaves them to
XLA, with its argument names and outputs: each returns new tensors (the
weight, then the new slots) and leaves its inputs as they were. A
multi-tensor op takes its arrays interleaved (``w0, g0, w1, g1, ...``),
as positional arguments or one list, and its per-tensor ``lrs``/``wds``
as lists (``preloaded_*``: two device arrays after the tensors). A
``clip_gradient`` of 0 or less means none, as in the reference.
"""

import torch

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


# ------------------------------------------------ the reference's update ops
def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def _prep(grad, weight, rescale_grad, clip_gradient, wd):
    return _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight


@register('sgd_update')
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - lr * g


@register('sgd_mom_update')
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    mom = momentum * mom - lr * g
    return weight + mom, mom


@register('mp_sgd_update')
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    g = _prep(grad.float(), weight32, rescale_grad, clip_gradient, wd)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register('mp_sgd_mom_update')
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.float(), weight32, rescale_grad, clip_gradient, wd)
    mom = momentum * mom - lr * g
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


@register('nag_mom_update')
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    mom = momentum * mom + g
    return weight - lr * (g + momentum * mom), mom


@register('mp_nag_mom_update')
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad.float(), weight32, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * mom_new)
    return w32.to(weight.dtype), mom_new, w32


@register('signsgd_update')
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - lr * torch.sign(g)


@register('signum_update')
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    w = (1 - lr * wd_lh) * weight + lr * torch.sign(mom)
    return w, mom


@register('adam_update')
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam without bias correction (the caller folds it into ``lr``)."""
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * g * g
    return weight - lr * mean / (torch.sqrt(var) + epsilon), mean, var


def _adamw(weight, g, mean, var, lr, beta1, beta2, epsilon, wd, eta):
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * g * g
    w = weight - eta * (lr * mean / (torch.sqrt(var) + epsilon) + wd * weight)
    return w, mean, var


@register('adamw_update')
def adamw_update(weight, grad, mean, var, rescale_grad=1.0, lr=0.001,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay (reference src/operator/contrib/adamw.cc): wd
    multiplies the weight, not the gradient."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return _adamw(weight, g, mean, var, lr, beta1, beta2, epsilon, wd, eta)


@register('mp_adamw_update')
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad=1.0,
                    lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                    wd=0.0, eta=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient)
    w32, mean, var = _adamw(weight32, g, mean, var, lr, beta1, beta2,
                            epsilon, wd, eta)
    return w32.to(weight.dtype), mean, var, w32


@register('ftrl_update')
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    z = z + g - sigma * weight
    w = torch.where(torch.abs(z) > lamda1,
                    -(z - torch.sign(z) * lamda1)
                    / ((beta + torch.sqrt(new_n)) / lr + wd), 0.0)
    return w, z, new_n


@register('ftml_update')
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """Follow the moving leader (reference optimizer_op.cc FTMLUpdate)."""
    g = _rescale_clip(grad, rescale_grad, clip_grad) + wd * weight
    v_new = beta2 * v + (1 - beta2) * g * g
    d_new = (1 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


@register('rmsprop_update')
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    n = gamma1 * n + (1 - gamma1) * g * g
    w = weight - lr * g / torch.sqrt(n + epsilon)
    if clip_weights > 0:
        w = w.clamp(-clip_weights, clip_weights)
    return w, n


@register('rmspropalex_update')
def rmspropalex_update(weight, grad, n, g_acc, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep(grad, weight, rescale_grad, clip_gradient, wd)
    n = gamma1 * n + (1 - gamma1) * g * g
    g_acc = gamma1 * g_acc + (1 - gamma1) * g
    delta = gamma2 * delta - lr * g / torch.sqrt(n - g_acc * g_acc + epsilon)
    w = weight + delta
    if clip_weights > 0:
        w = w.clamp(-clip_weights, clip_weights)
    return w, n, g_acc, delta


def _lamb_phase1(weight, g, mean, var, beta1, beta2, epsilon, t,
                 bias_correction, wd):
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * g * g
    if bias_correction:
        mhat = mean / (1 - beta1 ** t)
        vhat = var / (1 - beta2 ** t)
    else:
        mhat, vhat = mean, var
    return mhat / (torch.sqrt(vhat) + epsilon) + wd * weight, mean, var


def _trust(r1, r2, lower_bound, upper_bound):
    if lower_bound > 0:
        r1 = r1.clamp_min(lower_bound)
    if upper_bound > 0:
        r1 = r1.clamp_max(upper_bound)
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, 1.0)


@register('lamb_update_phase1')
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """The update direction and the new moments; phase 2 applies the
    trust ratio."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return _lamb_phase1(weight, g, mean, var, beta1, beta2, epsilon, t,
                        bias_correction, wd)


@register('mp_lamb_update_phase1')
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    g = _rescale_clip(grad.float(), rescale_grad, clip_gradient)
    return _lamb_phase1(weight32, g, mean, var, beta1, beta2, epsilon, t,
                        bias_correction, wd)


@register('lamb_update_phase2')
def lamb_update_phase2(weight, g, r1, r2, lr=0.001, lower_bound=-1.0,
                       upper_bound=-1.0):
    return weight - lr * _trust(r1, r2, lower_bound, upper_bound) * g


@register('mp_lamb_update_phase2')
def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr=0.001,
                          lower_bound=-1.0, upper_bound=-1.0):
    w32 = weight32 - lr * _trust(r1, r2, lower_bound, upper_bound) * g
    return w32.to(weight.dtype), w32


@register('sparse_adagrad_update')
def sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """The dense-input form of the reference's row-sparse AdaGrad kernel,
    as the reference registers it; a ``RowSparseNDArray`` gradient takes
    ``AdaGrad``'s row-wise update (``Optimizer.update``)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    if wd > 0:
        g = g + wd * weight
    h = history + g * g
    return weight - lr * g / (torch.sqrt(h) + epsilon), h


# -------------------------------------------------------- multi-tensor ops
def _arrays(arrays, stride, tail=0, count=None):
    """The flat array list (positional, or one list) and the number of
    tensors: ``count``, else ``(len - tail) // stride``."""
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return arrays, count if count is not None else \
        (len(arrays) - tail) // stride


@register('multi_sgd_update')
def multi_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=None):
    """``(w, g)`` pairs; one new weight each."""
    arrays, n = _arrays(arrays, 2, count=num_weights)
    return tuple(sgd_update(arrays[2 * i], arrays[2 * i + 1], lr=lrs[i],
                            wd=wds[i], rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient) for i in range(n))


@register('multi_sgd_mom_update')
def multi_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=None):
    """``(w, g, mom)`` triples; ``(w', mom')`` each."""
    arrays, n = _arrays(arrays, 3, count=num_weights)
    outs = []
    for i in range(n):
        outs.extend(sgd_mom_update(
            *arrays[3 * i:3 * i + 3], lr=lrs[i], momentum=momentum,
            wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient))
    return tuple(outs)


@register('multi_mp_sgd_update')
def multi_mp_sgd_update(*arrays, lrs=None, wds=None, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=None):
    """``(w, g, w32)`` triples; ``(w', w32')`` each."""
    arrays, n = _arrays(arrays, 3, count=num_weights)
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_update(
            *arrays[3 * i:3 * i + 3], lr=lrs[i], wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient))
    return tuple(outs)


@register('multi_mp_sgd_mom_update')
def multi_mp_sgd_mom_update(*arrays, lrs=None, wds=None, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=None):
    """``(w, g, mom, w32)`` quadruples; ``(w', mom', w32')`` each."""
    arrays, n = _arrays(arrays, 4, count=num_weights)
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_mom_update(
            *arrays[4 * i:4 * i + 4], lr=lrs[i], momentum=momentum,
            wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient))
    return tuple(outs)


@register('preloaded_multi_sgd_update')
def preloaded_multi_sgd_update(*arrays, rescale_grad=1.0,
                               clip_gradient=-1.0, num_weights=None):
    """:func:`multi_sgd_update` with ``lrs`` and ``wds`` as the last two
    arrays, on the device (reference contrib/preloaded_multi_sgd-inl.h)."""
    arrays, n = _arrays(arrays, 2, tail=2, count=num_weights)
    lrs, wds = arrays[-2], arrays[-1]
    return tuple(sgd_update(arrays[2 * i], arrays[2 * i + 1], lr=lrs[i],
                            wd=wds[i], rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient) for i in range(n))


@register('preloaded_multi_sgd_mom_update')
def preloaded_multi_sgd_mom_update(*arrays, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=None):
    arrays, n = _arrays(arrays, 3, tail=2, count=num_weights)
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i in range(n):
        outs.extend(sgd_mom_update(
            *arrays[3 * i:3 * i + 3], lr=lrs[i], momentum=momentum,
            wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient))
    return tuple(outs)


@register('preloaded_multi_mp_sgd_update')
def preloaded_multi_mp_sgd_update(*arrays, rescale_grad=1.0,
                                  clip_gradient=-1.0, num_weights=None):
    arrays, n = _arrays(arrays, 3, tail=2, count=num_weights)
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_update(
            *arrays[3 * i:3 * i + 3], lr=lrs[i], wd=wds[i],
            rescale_grad=rescale_grad, clip_gradient=clip_gradient))
    return tuple(outs)


@register('preloaded_multi_mp_sgd_mom_update')
def preloaded_multi_mp_sgd_mom_update(*arrays, momentum=0.0,
                                      rescale_grad=1.0, clip_gradient=-1.0,
                                      num_weights=None):
    arrays, n = _arrays(arrays, 4, tail=2, count=num_weights)
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_mom_update(
            *arrays[4 * i:4 * i + 4], lr=lrs[i], momentum=momentum,
            wd=wds[i], rescale_grad=rescale_grad,
            clip_gradient=clip_gradient))
    return tuple(outs)


def _lamb_full(w32, g, mean, var, beta1, beta2, epsilon, t,
               bias_correction, wd, lower_bound, upper_bound, lr):
    upd, mean, var = _lamb_phase1(w32, g, mean, var, beta1, beta2, epsilon,
                                  t, bias_correction, wd)
    r1 = torch.sqrt(torch.sum(w32 * w32))
    r2 = torch.sqrt(torch.sum(upd * upd))
    return w32 - lr * _trust(r1, r2, lower_bound, upper_bound) * upd, \
        mean, var


@register('multi_lamb_update')
def multi_lamb_update(*arrays, learning_rates=None, wds=None, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, step_count=None,
                      bias_correction=True, rescale_grad=1.0,
                      lower_bound=-1.0, upper_bound=-1.0,
                      clip_gradient=-1.0, num_tensors=None):
    """``(w, g, mean, var)`` quadruples (reference contrib/multi_lamb.cc);
    ``(w', mean', var')`` each."""
    arrays, n = _arrays(arrays, 4, count=num_tensors)
    outs = []
    for i in range(n):
        w, g, mean, var = arrays[4 * i:4 * i + 4]
        outs.extend(_lamb_full(
            w, _rescale_clip(g, rescale_grad, clip_gradient), mean, var,
            beta1, beta2, epsilon, step_count[i], bias_correction, wds[i],
            lower_bound, upper_bound, learning_rates[i]))
    return tuple(outs)


@register('multi_mp_lamb_update')
def multi_mp_lamb_update(*arrays, learning_rates=None, wds=None,
                         beta1=0.9, beta2=0.999, epsilon=1e-6,
                         step_count=None, bias_correction=True,
                         rescale_grad=1.0, lower_bound=-1.0,
                         upper_bound=-1.0, clip_gradient=-1.0,
                         num_tensors=None):
    """``(w, g, mean, var, w32)``; ``(w', mean', var', w32')`` each."""
    arrays, n = _arrays(arrays, 5, count=num_tensors)
    outs = []
    for i in range(n):
        w, g, mean, var, w32 = arrays[5 * i:5 * i + 5]
        nw32, nmean, nvar = _lamb_full(
            w32, _rescale_clip(g.float(), rescale_grad, clip_gradient), mean,
            var, beta1, beta2, epsilon, step_count[i], bias_correction,
            wds[i], lower_bound, upper_bound, learning_rates[i])
        outs.extend([nw32.to(w.dtype), nmean, nvar, nw32])
    return tuple(outs)


def _lans_full(w32, g, mean, var, beta1, beta2, epsilon, t, wd, lr):
    """LANS (reference contrib/multi_lans.cc): the gradient normalized per
    tensor, an Adam term and a momentum-free term, each scaled by its
    trust ratio."""
    g = g / torch.sqrt(torch.sum(g * g)).clamp_min(1e-12)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * g * g
    mhat = mean / (1 - beta1 ** t)
    vhat = var / (1 - beta2 ** t)
    denom = torch.sqrt(vhat) + epsilon
    upd_m = mhat / denom + wd * w32
    upd_g = g / denom + wd * w32
    wnorm = torch.sqrt(torch.sum(w32 * w32))

    def ratio(upd):
        un = torch.sqrt(torch.sum(upd * upd))
        return torch.where((wnorm > 0) & (un > 0), wnorm / un, 1.0)

    new_w = w32 - lr * (beta1 * ratio(upd_m) * upd_m
                        + (1 - beta1) * ratio(upd_g) * upd_g)
    return new_w, mean, var


@register('multi_lans_update')
def multi_lans_update(*arrays, learning_rates=None, wds=None, beta1=0.9,
                      beta2=0.999, epsilon=1e-6, step_count=None,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      num_tensors=None):
    """``(w, g, mean, var)`` quadruples; ``(w', mean', var')`` each."""
    arrays, n = _arrays(arrays, 4, count=num_tensors)
    outs = []
    for i in range(n):
        w, g, mean, var = arrays[4 * i:4 * i + 4]
        outs.extend(_lans_full(
            w, _rescale_clip(g, rescale_grad, clip_gradient), mean, var,
            beta1, beta2, epsilon, step_count[i], wds[i],
            learning_rates[i]))
    return tuple(outs)


@register('multi_mp_lans_update')
def multi_mp_lans_update(*arrays, learning_rates=None, wds=None,
                         beta1=0.9, beta2=0.999, epsilon=1e-6,
                         step_count=None, rescale_grad=1.0,
                         clip_gradient=-1.0, num_tensors=None):
    arrays, n = _arrays(arrays, 5, count=num_tensors)
    outs = []
    for i in range(n):
        w, g, mean, var, w32 = arrays[5 * i:5 * i + 5]
        nw32, nmean, nvar = _lans_full(
            w32, _rescale_clip(g.float(), rescale_grad, clip_gradient), mean,
            var, beta1, beta2, epsilon, step_count[i], wds[i],
            learning_rates[i])
        outs.extend([nw32.to(w.dtype), nmean, nvar, nw32])
    return tuple(outs)


@register('multi_adamw_update')
def multi_adamw_update(*arrays, learning_rates=None, wds=None, etas=None,
                       beta1=0.9, beta2=0.999, epsilon=1e-8,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       num_tensors=None):
    """``(w, g, mean, var)`` quadruples (reference contrib/adamw.cc);
    ``(w', mean', var')`` each."""
    arrays, n = _arrays(arrays, 4, count=num_tensors)
    outs = []
    for i in range(n):
        w, g, mean, var = arrays[4 * i:4 * i + 4]
        outs.extend(_adamw(
            w, _rescale_clip(g, rescale_grad, clip_gradient), mean, var,
            learning_rates[i], beta1, beta2, epsilon, wds[i],
            etas[i] if etas is not None else 1.0))
    return tuple(outs)


@register('multi_mp_adamw_update')
def multi_mp_adamw_update(*arrays, learning_rates=None, wds=None,
                          etas=None, beta1=0.9, beta2=0.999,
                          epsilon=1e-8, rescale_grad=1.0,
                          clip_gradient=-1.0, num_tensors=None):
    arrays, n = _arrays(arrays, 5, count=num_tensors)
    outs = []
    for i in range(n):
        w, g, mean, var, w32 = arrays[5 * i:5 * i + 5]
        nw32, nmean, nvar = _adamw(
            w32, _rescale_clip(g.float(), rescale_grad, clip_gradient), mean,
            var, learning_rates[i], beta1, beta2, epsilon, wds[i],
            etas[i] if etas is not None else 1.0)
        outs.extend([nw32.to(w.dtype), nmean, nvar, nw32])
    return tuple(outs)


@register('multi_sum_sq', differentiable=False)
def multi_sum_sq(*arrays, num_arrays=None):
    """Each tensor's sum of squares, in fp32 (reference
    contrib/multi_sum_sq.cc; LAMB's and LARS's norms)."""
    arrays, _ = _arrays(arrays, 1)
    return torch.stack([torch.sum(a.float() ** 2) for a in arrays])


@register('multi_all_finite', differentiable=False)
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    """``[1.]`` iff every element of every tensor is finite (reference
    contrib/all_finite.cc). With ``init_output=False`` the last array is
    the previous flag, ANDed in."""
    arrays, _ = _arrays(arrays, 1)
    if not init_output:
        arrays, prev = arrays[:-1], arrays[-1]
        ok = prev.reshape(()).bool()
    else:
        ok = torch.tensor(True, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a.float()).all()
    return ok.float().reshape(1)


@register('multi_lars', differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0):
    """Per-tensor LARS learning rates from squared norms (reference
    contrib/multi_lars.cc)."""
    wn = torch.sqrt(weights_sum_sq)
    gn = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = eta * wn / (gn + wds * wn + eps)
    return lrs * torch.where((wn > 0) & (gn > 0), trust, 1.0)


@register('reset_arrays', differentiable=False)
def reset_arrays(*arrays, num_arrays=None):
    """Zeros like each tensor (reference contrib/reset_arrays.cc)."""
    arrays, _ = _arrays(arrays, 1)
    return tuple(torch.zeros_like(a) for a in arrays)
