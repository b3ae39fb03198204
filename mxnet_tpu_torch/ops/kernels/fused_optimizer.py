"""Fused optimizer updates, Adam and SGD with momentum: the CUDA kernels
``csrc/fused_optimizer.cu`` and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas/fused_optimizer.py``. Every function
here updates the weight and the slots IN PLACE and returns them, as the
TPU kernels alias their buffers (``input_output_aliases``). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel, or raises on a
dtype, shape or layout the kernel does not take. There is no size gate:
the kernel masks its own tail.

The step-varying scalars (``lr``, ``wd`` and Adam's bias corrections
``bc1``, ``bc2``) are plain arguments, where the TPU kernel reads them from
a device vector so that XLA need not recompile.
"""

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ['adam_step', 'adam_step_plain', 'sgd_mom_step',
           'sgd_mom_step_plain']

_ADAM_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
    [ctypes.c_float] * 11 + [ctypes.c_int, ctypes.c_void_p]
_SGD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
    [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p]


def _prep_grad(g, w, wd, rescale_grad, clip_gradient):
    # the reference's _prep_grad: rescale, clip, then + wd * w
    g = g * rescale_grad
    if clip_gradient is not None:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * w


@torch.no_grad()
def adam_step_plain(w, g, m, v, lr, wd, bc1, bc2, *, beta1, beta2, epsilon,
                    rescale_grad=1.0, clip_gradient=None):
    """The Adam kernel's function in plain PyTorch (``_adam_kernel`` of
    the reference), in place on ``w``, ``m``, ``v``. The bias corrections
    divide as 0-dim tensors: PyTorch on CUDA turns a division by a Python
    number into a product with its reciprocal, 1 ulp off the division
    that the reference and the kernel take."""
    g = _prep_grad(g, w, wd, rescale_grad, clip_gradient)
    m.copy_(beta1 * m + (1 - beta1) * g)
    v.copy_(beta2 * v + (1 - beta2) * g * g)
    mhat, vhat = m / m.new_full((), bc1), v / v.new_full((), bc2)
    w.copy_(w - lr * mhat / (torch.sqrt(vhat) + epsilon))
    return w, m, v


@torch.no_grad()
def sgd_mom_step_plain(w, g, mom, lr, wd, *, momentum, rescale_grad=1.0,
                       clip_gradient=None):
    """The SGD-momentum kernel's function in plain PyTorch
    (``_sgd_mom_kernel`` of the reference), in place on ``w``, ``mom``."""
    g = _prep_grad(g, w, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * g)
    w.add_(mom)
    return w, mom


def _check(what, tensors):
    """Raise on what neither version takes; True when the kernel runs."""
    shape = tensors[0].shape
    if any(t.shape != shape for t in tensors):
        raise MXNetError(f'{what}: shapes differ: '
                         f'{[tuple(t.shape) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError(f'{what}: tensors must be contiguous')
    if tensors[0].device.type == 'cpu':
        return False
    dev = tensors[0].device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise MXNetError(f'{what}: tensors must share one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if any(t.dtype != torch.float32 for t in tensors):
        raise MXNetError(f'{what}: the kernel takes float32, got '
                         f'{[t.dtype for t in tensors]}')
    if tensors[0].numel() and \
            len({t.data_ptr() for t in tensors}) != len(tensors):
        raise MXNetError(f'{what}: the weight, gradient and slots must be '
                         f'distinct buffers')
    return True


def _clip(clip_gradient):
    return (0.0, 0) if clip_gradient is None else (float(clip_gradient), 1)


def adam_step(w, g, m, v, lr, wd, bc1, bc2, *, beta1, beta2, epsilon,
              rescale_grad=1.0, clip_gradient=None):
    """One Adam update of ``w`` and its moments ``m``, ``v`` from ``g``, in
    place; returns ``(w, m, v)``. ``bc1``/``bc2`` are the bias corrections
    ``1 - beta**t`` (1 for none). fp32 and contiguous on the card."""
    if not _check('adam_step', (w, g, m, v)):
        return adam_step_plain(w, g, m, v, lr, wd, bc1, bc2, beta1=beta1,
                               beta2=beta2, epsilon=epsilon,
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient)
    if w.numel() == 0:
        return w, m, v
    fn = _build.function('fused_optimizer', 'adam_step_f32', _ADAM_ARGS)
    with _build.on_device(w.device):
        rc = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                w.numel(), lr, wd, bc1, bc2, beta1, 1.0 - beta1, beta2,
                1.0 - beta2, epsilon, rescale_grad, *_clip(clip_gradient),
                torch.cuda.current_stream(w.device).cuda_stream)
    _build.check('fused_optimizer', rc, 'adam_step')
    adam_step.launches += 1
    return w, m, v


adam_step.launches = 0


def sgd_mom_step(w, g, mom, lr, wd, *, momentum, rescale_grad=1.0,
                 clip_gradient=None):
    """One SGD-with-momentum update of ``w`` and ``mom`` from ``g``, in
    place; returns ``(w, mom)``. fp32 and contiguous on the card."""
    if not _check('sgd_mom_step', (w, g, mom)):
        return sgd_mom_step_plain(w, g, mom, lr, wd, momentum=momentum,
                                  rescale_grad=rescale_grad,
                                  clip_gradient=clip_gradient)
    if w.numel() == 0:
        return w, mom
    fn = _build.function('fused_optimizer', 'sgd_mom_step_f32', _SGD_ARGS)
    with _build.on_device(w.device):
        rc = fn(w.data_ptr(), g.data_ptr(), mom.data_ptr(), w.numel(), lr,
                wd, momentum, rescale_grad, *_clip(clip_gradient),
                torch.cuda.current_stream(w.device).cuda_stream)
    _build.check('fused_optimizer', rc, 'sgd_mom_step')
    sgd_mom_step.launches += 1
    return w, mom


sgd_mom_step.launches = 0
