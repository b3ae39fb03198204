"""Fused optimizer updates, Adam and SGD with momentum: the CUDA kernels
``csrc/fused_optimizer.cu`` and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas/fused_optimizer.py``. Every function
here updates the weight and the slots IN PLACE and returns them, as the
TPU kernels alias their buffers (``input_output_aliases``). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel, or raises on a
dtype, shape or layout the kernel does not take. There is no size gate:
the kernel masks its own tail.

The kernels take fp32 only, as the Pallas kernels do. A weight of another
float dtype (a net cast to bf16) takes the plain version on any device,
as the reference sends any non-fp32 weight to XLA
(``mxnet_tpu/ops/pallas/fused_optimizer.py:64-71``): the choice is made
from the dtypes alone, before any launch, and counted in the wrapper's
``plain_updates``. Its gradient must have the weight's dtype and its slots
that dtype or fp32; any other mix raises on the card. The plain version
computes such an update in fp32, as the reference's Trainer does (its
fp32 device scalars promote the arithmetic), and stores the weight back in
its own dtype.

The step-varying hyperparameters come in a small fp32 tensor on the
weight's device, as the TPU kernels take them: ``(lr, wd, bc1, bc2)`` for
Adam (``bc1``, ``bc2`` its bias corrections ``1 - beta**t``) and ``(lr,
wd)`` for SGD-momentum. The kernels read it when they run, so an update
captured in a CUDA graph takes a new learning rate or update count from
the vector on every replay; the plain versions read the same vector.
"""

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ['adam_step', 'adam_step_plain', 'sgd_mom_step',
           'sgd_mom_step_plain', 'hyper_vector']

_ADAM_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p] + \
    [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p]
_SGD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p] + \
    [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]


def hyper_vector(values, device):
    """``values`` (a list, or a list of rows) as a float32 tensor on
    ``device``; to a card through pinned memory, so that the host does not
    wait for the kernels queued before the copy."""
    src = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type != 'cuda':
        return src.to(device)
    return src.pin_memory().to(device, non_blocking=True)


def _prep_grad(g, w, wd, rescale_grad, clip_gradient):
    # the reference's _prep_grad: rescale and clip in g's dtype, then
    # + wd * w (w in fp32 for a weight of another dtype)
    g = g * rescale_grad
    if clip_gradient is not None:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * w


@torch.no_grad()
def adam_step_plain(w, g, m, v, hyper, *, beta1, beta2, epsilon,
                    rescale_grad=1.0, clip_gradient=None):
    """The Adam kernel's function in plain PyTorch (``_adam_kernel`` of
    the reference), in place on ``w``, ``m``, ``v``; ``hyper`` holds
    ``(lr, wd, bc1, bc2)``. Its entries act as 0-dim tensors, as the
    reference's traced scalars do (the bias corrections divide: PyTorch
    on CUDA would turn a division by a Python number into a product with
    its reciprocal, 1 ulp off the division that the kernel takes)."""
    lr, wd, bc1, bc2 = hyper[0], hyper[1], hyper[2], hyper[3]
    wf = w.float()          # w itself when it is fp32, as are the slots
    g = _prep_grad(g, wf, wd, rescale_grad, clip_gradient)
    mf = beta1 * m.float() + (1 - beta1) * g
    vf = beta2 * v.float() + (1 - beta2) * g * g
    m.copy_(mf)
    v.copy_(vf)
    mhat, vhat = mf / bc1, vf / bc2
    w.copy_(wf - lr * mhat / (torch.sqrt(vhat) + epsilon))
    return w, m, v


@torch.no_grad()
def sgd_mom_step_plain(w, g, mom, hyper, *, momentum, rescale_grad=1.0,
                       clip_gradient=None):
    """The SGD-momentum kernel's function in plain PyTorch
    (``_sgd_mom_kernel`` of the reference), in place on ``w``, ``mom``;
    ``hyper`` holds ``(lr, wd)``."""
    lr, wd = hyper[0], hyper[1]
    wf = w.float()
    g = _prep_grad(g, wf, wd, rescale_grad, clip_gradient)
    mf = momentum * mom.float() - lr * g
    mom.copy_(mf)
    w.copy_(wf + mf)
    return w, mom


def _check(what, tensors, hyper, n_hyper):
    """Raise on what neither version takes; True when the kernel runs,
    False when the plain version does: for a CPU tensor, and by the dtype
    rule (a weight that is not fp32, on any device)."""
    if not (torch.is_tensor(hyper) and hyper.dtype == torch.float32
            and hyper.is_contiguous() and hyper.numel() >= n_hyper
            and hyper.device == tensors[0].device):
        got = (f'{hyper.dtype}, {tuple(hyper.shape)} on {hyper.device}'
               if torch.is_tensor(hyper) else repr(hyper))
        raise MXNetError(f'{what}: the hyperparameters must be a contiguous '
                         f'float32 tensor of {n_hyper} values on '
                         f'{tensors[0].device}, got {got}')
    shape = tensors[0].shape
    if any(t.shape != shape for t in tensors):
        raise MXNetError(f'{what}: shapes differ: '
                         f'{[tuple(t.shape) for t in tensors]}')
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError(f'{what}: tensors must be contiguous')
    w, g = tensors[0], tensors[1]
    if w.device.type == 'cpu':
        return False
    dev = w.device
    if dev.type != 'cuda' or any(t.device != dev for t in tensors):
        raise MXNetError(f'{what}: tensors must share one CUDA device, got '
                         f'{[str(t.device) for t in tensors]}')
    if w.dtype != torch.float32 and w.is_floating_point() \
            and g.dtype == w.dtype \
            and all(t.dtype in (w.dtype, torch.float32) for t in tensors[2:]):
        return False
    if any(t.dtype != torch.float32 for t in tensors):
        raise MXNetError(f'{what}: the kernel takes float32, and a weight '
                         f'of another float dtype takes the plain update '
                         f'with a gradient of its dtype and slots of its '
                         f'dtype or float32; got '
                         f'{[t.dtype for t in tensors]}')
    if tensors[0].numel() and \
            len({t.data_ptr() for t in tensors}) != len(tensors):
        raise MXNetError(f'{what}: the weight, gradient and slots must be '
                         f'distinct buffers')
    return True


def _clip(clip_gradient):
    return (0.0, 0) if clip_gradient is None else (float(clip_gradient), 1)


def adam_step(w, g, m, v, hyper, *, beta1, beta2, epsilon,
              rescale_grad=1.0, clip_gradient=None):
    """One Adam update of ``w`` and its moments ``m``, ``v`` from ``g``, in
    place; returns ``(w, m, v)``. ``hyper`` is a float32 tensor on their
    device holding ``(lr, wd, bc1, bc2)``, ``bc1``/``bc2`` the bias
    corrections ``1 - beta**t`` (1 for none). Contiguous; the kernel on
    the card takes fp32, and a weight of another dtype takes the plain
    version (see the module docstring)."""
    if not _check('adam_step', (w, g, m, v), hyper, 4):
        if w.dtype != torch.float32:
            adam_step.plain_updates += 1
        return adam_step_plain(w, g, m, v, hyper, beta1=beta1,
                               beta2=beta2, epsilon=epsilon,
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient)
    if w.numel() == 0:
        return w, m, v
    fn = _build.function('fused_optimizer', 'adam_step_f32', _ADAM_ARGS)
    with _build.on_device(w.device):
        rc = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                w.numel(), hyper.data_ptr(), beta1, 1.0 - beta1, beta2,
                1.0 - beta2, epsilon, rescale_grad, *_clip(clip_gradient),
                torch.cuda.current_stream(w.device).cuda_stream)
    _build.check('fused_optimizer', rc, 'adam_step')
    adam_step.launches += 1
    return w, m, v


adam_step.launches = 0
adam_step.plain_updates = 0


def sgd_mom_step(w, g, mom, hyper, *, momentum, rescale_grad=1.0,
                 clip_gradient=None):
    """One SGD-with-momentum update of ``w`` and ``mom`` from ``g``, in
    place; returns ``(w, mom)``. ``hyper`` is a float32 tensor on their
    device holding ``(lr, wd)``. Contiguous; dtypes as :func:`adam_step`
    takes them."""
    if not _check('sgd_mom_step', (w, g, mom), hyper, 2):
        if w.dtype != torch.float32:
            sgd_mom_step.plain_updates += 1
        return sgd_mom_step_plain(w, g, mom, hyper, momentum=momentum,
                                  rescale_grad=rescale_grad,
                                  clip_gradient=clip_gradient)
    if w.numel() == 0:
        return w, mom
    fn = _build.function('fused_optimizer', 'sgd_mom_step_f32', _SGD_ARGS)
    with _build.on_device(w.device):
        rc = fn(w.data_ptr(), g.data_ptr(), mom.data_ptr(), w.numel(),
                hyper.data_ptr(), momentum, rescale_grad,
                *_clip(clip_gradient),
                torch.cuda.current_stream(w.device).cuda_stream)
    _build.check('fused_optimizer', rc, 'sgd_mom_step')
    sgd_mom_step.launches += 1
    return w, mom


sgd_mom_step.launches = 0
sgd_mom_step.plain_updates = 0
