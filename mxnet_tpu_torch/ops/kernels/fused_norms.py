"""Fused row normalisation, RMS or LayerNorm: the CUDA kernel
``csrc/fused_norms.cu`` and its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas/fused_norms.py``. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel, or raises on a dtype,
shape or layout the kernel does not take.

:class:`FusedNormFunction` gives the op its gradient, as the reference's
``custom_vjp`` does: the forward is the wrapper (the kernel on the card)
and the backward is the reference's ``_fused_norm_bwd``, a recompute of
the statistics in fp32 plain PyTorch. That backward is XLA in the
reference, not a Pallas kernel, so it is no kernel here either.
"""

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ['fused_norm', 'fused_norm_plain', 'fused_norm_bwd',
           'FusedNormFunction', 'fused_rms_norm', 'fused_layer_norm']

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_void_p]


def _out_dtype(x, gamma, beta):
    """The reference's promotion (``out * gamma + beta``): norm weights
    kept in fp32 give fp32 out."""
    dt = torch.promote_types(x.dtype, gamma.dtype)
    return dt if beta is None else torch.promote_types(dt, beta.dtype)


def fused_norm_plain(x, gamma, beta, eps, rms):
    """The kernel's function in plain PyTorch (``_ln_xla`` of the
    reference): fp32 statistics over the last axis."""
    xf = x.float()
    if rms:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        xc = xf - xf.mean(-1, keepdim=True)
        y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(_out_dtype(x, gamma, beta))


def fused_norm(x, gamma, beta=None, eps=1e-5, rms=False):
    """Normalise contiguous ``x`` over its last axis: RMS (``rms=True``,
    ``beta`` None) or LayerNorm. fp32 only on the card."""
    d = x.shape[-1]
    tensors = (x, gamma) if beta is None else (x, gamma, beta)
    if any(t.shape != (d,) for t in tensors[1:]):
        raise MXNetError(f'fused_norm: gamma/beta must be ({d},)')
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError('fused_norm: tensors must be contiguous')
    if rms and beta is not None:
        raise MXNetError('fused_norm: RMS mode takes no beta')
    if x.device.type == 'cpu':
        return fused_norm_plain(x, gamma, beta, eps, rms)
    if x.device.type != 'cuda' or any(t.device != x.device
                                      for t in tensors):
        raise MXNetError(f'fused_norm: tensors must share one CUDA device, '
                         f'got {[str(t.device) for t in tensors]}')
    if any(t.dtype != torch.float32 for t in tensors):
        raise MXNetError(f'fused_norm: the kernel takes float32, got '
                         f'{[t.dtype for t in tensors]}')
    out = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return out
    if n >= 2 ** 31 or d >= 2 ** 31:
        raise MXNetError(f'fused_norm: shape {tuple(x.shape)} too large')
    fn = _build.function('fused_norms', 'fused_norm_f32', _ARGS)
    with _build.on_device(x.device):
        rc = fn(x.data_ptr(), gamma.data_ptr(),
                None if beta is None else beta.data_ptr(), out.data_ptr(),
                n, d, float(eps), int(rms),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check('fused_norms', rc, 'fused_norm')
    fused_norm.launches += 1
    return out


fused_norm.launches = 0


def fused_rms_norm(x, gamma, eps=1e-6):
    """RMSNorm over the last axis (Llama family)."""
    return fused_norm(x, gamma, None, eps, rms=True)


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis."""
    return fused_norm(x, gamma, beta, eps, rms=False)


def fused_norm_bwd(x, gamma, beta, g, eps, rms):
    """``(dx, dgamma, dbeta)`` of :func:`fused_norm` for the output
    gradient ``g`` (``_fused_norm_bwd`` of the reference): the statistics
    recomputed in fp32, each result cast to its input's dtype; ``dbeta``
    is ``None`` when ``beta`` is."""
    xf, gf, gm = x.float(), g.float(), gamma.float()
    red = tuple(range(x.dim() - 1))

    def lead_sum(t):        # sum over every axis but the last
        return t.sum(red) if red else t

    if rms:
        rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        xhat = xf * rstd
        dy = gf * gm
        # d/dx of x * rsqrt(mean(x^2)+eps)
        dx = rstd * (dy - xhat * (dy * xhat).mean(-1, keepdim=True))
    else:
        xc = xf - xf.mean(-1, keepdim=True)
        rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        xhat = xc * rstd
        dy = gf * gm
        dx = rstd * (dy - dy.mean(-1, keepdim=True)
                     - xhat * (dy * xhat).mean(-1, keepdim=True))
    dgamma = lead_sum(gf * xhat)
    dbeta = None if beta is None else lead_sum(gf).to(beta.dtype)
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta


class FusedNormFunction(torch.autograd.Function):
    """:func:`fused_norm` with a gradient through
    :func:`fused_norm_bwd`. ``apply(x, gamma, beta, eps, rms)``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, rms):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.rms = eps, rms
        return fused_norm(x, gamma, beta, eps, rms)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        return fused_norm_bwd(x, gamma, beta, g, ctx.eps, ctx.rms) + (
            None, None)
