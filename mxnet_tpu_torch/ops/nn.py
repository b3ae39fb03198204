"""Neural-network ops of the port that the Llama path calls: ``rms_norm``,
``layer_norm`` and ``silu``.

Counterpart of the same ops in ``mxnet_tpu/ops/nn.py``. A last-axis norm
goes through the fused norm kernel (:mod:`.kernels.fused_norms`); other
axes use plain PyTorch, as the reference uses XLA there. Where autograd
records (:func:`.kernels.needs_grad`), the last-axis norm goes through
:class:`.kernels.fused_norms.FusedNormFunction`, whose backward is the
reference's; otherwise it calls the kernel's wrapper directly, so that
inference pays nothing for the gradient.
"""

import torch
import torch.nn.functional as F

from .kernels import needs_grad
from .kernels.fused_norms import FusedNormFunction, fused_layer_norm, \
    fused_rms_norm

__all__ = ['rms_norm', 'layer_norm', 'silu']


def _bcast(v, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis`` (reference: src/operator/nn/layer_norm.cc)."""
    if axis in (-1, data.dim() - 1) and gamma.dim() == 1:
        x, g, b = data.contiguous(), gamma.contiguous(), beta.contiguous()
        if needs_grad(x, g, b):
            return FusedNormFunction.apply(x, g, b, eps, False)
        return fused_layer_norm(x, g, b, eps)
    mean = data.mean(axis, keepdim=True)
    var = data.var(axis, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    return out * _bcast(gamma, data.dim(), axis) \
        + _bcast(beta, data.dim(), axis)


def rms_norm(data, gamma, axis=-1, eps=1e-6):
    """RMSNorm over ``axis`` for the LLM stack."""
    if axis in (-1, data.dim() - 1) and gamma.dim() == 1:
        x, g = data.contiguous(), gamma.contiguous()
        if needs_grad(x, g):
            return FusedNormFunction.apply(x, g, None, eps, True)
        return fused_rms_norm(x, g, eps)
    ms = (data * data).mean(axis, keepdim=True)
    return data * torch.rsqrt(ms + eps) * _bcast(gamma, data.dim(), axis)


def silu(x):
    """``x * sigmoid(x)``. In fp32, one fused op. In a 16-bit type (the
    bf16 activations of a quantized net), the reference's ``jax.nn.silu``
    steps, ``x * (1 / (1 + exp(-x)))``, each rounded to that type as XLA
    rounds them: one rounding at the end gives other bf16 values."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))
