"""Flash-attention forward, normalised form: the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Counterpart of ``_flash_fwd`` in ``mxnet_tpu/ops/pallas/flash_attention.py``.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel, or
raises on a dtype, shape or layout the kernel does not take.

:class:`FlashAttentionFunction` gives the op its gradient, as the
reference's ``custom_vjp`` (``_flash3``) does: the forward is the wrapper
(the kernel on the card) and the backward is the reference's
``_flash3_bwd``, a blockless recompute of the softmax in fp32 plain
PyTorch. That backward is XLA in the reference, not a Pallas kernel, so it
is no kernel here either.
"""

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ['flash_attention_fwd', 'flash_attention_plain',
           'flash_attention_bwd', 'FlashAttentionFunction', 'HEAD_DIMS']

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128)

_NEG_INF = -1e30
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _probs(q, k, sm_scale, causal):
    """fp32 softmax of the scaled scores, bottom-right causal mask."""
    s = torch.einsum('bqd,bkd->bqk', q.float(), k.float()) * sm_scale
    if causal:
        t, src = s.shape[-2], s.shape[-1]
        mask = torch.ones(t, src, dtype=torch.bool, device=s.device).tril(
            src - t)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return torch.softmax(s, dim=-1)


def flash_attention_plain(q, k, v, sm_scale, causal):
    """The kernel's function in plain PyTorch (``_reference_attention``
    of the reference): q ``(BH, T, d)``, k/v ``(BH, S, d)``, fp32
    softmax, bottom-right causal mask."""
    p = _probs(q, k, sm_scale, causal)
    return torch.einsum('bqk,bkd->bqd', p, v.float()).to(q.dtype)


def flash_attention_bwd(q, k, v, g, sm_scale, causal):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the output
    gradient ``g`` (``_flash3_bwd`` of the reference): ``p`` recomputed
    without blocks, the rest in fp32, each result cast to its input's
    dtype. It holds four ``(BH, T, S)`` fp32 tensors at a time."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = _probs(qf, kf, sm_scale, causal)
    dv = torch.einsum('bqk,bqd->bkd', p, gf)
    dp = torch.einsum('bqd,bkd->bqk', gf, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum('bqk,bkd->bqd', ds, kf)
    dk = torch.einsum('bqk,bqd->bkd', ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention_fwd` with a gradient through
    :func:`flash_attention_bwd`. ``apply(q, k, v, sm_scale, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return flash_attention_fwd(q, k, v, sm_scale, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, g, ctx.sm_scale,
                                   ctx.causal) + (None, None)


def flash_attention_fwd(q, k, v, sm_scale, causal):
    """Normalised blockwise attention over q ``(BH, T, d)`` and k/v
    ``(BH, S, d)``, all contiguous; bottom-right causal (``q_offset = S -
    T``) when ``causal``, which needs T <= S. Output in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise MXNetError(f'flash_attention: want q (BH, T, d) and k, v '
                         f'(BH, S, d); got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    bh, t, d = q.shape
    s = k.shape[1]
    if causal and t > s:
        raise MXNetError('flash_attention: causal with T > S leaves rows '
                         'with no key; the op takes the plain path there')
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise MXNetError('flash_attention: q, k, v must be contiguous')
    if q.device.type == 'cpu':
        return flash_attention_plain(q, k, v, sm_scale, causal)
    if q.device.type != 'cuda' or k.device != q.device \
            or v.device != q.device:
        raise MXNetError('flash_attention: q, k, v must share one CUDA '
                         'device')
    if any(x.dtype != torch.float32 for x in (q, k, v)):
        raise MXNetError(f'flash_attention: the kernel takes float32, got '
                         f'{q.dtype}, {k.dtype}, {v.dtype}')
    if d not in HEAD_DIMS:
        raise MXNetError(f'flash_attention: head dim {d} not in {HEAD_DIMS}')
    if not all(x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise MXNetError('flash_attention: q, k, v must be 16-byte aligned')
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if max(bh, t, s) >= 2 ** 31:
        raise MXNetError('flash_attention: shape too large')
    fn = _build.function('flash_attention', 'flash_attention_fwd_f32', _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, t, s, d, float(sm_scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check('flash_attention', rc, 'flash_attention')
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
