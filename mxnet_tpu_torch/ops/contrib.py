"""Contrib ops of the port: the attention ops, ``flash_attention``,
``paged_attention_decode`` and ``multi_head_attention``, and the
calibration op ``calibrate_entropy``.

Counterpart of the same ops in ``mxnet_tpu/ops/contrib.py``. The attention
ops reshape their operands and call the hand-written kernel's wrapper
(:mod:`.kernels.flash_attention`, :mod:`.kernels.paged_attention`), which
runs the plain PyTorch version for CPU tensors. Where autograd records,
``flash_attention`` goes through
:class:`.kernels.flash_attention.FlashAttentionFunction`, whose backward
is the reference's ``_flash3_bwd``. ``multi_head_attention`` without a
mask or dropout is ``flash_attention``; with them, plain PyTorch, as the
reference leaves that case to XLA. ``calibrate_entropy`` reuses the
calibration collector of :mod:`mxnet_tpu_torch.quantization`.
``group_adagrad_update`` is the reference's row-wise AdaGrad in plain
PyTorch. The other contrib ops of the reference wait (``ops/ledger.py``).
"""

import numpy as _np
import torch

from .kernels import needs_grad
from .kernels.flash_attention import FlashAttentionFunction, \
    flash_attention_fwd, flash_attention_plain
from .kernels.paged_attention import paged_attention_decode as _paged
from .registry import register

__all__ = ['flash_attention', 'paged_attention_decode',
           'multi_head_attention', 'calibrate_entropy',
           'group_adagrad_update']


@register('flash_attention')
def flash_attention(q, k, v, sm_scale=None, causal=False, block_q=128,
                    block_k=128):
    """Blockwise fused attention. q ``(..., T, d)``; k/v ``(..., S, d)``
    with matching leading dims; ``sm_scale`` defaults to 1/sqrt(d);
    causal masking is bottom-right aligned. Returns ``(..., T, d)`` in
    q's dtype, softmax and accumulation in fp32. ``block_q``/``block_k``
    are the TPU kernel's tiles, taken for the reference's signature and
    not used: the kernel's plan picks its own."""
    q_shape = q.shape
    d = q_shape[-1]
    t, s = q.shape[-2], k.shape[-2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    qr = q.reshape(-1, t, d).contiguous()
    kr = k.reshape(-1, s, d).contiguous()
    vr = v.reshape(-1, s, d).contiguous()
    if causal and t > s:
        # more queries than keys leaves fully masked rows: the reference
        # takes plain attention there (its kernel would emit zeros), and
        # autograd differentiates it as it stands
        return flash_attention_plain(qr, kr, vr, sm_scale,
                                     causal).reshape(q_shape)
    if needs_grad(qr, kr, vr):
        out = FlashAttentionFunction.apply(qr, kr, vr, sm_scale, causal)
    else:
        out = flash_attention_fwd(qr, kr, vr, sm_scale, causal)
    return out.reshape(q_shape)


@register('paged_attention_decode')
def paged_attention_decode(q, k_pool, v_pool, pages, offset,
                           sm_scale=None):
    """One decode step of attention over a paged KV pool.

    q ``(B, H, dh)``: this step's queries, RoPE applied; k_pool/v_pool
    ``(num_pages, page_size, kv_heads, dh)``, already holding this step's
    K/V; pages ``(B, pages_per_seq)`` int32 block table; offset ``(B,)``
    int32, the absolute position of row b's current token (row b attends
    logical positions ``<= offset[b]``). Query heads ``[j*G, (j+1)*G)``
    share KV head ``j``."""
    B, H, dh = q.shape
    kv = k_pool.shape[2]
    scale = (dh ** -0.5) if sm_scale is None else sm_scale
    out = _paged(q.reshape(B, kv, H // kv, dh).contiguous(), k_pool, v_pool,
                 pages, offset, scale)
    return out.reshape(B, H, dh)


@register('multi_head_attention')
def multi_head_attention(q, k, v, num_heads, mask=None, dropout_p=0.0,
                         causal=False, key=None):
    """Scaled-dot-product attention over ``(batch, seq, embed)``. With no
    mask and no dropout it is :func:`flash_attention` over the heads;
    otherwise plain PyTorch in fp32, where ``key`` (a ``torch.Generator``
    on q's device) draws the dropout mask."""
    b, sq, e = q.shape
    hd = e // num_heads
    qh = q.reshape(b, sq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], num_heads, hd).transpose(1, 2)
    if mask is None and dropout_p == 0.0:
        out = flash_attention(qh, kh, vh, causal=causal)
        return out.transpose(1, 2).reshape(b, sq, e)
    sk = k.shape[1]
    if causal:
        # bottom-right aligned, as the flash path when T != S
        tri = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril(sk - sq)
        mask = tri if mask is None else mask.to(torch.bool) & tri
    s = torch.einsum('bhqd,bhkd->bhqk', qh.float(), kh.float()) * hd ** -0.5
    if mask is not None:
        s = torch.where(mask.to(torch.bool), s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0:
        if key is None:
            raise ValueError(
                'multi_head_attention with dropout_p > 0 needs key= (a '
                'torch.Generator); pass one or apply dropout outside')
        keep = torch.rand(p.shape, generator=key, device=p.device) \
            < 1.0 - dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    out = torch.einsum('bhqk,bhkd->bqhd', p, vh.float()).to(q.dtype)
    return out.reshape(b, sq, e)


@register('calibrate_entropy', differentiable=False)
def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-optimal int8 threshold from a histogram (reference
    quantization/calibrate.cc ``_contrib_calibrate_entropy``); returns
    ``(threshold, divergence)`` as fp32 0-dim tensors, the divergence 0
    as in the reference."""
    from ..quantization import _HistogramCollector
    c = _HistogramCollector.__new__(_HistogramCollector)
    c.hist = _np.asarray(hist.cpu() if torch.is_tensor(hist) else hist)
    c.edges = _np.asarray(hist_edges.cpu() if torch.is_tensor(hist_edges)
                          else hist_edges)
    c.num_bins = int(c.hist.shape[0])
    c.min = float(c.edges[0])
    c.max = float(c.edges[-1])
    _, hi = c.entropy(num_quantized_bins=int(num_quantized_bins))
    return (torch.tensor(hi, dtype=torch.float32),
            torch.tensor(0.0, dtype=torch.float32))


@register('group_adagrad_update')
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """AdaGrad over each row's mean squared gradient (reference
    src/operator/contrib/optimizer_op.cc ``_contrib_group_adagrad_update``):
    ``history`` holds one value a row (``(rows, 1, ...)``); returns
    ``(weight, history)``."""
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if g.dim() > 1:
        hist = history + torch.mean(g * g, dim=tuple(range(1, g.dim())),
                                    keepdim=True)
    else:
        hist = history + g * g
    return weight - lr * g / (torch.sqrt(hist) + epsilon), hist
