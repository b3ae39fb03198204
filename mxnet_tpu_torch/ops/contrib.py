"""Contrib ops of the port: the attention ops that the Llama path calls,
``flash_attention`` and ``paged_attention_decode``, and the calibration op
``calibrate_entropy``.

Counterpart of the same ops in ``mxnet_tpu/ops/contrib.py``. Each reshapes
its operands and calls the hand-written kernel's wrapper
(:mod:`.kernels.flash_attention`, :mod:`.kernels.paged_attention`), which
runs the plain PyTorch version for CPU tensors. Where autograd records,
``flash_attention`` goes through
:class:`.kernels.flash_attention.FlashAttentionFunction`, whose backward
is the reference's ``_flash3_bwd``. ``calibrate_entropy`` reuses the
calibration collector of :mod:`mxnet_tpu_torch.quantization`.
"""

import numpy as _np
import torch

from .kernels import needs_grad
from .kernels.flash_attention import FlashAttentionFunction, \
    flash_attention_fwd, flash_attention_plain
from .kernels.paged_attention import paged_attention_decode as _paged

__all__ = ['flash_attention', 'paged_attention_decode', 'calibrate_entropy']


def flash_attention(q, k, v, sm_scale=None, causal=False):
    """Blockwise fused attention. q ``(..., T, d)``; k/v ``(..., S, d)``
    with matching leading dims; ``sm_scale`` defaults to 1/sqrt(d);
    causal masking is bottom-right aligned. Returns ``(..., T, d)`` in
    q's dtype, softmax and accumulation in fp32."""
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


def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-optimal int8 threshold from a histogram (reference
    quantization/calibrate.cc ``_contrib_calibrate_entropy``); returns
    ``(threshold, divergence)`` as fp32 0-dim tensors, the divergence 0
    as in the reference."""
    from ..quantization import _HistogramCollector
    c = _HistogramCollector.__new__(_HistogramCollector)
    c.hist = _np.asarray(hist)
    c.edges = _np.asarray(hist_edges)
    c.num_bins = int(c.hist.shape[0])
    c.min = float(c.edges[0])
    c.max = float(c.edges[-1])
    _, hi = c.entropy(num_quantized_bins=int(num_quantized_bins))
    return (torch.tensor(hi, dtype=torch.float32),
            torch.tensor(0.0, dtype=torch.float32))
