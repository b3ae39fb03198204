"""Quantization ops of the port: ``range_to_scale``, ``quantize_v2``,
``dequantize``, ``requantize`` and ``quantized_dense``.

Counterpart of ``mxnet_tpu/ops/quantization_ops.py``. Symmetric int8, per
tensor for activations, per output channel for weights; see
:mod:`mxnet_tpu_torch.quantization` for calibration and the net rewrite.
``quantized_dense`` is the int8 product with the dequantize fused into its
epilogue, through the hand-written kernel (:mod:`.kernels.int8_matmul`).
``quantized_conv2d`` is an int8 convolution with the same epilogue, which
the reference leaves to XLA: here the int8 product over the input's
gathered windows, through the same kernel (``quantized_conv2d_plain``, one
float64 convolution, is what it must equal). The five ops are registered
(``mx.nd``), with no gradient.

Scales are fp32 and every division is by an fp32 tensor on the data's
device, never by a Python number: PyTorch on CUDA divides by a Python
number (or a CPU scalar) as a product with its reciprocal, which can be 1
ulp off the true quotient, and 1 ulp before ``round`` moves a code that sits
on a .5 boundary. ``torch.round`` rounds half to even, as ``jnp.round``.
"""

import torch
import torch.nn.functional as F

from .kernels.int8_matmul import int8_matmul
from .registry import register

__all__ = ['range_to_scale', 'quantize_v2', 'dequantize', 'requantize',
           'quantized_dense', 'quantized_conv2d', 'quantized_conv2d_plain']


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def range_to_scale(min_range, max_range, dtype='int8'):
    """max(|min|, |max|) / 127 (255 for uint8), 1 where the range is 0."""
    dev = max_range.device if torch.is_tensor(max_range) else None
    amax = torch.maximum(_f32(min_range, dev).abs(), _f32(max_range, dev).abs())
    qmax = _f32(127.0 if dtype == 'int8' else 255.0, amax.device)
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


@register('quantize_v2', differentiable=False, namespaces=('nd',))
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type='int8'):
    """float -> int8/uint8 with calibrated or data-derived ranges; returns
    ``(quantized, min_range, max_range)``. uint8 uses the unsigned [0, max]
    scheme of post-ReLU activations."""
    if min_calib_range is None or max_calib_range is None:
        min_r, max_r = data.min(), data.max()
    else:
        min_r = _f32(min_calib_range, data.device)
        max_r = _f32(max_calib_range, data.device)
    if out_type in ('int8', 'auto'):
        scale = range_to_scale(min_r, max_r)
        q = torch.clamp(torch.round(data / scale), -127, 127).to(torch.int8)
    elif out_type == 'uint8':
        scale = range_to_scale(min_r, max_r, 'uint8')
        q = torch.clamp(torch.round(data / scale), 0, 255).to(torch.uint8)
    else:
        raise ValueError(f'unsupported out_type {out_type!r}')
    return q, min_r, max_r


@register('dequantize', differentiable=False, namespaces=('nd',))
def dequantize(data, min_range, max_range, out_type='float32'):
    qtype = 'uint8' if data.dtype == torch.uint8 else 'int8'
    scale = range_to_scale(_f32(min_range, data.device),
                           _f32(max_range, data.device), qtype)
    return data.float() * scale


@register('requantize', differentiable=False, namespaces=('nd',))
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8 under the (possibly calibrated) range."""
    real = dequantize(data, min_range, max_range)
    return quantize_v2(real, min_calib_range, max_calib_range)


@register('quantized_dense', differentiable=False, namespaces=('nd',))
def quantized_dense(x_q, w_q, scale, bias=None, out_dtype='bfloat16'):
    """int8 x int8 -> int32 product with the dequantize in the epilogue:
    scale per output channel, add bias, cast to ``out_dtype``.

    x_q ``(..., K)`` int8; w_q ``(N, K)`` int8 (the Dense ``(out, in)``
    layout); scale ``(N,)`` fp32, the combined activation x weight scale;
    bias ``(N,)`` fp32 or None."""
    return int8_matmul(x_q.contiguous(), w_q, scale, bias, out_dtype)


def _pad16(k):
    return -(-k // 16) * 16


def _windows(x, kh, kw, strides, dilation, oh, ow, kpad):
    """The convolution's input windows of NHWC int8 ``x`` (padded) as the
    rows of an ``(N * OH * OW, kpad)`` int8 matrix, each row ``(C, kh,
    kw)`` in the order of an OIHW weight's flattened rows, zero beyond
    ``C * kh * kw``. A 1 x 1, stride-1 window of a contiguous ``x`` whose
    rows need no padding is ``x`` itself."""
    n, _, _, c = x.shape
    k, m = c * kh * kw, n * oh * ow
    (sh, sw), (dh, dw) = strides, dilation
    v = x.unfold(1, dh * (kh - 1) + 1, sh).unfold(2, dw * (kw - 1) + 1, sw)
    if dh > 1 or dw > 1:
        v = v[..., ::dh, ::dw]
    if k == kpad and kh == kw == 1 and v.is_contiguous():
        return v.reshape(m, k)
    rows = x.new_empty(m, kpad)
    if kpad > k:
        rows[:, k:].zero_()
    rows[:, :k].view(n, oh, ow, c, kh, kw).copy_(v)
    return rows


@register('quantized_conv2d', differentiable=False, namespaces=('nd',))
def quantized_conv2d(x_q, w_q, scale, bias=None, out_dtype='bfloat16',
                     strides=(1, 1), padding=(0, 0), dilation=(1, 1),
                     groups=1, layout='NCHW'):
    """int8 convolution with quantized_dense's epilogue: the int32
    accumulator times ``scale`` per output channel, plus ``bias``, cast to
    ``out_dtype``. w_q OIHW int8; scale/bias ``(O,)`` fp32.

    The reference leaves it to XLA's int8 convolution. Here it is the
    int8 product of :func:`quantized_dense` over the input's windows: the
    NHWC input, zero-padded, is gathered into rows of ``C * kh * kw``
    codes (zero-filled up to a multiple of 16, which the kernel's Hopper
    designs take; a 1 x 1 stride-1 convolution reads the input as it is),
    and each group is one launch of the int8 kernel against the weight's
    flattened rows. Integer sums are exact on either route, so the result
    equals the convolution of the codes bit for bit. An ``NCHW`` result is
    an NCHW view of the NHWC product (channels-last strides), which the
    elementwise ops after it keep."""
    nchw = layout == 'NCHW'
    x = x_q.permute(0, 2, 3, 1) if nchw else x_q
    x = x.contiguous()
    n, h, w, _ = x.shape
    o, cg, kh, kw = w_q.shape
    (sh, sw), (ph, pw), (dh, dw) = strides, padding, dilation
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    k = cg * kh * kw
    kpad = _pad16(k)
    wmat = w_q.reshape(o, k)
    if kpad > k:
        wmat = F.pad(wmat, (0, kpad - k))
    og = o // groups
    outs = []
    for g in range(groups):
        xg = x if groups == 1 else x[..., g * cg:(g + 1) * cg]
        rows = _windows(xg, kh, kw, (sh, sw), (dh, dw), oh, ow, kpad)
        sl = slice(g * og, (g + 1) * og)
        outs.append(quantized_dense(
            rows, wmat[sl].contiguous(), scale[sl].contiguous(),
            None if bias is None else bias[sl].contiguous(), out_dtype))
    out = (outs[0] if groups == 1 else torch.cat(outs, -1)) \
        .view(n, oh, ow, o)
    return out.permute(0, 3, 1, 2) if nchw else out


def quantized_conv2d_plain(x_q, w_q, scale, bias=None, out_dtype='bfloat16',
                           strides=(1, 1), padding=(0, 0), dilation=(1, 1),
                           groups=1, layout='NCHW'):
    """:func:`quantized_conv2d` as one convolution of the codes in float64,
    which holds every int8 sum exactly (|sum| <= 127**2 * C * kh * kw <
    2**53), then the same epilogue: what the gathered route must equal bit
    for bit."""
    x = x_q if layout == 'NCHW' else x_q.permute(0, 3, 1, 2)
    acc = F.conv2d(x.double(), w_q.double(), stride=tuple(strides),
                   padding=tuple(padding), dilation=tuple(dilation),
                   groups=groups)
    out = acc.float() * scale.reshape(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    out = out.to(getattr(torch, str(out_dtype)))
    return out if layout == 'NCHW' else out.permute(0, 2, 3, 1)
