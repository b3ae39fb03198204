"""Neural-network ops.

Counterpart of ``mxnet_tpu/ops/nn.py`` (reference src/operator/nn/):
fully-connected, embedding, convolution and its transpose, pooling,
activations, the softmax family, batch/layer/group/instance/RMS norms,
dropout, resizing and im2col. The products and convolutions are cuBLAS and
cuDNN through PyTorch, as the reference leaves them to XLA; the
convolutions run in fp32 on a card whatever cuDNN's TF32 flag says
(:class:`_Fp32Conv`), as the reference's fp32 ones do. A last-axis
``rms_norm`` or ``layer_norm`` with a 1-D gamma goes through the fused
norm kernel (:mod:`.kernels.fused_norms`); other axes use plain PyTorch,
as the reference uses XLA there. Where autograd records
(:func:`.kernels.needs_grad`), the norm goes through
:class:`.kernels.fused_norms.FusedNormFunction`, whose backward is the
reference's; otherwise it calls the kernel's wrapper directly, so that
inference pays nothing for the gradient.

Not ported yet (``ops/ledger.py``, ROADMAP A11): the fused ``rnn`` and
``ctc_loss``.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

from .. import _dtypes
from .kernels import needs_grad
from .kernels.fused_norms import FusedNormFunction, fused_layer_norm, \
    fused_rms_norm
from .manipulation import gather_index, fill_value
from .registry import register

__all__ = ['rms_norm', 'layer_norm', 'silu']


def _bcast(v, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


# --------------------------------------------------------------------- linear
@register('fully_connected', aliases=('FullyConnected',))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """``data @ weight.T (+ bias)``; weight ``(num_hidden, input_dim)``."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


@register('embedding', aliases=('Embedding',))
def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    """Rows of ``weight`` at ``data``: a negative index wraps once and an
    index still out of range gives a row of NaN, as the reference's
    ``jnp.take`` fills it."""
    return _rows(data, weight)


def sparse_grad_embedding(data, weight):
    """:func:`embedding` whose backward gives ``weight`` torch's sparse COO
    gradient, one entry a token occurrence, and writes nothing
    table-shaped (the reference's ``_sparse_grad_embedding``,
    ``mxnet_tpu/gluon/nn/basic_layers.py:352``); ``Embedding(sparse_grad=
    True)`` calls it while autograd records."""
    return _rows(data, weight, sparse=True)


def _rows(data, weight, sparse=False):
    idx, valid = gather_index(data, weight.shape[0], 'fill')
    out = F.embedding(idx, weight, sparse=sparse)
    return torch.where(valid[..., None], out,
                       torch.full_like(out, fill_value(out.dtype)))


# --------------------------------------------------------------- convolutions
def _tuplize(v, n):
    if v is None:
        return None
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _to_nc(x, layout, ndim):
    """``x`` in channels-first order, and the permutation back."""
    if layout is None or layout.startswith('NC'):
        return x, None
    perm = [0, ndim + 1] + list(range(1, ndim + 1))
    back = [0] + list(range(2, ndim + 2)) + [1]
    return x.permute(perm), back


@contextlib.contextmanager
def _fp32_cudnn():
    """cuDNN in full fp32 for the span, whatever the process-wide flag
    says: PyTorch lets cuDNN's convolutions run in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), where the reference's
    fp32 convolutions are fp32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Fp32Conv(torch.autograd.Function):
    """``aten.convolution`` on a card with its forward and its backward
    under :func:`_fp32_cudnn`: autograd runs the backward later, after the
    forward's span has ended, so the flag must be set there again."""

    @staticmethod
    def forward(ctx, x, w, b, args):
        ctx.save_for_backward(x, w)
        ctx.args, ctx.has_bias = args, b is not None
        with _fp32_cudnn():
            return torch.ops.aten.convolution(x, w, b, *args)

    @staticmethod
    def backward(ctx, go):
        x, w = ctx.saved_tensors
        stride, padding, dilation, transposed, out_pad, groups = ctx.args
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        out_c = w.shape[1] * groups if transposed else w.shape[0]
        with _fp32_cudnn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                go, x, w, [out_c] if ctx.has_bias else None, stride,
                padding, dilation, transposed, out_pad, groups, mask)
        return gx, gw, gb, None


def _conv(data, weight, bias, layout, stride, pad, dilate, groups,
          transposed=False, adj=None):
    ndim = data.dim() - 2
    x, back = _to_nc(data, layout, ndim)
    args = (list(_tuplize(stride, ndim) or (1,) * ndim),
            list(_tuplize(pad, ndim) or (0,) * ndim),
            list(_tuplize(dilate, ndim) or (1,) * ndim), transposed,
            list(_tuplize(adj, ndim) or (0,) * ndim), groups)
    if x.is_cuda and x.dtype == torch.float32:
        # TF32 off for fp32 only: a bf16 convolution runs cuDNN in bf16
        out = _Fp32Conv.apply(x, weight, bias, args)
    else:
        out = torch.ops.aten.convolution(x, weight, bias, *args)
    return out if back is None else out.permute(back)


@register('convolution', aliases=('Convolution',))
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    """Grouped, dilated convolution; weights ``(O, I/groups, *k)``. On a
    card cuDNN runs it in fp32, TF32 off (:class:`_Fp32Conv`)."""
    return _conv(data, weight, None if no_bias else bias, layout, stride,
                 pad, dilate, num_group)


@register('deconvolution', aliases=('Deconvolution',))
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, layout=None,
                  target_shape=None):
    """Transposed convolution; weights ``(I, O/groups, *k)``; fp32 on a
    card as :func:`convolution`."""
    return _conv(data, weight, None if no_bias else bias, layout, stride,
                 pad, dilate, num_group, transposed=True, adj=adj)


# -------------------------------------------------------------------- pooling
_MAXP = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGP = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register('pooling', aliases=('Pooling',))
def pooling(data, kernel=None, pool_type='max', global_pool=False,
            stride=None, pad=None, pooling_convention='valid',
            count_include_pad=True, layout=None):
    """Max, average, sum or L2 pooling. The input is padded explicitly
    (``-inf`` for max, 0 otherwise; ``'full'`` adds what the last window
    needs at the high end), then pooled with no padding, so every window
    and divisor is the reference's ``reduce_window``'s."""
    ndim = data.dim() - 2
    x, back = _to_nc(data, layout, ndim)
    sp = tuple(range(2, ndim + 2))
    if global_pool:
        out = torch.amax(x, dim=sp, keepdim=True) if pool_type == 'max' \
            else torch.mean(x, dim=sp, keepdim=True)
        return out if back is None else out.permute(back)
    kernel = _tuplize(kernel, ndim)
    stride = _tuplize(stride, ndim) or (1,) * ndim
    pad = _tuplize(pad, ndim) or (0,) * ndim
    pw = []
    for i in reversed(range(ndim)):
        hi = pad[i]
        if pooling_convention == 'full':
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            if rem:
                hi += stride[i] - rem
        pw += [pad[i], hi]
    if pool_type == 'max':
        low = float('-inf') if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        out = _MAXP[ndim](F.pad(x, pw, value=low), kernel, stride)
    elif pool_type in ('avg', 'sum', 'lp'):
        src = x * x if pool_type == 'lp' else x
        area = math.prod(kernel)
        summed = _AVGP[ndim](F.pad(src, pw), kernel, stride) * area
        if pool_type == 'sum':
            out = summed
        elif pool_type == 'lp':
            out = torch.sqrt(summed)
        elif count_include_pad:
            out = summed / area
        else:
            counts = _AVGP[ndim](F.pad(torch.ones_like(x), pw), kernel,
                                 stride) * area
            out = summed / counts
    else:
        raise ValueError(f'unknown pool_type {pool_type}')
    return out if back is None else out.permute(back)


@register('adaptive_avg_pooling', aliases=('contrib_AdaptiveAvgPooling2D',))
def adaptive_avg_pooling(data, output_size=1):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    n, c, h, w = data.shape
    return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


# ---------------------------------------------------------------- activations
@register('activation', aliases=('Activation',))
def activation(data, act_type='relu'):
    if act_type == 'relu':
        return F.relu(data)
    if act_type == 'sigmoid':
        return torch.sigmoid(data)
    if act_type == 'tanh':
        return torch.tanh(data)
    if act_type == 'softrelu':
        return F.softplus(data)
    if act_type == 'softsign':
        return F.softsign(data)
    if act_type == 'log_sigmoid':
        return F.logsigmoid(data)
    if act_type == 'mish':
        return data * torch.tanh(F.softplus(data))
    raise ValueError(f'unknown act_type {act_type}')


@register('relu')
def relu(x):
    return F.relu(x)


@register('sigmoid')
def sigmoid(x):
    return torch.sigmoid(x)


@register('softplus')
def softplus(x):
    return F.softplus(x)


@register('silu', aliases=('swish',))
def silu(x):
    """``x * sigmoid(x)``. In fp32, one fused op. In a 16-bit type (the
    bf16 activations of a quantized net), the reference's ``jax.nn.silu``
    steps, ``x * (1 / (1 + exp(-x)))``, each rounded to that type as XLA
    rounds them: one rounding at the end gives other bf16 values."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


@register('gelu')
def gelu(x, approximate=True):
    return F.gelu(x, approximate='tanh' if approximate else 'none')


@register('hard_sigmoid')
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register('hard_swish')
def hard_swish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@register('leaky_relu', aliases=('LeakyReLU',))
def leaky_relu(data, gamma=None, act_type='leaky', slope=0.25,
               lower_bound=0.125, upper_bound=0.334, key=None):
    """leaky / prelu / elu / selu / gelu / rrelu (mean slope)."""
    if act_type == 'leaky':
        return torch.where(data >= 0, data, slope * data)
    if act_type == 'prelu':
        g = gamma
        if g.dim() < data.dim():
            g = _bcast(g, data.dim(), 1)
        return torch.where(data >= 0, data, g * data)
    if act_type == 'elu':
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == 'selu':
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data,
                                   alpha * torch.expm1(data))
    if act_type == 'gelu':
        return F.gelu(data)
    if act_type == 'rrelu':
        return torch.where(data >= 0, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError(f'unknown act_type {act_type}')


# ------------------------------------------------------------------- softmaxes
def _tempered(data, temperature):
    return data if temperature in (None, 1.0) else data / temperature


@register('softmax', aliases=('Softmax',))
def softmax(data, axis=-1, length=None, temperature=None, use_length=False,
            dtype=None):
    """Softmax over ``axis``, with optional length masking."""
    x = _tempered(data, temperature)
    if use_length and length is not None:
        steps = torch.arange(x.shape[axis], device=x.device)
        mask = _bcast(steps, x.dim(), axis) < torch.unsqueeze(length, axis)
        x = torch.where(mask, x, torch.full_like(x, float('-inf')))
        return torch.where(mask, torch.softmax(x, dim=axis),
                           torch.zeros_like(x))
    out = torch.softmax(x, dim=axis)
    return out.to(_dtypes.to_torch(dtype)) if dtype else out


@register('log_softmax')
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    out = torch.log_softmax(_tempered(data, temperature), dim=axis)
    return out.to(_dtypes.to_torch(dtype)) if dtype else out


def _masked(data, mask, temperature):
    keep = mask.to(torch.bool)
    x = torch.where(keep, data / temperature,
                    torch.full_like(data, torch.finfo(data.dtype).min))
    return x, keep


@register('masked_softmax')
def masked_softmax(data, mask=None, axis=-1, temperature=1.0,
                   normalize=True):
    if mask is None:
        return torch.softmax(data / temperature, dim=axis)
    x, keep = _masked(data, mask, temperature)
    return torch.where(keep, torch.softmax(x, dim=axis),
                       torch.zeros_like(x))


@register('masked_log_softmax')
def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0):
    if mask is None:
        return torch.log_softmax(data / temperature, dim=axis)
    x, _ = _masked(data, mask, temperature)
    return torch.log_softmax(x, dim=axis)


@register('softmax_cross_entropy')
def softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    oh = F.one_hot(label.long(), data.shape[-1]).to(data.dtype)
    return -torch.sum(oh * logp)


@register('softmin')
def softmin(data, axis=-1, length=None, temperature=None, use_length=False,
            dtype=None):
    return softmax(-data, axis=axis, length=length, temperature=temperature,
                   use_length=use_length, dtype=dtype)


# ------------------------------------------------------------- normalizations
@register('batch_norm_inference', aliases=('BatchNormInference',))
def batch_norm_inference(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
                         axis=1, fix_gamma=False, use_global_stats=True,
                         scale_shift=True):
    nd = x.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(_bcast(moving_var, nd, axis) + eps)
    return (x - _bcast(moving_mean, nd, axis)) * inv * _bcast(g, nd, axis) \
        + _bcast(beta, nd, axis)


@register('batch_norm_train')
def batch_norm_train(x, gamma, beta, eps=1e-5, axis=1, fix_gamma=False):
    """Training-mode batch norm: ``(out, batch_mean, batch_var)``; the
    layer updates its running statistics from the last two."""
    nd = x.dim()
    axis %= nd
    red = tuple(i for i in range(nd) if i != axis)
    mean = torch.mean(x, dim=red)
    var = torch.var(x, dim=red, unbiased=False)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(_bcast(var, nd, axis) + eps)
    out = (x - _bcast(mean, nd, axis)) * inv * _bcast(g, nd, axis) \
        + _bcast(beta, nd, axis)
    return out, mean, var


@register('layer_norm', aliases=('LayerNorm',))
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


@register('rms_norm')
def rms_norm(data, gamma, axis=-1, eps=1e-6):
    """RMSNorm over ``axis`` for the LLM stack."""
    if axis in (-1, data.dim() - 1) and gamma.dim() == 1:
        x, g = data.contiguous(), gamma.contiguous()
        if needs_grad(x, g):
            return FusedNormFunction.apply(x, g, None, eps, True)
        return fused_rms_norm(x, g, eps)
    ms = (data * data).mean(axis, keepdim=True)
    return data * torch.rsqrt(ms + eps) * _bcast(gamma, data.dim(), axis)


@register('group_norm', aliases=('GroupNorm',))
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    n, c = data.shape[0], data.shape[1]
    spatial = tuple(data.shape[2:])
    x = data.reshape(n, num_groups, c // num_groups, *spatial)
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = x.var(dim=red, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = [1, c] + [1] * len(spatial)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register('instance_norm', aliases=('InstanceNorm',))
def instance_norm(data, gamma, beta, eps=1e-5):
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = [1, -1] + [1] * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register('l2_normalization', aliases=('L2Normalization',))
def l2_normalization(data, eps=1e-10, mode='instance'):
    if mode == 'instance':
        red = tuple(range(1, data.dim()))
    elif mode == 'channel':
        red = (1,)
    elif mode == 'spatial':
        red = tuple(range(2, data.dim()))
    else:
        raise ValueError(mode)
    return data / torch.sqrt(torch.sum(data * data, dim=red, keepdim=True)
                             + eps)


@register('lrn', aliases=('LRN',))
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Cross-channel local response norm (NCHW)."""
    half = nsize // 2
    sq = F.pad(data * data, [0, 0] * (data.dim() - 2) + [half, half])
    ssum = sq.unfold(1, nsize, 1).sum(-1)
    return data / (knorm + alpha / nsize * ssum) ** beta


@register('moments')
def moments(data, axes=None, keepdims=False):
    dims = tuple(range(data.dim())) if axes is None else tuple(axes)
    return (data.mean(dim=dims, keepdim=keepdims),
            data.var(dim=dims, keepdim=keepdims, unbiased=False))


# -------------------------------------------------------------------- dropout
@register('dropout', aliases=('Dropout',), stochastic=True)
def dropout(data, p=0.5, mode='training', axes=(), key=None, training=True):
    """Zero each entry with probability ``p`` and scale the rest by
    ``1 / (1 - p)``; the mask is drawn from ``key``, the generator of the
    data's device."""
    if not training or p <= 0:
        return data
    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=key, device=data.device) < keep
    return torch.where(mask, data / keep, torch.zeros_like(data))


# -------------------------------------------------------- resize / upsampling
@register('upsampling', aliases=('UpSampling',))
def upsampling(data, scale=2, sample_type='nearest'):
    if sample_type == 'nearest':
        return torch.repeat_interleave(
            torch.repeat_interleave(data, scale, dim=2), scale, dim=3)
    return F.interpolate(data, scale_factor=scale, mode='bilinear',
                         align_corners=False)


@register('interp_resize', aliases=('contrib_BilinearResize2D',))
def interp_resize(data, height=None, width=None, scale_height=None,
                  scale_width=None, mode='bilinear', align_corners=False):
    n, c, h, w = data.shape
    oh = height or int(h * scale_height)
    ow = width or int(w * scale_width)
    return F.interpolate(data, size=(oh, ow),
                         mode='bilinear' if mode in ('bilinear', 'linear')
                         else mode, align_corners=False)


# ---------------------------------------------------------------- misc neural
@register('topk_accuracy_helper', differentiable=False)
def topk_accuracy_helper(pred, label, k=1):
    idx = torch.topk(pred, k, dim=-1).indices
    return torch.any(idx == label[..., None].to(idx.dtype), dim=-1)


# ------------------------------------------------------------- im2col/col2im
def _im2col_args(kernel, stride, dilate, pad):
    n = len(kernel)
    return dict(kernel_size=tuple(kernel),
                dilation=tuple(dilate) if dilate else (1,) * n,
                padding=tuple(pad) if pad else (0,) * n,
                stride=tuple(stride) if stride else (1,) * n)


@register('im2col')
def im2col(data, kernel=None, stride=None, dilate=None, pad=None):
    """``(N, C, H, W)`` -> ``(N, C * prod(kernel), positions)``, channel-
    major (two spatial axes)."""
    return F.unfold(data, **_im2col_args(kernel, stride, dilate, pad))


@register('col2im')
def col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
           pad=None):
    """The adjoint of :func:`im2col`: overlapping patches sum back."""
    return F.fold(data, tuple(output_size),
                  **_im2col_args(kernel, stride, dilate, pad))
