"""Legacy-name ops: the ``broadcast_*``/``elemwise_*`` names, ``slice``,
``broadcast_axis``, ``cast_storage``, ``sparse_retain``, the triangle
packers, ``sample_generalized_negative_binomial`` and
``deformable_convolution``.

Counterpart of ``mxnet_tpu/ops/legacy_ops.py`` (reference
src/operator/tensor/elemwise_binary_broadcast_op_basic.cc, matrix_op.cc,
cast_storage.cc, la_op.cc, contrib/deformable_convolution.cc), in plain
PyTorch as the reference is in XLA. The legacy ``softsign`` and
``square_sum`` sit in :mod:`.elemwise` and :mod:`.reduce`, with their
families. The AMP casts are in :mod:`.elemwise`; the image ops wait under
ROADMAP A11.
"""

import math

import torch

from .. import _dtypes
from .elemwise import _named
from .random_ops import standard_gamma
from .registry import register


class _ZeroGrad(torch.autograd.Function):
    """A comparison's 0/1 values in the operands' dtype, recorded with
    the zero gradient the reference's float comparisons have."""

    @staticmethod
    def forward(ctx, out, a, b):
        ctx.save_for_backward(a, b)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return None, torch.zeros_like(a), torch.zeros_like(b)


def _pair(fn, compare=False):
    def op(lhs, rhs):
        dt = _dtypes.result_type(lhs, rhs)
        dev = lhs.device if torch.is_tensor(lhs) else rhs.device
        a, b = (_dtypes.tensor_of(v, dt, dev) for v in (lhs, rhs))
        if not compare:
            return fn(a, b)
        out = fn(a, b).to(a.dtype)
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _ZeroGrad.apply(out, a, b)
        return out
    return op


def _nonzero2(fn):
    return lambda a, b: fn(a != 0, b != 0)


_LEGACY_BINARY = {
    'broadcast_add': (torch.add, False), 'broadcast_sub': (torch.sub, False),
    'broadcast_mul': (torch.mul, False),
    'broadcast_div': (torch.true_divide, False),
    'broadcast_mod': (torch.remainder, False),
    'broadcast_power': (torch.pow, False),
    'broadcast_maximum': (torch.maximum, False),
    'broadcast_minimum': (torch.minimum, False),
    'broadcast_hypot': (lambda a, b: torch.hypot(
        a if a.is_floating_point() else a.float(),
        b if b.is_floating_point() else b.float()), False),
    'broadcast_equal': (torch.eq, True),
    'broadcast_not_equal': (torch.ne, True),
    'broadcast_greater': (torch.gt, True),
    'broadcast_greater_equal': (torch.ge, True),
    'broadcast_lesser': (torch.lt, True),
    'broadcast_lesser_equal': (torch.le, True),
    'broadcast_logical_and': (_nonzero2(torch.logical_and), True),
    'broadcast_logical_or': (_nonzero2(torch.logical_or), True),
    'broadcast_logical_xor': (_nonzero2(torch.logical_xor), True),
    'elemwise_add': (torch.add, False), 'elemwise_sub': (torch.sub, False),
    'elemwise_mul': (torch.mul, False),
    'elemwise_div': (torch.true_divide, False),
}


for _name, (_fn, _back) in _LEGACY_BINARY.items():
    register(_name, namespaces=('nd',))(_named(_pair(_fn, _back), _name))


@register('slice')
def slice_legacy(data, begin, end, step=None, axes=None):
    """Reference matrix_op.cc ``slice``: begin/end/step tuples with None
    wildcards; with ``axes`` the triplets apply to the named axes (the ONNX
    Slice form)."""
    nd = data.dim()
    if axes is not None:
        idx = [slice(None)] * nd
        step = step if step is not None else (None,) * len(axes)
        for ax, b, e, s in zip(axes, begin, end, step):
            idx[ax] = slice(b, e, s)
    else:
        begin = tuple(begin) + (None,) * (nd - len(begin))
        end = tuple(end) + (None,) * (nd - len(end))
        step = tuple(step) + (None,) * (nd - len(step)) if step \
            else (None,) * nd
        idx = [slice(b, e, s) for b, e, s in zip(begin, end, step)]
    out = data
    for ax, sl in enumerate(idx):
        start, stop, st = sl.indices(data.shape[ax])
        if st < 0:      # torch slices step forward only
            pos = torch.arange(start, stop, st, device=data.device)
            out = out.index_select(ax, pos)
        elif (start, stop, st) != (0, data.shape[ax], 1):
            out = out[(slice(None),) * ax + (slice(start, stop, st),)]
    return out


@register('broadcast_axis', aliases=('broadcast_axes',))
def broadcast_axis(data, axis=(), size=()):
    """Broadcast size-1 axes to ``size`` (reference matrix_op.cc
    broadcast_axis)."""
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return torch.broadcast_to(data, tuple(shape))


@register('cast_storage')
def cast_storage(data, stype='default'):
    """The storage cast as an op on dense values: the identity, as in the
    reference; ``ndarray.sparse.cast_storage`` makes the sparse arrays."""
    return data


@register('sparse_retain', differentiable=False)
def sparse_retain(data, indices):
    """Keep the rows ``indices``, zero the rest (the dense form of
    reference sparse_retain.cc)."""
    mask = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    mask[indices.long()] = True
    return torch.where(mask.reshape((-1,) + (1,) * (data.dim() - 1)),
                       data, torch.zeros((), dtype=data.dtype,
                                         device=data.device))


def _tri_indices(n, offset, lower, device):
    if lower:
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


@register('extracttrian', aliases=('linalg_extracttrian',))
def extracttrian(A, offset=0, lower=True):
    """The triangle as a packed vector (reference la_op.cc
    _linalg_extracttrian)."""
    r, c = _tri_indices(A.shape[-1], offset, lower, A.device)
    return A[..., r, c]


@register('maketrian', aliases=('linalg_maketrian',))
def maketrian(v, offset=0, lower=True):
    """A packed vector back to its triangular matrix (reference
    _linalg_maketrian)."""
    m = v.shape[-1]
    n = int((math.sqrt(8 * m + 1) - 1) / 2) + abs(offset)
    r, c = _tri_indices(n, offset, lower, v.device)
    out = torch.zeros(v.shape[:-1] + (n, n), dtype=v.dtype, device=v.device)
    out[..., r, c] = v
    return out


@register('sample_generalized_negative_binomial', stochastic=True,
          differentiable=False)
def sample_generalized_negative_binomial(mu, alpha, shape=None, key=None):
    """Gamma-Poisson mixture with mean ``mu`` and dispersion ``alpha``
    (reference random/sample_op.cc), over the device's generator."""
    dev = key.device
    mu = _dtypes.tensor_of(mu, torch.float32, dev)
    alpha = _dtypes.tensor_of(alpha, torch.float32, dev)
    sz = tuple(shape) if shape is not None else tuple(
        torch.broadcast_shapes(mu.shape, alpha.shape))
    k = torch.broadcast_to(1.0 / torch.clamp(alpha, min=1e-12), sz)
    lam = standard_gamma(k, key) * mu * alpha
    return torch.poisson(lam, generator=key)


@register('deformable_convolution')
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_filter=0, num_deformable_group=1,
                           no_bias=False):
    """Deformable convolution v1 (reference
    contrib/deformable_convolution.cc): each tap sampled bilinearly at its
    offset position, then one product with the weights. A sample outside
    the padded input reads zero; a corner past the edge of a sample
    inside it reads the edge pixel, as the JAX package's op does."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    N, C, H, W = data.shape
    OH = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = torch.nn.functional.pad(data, (pw, pw, ph, ph))
    Hp, Wp = H + 2 * ph, W + 2 * pw
    G = num_deformable_group
    Cg = C // G
    dev, dt = data.device, data.dtype
    # the undeformed tap positions, (kh*kw, OH, OW)
    ty = (torch.arange(OH, device=dev) * sh)[None, :, None] + (
        torch.arange(kh, device=dev) * dh).repeat_interleave(kw)[:, None,
                                                                 None]
    tx = (torch.arange(OW, device=dev) * sw)[None, None, :] + (
        torch.arange(kw, device=dev) * dw).repeat(kh)[:, None, None]
    off = offset.reshape(N, G, kh * kw, 2, OH, OW)
    oy = ty.to(dt) + off[:, :, :, 0]        # (N, G, K, OH, OW)
    ox = tx.to(dt) + off[:, :, :, 1]
    y0, x0 = torch.floor(oy), torch.floor(ox)
    wy, wx = oy - y0, ox - x0
    xg = x.reshape(N, G, Cg, Hp * Wp)

    def gather(yy, xx):
        yy = yy.long().clamp(0, Hp - 1)
        xx = xx.long().clamp(0, Wp - 1)
        flat = (yy * Wp + xx).reshape(N, G, 1, -1).expand(N, G, Cg, -1)
        return torch.gather(xg, 3, flat).reshape(N, G, Cg, kh * kw, OH, OW)

    def w(t):
        return t[:, :, None]

    cols = (gather(y0, x0) * w((1 - wy) * (1 - wx))
            + gather(y0, x0 + 1) * w((1 - wy) * wx)
            + gather(y0 + 1, x0) * w(wy * (1 - wx))
            + gather(y0 + 1, x0 + 1) * w(wy * wx))
    inside = (oy > -1) & (oy < Hp) & (ox > -1) & (ox < Wp)
    cols = cols * w(inside.to(dt))
    F_ = weight.shape[0]
    out = torch.einsum('nckhw,fck->nfhw', cols.reshape(N, C, kh * kw, OH,
                                                        OW),
                       weight.reshape(F_, C, kh * kw))
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out
