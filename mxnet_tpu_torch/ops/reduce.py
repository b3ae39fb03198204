"""Reductions, sorting and ordering ops.

Counterpart of ``mxnet_tpu/ops/reduce.py`` (reference
src/operator/tensor/broadcast_reduce_op*, ordering_op). The results take
the JAX package's dtypes: an integer sum, product or cumulative sum stays
int32 where torch gives int64 (the registry narrows it), a mean of
integers is float32 where torch raises, and index results are int32.
"""

import torch

from .. import _dtypes
from .registry import register


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (tuple, list)):
        return tuple(a % max(x.dim(), 1) for a in axis)
    return (axis % max(x.dim(), 1),)


def _float_in(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _reduce(fn, x, axis, keepdims, **kw):
    dims = _dims(x, axis)
    if x.dim() == 0:
        return fn(x, dim=(), keepdim=keepdims, **kw) if dims else x
    return fn(x, dim=dims, keepdim=keepdims, **kw)


@register('sum')
def sum_(x, axis=None, dtype=None, keepdims=False, initial=None, where=None):
    out = _reduce(torch.sum, x, axis, keepdims,
                  dtype=_dtypes.to_torch(dtype, narrow=False))
    return out if initial is None else out + initial


@register('square_sum')
def square_sum(data, axis=None, keepdims=False):
    """x^2 summed (reference tensor/square_sum.cc, registered in
    ``mxnet_tpu/ops/legacy_ops.py``; a reduction, so it sits here)."""
    return _reduce(torch.sum, data * data, axis, keepdims)


@register('mean')
def mean(x, axis=None, dtype=None, keepdims=False):
    out = _reduce(torch.mean, _float_in(x), axis, keepdims)
    return out if dtype is None else out.to(_dtypes.to_torch(dtype))


@register('prod')
def prod(x, axis=None, dtype=None, keepdims=False):
    dims = _dims(x, axis)
    out = x if dtype is None else x.to(_dtypes.to_torch(dtype))
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


def _amax(x, axis=None, keepdims=False):
    if x.dim() == 0:
        return x
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims)


def _amin(x, axis=None, keepdims=False):
    if x.dim() == 0:
        return x
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims)


def _nan_fill(x, value):
    return torch.where(torch.isnan(x), torch.full_like(x, value), x)


def nansum(x, axis=None, dtype=None, keepdims=False):
    return sum_(_nan_fill(x, 0) if x.is_floating_point() else x, axis,
                dtype, keepdims)


def nanprod(x, axis=None, dtype=None, keepdims=False):
    return prod(_nan_fill(x, 1) if x.is_floating_point() else x, axis,
                dtype, keepdims)


def nanmax(x, axis=None, keepdims=False):
    return _amax(_nan_fill(x, float('-inf')), axis, keepdims)


def nanmin(x, axis=None, keepdims=False):
    return _amin(_nan_fill(x, float('inf')), axis, keepdims)


def _quantile(x, q, axis, keepdims, method='linear'):
    """numpy's quantile over ``axis`` (None: the flattened array)."""
    xf = _float_in(x)
    qt = torch.as_tensor(q, dtype=xf.dtype, device=x.device)
    if axis is None:
        out = torch.quantile(xf.reshape(-1), qt, interpolation=method)
        if keepdims:
            out = out.reshape(out.shape + (1,) * x.dim())
        return out
    dims = _dims(x, axis)
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = xf.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = torch.quantile(moved, qt, dim=-1, interpolation=method)
    if keepdims:
        shape = list(x.shape)
        for d in dims:
            shape[d] = 1
        out = out.reshape(out.shape[:qt.dim()] + tuple(shape))
    return out


def median(x, axis=None, keepdims=False):
    return _quantile(x, 0.5, axis, keepdims)


def nanmean(x, axis=None, dtype=None, keepdims=False):
    out = _reduce(torch.nanmean, _float_in(x), axis, keepdims)
    return out if dtype is None else out.to(_dtypes.to_torch(dtype))


def ptp(x, axis=None, keepdims=False):
    return _amax(x, axis, keepdims) - _amin(x, axis, keepdims)


for _nm, _f in [('max', _amax), ('min', _amin), ('amax', _amax),
                ('amin', _amin), ('nansum', nansum), ('nanprod', nanprod),
                ('nanmax', nanmax), ('nanmin', nanmin), ('median', median),
                ('nanmean', nanmean), ('ptp', ptp)]:
    register(_nm)(_f)


def _arg(fn):
    def op(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x.reshape(-1), dim=0)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return fn(x, dim=axis, keepdim=keepdims)
    return op


def nanargmax(x, axis=None, keepdims=False):
    return _arg(torch.argmax)(_nan_fill(x, float('-inf')), axis, keepdims)


def nanargmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin)(_nan_fill(x, float('inf')), axis, keepdims)


def count_nonzero(x, axis=None, keepdims=False):
    return _reduce(torch.sum, x != 0, axis, keepdims)


for _nm, _f in [('argmax', _arg(torch.argmax)),
                ('argmin', _arg(torch.argmin)), ('nanargmax', nanargmax),
                ('nanargmin', nanargmin), ('count_nonzero', count_nonzero)]:
    register(_nm, differentiable=False)(_f)


@register('std')
def std(x, axis=None, ddof=0, keepdims=False):
    return _reduce(torch.std, _float_in(x), axis, keepdims, correction=ddof)


@register('var')
def var(x, axis=None, ddof=0, keepdims=False):
    return _reduce(torch.var, _float_in(x), axis, keepdims, correction=ddof)


@register('average')
def average(x, axis=None, weights=None, returned=False):
    if weights is None:
        avg = mean(x, axis)
        wsum = torch.full_like(avg, x.numel() / max(avg.numel(), 1))
    else:
        w = weights
        if w.dim() == 1 and x.dim() > 1 and axis is not None:
            shape = [1] * x.dim()
            shape[axis] = -1
            w = w.reshape(shape)
        wsum = sum_(torch.broadcast_to(w, x.shape).to(_float_in(x).dtype),
                    axis)
        avg = sum_(x * w, axis) / wsum
    return (avg, wsum) if returned else avg


def _cum(fn):
    def op(x, axis=None, dtype=None):
        if axis is None:
            x, axis = x.reshape(-1), 0
        return fn(x, dim=axis, dtype=_dtypes.to_torch(dtype, narrow=False))
    return op


register('cumsum')(_cum(torch.cumsum))
register('cumprod')(_cum(torch.cumprod))


def _bool_reduce(fn):
    def op(x, axis=None, keepdims=False):
        out = x.to(torch.bool)
        for d in sorted(_dims(x, axis), reverse=True):
            out = fn(out, dim=d, keepdim=keepdims)
        return out
    return op


register('all', differentiable=False)(_bool_reduce(torch.all))
register('any', differentiable=False)(_bool_reduce(torch.any))


@register('norm')
def norm(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(_float_in(x), ord=ord, dim=axis,
                             keepdim=keepdims)


@register('sort')
def sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register('argsort', differentiable=False)
def argsort(x, axis=-1, is_ascend=True, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    idx = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx if dtype is None else idx.to(_dtypes.to_torch(dtype))


@register('topk', differentiable=False)
def topk(x, axis=-1, k=1, ret_typ='indices', is_ascend=False,
         dtype='float32'):
    """Reference: src/operator/tensor/ordering_op.cc topk."""
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    if ret_typ == 'indices':
        return idx.to(_dtypes.to_torch(dtype))
    if ret_typ == 'value':
        return vals
    if ret_typ == 'both':
        return vals, idx.to(_dtypes.to_torch(dtype))
    raise ValueError(f'unknown ret_typ {ret_typ}')


@register('unique', differentiable=False,
          dynamic_shape=lambda args, kw: kw.get('size') is None)
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, size=None):
    """numpy's unique of the flattened array (``axis`` None), the first
    index of each value included."""
    if axis is not None:
        raise NotImplementedError('unique over an axis is not ported yet')
    flat = x.reshape(-1)
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    outs = [vals]
    if return_index:
        pos = torch.arange(flat.numel(), device=x.device)
        first = torch.full((vals.numel(),), flat.numel(), dtype=pos.dtype,
                           device=x.device)
        outs.append(first.scatter_reduce(0, inv, pos, 'amin'))
    if return_inverse:
        outs.append(inv)
    if return_counts:
        outs.append(counts)
    if size is not None:
        outs = [o[:size] if o.numel() >= size else torch.cat(
            [o, o[-1:].expand(size - o.numel())]) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


@register('histogram', differentiable=False)
def histogram(x, bins=10, range=None):
    xf = _float_in(x)
    lo, hi = (xf.min(), xf.max()) if range is None else \
        (torch.as_tensor(range[0]), torch.as_tensor(range[1]))
    lo, hi = float(lo), float(hi)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, int(bins) + 1, device=x.device,
                           dtype=xf.dtype)
    counts = torch.histc(xf, bins=int(bins), min=lo, max=hi)
    return counts.to(xf.dtype), edges


@register('bincount', differentiable=False)
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x.reshape(-1).long(), weights=weights,
                          minlength=int(minlength))


_METHODS = {'linear', 'lower', 'higher', 'nearest', 'midpoint'}


@register('percentile')
def percentile(x, q, axis=None, keepdims=False, interpolation='linear'):
    q = q / 100.0 if not torch.is_tensor(q) else q.float() / 100.0
    return _quantile(x, q, axis, keepdims, interpolation)


@register('quantile')
def quantile(x, q, axis=None, keepdims=False, interpolation='linear'):
    return _quantile(x, q, axis, keepdims, interpolation)


@register('argmax_channel', differentiable=False)
def argmax_channel(data):
    """argmax over axis 1 in the data's dtype (legacy classifier
    helper)."""
    return torch.argmax(data, dim=1).to(data.dtype)
