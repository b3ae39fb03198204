"""NumPy-parity tail ops: the array-api aliases and the ``_npi_*`` long
tail.

Counterpart of ``mxnet_tpu/ops/numpy_extras.py``. Each op is PyTorch on
the arrays' device, as the reference's are one ``jnp`` call each; binary
ops promote to JAX's result type first. ``partition``/``argpartition``
return a full (stable) sort, which meets the partition contract; the
elements on either side of ``kth`` are in no promised order in the
reference either. ``compress`` without ``size`` has a data-dependent
shape (``dynamic_shape``).
"""

import torch

from .. import _dtypes
from ..context import resolve_device
from .elemwise import _binary, _float2, _named
from .registry import register


_ALIAS_1IN = {
    'acos': torch.acos, 'asin': torch.asin, 'atan': torch.atan,
    'acosh': torch.acosh, 'asinh': torch.asinh, 'atanh': torch.atanh,
    'bitwise_invert': torch.bitwise_not,
    'matrix_transpose': lambda x: x.transpose(-1, -2),
}
_ALIAS_2IN = {
    'atan2': _float2(torch.atan2), 'logaddexp2': _float2(torch.logaddexp2),
    'pow': torch.pow, 'bitwise_left_shift': torch.bitwise_left_shift,
    'bitwise_right_shift': torch.bitwise_right_shift,
}
for _n, _f in _ALIAS_1IN.items():
    register(_n)(_named(_f, _n))
for _n, _f in _ALIAS_2IN.items():
    register(_n)(_named(_binary(_f), _n))


def _flat_or(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


@register('nancumsum')
def nancumsum(x, axis=None, dtype=None):
    x, axis = _flat_or(x, axis)
    return torch.cumsum(torch.where(torch.isnan(x), 0, x), dim=axis)


@register('nancumprod')
def nancumprod(x, axis=None, dtype=None):
    x, axis = _flat_or(x, axis)
    return torch.cumprod(torch.where(torch.isnan(x), 1, x), dim=axis)


@register('modf')
def modf(x):
    x = x if x.is_floating_point() else x.float()
    whole = torch.trunc(x)
    return x - whole, whole


@register('frexp')
def frexp(x):
    m, e = torch.frexp(x if x.is_floating_point() else x.float())
    return m, e.to(torch.int32)


@register('vecdot')
def vecdot(a, b, axis=-1):
    dt = _dtypes.result_type(a, b)
    a, b = a.to(dt), b.to(dt)
    return (a.conj() * b).sum(dim=axis)


@register('divmod')
def divmod_(a, b):
    dt = _dtypes.result_type(a, b)
    dev = a.device if torch.is_tensor(a) else b.device
    a, b = (_dtypes.tensor_of(v, dt, dev) for v in (a, b))
    return torch.div(a, b, rounding_mode='floor'), torch.remainder(a, b)


@register('permute_dims')
def permute_dims(x, axes=None):
    if axes is None:
        axes = tuple(range(x.dim()))[::-1]
    return x.permute(*axes)


@register('gradient')
def gradient(f, *varargs, axis=None):
    """``np.gradient``, spacing varargs included; one array for one axis,
    a tuple for several."""
    f = f if f.is_floating_point() else f.float()
    dims = tuple(range(f.dim())) if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    spacing = list(varargs) if varargs else 1.0
    if isinstance(spacing, list) and len(spacing) == 1 and len(dims) > 1:
        spacing = spacing * len(dims)
    out = torch.gradient(f, spacing=spacing, dim=dims)
    return out[0] if len(out) == 1 else tuple(out)


@register('digitize', differentiable=False)
def digitize(x, bins, right=False):
    """``np.digitize``: for ascending bins, ``i`` with ``bins[i-1] <= x <
    bins[i]`` (``right``: ``bins[i-1] < x <= bins[i]``); descending bins
    count from the other end."""
    bins = bins.to(x.dtype) if x.is_floating_point() else bins
    if bins.numel() > 1 and bool(bins[0] > bins[-1]):
        flipped = torch.flip(bins, [0])
        return bins.numel() - torch.bucketize(x, flipped, right=right)
    return torch.bucketize(x, bins, right=not right)


@register('isin', differentiable=False)
def isin(element, test_elements, invert=False):
    return torch.isin(element, test_elements, invert=invert)


def _moved(a, axis):
    """``a`` with the ``axis`` dims flattened into one last dim (all of
    them for None), and the shape kept dims reduce to."""
    if axis is None:
        return a.reshape(-1), -1, [1] * a.dim()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(x % a.dim() for x in axes)
    rest = [d for d in range(a.dim()) if d not in axes]
    moved = a.permute(*rest, *axes).reshape(
        [a.shape[d] for d in rest] + [-1])
    keep = [1 if d in axes else a.shape[d] for d in range(a.dim())]
    return moved, -1, keep


def _nanquantile(a, q, axis, keepdims):
    a = a if a.is_floating_point() else a.float()
    moved, dim, keep = _moved(a, axis)
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    out = torch.nanquantile(moved, qt, dim=dim)
    if keepdims:
        out = out.reshape(tuple(qt.shape) + tuple(keep))
    return out


@register('nanmedian')
def nanmedian(a, axis=None, keepdims=False):
    return _nanquantile(a, 0.5, axis, keepdims)


@register('nanpercentile')
def nanpercentile(a, q, axis=None, keepdims=False):
    q = q / 100.0 if torch.is_tensor(q) else torch.as_tensor(q) / 100.0
    return _nanquantile(a, q, axis, keepdims)


@register('nanquantile')
def nanquantile(a, q, axis=None, keepdims=False):
    return _nanquantile(a, q, axis, keepdims)


def _nanvar(a, axis, ddof, keepdims):
    a = a if a.is_floating_point() else a.float()
    dims = None if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    ok = ~torch.isnan(a)
    n = ok.sum(dim=dims, keepdim=True).to(a.dtype)
    z = torch.where(ok, a, 0)
    mean = z.sum(dim=dims, keepdim=True) / n
    dev = torch.where(ok, a - mean, 0)
    var = (dev * dev).sum(dim=dims, keepdim=True) / torch.clamp(
        n - ddof, min=0)
    if not keepdims:
        var = var.squeeze(dims) if dims is not None else var.reshape(())
    return var


@register('nanstd')
def nanstd(a, axis=None, ddof=0, keepdims=False):
    return torch.sqrt(_nanvar(a, axis, ddof, keepdims))


@register('nanvar')
def nanvar(a, axis=None, ddof=0, keepdims=False):
    return _nanvar(a, axis, ddof, keepdims)


@register('trapezoid')
def trapezoid(y, x=None, dx=1.0, axis=-1):
    y = y if y.is_floating_point() else y.float()
    if x is not None:
        return torch.trapezoid(y, x.to(y.dtype), dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


@register('partition', differentiable=False)
def partition(a, kth, axis=-1):
    return torch.sort(a, dim=axis, stable=True).values


@register('argpartition', differentiable=False)
def argpartition(a, kth, axis=-1):
    return torch.sort(a, dim=axis, stable=True).indices


@register('put_along_axis')
def put_along_axis(arr, indices, values, axis):
    """The array with ``values`` written at ``indices`` along ``axis``
    (``jnp.put_along_axis(..., inplace=False)``: a new array)."""
    if axis is None:
        shape, arr, indices = arr.shape, arr.reshape(-1), indices.reshape(-1)
        axis = 0
    else:
        shape = None
    idx = indices.long()
    idx = torch.where(idx < 0, idx + arr.shape[axis], idx)
    vals = _dtypes.tensor_of(values, arr.dtype, arr.device) \
        if not torch.is_tensor(values) else values.to(arr.dtype)
    out = arr.scatter(axis, idx, torch.broadcast_to(vals, idx.shape))
    return out if shape is None else out.reshape(shape)


@register('select')
def select(condlist, choicelist, default=0):
    """The value of the first true condition's choice, else ``default``."""
    dt = _dtypes.result_type(*choicelist, default)
    dev = choicelist[0].device
    out = _dtypes.tensor_of(default, dt, dev)
    for c, v in zip(reversed(list(condlist)), reversed(list(choicelist))):
        out = torch.where(c.bool(), v.to(dt), out)
    return out


@register('choose')
def choose(a, choices, mode='clip'):
    choices = list(choices)
    dt = _dtypes.result_type(*choices)
    shape = torch.broadcast_shapes(a.shape, *[c.shape for c in choices])
    stacked = torch.stack([torch.broadcast_to(c.to(dt), shape)
                           for c in choices])
    idx = torch.broadcast_to(a.long(), shape)
    n = len(choices)
    idx = idx.clamp(0, n - 1) if mode == 'clip' else torch.remainder(idx, n)
    return torch.gather(stacked, 0, idx[None]).squeeze(0)


@register('lexsort', differentiable=False)
def lexsort(keys, axis=-1):
    """Indices sorting by the last key, ties broken by the ones before
    (stable sorts, first key first)."""
    keys = list(keys)
    idx = torch.broadcast_to(
        torch.arange(keys[0].shape[axis], device=keys[0].device).reshape(
            [-1 if d == axis % keys[0].dim() else 1
             for d in range(keys[0].dim())]), keys[0].shape)
    for k in keys:
        order = torch.argsort(torch.take_along_dim(k, idx, dim=axis),
                              dim=axis, stable=True)
        idx = torch.take_along_dim(idx, order, dim=axis)
    return idx


def _edges(a, bins, range_):
    """``np.histogram_bin_edges`` for a count of bins, in ``a``'s float
    dtype: ``range_`` or ``a``'s min and max (widened by 0.5 each way
    where they are equal)."""
    a = a if a.is_floating_point() else a.float()
    if range_ is None:
        lo, hi = a.min(), a.max()
    else:
        lo = torch.as_tensor(range_[0], dtype=a.dtype, device=a.device)
        hi = torch.as_tensor(range_[1], dtype=a.dtype, device=a.device)
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    steps = torch.arange(bins + 1, dtype=a.dtype, device=a.device) / bins
    return lo + (hi - lo) * steps


@register('histogram_bin_edges', differentiable=False)
def histogram_bin_edges(a, bins=10, range=None):
    return _edges(a, bins, range)


@register('histogram2d', differentiable=False)
def histogram2d(x, y, bins=10, range=None, density=None):
    """``np.histogram2d`` for counts of bins: ``(H, xedges, yedges)``,
    each value's bin found on the edges as JAX's ``histogramdd`` finds it
    (the last bin closed on the right)."""
    nx, ny = (bins, bins) if isinstance(bins, int) else bins
    rx, ry = (None, None) if range is None else range
    ex, ey = _edges(x, nx, rx), _edges(y, ny, ry)

    def bin_of(v, e):
        i = torch.searchsorted(e, v.to(e.dtype).contiguous(), right=True)
        i = torch.where(v == e[-1], i - 1, i)
        return i - 1, (i >= 1) & (i <= e.shape[0] - 1)

    bx, okx = bin_of(x.reshape(-1), ex)
    by, oky = bin_of(y.reshape(-1), ey)
    ok = okx & oky
    flat = torch.where(ok, bx * ny + by, 0)
    h = torch.zeros(nx * ny, dtype=torch.int64, device=ex.device)
    h.index_add_(0, flat, ok.to(torch.int64))
    h = h.reshape(nx, ny)
    if density:
        h = h.to(ex.dtype)
        area = torch.diff(ex)[:, None] * torch.diff(ey)[None, :]
        h = h / (h.sum() * area)
    return h, ex, ey


@register('geomspace')
def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              ctx=None, device=None):
    """Numbers spaced evenly on a log scale, the end points exact (as
    ``jnp.geomspace`` sets them)."""
    dev = resolve_device(ctx if ctx is not None else device)
    s = torch.as_tensor(start, dtype=torch.float64, device=dev)
    e = torch.as_tensor(stop, dtype=torch.float64, device=dev)
    n = num if endpoint else num + 1
    t = torch.linspace(0, 1, n, dtype=torch.float64, device=dev)
    if not endpoint:
        t = t[:-1]
    shape = [-1] + [1] * s.dim()
    sign = torch.sign(s)
    ls, le = torch.log10(s * sign), torch.log10(e * sign)
    out = sign * torch.pow(10.0, ls + (le - ls) * t.reshape(shape))
    if num:
        out[0] = s
        if endpoint and num > 1:
            out[-1] = e
    out = torch.movedim(out, 0, axis)
    return out.to(_dtypes.to_torch(dtype) if dtype is not None
                  else torch.float32)


@register('compress', differentiable=False,
          dynamic_shape=lambda a, kw: kw.get(
              'size', a[3] if len(a) > 3 else None) is None)
def compress(condition, a, axis=None, size=None, fill_value=0):
    """The slices of ``a`` along ``axis`` where ``condition`` holds; with
    ``size`` padded with ``fill_value`` or cut to that many."""
    if axis is None:
        a, axis = a.reshape(-1), 0
    cond = condition.bool().reshape(-1)
    cond = cond[:a.shape[axis]]
    if cond.shape[0] < a.shape[axis]:
        cond = torch.cat([cond, cond.new_zeros(a.shape[axis] -
                                               cond.shape[0])])
    out = a.index_select(axis, torch.nonzero(cond).flatten())
    if size is None:
        return out
    have = out.shape[axis]
    if have >= size:
        return out.narrow(axis, 0, size)
    shape = list(out.shape)
    shape[axis] = size - have
    return torch.cat([out, torch.full(shape, fill_value, dtype=out.dtype,
                                      device=out.device)], dim=axis)

