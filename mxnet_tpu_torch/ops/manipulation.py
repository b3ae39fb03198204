"""Shape and layout manipulation and indexing ops.

Counterpart of ``mxnet_tpu/ops/manipulation.py`` (reference
src/operator/tensor/matrix_op*, indexing_op, init_op). Gathers follow
what the reference's XLA gathers do with an index out of range, and never
index out of range on the card (a device-side assert there would poison
the process's CUDA context): ``take`` clamps or wraps as its ``mode``
says; ``pick``, ``take_along_axis`` and ``embedding`` wrap negative
indices and fill what is still out of range (NaN for floats), as
``jnp.take_along_axis`` and ``jnp.take`` do; ``gather_nd`` and array
indexing wrap negative indices and clamp (:func:`gather_index`).
"""

import math

import torch

from .. import _dtypes
from .registry import register


def _ints(idx):
    return idx.long() if torch.is_tensor(idx) else torch.as_tensor(idx)


def gather_index(idx, n, mode):
    """``(index, valid)`` for gathering along an axis of length ``n``:
    ``'clip'`` clamps into ``[0, n)``; ``'wrap'`` takes ``idx mod n``;
    ``'fill'`` and ``'clamp'`` first wrap negative indices once, then
    clamp, and ``valid`` marks the entries that were in range (``'fill'``
    replaces the others)."""
    idx = idx.long()
    if mode == 'wrap':
        return torch.remainder(idx, max(n, 1)), None
    if mode == 'clip':
        return idx.clamp(0, max(n - 1, 0)), None
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n) if mode == 'fill' else None
    return idx.clamp(0, max(n - 1, 0)), valid


def fill_value(dtype):
    """What ``jnp``'s fill mode puts where an index was out of range."""
    if dtype.is_floating_point or dtype.is_complex:
        return float('nan')
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _filled(out, valid):
    if valid is None:
        return out
    return torch.where(valid, out, torch.full_like(out, fill_value(out.dtype)))


def _seq(arrays):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        return list(arrays[0])
    return list(arrays)


def _common(arrays):
    dt = _dtypes.result_type(*arrays)
    return [a.to(dt) for a in arrays]


@register('reshape', aliases=('Reshape',))
def reshape(x, newshape, reverse=False, order='C'):
    shape = (newshape,) if isinstance(newshape, int) else tuple(
        int(s) for s in newshape)
    if 0 in shape:
        shape = tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))
    if order == 'F':
        return x.permute(*reversed(range(x.dim()))).reshape(
            tuple(reversed(shape))).permute(*reversed(range(len(shape))))
    return x.reshape(shape)


@register('transpose')
def transpose(x, axes=None):
    axes = tuple(reversed(range(x.dim()))) if axes is None else tuple(axes)
    return x.permute(*axes)


@register('swapaxes', aliases=('SwapAxis',))
def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


@register('moveaxis')
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@register('rollaxis')
def rollaxis(x, axis, start=0):
    n = x.dim()
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    return torch.movedim(x, axis, start) if axis != start else x


@register('expand_dims')
def expand_dims(x, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    n = x.dim() + len(axes)
    for a in sorted(a % n for a in axes):
        x = x.unsqueeze(a)
    return x


@register('squeeze')
def squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in sorted((a % x.dim() for a in axes), reverse=True):
        if x.shape[a] != 1:
            raise ValueError(f'cannot squeeze axis {a} of size {x.shape[a]}')
        x = x.squeeze(a)
    return x


@register('broadcast_to')
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape))


@register('ravel')
def ravel(x, order='C'):
    return reshape(x, (-1,), order=order)


@register('flatten', aliases=('Flatten',))
def flatten(x):
    """Collapse all but the first axis (reference Flatten)."""
    return x.reshape(x.shape[0], -1)


@register('concatenate', aliases=('concat', 'Concat'))
def concatenate(*arrays, axis=0):
    arrays = _common(_seq(arrays))
    if axis is None:
        return torch.cat([a.reshape(-1) for a in arrays])
    return torch.cat(arrays, dim=axis)


@register('stack')
def stack(*arrays, axis=0):
    return torch.stack(_common(_seq(arrays)), dim=axis)


@register('vstack', aliases=('row_stack',))
def vstack(*arrays):
    return torch.vstack(_common(_seq(arrays)))


@register('hstack')
def hstack(*arrays):
    return torch.hstack(_common(_seq(arrays)))


@register('dstack')
def dstack(*arrays):
    return torch.dstack(_common(_seq(arrays)))


@register('column_stack')
def column_stack(*arrays):
    return torch.column_stack(_common(_seq(arrays)))


def _split_points(n, ios, even):
    if isinstance(ios, int):
        if even and n % ios:
            raise ValueError('array split does not result in an equal '
                             'division')
        q, r = divmod(n, ios)
        sizes = [q + 1] * r + [q] * (ios - r)
        return [sum(sizes[:i]) for i in range(1, ios)]
    return [min(max(i + n if i < 0 else i, 0), n) for i in ios]


def _split(x, ios, axis, even):
    axis %= x.dim()
    n = x.shape[axis]
    pts = [0] + _split_points(n, ios, even) + [n]
    return tuple(x.narrow(axis, a, max(b - a, 0))
                 for a, b in zip(pts[:-1], pts[1:]))


@register('split')
def split(x, indices_or_sections, axis=0):
    return _split(x, indices_or_sections, axis, True)


@register('array_split')
def array_split(x, indices_or_sections, axis=0):
    return _split(x, indices_or_sections, axis, False)


@register('hsplit')
def hsplit(x, indices_or_sections):
    return _split(x, indices_or_sections, 1 if x.dim() > 1 else 0, True)


@register('dsplit')
def dsplit(x, indices_or_sections):
    return _split(x, indices_or_sections, 2, True)


@register('vsplit')
def vsplit(x, indices_or_sections):
    return _split(x, indices_or_sections, 0, True)


@register('tile')
def tile(x, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(x, reps)


@register('repeat')
def repeat(x, repeats, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if torch.is_tensor(repeats):
        repeats = repeats.long()
    return torch.repeat_interleave(x, repeats, dim=axis)


@register('flip')
def flip(x, axis=None):
    dims = tuple(range(x.dim())) if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    return torch.flip(x, dims=dims)


@register('fliplr')
def fliplr(x):
    return torch.fliplr(x)


@register('flipud')
def flipud(x):
    return torch.flipud(x)


@register('roll')
def roll(x, shift, axis=None):
    if axis is None:
        return torch.roll(x.reshape(-1), shift).reshape(x.shape)
    return torch.roll(x, shift, dims=axis)


@register('rot90')
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, dims=list(axes))


@register('pad')
def pad(x, pad_width, mode='constant', constant_values=0,
        constant_value=None):
    """numpy-style pad, also taking the reference Pad op's flat
    ``(before0, after0, before1, after1, ...)`` and ``constant_value``.
    Modes: constant, edge, reflect, symmetric, wrap."""
    if constant_value is not None:
        constant_values = constant_value
    nd = x.dim()
    if isinstance(pad_width, int):
        pw = [(pad_width, pad_width)] * nd
    elif (isinstance(pad_width, (tuple, list)) and pad_width
          and not isinstance(pad_width[0], (tuple, list))):
        if len(pad_width) == 2 * nd and nd != 1:
            pw = [(pad_width[2 * i], pad_width[2 * i + 1])
                  for i in range(nd)]
        elif len(pad_width) == 2:
            pw = [tuple(pad_width)] * nd
        else:
            pw = [(pad_width[0], pad_width[0])] * nd
    else:
        pw = [tuple(p) for p in pad_width]
        if len(pw) == 1:
            pw = pw * nd
    if mode == 'constant':
        flat = [v for p in reversed(pw) for v in p]
        return torch.nn.functional.pad(x, flat, value=constant_values)
    out = x
    for d, (lo, hi) in enumerate(pw):
        n = out.shape[d]
        idx = torch.arange(-lo, n + hi, device=x.device)
        if mode == 'edge':
            idx = idx.clamp(0, n - 1)
        elif mode == 'wrap':
            idx = torch.remainder(idx, n)
        elif mode == 'reflect':
            period = 2 * (n - 1) if n > 1 else 1
            idx = torch.remainder(idx, period)
            idx = torch.where(idx >= n, period - idx, idx)
        elif mode == 'symmetric':
            idx = torch.remainder(idx, 2 * n)
            idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        else:
            raise NotImplementedError(f'pad mode {mode!r} is not ported yet')
        out = out.index_select(d, idx)
    return out


@register('take')
def take(x, indices, axis=None, mode='clip'):
    """Gather along ``axis`` (flattened when None); ``mode`` 'clip'
    clamps, 'wrap' wraps, 'fill' fills (see :func:`gather_index`)."""
    idx = _ints(indices).to(x.device)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    i, valid = gather_index(idx, x.shape[axis], mode or 'fill')
    out = x.index_select(axis, i.reshape(-1)).reshape(
        x.shape[:axis] + tuple(idx.shape) + x.shape[axis + 1:])
    if valid is not None:
        vshape = (1,) * axis + tuple(idx.shape) + (1,) * (x.dim() - axis - 1)
        out = _filled(out, valid.reshape(vshape))
    return out


@register('take_along_axis')
def take_along_axis(x, indices, axis):
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    i, valid = gather_index(_ints(indices), x.shape[axis], 'fill')
    shape = list(torch.broadcast_shapes(
        tuple(d if k != axis else 1 for k, d in enumerate(x.shape)),
        tuple(d if k != axis else 1 for k, d in enumerate(i.shape))))
    xs = list(shape)
    xs[axis] = x.shape[axis]
    isz = list(shape)
    isz[axis] = i.shape[axis]
    out = torch.gather(x.expand(xs), axis, i.expand(isz))
    return _filled(out, valid.expand(isz))


@register('pick')
def pick(x, index, axis=-1, keepdims=False, mode='clip'):
    """Reference broadcast_reduce_op_index.cc pick: one entry along
    ``axis`` per position, through ``take_along_axis``."""
    idx = torch.unsqueeze(_ints(index), axis)
    out = take_along_axis(x, idx, axis)
    return out if keepdims else torch.squeeze(out, axis)


@register('gather_nd')
def gather_nd(data, indices):
    """indices (M, N1...Nk) select along the first M axes of data."""
    idx = _ints(indices)
    key = tuple(gather_index(idx[i], data.shape[i], 'clamp')[0]
                for i in range(idx.shape[0]))
    return data[key]


@register('scatter_nd', differentiable=True)
def scatter_nd(data, indices, shape):
    idx = _ints(indices)
    key = tuple(gather_index(idx[i], shape[i], 'clamp')[0]
                for i in range(idx.shape[0]))
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(key, data, accumulate=True)


@register('one_hot', differentiable=False)
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype='float32'):
    idx = _ints(indices)
    oh = (idx[..., None] == torch.arange(depth, device=idx.device)).to(
        _dtypes.to_torch(dtype))
    return oh * on_value + (1.0 - oh) * off_value


@register('slice_axis')
def slice_axis(x, axis, begin, end):
    n = x.shape[axis]
    if end is None:
        end = n
    if end < 0:
        end += n
    if begin < 0:
        begin += n
    return x.narrow(axis, begin, max(end - begin, 0))


@register('slice_like')
def slice_like(x, shape_like, axes=()):
    sl = [slice(None)] * x.dim()
    for ax in (axes or range(x.dim())):
        sl[ax] = slice(0, shape_like.shape[ax])
    return x[tuple(sl)]


@register('_slice_like_internal')
def _slice_like_internal(x):
    return x


@register('_npi_getitem', namespaces=())
def _npi_getitem(x, key=None):
    """Static basic indexing (ints/slices/None/Ellipsis) as an op."""
    from ..ndarray.ndarray import index_key
    return x[index_key(x, key)]


@register('_npi_setitem', namespaces=())
def _npi_setitem(x, v=0, key=None):
    """``x[key] = v`` as a new array; ``x`` keeps its value."""
    from ..ndarray.ndarray import index_key
    v = _dtypes.tensor_of(v, x.dtype, x.device)
    if key is Ellipsis or (isinstance(key, slice) and key == slice(None)):
        return torch.broadcast_to(v, x.shape).clone()
    new = x.clone()
    new[index_key(x, key)] = v
    return new


@register('where_nd', aliases=())
def where_nd(cond, x, y):
    from .elemwise import where
    return where(cond, x, y)


@register('tril')
def tril(x, k=0):
    return torch.tril(x, k)


@register('triu')
def triu(x, k=0):
    return torch.triu(x, k)


@register('diag')
def diag(x, k=0):
    return torch.diag(x, k)


@register('diagonal')
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@register('diagflat')
def diagflat(x, k=0):
    return torch.diagflat(x, k)


@register('trace')
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@register('searchsorted', differentiable=False)
def searchsorted(a, v, side='left'):
    v = torch.as_tensor(v, device=a.device).to(a.dtype)
    return torch.searchsorted(a, v, right=(side == 'right'))


def _dyn_unless_size(args, kwargs):
    # with size= the output shape is static
    return kwargs.get('size') is None and (len(args) < 2 or args[1] is None)


def _sized(t, size, fill=0):
    if size is None:
        return t
    if t.shape[0] >= size:
        return t[:size]
    pad = torch.full((size - t.shape[0],) + t.shape[1:], fill,
                     dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


@register('argwhere', differentiable=False, dynamic_shape=_dyn_unless_size)
def argwhere(x, size=None):
    return _sized(torch.argwhere(x), size)


@register('nonzero', differentiable=False, dynamic_shape=_dyn_unless_size)
def nonzero(x, size=None):
    nz = _sized(torch.argwhere(x), size)
    return tuple(nz[:, i] for i in range(x.dim()))


@register('flatnonzero', differentiable=False,
          dynamic_shape=_dyn_unless_size)
def flatnonzero(a, size=None):
    return _sized(torch.argwhere(a.reshape(-1))[:, 0], size)


@register('boolean_mask', static_argnums=(1,), static_argnames=('index',),
          dynamic_shape=True)
def boolean_mask(data, index, axis=0):
    """Keep the entries of ``data`` along ``axis`` where ``index`` is
    true; differentiable in ``data``."""
    keep = torch.argwhere(index.to(torch.bool).reshape(-1))[:, 0]
    return data.index_select(axis, keep.to(data.device))


@register('sequence_mask')
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Reference: src/operator/sequence_mask.cc."""
    if not use_sequence_length or sequence_length is None:
        return data
    maxlen = data.shape[axis]
    bshape = [1] * data.dim()
    bshape[axis] = maxlen
    steps = torch.arange(maxlen, device=data.device).reshape(bshape)
    lshape = [1] * data.dim()
    batch_axis = 1 if axis == 0 else 0
    lshape[batch_axis] = data.shape[batch_axis]
    lens = sequence_length.reshape(lshape)
    return torch.where(steps < lens, data,
                       _dtypes.tensor_of(value, data.dtype, data.device))


@register('reverse', aliases=('SequenceReverse_simple',))
def reverse(x, axis):
    return flip(x, axis)


@register('meshgrid')
def meshgrid(*xs, indexing='xy'):
    return tuple(torch.meshgrid(*_common(list(xs)), indexing=indexing))


@register('broadcast_arrays')
def broadcast_arrays(*xs):
    return tuple(torch.broadcast_tensors(*xs))


@register('atleast_1d')
def atleast_1d(x):
    return torch.atleast_1d(x)


@register('atleast_2d')
def atleast_2d(x):
    return torch.atleast_2d(x)


@register('atleast_3d')
def atleast_3d(x):
    return torch.atleast_3d(x)


def _positions(obj, n, device):
    if isinstance(obj, slice):
        return torch.arange(n, device=device)[obj]
    return torch.as_tensor(obj, device=device).long().reshape(-1)


@register('insert')
def insert(arr, obj, values, axis=None):
    """numpy's insert: ``values`` go before the entries at ``obj``."""
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.dim()
    n = arr.shape[axis]
    vals = torch.as_tensor(values, device=arr.device).to(arr.dtype)
    shape = list(arr.shape)
    if isinstance(obj, int) or (torch.is_tensor(obj) and obj.dim() == 0):
        i = int(obj)
        i = i + n if i < 0 else i
        vals = vals.reshape((1,) * (arr.dim() - vals.dim())
                            + tuple(vals.shape))
        vals = torch.movedim(vals, 0, axis)
        shape[axis] = vals.shape[axis]
        return torch.cat([arr.narrow(axis, 0, i),
                          torch.broadcast_to(vals, shape),
                          arr.narrow(axis, i, n - i)], dim=axis)
    pos = _positions(obj, n, arr.device)
    pos = torch.where(pos < 0, pos + n, pos)
    k = pos.numel()
    shape[axis] = k
    vals = torch.broadcast_to(vals, shape)
    rank = torch.empty_like(pos)
    rank[torch.argsort(pos, stable=True)] = torch.arange(k, device=arr.device)
    new_pos = pos + rank
    is_new = torch.zeros(n + k, dtype=torch.bool, device=arr.device)
    is_new[new_pos] = True
    out_shape = list(arr.shape)
    out_shape[axis] = n + k
    out = torch.empty(out_shape, dtype=arr.dtype, device=arr.device)
    out = out.index_copy(axis, torch.argwhere(~is_new)[:, 0], arr)
    return out.index_copy(axis, new_pos, vals)


@register('delete')
def delete(arr, obj, axis=None):
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    axis %= arr.dim()
    n = arr.shape[axis]
    pos = _positions(obj, n, arr.device)
    pos = torch.where(pos < 0, pos + n, pos)
    keep = torch.ones(n, dtype=torch.bool, device=arr.device)
    keep[pos] = False
    return arr.index_select(axis, torch.argwhere(keep)[:, 0])


@register('append')
def append(arr, values, axis=None):
    values = torch.as_tensor(values, device=arr.device)
    if axis is None:
        return concatenate([arr.reshape(-1), values.reshape(-1)])
    return concatenate([arr, values], axis=axis)


@register('resize')
def resize(a, new_shape):
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    n = math.prod(shape)
    flat = a.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(shape, dtype=a.dtype, device=a.device)
    reps = -(-n // flat.numel())
    return flat.repeat(reps)[:n].reshape(shape)


@register('interp')
def interp(x, xp, fp, left=None, right=None):
    """numpy's one-dimensional linear interpolation."""
    dt = _dtypes.result_type(x, xp, fp, 1.0)
    x, xp, fp = x.to(dt), xp.to(dt), fp.to(dt)
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    x0, x1 = xp[i - 1], xp[i]
    y0, y1 = fp[i - 1], fp[i]
    t = (x - x0) / torch.where(x1 == x0, torch.ones_like(x1), x1 - x0)
    out = y0 + t * (y1 - y0)
    out = torch.where(x < xp[0], fp[0] if left is None else
                      torch.as_tensor(left, dtype=dt, device=x.device), out)
    return torch.where(x > xp[-1], fp[-1] if right is None else
                       torch.as_tensor(right, dtype=dt, device=x.device), out)


@register('fill_diagonal')
def fill_diagonal(a, val, wrap=False):
    out = a.clone()
    if a.dim() == 2:
        n = a.shape[0] if wrap else min(a.shape)
        step = a.shape[1] + 1
        flat = out.reshape(-1)
        idx = torch.arange(0, min(n * a.shape[1], flat.numel()), step,
                           device=a.device)
        v = torch.as_tensor(val, dtype=a.dtype, device=a.device).reshape(-1)
        flat[idx] = v.repeat(-(-idx.numel() // v.numel()))[:idx.numel()] \
            if v.numel() > 1 else v
        return flat.reshape(a.shape)
    idx = torch.arange(min(a.shape), device=a.device)
    out[(idx,) * a.dim()] = torch.as_tensor(val, dtype=a.dtype,
                                            device=a.device)
    return out


@register('ediff1d')
def ediff1d(ary, to_end=None, to_begin=None):
    flat = ary.reshape(-1)
    parts = [flat[1:] - flat[:-1]]
    if to_begin is not None:
        parts.insert(0, torch.as_tensor(to_begin, device=ary.device)
                     .to(ary.dtype).reshape(-1))
    if to_end is not None:
        parts.append(torch.as_tensor(to_end, device=ary.device)
                     .to(ary.dtype).reshape(-1))
    return torch.cat(parts)


@register('diff')
def diff(a, n=1, axis=-1):
    return torch.diff(a, n=n, dim=axis)


@register('cross')
def cross(a, b, axis=-1):
    a, b = torch.broadcast_tensors(*_common([a, b]))
    return torch.linalg.cross(a, b, dim=axis)


@register('trapz')
def trapz(y, x=None, dx=1.0, axis=-1):
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, x, dim=axis)


@register('isclose', differentiable=False)
def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _common([a, b])
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register('allclose', differentiable=False)
def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return isclose(a, b, rtol, atol, equal_nan).all()


@register('array_equal', differentiable=False)
def array_equal(a, b):
    if tuple(a.shape) != tuple(b.shape):
        return torch.tensor(False, device=a.device)
    return (a == b).all()


@register('unravel_index', differentiable=False)
def unravel_index(indices, shape):
    return torch.stack(torch.unravel_index(indices.long(), tuple(shape)))


@register('ravel_multi_index', differentiable=False, aliases=('ravel_index',))
def ravel_multi_index(multi_index, shape):
    out = torch.zeros_like(multi_index[0]).long()
    for i, n in enumerate(shape):
        out = out * n + multi_index[i].long().clamp(0, n - 1)
    return out


@register('unwrap')
def unwrap(p, discont=None, axis=-1, period=6.283185307179586):
    """numpy's unwrap."""
    p = p if p.is_floating_point() else p.float()
    dd = torch.diff(p, dim=axis)
    half = period / 2
    discont = half if discont is None else max(discont, half)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    correct = torch.where(dd.abs() < discont, torch.zeros_like(dd),
                          ddmod - dd)
    first = p.narrow(axis, 0, 1)
    return torch.cat([first, p.narrow(axis, 1, p.shape[axis] - 1)
                      + torch.cumsum(correct, dim=axis)], dim=axis)


def _correlate_full(a, v):
    """Full cross-correlation of 1-D ``a`` and ``v`` (numpy's
    ``correlate(a, v, 'full')``)."""
    a, v = _common([a, v])
    a = a if a.is_floating_point() else a.float()
    v = v.to(a.dtype)
    pad = v.numel() - 1
    return torch.nn.functional.conv1d(a.reshape(1, 1, -1),
                                      v.reshape(1, 1, -1),
                                      padding=pad).reshape(-1)


def _mode_slice(full, n, m, mode):
    if mode == 'full':
        return full
    if mode == 'same':
        start = (min(n, m) - 1) // 2
        return full[start:start + max(n, m)]
    return full[min(n, m) - 1:max(n, m)]


@register('convolve')
def convolve(a, v, mode='full'):
    if v.numel() > a.numel():
        a, v = v, a
    full = _correlate_full(a, v.flip(0))
    return _mode_slice(full, a.numel(), v.numel(), mode)


@register('correlate')
def correlate(a, v, mode='valid'):
    full = _correlate_full(a, v)
    return _mode_slice(full, a.numel(), v.numel(), mode)


@register('cov')
def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None):
    x = m if m.dim() > 1 else m.reshape(1, -1)
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = y if y.dim() > 1 else y.reshape(1, -1)
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        x = torch.cat(_common([x, yy]), dim=0)
    x = x if x.is_floating_point() else x.float()
    if ddof is None:
        ddof = 0 if bias else 1
    out = torch.cov(x, correction=ddof, fweights=fweights,
                    aweights=aweights)
    return out


@register('corrcoef')
def corrcoef(x, y=None, rowvar=True):
    c = cov(x, y, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    return (c / d[:, None] / d[None, :]).clamp(-1, 1)


@register('depth_to_space')
def depth_to_space(data, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register('space_to_depth')
def space_to_depth(data, block_size):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register('arange_like', differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, ctx=None, axis=None):
    """arange shaped like ``data`` (or its ``axis`` extent)."""
    n = data.numel() if axis is None else data.shape[axis]
    idx = torch.div(torch.arange(n, device=data.device), repeat,
                    rounding_mode='floor')
    out = start + step * idx.to(data.dtype)
    return out.reshape(data.shape) if axis is None else out


@register('around', aliases=('round_',))
def around(x, decimals=0):
    if not x.is_floating_point():
        return x
    return torch.round(x, decimals=int(decimals))


@register('reshape_like')
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)
    ls, le = lhs_begin or 0, lhs_end if lhs_end is not None else lhs.dim()
    rs, re_ = rhs_begin or 0, rhs_end if rhs_end is not None else rhs.dim()
    return lhs.reshape(lhs.shape[:ls] + rhs.shape[rs:re_] + lhs.shape[le:])


@register('broadcast_like')
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(lhs, rhs.shape)
    target = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        target[la] = rhs.shape[ra]
    return torch.broadcast_to(lhs, tuple(target))


@register('shape_array', differentiable=False)
def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register('size_array', differentiable=False)
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register('add_n', aliases=('ElementWiseSum',))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register('batch_take')
def batch_take(a, indices):
    """out[i] = a[i, indices[i]] (reference indexing_op.cc batch_take)."""
    idx = _ints(indices)[:, None]
    return take_along_axis(a, idx, 1)[:, 0]


@register('tril_indices', differentiable=False)
def tril_indices(n, k=0, m=None):
    t = torch.tril_indices(n, n if m is None else m, k)
    return t[0], t[1]


@register('triu_indices', differentiable=False)
def triu_indices(n, k=0, m=None):
    t = torch.triu_indices(n, n if m is None else m, k)
    return t[0], t[1]


@register('diag_indices_from', differentiable=False)
def diag_indices_from(arr):
    i = torch.arange(arr.shape[0], device=arr.device)
    return tuple(i for _ in range(arr.dim()))


@register('triu_indices_from', differentiable=False)
def triu_indices_from(arr, k=0):
    t = torch.triu_indices(arr.shape[-2], arr.shape[-1], k, device=arr.device)
    return t[0], t[1]


@register('polyval')
def polyval(p, x):
    p, x = _common([p, x])
    out = torch.zeros_like(x)
    for i in range(p.shape[0]):
        out = out * x + p[i]
    return out


@register('index_update', differentiable=False)
def index_update(data, indices, val):
    """Functional scatter-set; ``indices`` (K, N) dims-first, as
    gather_nd."""
    idx = _ints(indices)
    key = tuple(gather_index(idx[i], data.shape[i], 'clamp')[0]
                for i in range(idx.shape[0])) if idx.dim() > 1 else \
        (gather_index(idx, data.shape[0], 'clamp')[0],)
    return data.index_put(key, _dtypes.tensor_of(val, data.dtype,
                                                 data.device))


@register('constraint_check', differentiable=False)
def constraint_check(data, msg='constraint violated'):
    return data.to(torch.bool).all()


@register('empty_like')
def empty_like(prototype, dtype=None, order='C', subok=False, shape=None):
    return torch.zeros(tuple(prototype.shape) if shape is None else
                       tuple(shape), device=prototype.device,
                       dtype=_dtypes.to_torch(dtype) or prototype.dtype)
