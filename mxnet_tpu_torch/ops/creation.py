"""Array-creation ops.

Counterpart of ``mxnet_tpu/ops/creation.py`` (reference
src/operator/tensor/init_op.cc). The creators are frontends, not
dispatched ops: they make a fresh array on a context (``ctx=``/
``device=``, else the current context, which raises with no card) and
bypass autograd. ``zeros_like`` and friends go through the registry. The
JAX package's replayable ``_creation_*`` ops serve deferred compute,
which is not ported yet (``ops/ledger.py``).
"""

import torch

from .. import _dtypes
from ..context import resolve_device
from .registry import register


def _dev(ctx, device):
    return resolve_device(ctx if ctx is not None else device)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _out(t, dtype=None):
    from ..ndarray.ndarray import NDArray
    want = _dtypes.to_torch(dtype) if dtype is not None else \
        _dtypes.canonical(t.dtype)
    return NDArray(t.to(want))


def zeros(shape, dtype='float32', ctx=None, device=None, order='C'):
    return _out(torch.zeros(_shape(shape), device=_dev(ctx, device),
                            dtype=_dtypes.to_torch(dtype or 'float32')))


def ones(shape, dtype='float32', ctx=None, device=None, order='C'):
    return _out(torch.ones(_shape(shape), device=_dev(ctx, device),
                           dtype=_dtypes.to_torch(dtype or 'float32')))


def full(shape, fill_value, dtype=None, ctx=None, device=None):
    if dtype is None:
        dtype = _dtypes.result_type(fill_value)
    return _out(torch.full(_shape(shape), fill_value,
                           device=_dev(ctx, device),
                           dtype=_dtypes.to_torch(dtype)))


def empty(shape, dtype='float32', ctx=None, device=None):
    return zeros(shape, dtype=dtype, ctx=ctx, device=device)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    if stop is None:
        start, stop = 0, start
    if dtype is None:
        dtype = _dtypes.result_type(start, stop, step)
    return _out(torch.arange(start, stop, step, device=_dev(ctx, device),
                             dtype=torch.float64 if _dtypes.to_torch(
                                 dtype).is_floating_point else None),
                dtype)


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None,
             device=None):
    dev = _dev(ctx, device)
    n = int(num)
    if endpoint:
        t = torch.linspace(start, stop, n, device=dev, dtype=torch.float64)
    else:
        t = torch.linspace(start, stop, n + 1, device=dev,
                           dtype=torch.float64)[:-1]
    return _out(t, dtype or 'float32')


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None, device=None):
    t = linspace(start, stop, num, endpoint, 'float32', ctx, device)._data
    return _out(torch.pow(torch.as_tensor(base, dtype=torch.float32,
                                          device=t.device), t),
                dtype or 'float32')


def eye(N, M=None, k=0, dtype='float32', ctx=None, device=None):
    dev = _dev(ctx, device)
    M = N if M is None else M
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return _out(j - i == k, dtype or 'float32')


def identity(n, dtype='float32', ctx=None, device=None):
    return eye(n, dtype=dtype, ctx=ctx, device=device)


def tri(N, M=None, k=0, dtype='float32', ctx=None, device=None):
    dev = _dev(ctx, device)
    M = N if M is None else M
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return _out(j - i <= k, dtype or 'float32')


def indices(dimensions, dtype='int32', ctx=None, device=None):
    dev = _dev(ctx, device)
    grids = torch.meshgrid(*[torch.arange(d, device=dev)
                             for d in dimensions], indexing='ij')
    return _out(torch.stack(grids) if grids else
                torch.zeros((0,), device=dev), dtype)


# *_like ops go through the registry (no gradient: their values do not
# depend on the input's)
@register('zeros_like', differentiable=False)
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_dtypes.to_torch(dtype))


@register('ones_like', differentiable=False)
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=_dtypes.to_torch(dtype))


@register('full_like', differentiable=False)
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=_dtypes.to_torch(dtype))


@register('copy')
def copy_(x):
    return x.clone()


FRONTEND_CREATORS = {
    'zeros': zeros, 'ones': ones, 'full': full, 'empty': empty,
    'arange': arange, 'linspace': linspace, 'logspace': logspace, 'eye': eye,
    'identity': identity, 'tri': tri, 'indices': indices,
}


@register('vander')
def vander(x, N=None, increasing=False):
    n = x.shape[0] if N is None else N
    p = torch.arange(n, device=x.device)
    if not increasing:
        p = p.flip(0)
    return x[:, None] ** p[None, :].to(x.dtype)


def _window(fn_name, torch_fn):
    def wrapper(M, dtype='float32', ctx=None, device=None):
        t = torch_fn(int(M), periodic=False, dtype=torch.float32,
                     device=_dev(ctx, device))
        return _out(t, dtype or 'float32')
    wrapper.__name__ = fn_name
    wrapper.__doc__ = (f'The {fn_name} window function (reference '
                       f'_npi_{fn_name}, src/operator/numpy/np_window_op.cc).')
    return wrapper


blackman = _window('blackman', torch.blackman_window)
hamming = _window('hamming', torch.hamming_window)
hanning = _window('hanning', torch.hann_window)

FRONTEND_CREATORS.update(blackman=blackman, hamming=hamming,
                         hanning=hanning)
