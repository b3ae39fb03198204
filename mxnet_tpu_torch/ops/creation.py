"""Array-creation ops.

Counterpart of ``mxnet_tpu/ops/creation.py`` (reference
src/operator/tensor/init_op.cc). The creators are frontends, not
dispatched ops: they make a fresh array on a context (``ctx=``/
``device=``, else the current context, which raises with no card) and
bypass autograd. ``zeros_like`` and friends go through the registry.

Under a deferred-compute capture (``HybridBlock.export``) a creator
records a ``_creation_<name>`` node with its static arguments only, as
the reference's ``_creator`` does (``creation.py:29-49``), so that a
forward that makes fresh arrays (BERT's position ids) exports. The
twelve ``_creation_*`` ops replay such a node: the same function, on the
current context's device (a symbol's execution enters its bindings'
context).
"""

import torch

from .. import _deferred_compute as _dc
from .. import _dtypes
from ..context import resolve_device
from .registry import get_op, register


def _dev(ctx, device):
    return resolve_device(ctx if ctx is not None else device)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _out(t, dtype=None):
    from ..ndarray.ndarray import NDArray
    want = _dtypes.to_torch(dtype) if dtype is not None else \
        _dtypes.canonical(t.dtype)
    return NDArray(t.to(want))


def _zeros(shape, dtype='float32', device=None):
    return torch.zeros(_shape(shape), device=device,
                       dtype=_dtypes.to_torch(dtype or 'float32'))


def _ones(shape, dtype='float32', device=None):
    return torch.ones(_shape(shape), device=device,
                      dtype=_dtypes.to_torch(dtype or 'float32'))


def _full(shape, fill_value, dtype=None, device=None):
    if dtype is None:
        dtype = _dtypes.result_type(fill_value)
    return torch.full(_shape(shape), fill_value, device=device,
                      dtype=_dtypes.to_torch(dtype))


def _arange(start, stop=None, step=1, dtype=None, device=None):
    if stop is None:
        start, stop = 0, start
    if step is None:
        step = 1
    if dtype is None:
        dtype = _dtypes.result_type(start, stop, step)
    t = torch.arange(start, stop, step, device=device,
                     dtype=torch.float64 if _dtypes.to_torch(
                         dtype).is_floating_point else None)
    return t.to(_dtypes.to_torch(dtype))


def _linspace(start, stop, num=50, endpoint=True, dtype=None, device=None):
    n = int(num)
    if endpoint:
        t = torch.linspace(start, stop, n, device=device, dtype=torch.float64)
    else:
        t = torch.linspace(start, stop, n + 1, device=device,
                           dtype=torch.float64)[:-1]
    return t.to(_dtypes.to_torch(dtype or 'float32'))


def _logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
              device=None):
    t = _linspace(start, stop, num, endpoint, 'float32', device)
    return torch.pow(torch.as_tensor(base, dtype=torch.float32,
                                     device=t.device), t).to(
        _dtypes.to_torch(dtype or 'float32'))


def _eye(N, M=None, k=0, dtype='float32', device=None):
    M = N if M is None else M
    i = torch.arange(N, device=device)[:, None]
    j = torch.arange(M, device=device)[None, :]
    return (j - i == k).to(_dtypes.to_torch(dtype or 'float32'))


def _tri(N, M=None, k=0, dtype='float32', device=None):
    M = N if M is None else M
    i = torch.arange(N, device=device)[:, None]
    j = torch.arange(M, device=device)[None, :]
    return (j - i <= k).to(_dtypes.to_torch(dtype or 'float32'))


def _indices(dimensions, dtype='int32', device=None):
    grids = torch.meshgrid(*[torch.arange(d, device=device)
                             for d in dimensions], indexing='ij')
    t = torch.stack(grids) if grids else torch.zeros((0,), device=device)
    return t.to(_dtypes.to_torch(dtype or 'int32'))


def _windowed(torch_fn):
    def make(M, device=None):
        return torch_fn(int(M), periodic=False, dtype=torch.float32,
                        device=device)
    return make


_MAKERS = {
    'zeros': _zeros, 'ones': _ones, 'full': _full, 'arange': _arange,
    'linspace': _linspace, 'logspace': _logspace, 'eye': _eye, 'tri': _tri,
    'indices': _indices, 'blackman': _windowed(torch.blackman_window),
    'hamming': _windowed(torch.hamming_window),
    'hanning': _windowed(torch.hann_window),
}


def _replayable(name, make):
    def fn(*args, **kwargs):
        return make(*args, device=resolve_device(None), **kwargs)
    fn.__name__ = f'_creation_{name}'
    fn.__doc__ = f'``{name}`` on the current context (a replayed node).'
    register(f'_creation_{name}', namespaces=(), differentiable=False)(fn)


for _name, _make in _MAKERS.items():
    _replayable(_name, _make)


def _create(name, args, kwargs, ctx, device):
    """``name``'s array on the context; recorded under a capture with the
    static ``args``/``kwargs`` its replay takes."""
    out = _out(_MAKERS[name](*args, device=_dev(ctx, device), **kwargs))
    if _dc.is_deferred_compute():
        _dc.record(get_op(f'_creation_{name}'), args, kwargs, [], [], out,
                   None)
    return out


def zeros(shape, dtype='float32', ctx=None, device=None, order='C'):
    return _create('zeros', (shape,), {'dtype': dtype}, ctx, device)


def ones(shape, dtype='float32', ctx=None, device=None, order='C'):
    return _create('ones', (shape,), {'dtype': dtype}, ctx, device)


def full(shape, fill_value, dtype=None, ctx=None, device=None):
    return _create('full', (shape, fill_value), {'dtype': dtype}, ctx,
                   device)


def empty(shape, dtype='float32', ctx=None, device=None):
    return zeros(shape, dtype=dtype, ctx=ctx, device=device)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    return _create('arange', (start, stop, step), {'dtype': dtype}, ctx,
                   device)


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None,
             device=None):
    return _create('linspace', (start, stop, num),
                   {'endpoint': endpoint, 'dtype': dtype}, ctx, device)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None, device=None):
    return _create('logspace', (start, stop, num),
                   {'endpoint': endpoint, 'base': base, 'dtype': dtype},
                   ctx, device)


def eye(N, M=None, k=0, dtype='float32', ctx=None, device=None):
    return _create('eye', (N, M), {'k': k, 'dtype': dtype}, ctx, device)


def identity(n, dtype='float32', ctx=None, device=None):
    return eye(n, dtype=dtype, ctx=ctx, device=device)


def tri(N, M=None, k=0, dtype='float32', ctx=None, device=None):
    return _create('tri', (N, M), {'k': k, 'dtype': dtype}, ctx, device)


def indices(dimensions, dtype='int32', ctx=None, device=None):
    return _create('indices', (dimensions,), {'dtype': dtype}, ctx, device)


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


def _window(fn_name):
    def wrapper(M, dtype='float32', ctx=None, device=None):
        out = _create(fn_name, (M,), {}, ctx, device)
        return out.astype(dtype) if dtype else out
    wrapper.__name__ = fn_name
    wrapper.__doc__ = (f'The {fn_name} window function (reference '
                       f'_npi_{fn_name}, src/operator/numpy/np_window_op.cc).')
    return wrapper


blackman = _window('blackman')
hamming = _window('hamming')
hanning = _window('hanning')

FRONTEND_CREATORS.update(blackman=blackman, hamming=hamming,
                         hanning=hanning)
