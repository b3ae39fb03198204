"""``mx.np`` — the NumPy-compatible frontend.

Counterpart of ``mxnet_tpu/numpy/__init__.py`` (reference
python/mxnet/numpy/multiarray.py): the one NDArray class plays
``ndarray``, every registered op tagged ``'np'`` is injected below, and
``mx.np.random`` and ``mx.np.linalg`` hold the ``random_*`` and
``linalg_*`` ops. A public numpy callable with no op here resolves to a
host-side fallback on numpy copies (reference numpy/fallback.py), unless
the reference registers an op of that name that the port has not ported
yet: that name raises :class:`~mxnet_tpu_torch.ops.ledger.PendingOpError`
(``ops/ledger.py``), as a host copy would part from the reference's device
op (an in-place ``put_along_axis`` on a copy changes nothing).
"""

import sys as _sys

import numpy as _onp

from .. import _dtypes
from ..ndarray.ndarray import NDArray, array
from ..ndarray import register as _register
from ..ops import ledger as _ledger
from ..ops.creation import FRONTEND_CREATORS as _CREATORS

ndarray = NDArray

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
bfloat16 = 'bfloat16'
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
bool_ = _onp.bool_
pi = _onp.pi
e = _onp.e
euler_gamma = _onp.euler_gamma
inf = _onp.inf
nan = _onp.nan
newaxis = None
dtype = _onp.dtype

_mod = _sys.modules[__name__]
for _n, _f in _CREATORS.items():
    setattr(_mod, _n, _f)

_register.populate(_mod.__dict__, 'np')


def asarray(obj, dtype=None, ctx=None):
    if isinstance(obj, NDArray) and dtype is None and ctx is None:
        return obj
    return array(obj, dtype=dtype, ctx=ctx)


def shape(a):
    return a.shape if hasattr(a, 'shape') else _onp.shape(a)


def ndim(a):
    return a.ndim if hasattr(a, 'ndim') else _onp.ndim(a)


def size(a):
    return a.size if hasattr(a, 'size') else _onp.size(a)


def result_type(*args):
    return _dtypes.to_numpy(_dtypes.result_type(
        *[a._data if isinstance(a, NDArray) else a for a in args]))


def may_share_memory(a, b):
    return False  # no NDArray is written in place, so none aliases


def shares_memory(a, b):
    return False


_FALLBACK_BLOCK = {'save', 'savez', 'savez_compressed', 'load',
                   'fromfile', 'frombuffer', 'memmap', 'test'}


def __getattr__(name):
    label = _ledger.pending().get(name)
    if label is not None:
        raise _ledger.PendingOpError(
            f'np.{name} is not ported yet (ROADMAP {label}, ops/ledger.py)')
    if name.startswith('_') or name in _FALLBACK_BLOCK or \
            not hasattr(_onp, name):
        raise AttributeError(f'module {__name__!r} has no attribute '
                             f'{name!r}')
    target = getattr(_onp, name)
    if not callable(target) or isinstance(target, type):
        raise AttributeError(f'module {__name__!r} has no attribute '
                             f'{name!r}')

    def _fallback(*args, **kwargs):
        def remap(f, x):
            if isinstance(x, (list, tuple)):
                parts = [remap(f, e) for e in x]
                if isinstance(x, tuple) and type(x) is not tuple:
                    return type(x)(*parts)
                return type(x)(parts)
            return f(x)

        dev = [None]

        def host(x):
            if isinstance(x, NDArray):
                dev[0] = dev[0] or x.context
                return x.asnumpy()
            return x

        def wrap(o):
            return array(o, ctx=dev[0]) if isinstance(o, _onp.ndarray) \
                else o

        out = target(*[remap(host, a) for a in args],
                     **{k: remap(host, v) for k, v in kwargs.items()})
        return remap(wrap, out)

    _fallback.__name__ = name
    _fallback.__doc__ = (f'Official-numpy HOST fallback for np.{name} '
                         '(not a device op; reference numpy/fallback.py).')
    return _fallback


class linalg:
    """``mx.np.linalg`` namespace (reference numpy/linalg.py)."""


class random:
    """``mx.np.random`` namespace (reference numpy/random.py)."""


class fft:
    """``mx.np.fft`` namespace (reference numpy/__init__.py:143-160): the
    ``fft_*`` ops, on the arrays' device (complex outputs included)."""


def _build_sub_namespaces():
    from ..ops import registry as _reg
    subs = {'linalg_': linalg, 'random_': random, 'fft_': fft}
    for name, op in _reg.list_ops().items():
        for prefix, ns in subs.items():
            if name.startswith(prefix):
                setattr(ns, name[len(prefix):], staticmethod(
                    _reg.make_frontend(op.name)))
    from ..ops.random_ops import seed as _seed
    random.seed = staticmethod(_seed)
    linalg.norm = staticmethod(_reg.make_frontend('linalg_norm'))


_build_sub_namespaces()
