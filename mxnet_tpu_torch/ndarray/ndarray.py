"""NDArray: the user-visible array.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` (reference
include/mxnet/ndarray.h:82, python/mxnet/ndarray/ndarray.py:249). An
NDArray holds one ``torch.Tensor`` on an explicit ``torch.device``; its
context is that device's (``cpu(0)`` or ``gpu(i)``).

Value semantics over torch's views: an NDArray's payload is never written
in place. A write (``+=``, ``x[...] = v``, ``out=``, ``copyto``) rebinds
the NDArray to a new tensor (:meth:`NDArray._rebind`), as the reference
rebinds its immutable ``jax.Array``. So ``y = x[1:3]``, which may share
``x``'s storage as a torch view, keeps its values when ``x`` is written
later. A variable marked by ``attach_grad`` stays marked across writes:
the new value becomes a fresh leaf (:func:`.._tape.track`).

Sync points: ``wait_to_read``, ``asnumpy`` and ``item`` wait for the
payload's stream, where a deferred device error surfaces; ``waitall``
(:mod:`mxnet_tpu_torch.ndarray`) synchronizes every visible card.
"""

import numpy as _np
import torch

from .. import _dtypes, _tape
from ..context import Context, abstract_context, current_context, \
    resolve_device

__all__ = ['NDArray', 'array', 'context_of', 'index_key']

_INT_TYPES = (int, _np.integer)


def context_of(device):
    """The :class:`Context` of a ``torch.device`` (a meta tensor's is the
    abstract context of ``_deferred_compute``)."""
    if device.type == 'cuda':
        return Context('gpu', device.index or 0)
    if device.type == 'meta':
        return abstract_context()
    return Context('cpu', 0)


def _is_static_key(key):
    """True for basic-indexing keys (ints/slices/None/Ellipsis/int lists)."""
    if isinstance(key, tuple):
        return all(_is_static_key(k) for k in key)
    if key is None or key is Ellipsis or isinstance(key, _INT_TYPES):
        return True
    if isinstance(key, slice):
        return all(b is None or isinstance(b, _INT_TYPES)
                   for b in (key.start, key.stop, key.step))
    if isinstance(key, list):
        return all(isinstance(k, _INT_TYPES) for k in key)
    return False


def index_key(x, key):
    """``key`` as torch takes it for ``x``: NDArrays become tensors; an
    integer index array has its negative entries wrapped and is clamped
    into range, as XLA clamps a gather (on the card an index out of range
    would be a device-side assert); a slice with a negative step becomes
    an index array (torch slices step forward only); an int list becomes
    an index array."""
    if not isinstance(key, tuple):
        key = (key,)
    n_ell = sum(k is Ellipsis for k in key)
    used = sum(0 if k is None or k is Ellipsis else
               (k.ndim if isinstance(k, (NDArray, torch.Tensor))
                and k.dtype == torch.bool else 1)
               for k in key)
    out = []
    ax = 0
    for k in key:
        if k is Ellipsis and n_ell:
            out.append(k)
            ax += x.dim() - used
            continue
        if k is None:
            out.append(k)
            continue
        if isinstance(k, NDArray):
            k = k._data
        if isinstance(k, list):
            k = torch.tensor(k, device=x.device)
        if isinstance(k, torch.Tensor):
            k = k.to(x.device)
            if k.dtype == torch.bool:
                out.append(k)
                ax += k.dim()
                continue
            n = x.shape[ax]
            k = k.long()
            k = torch.where(k < 0, k + n, k).clamp(0, max(n - 1, 0))
            out.append(k)
            ax += 1
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            out.append(torch.arange(*k.indices(x.shape[ax]),
                                    device=x.device))
            ax += 1
            continue
        out.append(k)
        ax += 1
    return tuple(out)


class NDArray:
    """N-dimensional array holding one ``torch.Tensor``."""

    # NDArray operators win over numpy scalars on the left
    __array_priority__ = 1000.0
    #: the pending value of a bulked segment (``_bulk.LazyRef``) for a
    #: :class:`_LazyNDArray`, kept once settled; None for any other array
    _lazy = None

    def __init__(self, data):
        self._data = data
        self._ag = None
        self._layout = None     # sharding.dispatch.Layout of a shard

    # ------------------------------------------------------------------ basic
    @property
    def shape(self):
        """The global shape: a sharded array's payload is this rank's
        shard (:mod:`..sharding.dispatch`)."""
        if self._layout is not None:
            return self._layout.gshape
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _dtypes.to_numpy(self._data.dtype)

    @property
    def size(self):
        if self._layout is not None:
            return int(_np.prod(self._layout.gshape))
        return self._data.numel()

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context
    device = context

    @property
    def stype(self):
        return 'default'

    def _rebind(self, raw):
        """Replace the payload with ``raw`` (a write). Recorded linkage
        goes stale and is dropped; a variable's marking persists, its new
        value a fresh leaf."""
        self._data = raw.detach()
        self._layout = None
        if self._ag is not None and self._ag.variable:
            _tape.track(self)

    def _adopt_lazy(self, res):
        """Take the pending value of ``res`` (a :class:`_LazyNDArray`) as
        this array's new value, inside its segment (a write, as
        :meth:`_rebind`); a variable settles it first, since its new value
        becomes a leaf."""
        if self._ag is not None and self._ag.variable:
            self._rebind(res._data)
            return
        self.__dict__.pop('_data', None)
        self._layout = None
        self._lazy = res._lazy
        self.__class__ = _LazyNDArray

    # ------------------------------------------------------------- sync points
    def wait_to_read(self):
        """Block until the value is computed; a deferred device error is
        raised here (reference ndarray.py:2378)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def wait_to_write(self):
        self.wait_to_read()

    def asnumpy(self):
        """A host numpy copy: the sync point (reference ndarray.py:2574).
        A sharded array gathers its global value first: a collective, which
        every rank of its mesh calls."""
        t = self._data.detach()
        if self._layout is not None:
            from ..sharding.dispatch import gather_tensor
            with torch.no_grad():
                t = gather_tensor(t, self._layout)
        if t.dtype == torch.bfloat16:
            bf = _dtypes.to_numpy(t.dtype)
            return t.float().cpu().numpy().astype(
                bf if isinstance(bf, _np.dtype) else _np.float32)
        return t.cpu().numpy().copy()

    def item(self):
        return self.asnumpy().item()

    def asscalar(self):
        if self.size != 1:
            raise ValueError('The current array is not a scalar')
        return self.item()

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # ------------------------------------------------------------ conversions
    def astype(self, dtype, copy=True):
        from ..ops.registry import get_op, invoke
        if not copy and _dtypes.to_torch(dtype) == _dtypes.to_torch(
                self.dtype):
            return self
        return invoke(get_op('cast'), (self,), {'dtype': dtype})

    def copy(self):
        return self.copyto(self.context)

    def copyto(self, other):
        """A copy on a Context (a new array), or into another NDArray
        (cast to its dtype; the shapes must match)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.to_torch(),
                                                  copy=True))
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError(
                    f'copyto shape mismatch: {self.shape} vs destination '
                    f'{other.shape}')
            other._rebind(self._data.detach().to(
                other._data.device, other._data.dtype, copy=True))
            return other
        raise TypeError(f'copyto does not support type {type(other)}')

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context
    to_device = as_in_context

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    # --------------------------------------------------------------- autograd
    def attach_grad(self, grad_req='write', stype=None):
        """Allocate a gradient buffer and mark this array as a variable."""
        grad = NDArray(torch.zeros_like(self._data).detach())
        _tape.mark_variables([self], [grad], [grad_req])

    @property
    def grad(self):
        info = self._ag
        if info is not None and info.variable:
            return info.grad
        return None

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _tape.backward([self], [out_grad] if out_grad is not None else None,
                       retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # --------------------------------------------------------------- indexing
    def __getitem__(self, key):
        from ..ops.registry import get_op, apply_op, invoke
        if _is_static_key(key) and not isinstance(key, list):
            return invoke(get_op('_npi_getitem'), (self,), {'key': key})
        op = get_op('_slice_like_internal')
        return apply_op(op, [self], lambda x: x[index_key(x, key)])

    def __setitem__(self, key, value):
        from ..ops.registry import get_op, invoke
        if _is_static_key(key) and not isinstance(key, list):
            invoke(get_op('_npi_setitem'), (self, value),
                   {'key': key, 'out': self})
            return
        from .. import _deferred_compute as _dc
        if _dc.is_deferred_compute():
            raise NotImplementedError(
                'in-place assignment with array/boolean indices cannot be '
                'recorded for export; use static indices or np.where '
                'instead (reference deferred compute has the same limit)')
        x = self._data.detach()
        v = value._data.detach() if isinstance(value, NDArray) else value
        new = x.clone()
        new[index_key(x, key)] = _dtypes.tensor_of(v, x.dtype, x.device)
        self._rebind(new)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError('len() of unsized object')
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy())
        raise ValueError('The truth value of an array with more than one '
                         'element is ambiguous.')

    def __int__(self):
        return int(self.asnumpy())

    def __float__(self):
        return float(self.asnumpy())

    def __index__(self):
        if self.ndim == 0 and _np.issubdtype(self.dtype, _np.integer):
            return int(self.asnumpy())
        raise TypeError('only integer scalar arrays can be converted to an '
                        'index')

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f'{self.asnumpy()!r} <NDArray {self.shape} @{self.context}>'

    # ------------------------------------------------------------- arithmetic
    def _binop(self, other, opname, reverse=False):
        from ..ops.registry import get_op, invoke
        if isinstance(other, NDArray) or _np.isscalar(other) or isinstance(
                other, (_np.ndarray, list, tuple)):
            if isinstance(other, (_np.ndarray, list, tuple)):
                other = array(other, ctx=self.context)
            a, b = (other, self) if reverse else (self, other)
            return invoke(get_op(opname), (a, b), {})
        return NotImplemented

    def __add__(self, o): return self._binop(o, 'add')
    def __radd__(self, o): return self._binop(o, 'add', True)
    def __sub__(self, o): return self._binop(o, 'subtract')
    def __rsub__(self, o): return self._binop(o, 'subtract', True)
    def __mul__(self, o): return self._binop(o, 'multiply')
    def __rmul__(self, o): return self._binop(o, 'multiply', True)
    def __truediv__(self, o): return self._binop(o, 'true_divide')
    def __rtruediv__(self, o): return self._binop(o, 'true_divide', True)
    def __floordiv__(self, o): return self._binop(o, 'floor_divide')
    def __rfloordiv__(self, o): return self._binop(o, 'floor_divide', True)
    def __mod__(self, o): return self._binop(o, 'mod')
    def __rmod__(self, o): return self._binop(o, 'mod', True)
    def __pow__(self, o): return self._binop(o, 'power')
    def __rpow__(self, o): return self._binop(o, 'power', True)
    def __matmul__(self, o): return self._binop(o, 'matmul')
    def __rmatmul__(self, o): return self._binop(o, 'matmul', True)

    def __eq__(self, o): return self._binop(o, 'equal')
    def __ne__(self, o): return self._binop(o, 'not_equal')
    def __lt__(self, o): return self._binop(o, 'less')
    def __le__(self, o): return self._binop(o, 'less_equal')
    def __gt__(self, o): return self._binop(o, 'greater')
    def __ge__(self, o): return self._binop(o, 'greater_equal')

    def __and__(self, o): return self._binop(o, 'bitwise_and')
    def __or__(self, o): return self._binop(o, 'bitwise_or')
    def __xor__(self, o): return self._binop(o, 'bitwise_xor')

    def __neg__(self):
        return self._op('negative')

    def __abs__(self):
        return self._op('abs')

    def __invert__(self):
        return self._op('logical_not')

    def _inplace(self, other, opname):
        res = self._binop(other, opname)
        if res is NotImplemented:
            raise TypeError(
                f'unsupported operand type for in-place {opname}: '
                f'{type(other).__name__}')
        if res._lazy is not None and res._lazy.value is None:
            self._adopt_lazy(res)       # the write stays in the segment
        else:
            self._rebind(res._data)
        return self

    def __iadd__(self, o): return self._inplace(o, 'add')
    def __isub__(self, o): return self._inplace(o, 'subtract')
    def __imul__(self, o): return self._inplace(o, 'multiply')
    def __itruediv__(self, o): return self._inplace(o, 'true_divide')

    # ------------------------------------------------------ shape-manipulation
    def _op(self, name, *args, **kwargs):
        from ..ops.registry import get_op, invoke
        return invoke(get_op(name), (self,) + args, kwargs)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._op('reshape', newshape=shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._op('transpose', axes=axes or None)

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return self.reshape((-1,))

    def squeeze(self, axis=None):
        return self._op('squeeze', axis=axis)

    def expand_dims(self, axis):
        return self._op('expand_dims', axis=axis)

    def broadcast_to(self, shape):
        return self._op('broadcast_to', shape=shape)

    def broadcast_like(self, other):
        return self._op('broadcast_to', shape=other.shape)

    def swapaxes(self, a1, a2):
        return self._op('swapaxes', axis1=a1, axis2=a2)

    def split(self, *a, **kw):
        return self._op('split', *a, **kw)

    def take(self, indices, axis=None, mode='clip'):
        return self._op('take', indices, axis=axis, mode=mode)

    def repeat(self, repeats, axis=None):
        return self._op('repeat', repeats=repeats, axis=axis)

    def tile(self, reps):
        return self._op('tile', reps=reps)

    def clip(self, a_min=None, a_max=None):
        return self._op('clip', a_min=a_min, a_max=a_max)

    def round(self, decimals=0):
        return self._op('round', decimals=decimals)

    def pad(self, *a, **kw):
        return self._op('pad', *a, **kw)

    # ---------------------------------------------------------------- reduces
    def sum(self, axis=None, dtype=None, keepdims=False):
        return self._op('sum', axis=axis, dtype=dtype, keepdims=keepdims)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return self._op('mean', axis=axis, dtype=dtype, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._op('prod', axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op('max', axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op('min', axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op('argmax', axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op('argmin', axis=axis, keepdims=keepdims)

    def std(self, axis=None, ddof=0, keepdims=False):
        return self._op('std', axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return self._op('var', axis=axis, ddof=ddof, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None):
        return self._op('cumsum', axis=axis, dtype=dtype)

    def dot(self, other):
        return self._op('dot', other)

    def norm(self, ord=None, axis=None, keepdims=False):
        return self._op('norm', ord=ord, axis=axis, keepdims=keepdims)

    def abs(self):
        return self.__abs__()

    def sqrt(self):
        return self._op('sqrt')

    def exp(self):
        return self._op('exp')

    def log(self):
        return self._op('log')

    def sign(self):
        return self._op('sign')

    def all(self, axis=None, keepdims=False):
        return self._op('all', axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        return self._op('any', axis=axis, keepdims=keepdims)

    def tostype(self, stype):
        """This array in storage ``stype``: ``'default'`` is itself,
        ``'row_sparse'`` and ``'csr'`` its compression
        (:func:`.sparse.cast_storage`)."""
        if stype == 'default':
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def zeros_like(self):
        return self._op('zeros_like')

    def ones_like(self):
        return self._op('ones_like')


class _LazyNDArray(NDArray):
    """An NDArray whose value a bulked segment computes at its flush
    (:mod:`.._bulk`): its shape, dtype and context come from the record;
    reading ``_data`` settles it (a sync point: the segment is flushed,
    whichever thread recorded it) and makes it a plain NDArray. A plain
    NDArray's ``_data`` stays an attribute of its own, read with no
    check."""

    def __getattr__(self, name):
        if name != '_data':
            raise AttributeError(name)
        from .. import _bulk
        value = _bulk.materialize(self.__dict__['_lazy'])
        self.__dict__['_data'] = value
        self.__class__ = NDArray
        return value

    @classmethod
    def _of(cls, ref):
        nd = object.__new__(cls)
        nd._ag = None
        nd._layout = None
        nd._lazy = ref
        return nd

    @property
    def shape(self):
        return self._lazy.shape

    @property
    def dtype(self):
        return _dtypes.to_numpy(self._lazy.dtype)

    @property
    def size(self):
        n = 1
        for d in self._lazy.shape:
            n *= d
        return n

    @property
    def context(self):
        return context_of(self._lazy.device)

    ctx = context
    device = context

    def _rebind(self, raw):
        self.__class__ = NDArray
        self._lazy = None
        NDArray._rebind(self, raw)


def _host_dtype(source_array, dtype):
    """The dtype ``array()`` stores: ``dtype`` if given, else float64 and
    int64 numpy arrays narrow to 32 bits and Python data takes float32 or
    int32 by kind, as in the reference (ndarray.py:612-620)."""
    if dtype is not None:
        return dtype
    if isinstance(source_array, _np.ndarray):
        d = source_array.dtype
        return {_np.dtype(_np.float64): _np.float32,
                _np.dtype(_np.int64): _np.int32}.get(d, d)
    arr = _np.asarray(source_array)
    return (_np.float32 if arr.dtype.kind == 'f'
            else _np.int32 if arr.dtype.kind == 'i' else arr.dtype)


def array(source_array, ctx=None, dtype=None, device=None):
    """An NDArray from any array-like, on ``ctx`` (default: the current
    context, which raises with no card unless it is ``cpu()``)."""
    ctx = ctx or device
    if isinstance(source_array, NDArray):
        raw = source_array._data.detach()
        if dtype is not None:
            raw = raw.to(_dtypes.to_torch(dtype))
        if ctx is not None:
            raw = raw.to(resolve_device(ctx))
        return NDArray(raw)
    dev = resolve_device(ctx if ctx is not None else current_context())
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach().to(dev, copy=True)
        want = _dtypes.to_torch(dtype) if dtype is not None else \
            _dtypes.canonical(t.dtype)
        return NDArray(t.to(want))
    want = _dtypes.to_torch(_host_dtype(source_array, dtype))
    if want == torch.bfloat16:
        host = _np.asarray(source_array, dtype=_np.float32)
    else:
        host = _np.asarray(source_array,
                           dtype=_dtypes.to_numpy(want))
    return NDArray(torch.tensor(host, device=dev).to(want))
