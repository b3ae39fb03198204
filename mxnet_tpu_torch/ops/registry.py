"""Op registry and imperative dispatch.

Counterpart of ``mxnet_tpu/ops/registry.py``: an :class:`Op` record per
registered function, :func:`register` (which returns the function, so the
port's tensor functions stay callable as they are), :func:`apply_op`,
which runs an op over NDArray inputs, and :func:`invoke`, the call path
of every generated frontend function (``mx.np.*``, ``mx.npx.*``,
``mx.nd.*``), which splits NDArrays from constants, injects a stochastic
op's generator and honours ``out=``. The common eager call (no mode on,
no sharded argument, nothing to lift, no generator, no ``out=``) takes
:func:`_direct`, which hands the payloads to the op with no more work.

An op's ``fn`` is a plain function over ``torch.Tensor``s. Autograd is
``torch.autograd``: :func:`apply_op` turns torch's grad mode on exactly
while :func:`mxnet_tpu_torch.autograd.record` records, the op is
differentiable and an input is tracked, so that a kernel-backed op takes
its ``autograd.Function`` then and only then (``ops.kernels.needs_grad``),
and an op outside ``record()`` builds no graph. Every result is narrowed
to the 32-bit types the JAX package yields (:mod:`.._dtypes`).

A call with a sharded argument (``mx.sharding``: an NDArray holding this
rank's shard) goes to the dispatch that :func:`_bind_sharding` binds,
``sharding.dispatch.invoke``, which runs the op on the shards, lifting
fresh unsharded operands onto the mesh (the reference's ``lift_raws``).

While a deferred-compute capture is active (:mod:`.._deferred_compute`,
``HybridBlock.export``) :func:`invoke` records each call as a node of the
symbol after it dispatches, and a direct :func:`apply_op` records an
opaque node, as the reference does (``mxnet_tpu/ops/registry.py:270-271,
408-412``). During an abstract evaluation (meta tensors: the trace of an
export, ``Symbol.infer_shape``) an op given a meta tensor takes its
concrete inputs as meta too, and an op whose output shape depends on its
data raises :class:`DynamicShapeError`.
"""

import functools

import numpy as _np
import torch

from .. import _bulk
from .. import _deferred_compute as _dc
from .. import _dtypes, _graphs, _modes, _rng, _tape

__all__ = ['Op', 'register', 'get_op', 'list_ops', 'apply_op', 'invoke',
           'make_frontend', 'dispatch_count', 'DynamicShapeError',
           'HostStopError']

_OPS = {}
#: ``sharding.dispatch``, once ``mx.sharding`` is imported: its
#: ``made`` turns on the scan of a call's arguments for a shard, its
#: ``seen`` the check of values gathered whole from a batch split on dp
_DISPATCH = [None]


def _bind_sharding():
    """Route calls with a sharded argument to ``mx.sharding``'s dispatch
    (the reference binds its context here the same way, without a
    circular import at the top level)."""
    from ..sharding import dispatch
    _DISPATCH[0] = dispatch


def _any_sharded(args, kwargs):
    """True when an NDArray argument (also inside a list) is sharded."""
    for group in (args, kwargs.values()):
        for a in group:
            if getattr(a, '_layout', None) is not None:
                return True
            if isinstance(a, (list, tuple)) and any(
                    getattr(e, '_layout', None) is not None for e in a):
                return True
    return False


#: ops dispatched through :func:`apply_op` since the process started
_dispatched = [0]


class HostStopError(TypeError):
    """A control-flow op that decides on the host (``npx.while_loop``'s
    exit, ``npx.cond``'s branch) was called while a hybridized block
    captures a CUDA graph (``gluon.block.capturing()``); the block then
    runs its calls eagerly and counts them in ``eager_call_count``."""


def dispatch_count():
    """Ops dispatched through :func:`apply_op` so far."""
    return _dispatched[0]


class DynamicShapeError(TypeError):
    """An op whose output shape depends on its data was called inside a
    hybridized block's cached call (``gluon.block.is_tracing()``); the
    block then runs eagerly, as the reference's CachedOp does with
    ``is_dynamic``."""


class Op:
    """One registered operator: ``fn`` over tensors, ``differentiable``
    (False: outputs carry no gradient), ``stochastic`` (the dispatch
    passes the device's generator as ``key=``), the frontend
    ``namespaces`` and ``aliases``, ``static_argnums``/
    ``static_argnames`` (NDArray arguments passed as constants, with no
    gradient), ``dynamic_shape`` (True, or a predicate of the call's
    ``(args, kwargs)``: the output shape depends on the data) and
    ``n_out``, the output count of a symbolic call (an int or a function
    of ``(args, kwargs)``; :mod:`.arity` sets it). The JAX package's other
    attributes (the cost and lint metadata, a custom frontend ``wrap``)
    serve its analysis, which is not ported."""

    __slots__ = ('name', 'fn', 'differentiable', 'stochastic', 'namespaces',
                 'aliases', 'static_argnums', 'static_argnames',
                 'dynamic_shape', 'n_out')

    def __init__(self, name, fn, differentiable=True, stochastic=False,
                 namespaces=('np', 'nd'), aliases=(), static_argnums=(),
                 static_argnames=(), dynamic_shape=False, n_out=1):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.stochastic = stochastic
        self.namespaces = namespaces
        self.aliases = aliases
        self.static_argnums = frozenset(static_argnums)
        self.static_argnames = frozenset(static_argnames)
        self.dynamic_shape = dynamic_shape
        self.n_out = n_out


def register(name=None, differentiable=True, stochastic=False,
             namespaces=('np', 'nd'), aliases=(), static_argnums=(),
             static_argnames=(), dynamic_shape=False):
    """Decorator registering a tensor function as an operator; returns
    the function unchanged."""

    def deco(fn):
        opname = name or fn.__name__
        op = Op(opname, fn, differentiable=differentiable,
                stochastic=stochastic, namespaces=namespaces,
                aliases=aliases, static_argnums=static_argnums,
                static_argnames=static_argnames,
                dynamic_shape=dynamic_shape)
        _OPS[opname] = op
        for a in aliases:
            _OPS[a] = op
        return fn

    return deco


def get_op(name):
    return _OPS[name]


def list_ops():
    return dict(_OPS)


def _narrow(t, grad):
    if not torch.is_tensor(t):
        return t
    if not grad and t.requires_grad:
        t = t.detach()
    to = _dtypes.NARROW.get(t.dtype)
    return t if to is None else t.to(to)


def _abstract_raws(op, raws):
    """An abstract evaluation's inputs: all meta when one is (a concrete
    constant joins the traced values as its shape and dtype)."""
    if not any(r.is_meta for r in raws):
        return raws, False
    if op.dynamic_shape is True:
        raise DynamicShapeError(
            f'op {op.name!r} has a data-dependent output shape and cannot '
            f'run under abstract evaluation; execute it eagerly')
    return [r if r.is_meta else r.to('meta') for r in raws], True


class _Unkeyable(TypeError):
    pass


def _hashable(x):
    """A hashable token of a static op argument for a bulked segment's
    cache key; raises :class:`_Unkeyable` for values that must not be
    baked into one (tensors, numpy buffers), so that the op runs eagerly.
    Tokens carry the value's type and a float's repr: 2, 2.0 and True
    (and 0.0 and -0.0) compare equal in Python but compute apart."""
    if x is None or isinstance(x, (str, bytes)):
        return x
    if isinstance(x, bool):
        return ('b', x)
    if isinstance(x, int):
        return ('i', x)
    if isinstance(x, float):
        return ('f', repr(x))
    if isinstance(x, complex):
        return ('c', repr(x))
    if isinstance(x, (tuple, list)):
        return tuple(_hashable(e) for e in x)
    if isinstance(x, slice):
        return ('__slice__', _hashable(x.start), _hashable(x.stop),
                _hashable(x.step))
    if x is Ellipsis:
        return ('__ellipsis__',)
    if isinstance(x, _np.dtype):
        return ('__dtype__', str(x))
    if isinstance(x, torch.dtype):
        return ('__dtype__', str(x))
    if isinstance(x, _np.generic):
        return ('np', str(x.dtype), repr(x.item()))
    if isinstance(x, type):
        return ('__type__', x.__name__)
    if isinstance(x, torch.Generator):
        # a device's generator: the replay draws from it anew
        return ('__generator__', id(x))
    raise _Unkeyable(repr(type(x)))


def _bulk_key(consts, arr_slots, kw_static, kw_keys):
    """The cache key of everything baked into a call's closure, or None
    when an argument cannot key one."""
    try:
        arrpos = set(arr_slots)
        parts = []
        for i, c in enumerate(consts):
            if (i, None) in arrpos:
                parts.append('@')
            elif isinstance(c, list):
                parts.append(tuple('@' if (i, j) in arrpos else _hashable(e)
                                   for j, e in enumerate(c)))
            else:
                parts.append(_hashable(c))
        return (tuple(parts),
                tuple(sorted((k, _hashable(v)) for k, v in kw_static.items())),
                tuple(kw_keys))
    except _Unkeyable:
        return None


def _requires_grad(nd):
    ref = nd._lazy
    if ref is not None and ref.value is None:
        return ref.requires_grad
    return nd._data.requires_grad


def _bulked(op, arrays, fn, bulk_key):
    """``op`` recorded into this thread's bulked segment: its lazy
    outputs, or None (it runs now)."""
    from ..ndarray.ndarray import _LazyNDArray
    grad = op.differentiable and _tape.is_recording() and any(
        _requires_grad(a) for a in arrays)
    rec = _bulk.try_record(op, arrays, fn, bulk_key, grad)
    if rec is None:
        return None
    refs, multi = rec
    outs = [_LazyNDArray._of(r) for r in refs]
    _bulk.cap_check()
    return tuple(outs) if multi else outs[0]


def _run_meta(op, fn, raws):
    """``fn`` on meta tensors: an op that reads a value (``.item()``, a
    data-dependent shape) raises :class:`DynamicShapeError` there."""
    try:
        return fn(*raws)
    except (NotImplementedError, RuntimeError) as e:
        if 'meta' not in str(e):
            raise
        raise DynamicShapeError(
            f'op {op.name!r} reads its data and cannot run under abstract '
            f'evaluation: {e}') from e


def _naive_sync(res):
    """``engine.naive_engine``: wait for the op, so that a device error
    surfaces at the op that made it."""
    for o in (res if isinstance(res, tuple) else (res,)):
        t = o._data
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()


def apply_op(op, arrays, fn, _from_invoke=False, bulk_key=None):
    """Run ``fn`` over the payloads of the NDArrays ``arrays`` and wrap
    what it returns (a tensor or a tuple of them). Grad mode is on while
    autograd records, ``op`` is differentiable and an input is tracked;
    otherwise the op runs under ``torch.no_grad()`` and its outputs are
    untracked. While a mode of :mod:`.._modes` is on the call goes through
    :func:`_apply_special`."""
    from ..ndarray.ndarray import NDArray

    _dispatched[0] += 1
    if _modes.on[0]:
        return _apply_special(op, arrays, fn, _from_invoke, bulk_key)
    raws = [a._data for a in arrays]
    grad = op.differentiable and _tape.is_recording() and any(
        r.requires_grad for r in raws)
    with torch.set_grad_enabled(grad):
        outs = fn(*raws)
    if isinstance(outs, (tuple, list)):
        res = tuple(NDArray(_narrow(o, grad)) for o in outs)
    else:
        res = NDArray(_narrow(outs, grad))
    sh = _DISPATCH[0]
    if grad and sh is not None and sh.seen and sh.check_whole(arrays):
        sh._mark_whole(res)
    return res


def _apply_special(op, arrays, fn, from_invoke, bulk_key):
    """:func:`apply_op` with a mode on: a bulked call is recorded into its
    segment (``bulk_key``); an abstract evaluation runs the op on meta
    tensors; under a deferred-compute capture a direct call (not from
    :func:`invoke`) records an opaque node; ``engine.naive_engine`` waits
    for the op."""
    from ..ndarray.ndarray import NDArray

    if bulk_key is not None and arrays:
        res = _bulked(op, arrays, fn, bulk_key)
        if res is not None:
            return res
    raws = [a._data for a in arrays]
    meta = False
    if _dc._abstract[0]:
        raws, meta = _abstract_raws(op, raws)
    grad = op.differentiable and _tape.is_recording() and any(
        r.requires_grad for r in raws)
    with torch.set_grad_enabled(grad):
        outs = _run_meta(op, fn, raws) if meta else fn(*raws)
    if isinstance(outs, (tuple, list)):
        res = tuple(NDArray(_narrow(o, grad)) for o in outs)
    else:
        res = NDArray(_narrow(outs, grad))
    sh = _DISPATCH[0]
    if grad and sh is not None and sh.seen and sh.check_whole(arrays):
        sh._mark_whole(res)
    if not from_invoke and _dc.is_deferred_compute():
        _dc.record_opaque(op, fn, arrays, res)
    if _graphs.is_uncaptured():
        _naive_sync(res)        # engine.naive_engine
    return res


def _ndarrays(args, kwargs):
    from ..ndarray.ndarray import NDArray
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (e for e in a if isinstance(e, NDArray))


def _device_of(nd):
    ref = nd._lazy       # a pending bulked value: no sync for its device
    if ref is not None and ref.value is None:
        return ref.device
    return nd._data.device


def _first_device(args, kwargs, of=None):
    """The device of the first NDArray argument (``of(nd)``: a pending
    bulked value's, without settling it, while a mode is on)."""
    from ..ndarray.ndarray import NDArray
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            return a._data.device if of is None else of(a)
        if isinstance(a, (list, tuple)):
            for e in a:
                if isinstance(e, NDArray):
                    return e._data.device if of is None else of(e)
    return None


_NDArray = None      # ndarray.NDArray, bound at the first direct call


def _direct(op, args, kwargs):
    """:func:`invoke`'s path for the common eager call, taken while no mode
    of :mod:`.._modes` is on: the positional NDArray arguments (none of them
    sharded) go to the op as their payloads and everything else as it is;
    nothing needs lifting, no argument is an op's static one, no list is
    searched for an array, no generator is drawn from and no ``out=`` is
    written. Returns what :func:`apply_op` would, or None where the general
    path must run."""
    global _NDArray
    if _NDArray is None:
        from ..ndarray.ndarray import NDArray as _NDArray
    if op.stochastic or op.dynamic_shape or op.static_argnums \
            or op.static_argnames or 'out' in kwargs:
        return None
    sh = _DISPATCH[0]
    made = sh is not None and sh.made
    call = list(args)
    raws = []
    for i, a in enumerate(args):
        if isinstance(a, _NDArray):
            if a._layout is not None:
                return None
            call[i] = r = a._data
            raws.append(r)
        elif isinstance(a, (_np.ndarray, list, tuple)):
            return None
    if not raws:
        return None
    for v in kwargs.values():
        if isinstance(v, (_NDArray, _np.ndarray)) or (
                made and isinstance(v, (list, tuple))):
            return None
    grad = op.differentiable and _tape.is_recording() and any(
        r.requires_grad for r in raws)
    if grad and sh is not None and sh.seen:
        return None
    _dispatched[0] += 1
    if grad == torch.is_grad_enabled():
        outs = op.fn(*call, **kwargs)
    else:
        with torch.set_grad_enabled(grad):
            outs = op.fn(*call, **kwargs)
    if isinstance(outs, (tuple, list)):
        return tuple(_NDArray(_narrow(o, grad)) for o in outs)
    return _NDArray(_narrow(outs, grad))


def invoke(op_name, args, kwargs):
    """The call path of generated frontend functions: NDArray arguments
    (also inside list arguments, as ``concatenate`` takes them) become
    the op's tensor inputs; numpy arrays become NDArrays on the device of
    the first NDArray argument, as do positional numpy scalars where no
    NDArray is given (the op's data); everything else is a constant, which
    the elementwise ops promote as the reference does (a numpy scalar is a
    strong 0-dim array there). ``out=`` writes the result into the given
    NDArray (no gradient, as in the reference); a stochastic op gets
    ``key=``, the generator of its device (the first NDArray's, else
    ``ctx=``/``device=``, else the current context)."""
    op = _OPS[op_name] if isinstance(op_name, str) else op_name
    special = _modes.on[0]
    if not special:
        res = _direct(op, args, kwargs)
        if res is not None:
            return res
    from ..ndarray.ndarray import NDArray, array
    from ..context import resolve_device

    if op.dynamic_shape and (op.dynamic_shape is True
                             or op.dynamic_shape(args, kwargs)):
        from ..gluon.block import is_tracing
        if is_tracing() or (special and _dc._abstract[0] and any(
                getattr(a, '_data', None) is not None and a._data.is_meta
                for a in _ndarrays(args, kwargs))):
            raise DynamicShapeError(
                f'op {op.name!r} has a data-dependent output shape and '
                f'cannot run in a cached call; the block runs eagerly')
    sh = _DISPATCH[0]
    if sh is not None and sh.made and _any_sharded(args, kwargs):
        return sh.invoke(op, args, kwargs)
    kwargs = dict(kwargs)
    out = kwargs.pop('out', None)
    dev = _first_device(args, kwargs, _device_of if special else None)
    scalars_are_data = dev is None
    if op.stochastic:
        ctx, device = kwargs.pop('ctx', None), kwargs.pop('device', None)
        where = ctx if ctx is not None else device
        if kwargs.get('training', True) and kwargs.get('key') is None:
            if dev is None:
                dev = resolve_device(where)
            if dev.type != 'meta':      # an abstract draw needs no state
                kwargs['key'] = _rng.generator(dev)

    def lift(a, scalar=False):
        if isinstance(a, _np.ndarray) or (scalar and isinstance(
                a, _np.generic)):
            return array(a, ctx=dev)
        return a

    arr_slots = []   # (pos, sub_index or None)
    arrays = []
    consts = [lift(a, scalars_are_data) for a in args]
    for i, a in enumerate(consts):
        if isinstance(a, NDArray):
            if i in op.static_argnums:
                consts[i] = a._data.detach()
            else:
                arr_slots.append((i, None))
                arrays.append(a)
        elif isinstance(a, (list, tuple)):
            consts[i] = [lift(e) for e in a]
            for j, e in enumerate(consts[i]):
                if isinstance(e, NDArray):
                    arr_slots.append((i, j))
                    arrays.append(e)
    kw_arr, kw_static = {}, {}
    for k, v in kwargs.items():
        v = lift(v)
        if isinstance(v, NDArray):
            if k in op.static_argnames:
                kw_static[k] = v._data.detach()
            else:
                kw_arr[k] = v
        else:
            kw_static[k] = v
    kw_keys = list(kw_arr)
    arrays = arrays + [kw_arr[k] for k in kw_keys]
    fn_raw = op.fn
    npos = len(arr_slots)
    tmpl, bulk_key = consts, None
    if special and _bulk.active() and not _dc.is_deferred_compute() \
            and not _dc._abstract[0] and (sh is None or not sh.made):
        # a bulked segment keeps the closure: it holds no NDArray, so as
        # not to keep alive the arrays its caller dropped
        tmpl = list(consts)
        for i, j in arr_slots:
            if j is None:
                tmpl[i] = None
            else:
                tmpl[i] = list(tmpl[i])
                tmpl[i][j] = None
        bulk_key = _bulk_key(tmpl, arr_slots, kw_static, kw_keys)

    def fn(*raws):
        a = [list(x) if isinstance(x, list) else x for x in tmpl]
        for (i, j), r in zip(arr_slots, raws[:npos]):
            if j is None:
                a[i] = r
            else:
                a[i][j] = r
        kw = dict(kw_static)
        for k, r in zip(kw_keys, raws[npos:]):
            kw[k] = r
        return fn_raw(*a, **kw)

    if out is None:
        if not special:
            return apply_op(op, arrays, fn)
        res = apply_op(op, arrays, fn, True, bulk_key)
        if _dc.is_deferred_compute():
            _dc.record(op, consts, kw_static, kw_keys, arrays, res, None)
        return res
    # out= drops the autograd linkage (the reference's kWriteTo into an
    # existing array): the op runs unrecorded and the result is rebound
    prev = _tape.set_recording(False)
    try:
        res = apply_op(op, arrays, fn, True, bulk_key)
    finally:
        _tape.set_recording(prev)
    if isinstance(res, tuple):
        raise ValueError('out= not supported for multi-output op')
    if special and res._lazy is not None and res._lazy.value is None:
        out._adopt_lazy(res)        # the write stays in the segment
    else:
        out._rebind(res._data)
    if special and _dc.is_deferred_compute():
        _dc.record(op, consts, kw_static, kw_keys, arrays, res, out)
    return out


def make_frontend(op_name):
    """The user-facing function of an op (reference
    python/mxnet/ndarray/register.py:265)."""
    op = _OPS[op_name]

    @functools.wraps(op.fn)
    def frontend(*args, **kwargs):
        return invoke(op, args, kwargs)

    frontend.__name__ = op_name
    return frontend
