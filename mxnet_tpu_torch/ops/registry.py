"""Op registry and imperative dispatch.

Counterpart of ``mxnet_tpu/ops/registry.py``: an :class:`Op` record per
registered function, :func:`register` (which returns the function, so the
port's tensor functions stay callable as they are), :func:`apply_op`,
which runs an op over NDArray inputs, and :func:`invoke`, the call path
of every generated frontend function (``mx.np.*``, ``mx.npx.*``,
``mx.nd.*``), which splits NDArrays from constants, injects a stochastic
op's generator and honours ``out=``.

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

Left for later slices (ROADMAP A4 rest, A5): the bulked dispatch of
``_bulk.py`` and deferred compute.
"""

import functools

import numpy as _np
import torch

from .. import _dtypes, _rng, _tape

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
    gradient) and ``dynamic_shape`` (True, or a predicate of the call's
    ``(args, kwargs)``: the output shape depends on the data). The JAX
    package's other attributes (``n_out``, the cost and lint metadata, a
    custom frontend ``wrap``) serve symbols and the analysis, which are
    not ported yet."""

    __slots__ = ('name', 'fn', 'differentiable', 'stochastic', 'namespaces',
                 'aliases', 'static_argnums', 'static_argnames',
                 'dynamic_shape')

    def __init__(self, name, fn, differentiable=True, stochastic=False,
                 namespaces=('np', 'nd'), aliases=(), static_argnums=(),
                 static_argnames=(), dynamic_shape=False):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.stochastic = stochastic
        self.namespaces = namespaces
        self.aliases = aliases
        self.static_argnums = frozenset(static_argnums)
        self.static_argnames = frozenset(static_argnames)
        self.dynamic_shape = dynamic_shape


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


def apply_op(op, arrays, fn):
    """Run ``fn`` over the payloads of the NDArrays ``arrays`` and wrap
    what it returns (a tensor or a tuple of them). Grad mode is on while
    autograd records, ``op`` is differentiable and an input is tracked;
    otherwise the op runs under ``torch.no_grad()`` and its outputs are
    untracked."""
    from ..ndarray.ndarray import NDArray

    _dispatched[0] += 1
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


def _first_device(args, kwargs):
    from ..ndarray.ndarray import NDArray
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            return a._data.device
        if isinstance(a, (list, tuple)):
            for e in a:
                if isinstance(e, NDArray):
                    return e._data.device
    return None


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
    from ..ndarray.ndarray import NDArray, array
    from ..context import resolve_device

    op = _OPS[op_name] if isinstance(op_name, str) else op_name
    if op.dynamic_shape and (op.dynamic_shape is True
                             or op.dynamic_shape(args, kwargs)):
        from ..gluon.block import is_tracing
        if is_tracing():
            raise DynamicShapeError(
                f'op {op.name!r} has a data-dependent output shape and '
                f'cannot run in a cached call; the block runs eagerly')
    sh = _DISPATCH[0]
    if sh is not None and sh.made and _any_sharded(args, kwargs):
        return sh.invoke(op, args, kwargs)
    kwargs = dict(kwargs)
    out = kwargs.pop('out', None)
    dev = _first_device(args, kwargs)
    scalars_are_data = dev is None
    if op.stochastic:
        ctx, device = kwargs.pop('ctx', None), kwargs.pop('device', None)
        where = ctx if ctx is not None else device
        if kwargs.get('training', True) and kwargs.get('key') is None:
            if dev is None:
                dev = resolve_device(where)
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

    def fn(*raws):
        a = [list(x) if isinstance(x, list) else x for x in consts]
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
        return apply_op(op, arrays, fn)
    # out= drops the autograd linkage (the reference's kWriteTo into an
    # existing array): the op runs unrecorded and the result is rebound
    prev = _tape.set_recording(False)
    try:
        res = apply_op(op, arrays, fn)
    finally:
        _tape.set_recording(prev)
    if isinstance(res, tuple):
        raise ValueError('out= not supported for multi-output op')
    out._rebind(res._data)
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
