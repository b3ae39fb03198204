"""Deferred-compute graph capture.

Counterpart of ``mxnet_tpu/_deferred_compute.py`` (reference
``python/mxnet/_deferred_compute.py:25-70`` over
``Imperative::RecordDeferredCompute``/``GetDeferredComputeSymbol``): the
mechanism by which ``HybridBlock.export`` and ``_trace_symbol`` capture a
Symbol from a plain imperative ``forward``.

Every imperative op goes through ``ops.registry.invoke``; while a capture
is active each call records a serializable node (op name, an argument
template with array placeholders, static attributes) and tags the
NDArrays it returns with ``(node, out_index)``. :func:`get_symbol`
assembles the reachable subgraph into a :class:`..symbol.Symbol`.

Abstract evaluation. The JAX package traces under ``jax.eval_shape``,
so no FLOP runs and the captured inputs are tracers. Here the inputs and
parameters of a trace are tensors on ``torch.device('meta')``: they carry
a shape and a dtype and no storage, and every op on them computes its
output's shape and dtype only (:func:`abstract`). An op given a meta
tensor and a concrete one (a constant, a fresh ``arange``) takes the
concrete one as meta too. A concrete array that no op of the capture
made and no :func:`set_variable` tagged is a constant of the graph: above
256 elements a ``_const_buf{i}`` auxiliary parameter that ``export()``
saves beside the weights, at or below it an inline ``_constant`` node. An
untagged meta tensor has no value to embed and raises, as the reference's
untagged tracer does.
"""

import threading

import numpy as _np
import torch

from . import _modes

__all__ = ['context', 'is_deferred_compute', 'set_variable', 'record',
           'record_opaque', 'get_symbol', 'abstract', 'is_abstract']

_state = threading.local()

#: abstract evaluations running in any thread: while it is 0 the
#: dispatch does not look for meta tensors
_abstract = [0]
#: captures active in any thread: while it is 0 the dispatch records
#: nothing without asking its thread
_captures = [0]
_abstract_lock = threading.Lock()


class _Capture:
    def __init__(self):
        self.tagged = {}        # id(NDArray) -> (node, out_index)
        self.keepalive = []     # NDArrays tagged (their ids stay valid)
        self.nodes = []
        self.aux = {}           # name -> NDArray: hoisted big constants


def _stack():
    stack = getattr(_state, 'stack', None)
    if stack is None:
        stack = _state.stack = []
    return stack


def is_deferred_compute():
    """True while a capture is active in this thread (reference
    ``dc.is_deferred_compute``)."""
    if not _captures[0]:
        return False
    stack = getattr(_state, 'stack', None)
    return bool(stack)


class context:
    """Context manager activating a capture (reference
    ``_deferred_compute.py:44``)."""

    def __enter__(self):
        _stack().append(_Capture())
        with _abstract_lock:
            _captures[0] += 1
        _modes.add(1)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        with _abstract_lock:
            _captures[0] -= 1
        _modes.add(-1)


class abstract:
    """Inside the block the dispatch evaluates abstractly: an op with a
    meta input takes its other inputs as meta, and an op whose output
    shape depends on its data raises ``DynamicShapeError``."""

    def __enter__(self):
        with _abstract_lock:
            _abstract[0] += 1
        _modes.add(1)
        return self

    def __exit__(self, *exc):
        with _abstract_lock:
            _abstract[0] -= 1
        _modes.add(-1)


def is_abstract():
    """True while an abstract evaluation runs in some thread."""
    return _abstract[0] > 0


def meta_like(shape, dtype):
    """A meta tensor of ``shape`` and ``dtype`` (a name, numpy or torch
    dtype): a traced input's stand-in."""
    from . import _dtypes
    return torch.empty(tuple(shape), dtype=_dtypes.to_torch(dtype),
                       device='meta')


def _dtype_name(arr):
    return str(arr.dtype)


def set_variable(arrays, names, attrs=None):
    """Tag input NDArrays as symbol variables (reference
    ``dc.set_variable``); ``arrays``/``names`` may be single items or
    lists."""
    from .symbol.symbol import _SymNode

    if not isinstance(arrays, (list, tuple)):
        arrays, names = [arrays], [names]
    cap = _stack()[-1]
    for arr, name in zip(arrays, names):
        node = _SymNode('null', name, None, {}, [])
        node.attrs['__shape__'] = tuple(arr.shape)
        node.attrs['__dtype__'] = _dtype_name(arr)
        cap.nodes.append(node)
        cap.tagged[id(arr)] = (node, 0)
        cap.keepalive.append(arr)


def _entry_for(cap, arr, op_name='<unknown>'):
    """The entry of an input array; a concrete untagged array becomes an
    embedded constant (the reference embeds them as aux parameters)."""
    ent = cap.tagged.get(id(arr))
    if ent is not None:
        return ent
    if arr._data.is_meta:
        raise RuntimeError(
            f'deferred-compute input of op {op_name!r} is an untagged '
            'tracer; arrays used inside a captured forward must be created '
            'inside it or marked with dc.set_variable (reference raises the '
            'same invariant in Imperative::RecordDeferredCompute)')
    from .symbol.symbol import _SymNode
    if arr.size > 256:
        # big constant buffers go to the params file, not inline JSON
        name = f'_const_buf{len(cap.aux)}'
        node = _SymNode('null', name, None, {}, [])
        node.attrs.update({'__shape__': tuple(arr.shape),
                           '__dtype__': _dtype_name(arr), '__aux__': True})
        cap.aux[name] = arr
    else:
        node = _SymNode('_constant', None, None,
                        {'value': _np.asarray(arr.asnumpy()).tolist(),
                         'dtype': _dtype_name(arr)}, [])
    cap.nodes.append(node)
    ent = (node, 0)
    cap.tagged[id(arr)] = ent
    cap.keepalive.append(arr)
    return ent


def record(op, args, kw_static, kw_arr_keys, arrays, outputs, out_target):
    """Called by ``ops.registry.invoke`` after dispatch while a capture is
    active. ``arrays`` is the flat NDArray-slot list (positional slots,
    then keyword slots, as invoke lays out its closure); ``args``/
    ``kw_static`` are the call as made, NDArrays in place."""
    from .ndarray.ndarray import NDArray
    from .symbol.symbol import _SymNode

    cap = _stack()[-1]
    inputs = [_entry_for(cap, a, op.name) for a in arrays]
    slot = iter(range(len(arrays)))

    def spec_of(v):
        if isinstance(v, NDArray):
            return {'__arr__': next(slot)}
        if isinstance(v, (list, tuple)) and any(
                isinstance(e, NDArray) for e in v):
            return [spec_of(e) for e in v]
        return _encode_static(v)

    args_spec = [spec_of(a) for a in args]
    kwargs = {}
    for k, v in kw_static.items():
        if op.stochastic and k == 'key':
            continue  # drawn again from the context's generator at replay
        kwargs[k] = _encode_static(v)
    for k in kw_arr_keys:
        kwargs[k] = {'__arr__': next(slot)}

    node = _SymNode(op.name, None, args_spec, kwargs, inputs)
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    node.n_out = len(outs)
    cap.nodes.append(node)
    if out_target is not None:
        outs = (out_target,)
    for i, o in enumerate(outs):
        cap.tagged[id(o)] = (node, i)
        cap.keepalive.append(o)


def record_opaque(op, fn, arrays, outputs):
    """Record a closure-based op (a direct ``apply_op`` dispatch). The node
    replays through its captured closure, so the symbol stays executable,
    but it cannot serialize: ``Symbol.tojson()`` raises naming the op."""
    from .symbol.symbol import _SymNode

    cap = _stack()[-1]
    inputs = [_entry_for(cap, a, op.name) for a in arrays]
    node = _SymNode('_opaque', None, None, {}, inputs)
    node.attrs['__opaque_name__'] = op.name
    node.attrs['__opaque_fn__'] = fn
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    node.n_out = len(outs)
    cap.nodes.append(node)
    for i, o in enumerate(outs):
        cap.tagged[id(o)] = (node, i)
        cap.keepalive.append(o)


def _encode_static(v):
    """Static attributes as JSON can hold them (tuples, slices and dtypes
    survive a round trip through ``symbol.symbol._attr_to_json``)."""
    if isinstance(v, _np.dtype):
        return v
    if isinstance(v, type) and issubclass(v, _np.generic):
        return _np.dtype(v)
    if isinstance(v, torch.dtype):
        from . import _dtypes
        return _np.dtype(_dtypes.to_numpy(v))
    if isinstance(v, _np.generic):
        return v.item()
    if isinstance(v, _np.ndarray):
        return v.tolist()
    return v


def get_symbol(outputs):
    """The Symbol of the captured outputs (reference ``dc.get_symbol`` ->
    ``GetDeferredComputeSymbol``)."""
    from .ndarray.ndarray import NDArray
    from .symbol.symbol import Symbol

    cap = _stack()[-1]
    if isinstance(outputs, NDArray):
        outputs = [outputs]
    entries = []
    for o in outputs:
        ent = cap.tagged.get(id(o))
        if ent is None:
            raise RuntimeError(
                'output was not produced under deferred compute')
        entries.append(ent)
    sym = Symbol(entries)
    sym._aux.update(cap.aux)
    return sym
