"""Gluon ``Block`` and ``HybridBlock``.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
python/mxnet/gluon/block.py: Block:201, ``__call__``:705, HybridBlock:859,
``hybridize``:1217). ``Block`` registers children and parameters through
``__setattr__``, names parameters by their path
(``encoder.cell0.attention.qkv.weight``, exactly the JAX names) and saves
and loads them in the JAX package's npz format. It is a class of its own,
not a ``torch.nn.Module``: their public names clash (``apply``,
``zero_grad``, hooks, ``cast``, ``__call__``). Its parameters are real
torch leaves (:mod:`.parameter`).

``hybridize()`` gives a ``HybridBlock`` a :class:`_CachedGraph`, the
port's ``CachedOp``. The JAX package compiles the forward per key (input
shapes and dtypes, train mode, donation, argument structure) with
``jax.jit`` and records a call as one ``_CachedOp`` node whose backward
is that program's VJP; here, on a CUDA device:

* a call that is not recorded (predict mode, or ``train_mode()``)
  captures the forward once per key as a CUDA graph
  (``_graphs.StepGraph``) and replays it: the inputs are copied into the
  graph's static buffers, and the outputs are cloned out of its output
  tensors, which the next replay overwrites, since NDArrays have value
  semantics;
* a recorded call captures the forward and its backward as two graphs
  per key (``_graphs.GraphedCall``) and replays them as one node on the
  tape: ``loss.backward()`` replays the backward graph, which writes the
  input and parameter gradients, and the parameters' hooks copy them into
  their grad buffers. A second recorded call of a key while the first
  still waits for its backward would overwrite the activations that
  backward reads: it runs eagerly instead, and ``eager_call_count``
  counts it, as it counts the training-mode calls of a block that runs
  collectives (``SyncBatchNorm`` over several processes), the recorded
  calls of a block with a row-sparse gradient (``Embedding(sparse_grad=
  True)``: a sparse tensor of new size each backward) and every call of
  a block whose ``npx.while_loop`` or ``npx.cond`` decides on the host
  (``HostStopError`` inside a capture), none of which can be captured.
  ``create_graph=True`` through a replayed node runs the forward again
  eagerly under autograd, so that the gradients can be differentiated
  again (one that draws random numbers raises there);
* a key's first call is the capture's warm-up and the call's real answer
  (BatchNorm's running statistics move once); the graphs of a key are
  captured once, and again only if a parameter's leaf was replaced
  (``cast``, ``reset_ctx``), since a graph reads the weights at their
  addresses. ``compile_count`` counts keys, ``capture_count`` graphs;
* the captured graphs register the device's generator
  (``_rng.graph_generators``): a Dropout mask is drawn anew on every
  replay, but not the mask an eager call would draw from the same seed.

On the CPU every call runs eagerly under ``torch.autograd``, keyed and
counted the same way, so the keying can be held against the JAX
package's (``_graphs.emulated`` runs the graphed bookkeeping there in
tests).

``hybridize(remat=True)`` recomputes the forward in the backward: eagerly
through ``torch.utils.checkpoint``, graphed by a backward graph that runs
the forward again; the recomputation writes no running statistic and
draws the forward's random numbers again (eagerly from the generator's
state before the forward, graphed from a clone of the generator's state
set to the forward replay's offset: ``_graphs.GraphedCall``), so a block
with Dropout trains as it does without ``remat``. ``pure_function`` gives the
forward as a function of explicit tensors (the JAX package's pure export,
for K-step loops captured as one graph), ``prewarm`` builds keys ahead of
traffic, and ``register_op_hook`` monitors whole cached calls.

As in the reference, the first call after ``hybridize()`` on a block
that never ran runs eagerly (deferred initialization finishes before any
capture), hybridized children run inline inside a parent's cached call,
keyword arguments to a hybridized call raise, and an op with a
data-dependent output shape switches the block to eager calls with a
warning. Every write of a parameter is in place (``Parameter.set_data``,
the Trainer's update, BatchNorm's running statistics), so a replay sees
it.

Under ``mx.sharding.mesh(...)`` (reference ``block.py:349``, :545-551) a
hybridized call is sharded: its parameters are placed by the partition
rules once for each mesh (``_sharding_plan``: this rank keeps its shards),
its inputs are cut on the data axis by the context's ``batch_spec``, and
the context's fingerprint joins the key, so the same mesh is warm and a
new mesh is a new key. Such a call runs collectives (the gathers, the
tensor-parallel sums), which cannot be captured: it runs eagerly on the
card and counts in ``eager_call_count``, where the JAX package compiles one
partitioned program. A call outside any mesh of a block whose parameters
are sharded gathers them back first.

Export and import (reference ``block.py:1299``, :1485):
``_trace_symbol`` captures the forward in inference mode as a
:class:`..symbol.Symbol` by deferred compute, evaluating it abstractly:
the inputs and, through :func:`.parameter.substituted`, the parameters
are meta tensors inside the trace, so no FLOP runs and no parameter's
leaf is touched (the graphs captured from those leaves, and the Trainer's,
still read the trained weights after it). Under a capture (a symbol
trace, or a CUDA graph capture of the caller's stream) a hybridized block
and its children run ``forward``, never a graph replay.
``export()`` writes ``{path}-symbol.json`` and
``{path}-{epoch:04d}.params.npz`` in the JAX package's formats;
:class:`SymbolBlock` runs a symbol as a block, its free variables
parameters, its forward the symbol's replay through the op registry, so
autograd, ``hybridize()`` and the Trainer work on it.

``hybridize(backend=...)`` is kept and the whole graph captured, as the
JAX package keeps it and compiles the whole graph with XLA.
``hybridize(donate_inputs=True)`` donates the caller's input arrays to
every call that is not recorded (the JAX package's ``donate_argnums``,
its own key): the caller must not touch them after the call, and an
array so taken raises on its next read, as a deleted JAX array does; the
replay still copies it into the graph's static buffer. Not ported:
``hybridize(check=True)``, which waits with the analysis rules (ROADMAP
A11) and raises, and the StableHLO export of a graph with an opaque op,
which waits with ``gluon/rnn`` (A11).
"""

import contextlib
import re
import threading
import warnings

import numpy as _np
import torch

from .. import _deferred_compute as _dc
from .. import _graphs, _rng, _tape
from ..autograd import pause
from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray, array, context_of
from ..ops.registry import DynamicShapeError, HostStopError
from .parameter import DeferredInitializationError, Parameter, substituted

__all__ = ['Block', 'HybridBlock', 'SymbolBlock', 'ParameterDict',
           'is_tracing', 'record_aux_update']

_BLOCK_TRACE = threading.local()


@contextlib.contextmanager
def current_unsharded():
    """No sharding context inside the block (a whole forward)."""
    from ..sharding import context as _ctx
    stack = _ctx._stack()
    saved = list(stack)
    stack.clear()
    try:
        yield
    finally:
        stack[:] = saved


def is_tracing():
    """True inside a hybridized block's cached call: children run inline
    there, and an op with a data-dependent output shape raises
    ``DynamicShapeError``."""
    return getattr(_BLOCK_TRACE, 'depth', 0) > 0


_CAPTURE = threading.local()


def capturing():
    """True inside a hybridized block's capture of a CUDA graph (its
    warm-up included): an op that must decide on the host raises
    ``HostStopError`` there."""
    return getattr(_CAPTURE, 'depth', 0) > 0


@contextlib.contextmanager
def _capturing():
    _CAPTURE.depth = getattr(_CAPTURE, 'depth', 0) + 1
    try:
        yield
    finally:
        _CAPTURE.depth -= 1


def _stream_capturing():
    """True inside a CUDA graph capture of the current stream (a caller's
    ``StepGraph``, such as ``DecodeServer``'s step): a hybridized block
    then runs ``forward`` into that capture, as its children run inline in
    its own cached call."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class _Tracing:
    def __enter__(self):
        _BLOCK_TRACE.depth = getattr(_BLOCK_TRACE, 'depth', 0) + 1

    def __exit__(self, *exc):
        _BLOCK_TRACE.depth -= 1


def record_aux_update(param, value):
    """Write an auxiliary state (BatchNorm's running statistics) into the
    parameter's leaf in place, so that a captured graph and every later
    call read the new value (the JAX package rebinds eagerly and returns
    the value from a compiled graph). Inside a pure function the new value
    is collected and returned instead (JAX ``block.py:53-70``), and a
    remat recomputation writes nothing."""
    raw = value._data if isinstance(value, NDArray) else value
    writes = getattr(_BLOCK_TRACE, 'aux_writes', None)
    if writes is not None:
        writes[id(param)] = raw.detach()
        return
    if getattr(_BLOCK_TRACE, 'recomputing', False):
        return
    var = param._sync()
    with torch.no_grad():
        var.copy_(raw.detach())


@contextlib.contextmanager
def _recomputing(gen=None, state=None):
    """A remat recomputation: no auxiliary state is written, and with
    ``gen`` the forward's random draws are made again from ``state``, its
    generator state before the forward."""
    prev = getattr(_BLOCK_TRACE, 'recomputing', False)
    _BLOCK_TRACE.recomputing = True
    now = None
    if gen is not None:
        now = gen.get_state()
        gen.set_state(state)
    try:
        yield
    finally:
        _BLOCK_TRACE.recomputing = prev
        if now is not None:
            gen.set_state(now)


# ------------------------------------------------------------ argument trees
def _flatten(tree, inputs):
    """``(leaves, spec)`` of a nest of tuples, lists and dicts. NDArrays
    are leaves; ``None`` is structure. Other values are leaves of an input
    tree (they become NDArrays) and constants of an output tree."""
    leaves = []

    def walk(x):
        if isinstance(x, NDArray):
            leaves.append(x)
            return 'L'
        if x is None:
            return 'N'
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(e) for e in x))
        if isinstance(x, dict):
            keys = tuple(x)
            return ('dict', keys, tuple(walk(x[k]) for k in keys))
        if inputs:
            leaves.append(x)
            return 'L'
        return ('const', x)

    return leaves, walk(tree)


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s == 'L':
            return next(it)
        if s == 'N':
            return None
        if s[0] == 'const':
            return s[1]
        if s[0] == 'dict':
            return {k: build(c) for k, c in zip(s[1], s[2])}
        items = [build(c) for c in s[1]]
        return tuple(items) if s[0] == 'tuple' else items

    return build(spec)


def _pending(what):
    raise NotImplementedError(f'{what} is not ported yet (it waits with the '
                              f'analysis rules, ROADMAP A11)')


class _DonatedNDArray(NDArray):
    """An input that a ``hybridize(donate_inputs=True)`` call took: deleted,
    as a donated JAX array is, so that reading it raises."""

    def __getattr__(self, name):
        if name == '_data':
            raise RuntimeError(
                'Array has been deleted: it was donated to a hybridized '
                'call (hybridize(donate_inputs=True))')
        raise AttributeError(name)


def _donate(arrays):
    """Delete the caller's ``arrays`` after a donating call."""
    for nd in arrays:
        if type(nd) is NDArray and not getattr(nd, '_param', False):
            nd.__dict__.pop('_data', None)
            nd.__class__ = _DonatedNDArray


class ParameterDict(dict):
    """Ordered name -> Parameter mapping with batch helpers (the surviving
    surface of the reference's ParameterDict)."""

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for param in self.values():
            param.initialize(init=init, ctx=ctx, force_reinit=force_reinit)

    def zero_grad(self):
        for param in self.values():
            param.zero_grad()

    def setattr(self, name, value):
        for param in self.values():
            setattr(param, name, value)

    def reset_ctx(self, ctx):
        for param in self.values():
            param.reset_ctx(ctx)

    def save(self, filename, strip_prefix=''):
        from ..model import save_ndarray_map
        data = {}
        for name, param in self.items():
            if name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            data[name] = param.data()
        save_ndarray_map(filename, data)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, cast_dtype=False, dtype_source='current'):
        from ..model import load_ndarray_map
        self.load_dict(load_ndarray_map(filename, ctx=cpu()),
                       allow_missing=allow_missing,
                       ignore_extra=ignore_extra, source=filename)

    def load_dict(self, params, allow_missing=False, ignore_extra=False,
                  source='the dict'):
        """Set each parameter from ``params`` (name -> NDArray, numpy array
        or tensor), in place. A parameter missing from ``params`` raises
        unless ``allow_missing``; a name no parameter has raises unless
        ``ignore_extra``."""
        if not ignore_extra:
            extra = sorted(set(params) - set(self))
            if extra:
                raise KeyError(f'{source} has values for {extra}, which '
                               f'are not parameters of this block; pass '
                               f'ignore_extra=True to skip them')
        for name, param in self.items():
            if name in params:
                param.set_data(params[name])
            elif not allow_missing:
                raise KeyError(f'Parameter {name} missing in {source}')


class Block:
    """Base building block (reference gluon/block.py:201)."""

    def __init__(self, prefix=None, params=None):
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []
        self._ctx = None

    # ----------------------------------------------------------- registration
    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get('_children')
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            existing = self.__dict__.get('_reg_params')
            if existing is not None:
                existing[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block
        return block

    @property
    def params(self):
        """Direct parameters of this block (no descendants)."""
        return ParameterDict(self._reg_params)

    def collect_params(self, select=None):
        """Every parameter of this block's subtree, named by its path
        (reference block.py collect_params); ``select`` is a regular
        expression the names must match."""
        out = ParameterDict()
        self._collect_params_with_prefix(out, '')
        if select is not None:
            pattern = re.compile(select)
            out = ParameterDict({k: v for k, v in out.items()
                                 if pattern.match(k)})
        return out

    def _collect_params_with_prefix(self, out, prefix):
        for name, param in self._reg_params.items():
            full = f'{prefix}{name}'
            param._structure_name = full
            out[full] = param
        for name, child in self._children.items():
            child._collect_params_with_prefix(out, f'{prefix}{name}.')

    # ------------------------------------------------------------------ hooks
    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each call."""
        self._forward_hooks.append(hook)
        return hook

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call."""
        self._forward_pre_hooks.append(hook)
        return hook

    def apply(self, fn):
        """``fn(block)`` on every descendant, then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    # ------------------------------------------------------------------ state
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter of the subtree on ``ctx`` (default:
        the current context, a card unless a ``with mx.cpu():`` says
        otherwise)."""
        self._ctx = ctx
        self.collect_params().initialize(init=init, ctx=ctx,
                                         force_reinit=force_reinit)

    def _initialized_once(self):
        params = self.collect_params()
        return all(p._var is not None or p._deferred_init is not None
                   for p in params.values()) and bool(params)

    def cast(self, dtype):
        for param in self.collect_params().values():
            param.cast(dtype)
        return self

    def reset_ctx(self, ctx):
        self.collect_params().reset_ctx(ctx)

    def zero_grad(self):
        self.collect_params().zero_grad()

    def share_parameters(self, shared):
        """Take the parameters of ``shared`` (name -> Parameter) in place
        of this subtree's of the same names (reference block.py
        share_parameters). The subtree's cached graphs are dropped."""
        own = self.collect_params()
        for name, param in shared.items():
            if name in own:
                self._set_param_by_path(name, param)
        self.apply(lambda b: b._clear_cache())
        return self

    def _clear_cache(self):
        pass

    def _set_param_by_path(self, path, param):
        parts = path.split('.')
        block = self
        for p in parts[:-1]:
            block = block._children[p]
        block._reg_params[parts[-1]] = param
        object.__setattr__(block, parts[-1], param)

    # ----------------------------------------------------------- save / load
    def save_parameters(self, filename, deduplicate=False):
        """Reference block.py:339, in the JAX package's npz format."""
        self.collect_params().save(filename)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source='current'):
        """Reference block.py:375: a file either package saved; values go
        into the parameters in place."""
        params = self.collect_params()
        if not self._initialized_once():
            self.initialize(ctx=ctx)
        params.load(filename, ctx=ctx, allow_missing=allow_missing,
                    ignore_extra=ignore_extra)

    def load_dict(self, params, allow_missing=False, ignore_extra=False):
        """Set the parameters from ``params`` (structural name -> numpy
        array, NDArray or tensor), in place: a JAX net's ``{name:
        p.data().asnumpy()}`` carries its weights across, since the names
        are the same. Strict about missing and extra names unless told
        otherwise."""
        if not self._initialized_once():
            self.initialize(ctx=self._ctx)
        self.collect_params().load_dict(params, allow_missing=allow_missing,
                                        ignore_extra=ignore_extra)

    def save(self, prefix):
        self.save_parameters(f'{prefix}-model.params.npz')

    def load(self, prefix):
        self.load_parameters(f'{prefix}-model.params.npz')

    # ------------------------------------------------------------------- call
    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args, **kwargs)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):
        """Run the block on ``inputs`` and print each parameter's path,
        shape and size (the JAX package's ``print_summary`` table)."""
        with pause():
            self(*inputs)
        lines = [f'{"Layer":<40}{"Output":<24}{"Params":>12}', '=' * 76]
        total = 0
        for name, param in self.collect_params().items():
            n = 1
            for d in param.shape:
                n *= d
            total += n
            lines.append(f'{name:<40}{str(param.shape):<24}{n:>12}')
        lines += ['=' * 76, f'Total params: {total}']
        out = '\n'.join(lines)
        print(out)
        return out

    def __repr__(self):
        s = f'{type(self).__name__}('
        for name, child in self._children.items():
            s += f'\n  ({name}): {child!r}'.replace('\n', '\n  ')
        return s + ('\n)' if self._children else ')')

    def hybridize(self, active=True, **kwargs):
        """Plain Blocks recurse into their children (reference
        block.py:693)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    @property
    def compile_count(self):
        """Cache entries built for this subtree since the last
        ``hybridize()`` of each block: keys (counted once however often
        their graph replays)."""
        return sum(child.compile_count for child in self._children.values())


class _Entry:
    """One key of a :class:`_CachedGraph`: the graph of its calls that are
    not recorded, the leaves it captured, its static input buffers and its
    output tree; and its recorded calls' :class:`_Recorded` graphs, by
    which inputs and parameters require grad."""

    __slots__ = ('graph', 'leaves', 'inputs', 'out_spec', 'recorded')

    def __init__(self):
        self.graph = None
        self.leaves = ()
        self.inputs = ()
        self.out_spec = None
        self.recorded = {}


class _Recorded:
    """The forward and backward graphs of a key's recorded calls."""

    __slots__ = ('call', 'leaves', 'out')

    def __init__(self, call, leaves, out):
        self.call, self.leaves, self.out = call, leaves, out


class _CachedGraph:
    """The cache of one hybridized block (the role of CachedOp, reference
    src/imperative/cached_op.h:463); see the module docstring."""

    def __init__(self, block, static_alloc=True, remat=False, backend=None,
                 donate_inputs=False):
        self.block = block
        self.static_alloc = static_alloc
        self.remat = remat
        self.backend = backend      # kept; the whole graph is captured
        self.donate_inputs = donate_inputs
        self.compiles = 0     # keys built
        self.captures = 0     # CUDA graphs captured
        self.eager_calls = 0  # recorded calls run eagerly while a replay
        #                       of their key waited for its backward
        self._entries = {}
        self._param_order = None
        self._planned = None    # fingerprint of the mesh placed for
        self._dynamic = False
        self._host_stop = False   # a control-flow op stopped on the host
        self._monitor_callbacks = []
        self._lock = threading.RLock()

    def clear(self):
        with self._lock:
            for e in self._entries.values():
                if e.graph is not None:
                    e.graph.release()
            self._entries.clear()
            self._param_order = None

    def _params(self):
        """The block's parameters, and whether one is state that is not
        trained (BatchNorm's running statistics)."""
        if self._param_order is None:
            params = list(self.block.collect_params().values())
            self._param_order = (params,
                                 any(p.grad_req == 'null' for p in params))
        return self._param_order

    def _sharding_plan(self, ctx):
        """Place every parameter by the context's rules, once for each
        mesh: names relative to this block, as the reference matches
        them."""
        fp = ctx.fingerprint()
        if self._planned == fp:
            return
        ctx.place_params(self.block)
        self._planned = fp

    def _unplan(self):
        """Outside any mesh: parameters held whole again."""
        for p in self._params()[0]:
            p._unshard()
        self._planned = None

    def _sharded(self, ctx, args):
        """A call under a mesh: see the module docstring."""
        from ..sharding import dispatch
        self._sharding_plan(ctx)
        leaves, spec = _flatten(args, inputs=True)
        dev = next((x._data.device for x in leaves
                    if isinstance(x, NDArray)), None)
        in_nds = []
        for x in leaves:
            if not isinstance(x, NDArray):
                x = array(x, ctx=None if dev is None else context_of(dev))
            if not dispatch.is_sharded(x):
                lay = dispatch.Layout(ctx, ctx.batch_spec(x.shape), x.shape)
                if lay.sharded:
                    x = dispatch.shard(dispatch.cut(x._data, lay, grad=True),
                                       lay)
            in_nds.append(x)
        key = (tuple((x.shape, str(x.dtype)) for x in in_nds),
               _tape.is_training(), (), spec, ctx.fingerprint())
        with self._lock:
            if key not in self._entries:
                self._entries[key] = _Entry()
                self.compiles += 1
            self.eager_calls += 1
            return self._eager(key, spec, in_nds)

    def __call__(self, args):
        if self._dynamic:
            return self._monitor(self.block.forward(*args))
        from ..sharding import current
        ctx = current()
        if ctx is not None:
            return self._monitor(self._sharded(ctx, args))
        if self._planned is not None:
            self._unplan()
        leaves, spec = _flatten(args, inputs=True)
        dev = next((x._data.device for x in leaves
                    if isinstance(x, NDArray)), None)
        in_nds = [x if isinstance(x, NDArray) else array(
            x, ctx=None if dev is None else context_of(dev)) for x in leaves]
        params, aux = self._params()
        train_mode = _tape.is_training()
        recording = _tape.is_recording()
        # the JAX package's donation term: BatchNorm-style state is donated
        # on recorded train-mode calls under static_alloc, a key of its own
        donate = (3,) if (self.static_alloc and train_mode and recording
                          and aux) else ()
        if self.donate_inputs and not recording:
            donate += (1,)
        key = (tuple((x.shape, str(x.dtype)) for x in in_nds), train_mode,
               donate, spec)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _Entry()
                self.compiles += 1
            if not _graphs.can_capture(dev):
                out = self._eager(key, spec, in_nds)
            elif (train_mode and self._syncs()) or self._host_stop or (
                    recording and self._sparse_grads()):
                # a collective (SyncBatchNorm), a loop that stops on the
                # host (npx.while_loop, npx.cond) and a row-sparse
                # gradient (a sparse COO tensor each backward) cannot be
                # captured
                self.eager_calls += 1
                out = self._eager(key, spec, in_nds)
            elif recording:
                out = self._recorded(key, entry, spec, in_nds, params, dev)
            else:
                out = self._replay(key, entry, spec, in_nds, params, dev)
        if self.donate_inputs and not recording:
            kept = {id(o) for o in _flatten(out, inputs=False)[0]}
            _donate([x for x in leaves if id(x) not in kept])
        return self._monitor(out)

    def _syncs(self):
        """True when a block of this one runs collectives in training
        (``SyncBatchNorm`` over several processes)."""
        stack = [self.block]
        while stack:
            b = stack.pop()
            if getattr(b, 'syncs', None) is not None and b.syncs():
                return True
            stack.extend(b._children.values())
        return False

    def _sparse_grads(self):
        """True when a parameter of the block takes row-sparse gradients
        (``Embedding(sparse_grad=True)``)."""
        return any(p._grad_stype == 'row_sparse' and p.grad_req != 'null'
                   for p in self._params()[0])

    def _monitor(self, out):
        for cb in self._monitor_callbacks:
            cb(self.block, out)
        return out

    def _eager(self, key, spec, in_nds):
        try:
            if self.remat and _tape.is_recording():
                return self._checkpointed(spec, in_nds)
            with _Tracing():
                return self.block.forward(*_unflatten(spec, in_nds))
        except DynamicShapeError:
            return self._go_dynamic(key, spec, in_nds)

    def _checkpointed(self, spec, in_nds):
        """The forward under ``torch.utils.checkpoint``: its activations
        are recomputed in the backward, with the same random draws and no
        second write of the running statistics."""
        from torch.utils.checkpoint import checkpoint
        dev = in_nds[0]._data.device if in_nds else None
        gen = None if dev is None else _rng.generator(dev)
        state = None if gen is None else gen.get_state()
        out_spec, runs = [], [0]
        train = _tape.is_training()

        def run(*raws):
            again = runs[0] > 0
            runs[0] += 1
            # the recomputation runs in the backward: record it, in the
            # forward's train mode
            prev = (_tape.set_recording(True), _tape.set_training(train))
            try:
                with (_recomputing(gen, state) if again
                      else contextlib.nullcontext()), _Tracing():
                    out = self.block.forward(*_unflatten(
                        spec, [NDArray(r) for r in raws]))
            finally:
                _tape.set_recording(prev[0])
                _tape.set_training(prev[1])
            outs, spec_out = _flatten(out, inputs=False)
            out_spec[:] = [spec_out]
            return tuple(o._data for o in outs)

        raws = checkpoint(run, *[x._data for x in in_nds],
                          use_reentrant=False, preserve_rng_state=False)
        return _unflatten(out_spec[0], [NDArray(r) for r in raws])

    def _go_dynamic(self, key, spec, in_nds):
        # the reference's CachedOp with is_dynamic (cached_op.h:455): the
        # block runs op by op from now on
        self._dynamic = True
        self._entries.pop(key, None)
        warnings.warn(
            f'{type(self.block).__name__}: graph has data-dependent shapes; '
            'hybridize falls back to eager execution (reference CachedOp '
            'is_dynamic)', stacklevel=4)
        return self.block.forward(*_unflatten(spec, in_nds))

    def _stop_on_host(self, key, spec, in_nds):
        # a loop or branch decided on the host cannot be captured: this
        # call and every later one of the block run eagerly, counted
        self._host_stop = True
        self.eager_calls += 1
        return self._eager(key, spec, in_nds)

    def _no_nesting(self, dev):
        if dev.type == 'cuda' and torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f'{type(self.block).__name__}: a hybridized call inside '
                f'another CUDA graph capture; nested captures are not '
                f'supported')

    def _replay(self, key, entry, spec, in_nds, params, dev):
        leaves = tuple(p._sync() for p in params)
        if entry.graph is not None and any(
                a is not b for a, b in zip(entry.leaves, leaves)):
            entry.graph.release()       # a parameter's leaf was replaced
            entry.graph = None
        if entry.graph is None:
            return self._capture(key, entry, spec, in_nds, leaves, dev)
        for buf, x in zip(entry.inputs, in_nds):
            buf.copy_(x._data)
        outs = entry.graph.replay()
        return _unflatten(entry.out_spec, [NDArray(o.clone()) for o in outs])

    def _capture(self, key, entry, spec, in_nds, leaves, dev):
        self._no_nesting(dev)
        entry.inputs = tuple(x._data.detach().clone() for x in in_nds)

        def body():
            with _Tracing():
                out = self.block.forward(*_unflatten(
                    spec, [NDArray(t) for t in entry.inputs]))
            outs, entry.out_spec = _flatten(out, inputs=False)
            return [o._data for o in outs]

        graph = _graphs.step_graph(body, dev, _rng.graph_generators(dev))
        try:
            with _capturing():
                graph.capture(keep_warmup=True)
        except HostStopError:
            return self._stop_on_host(key, spec, in_nds)
        except DynamicShapeError:
            return self._go_dynamic(key, spec, in_nds)
        warm, graph.warmup_outputs = graph.warmup_outputs, None
        if dev.type == 'cuda':
            cur = torch.cuda.current_stream(dev)
            for t in warm:
                t.record_stream(cur)
        entry.graph, entry.leaves = graph, leaves
        self.captures += 1
        return _unflatten(entry.out_spec, [NDArray(t) for t in warm])

    def _recorded(self, key, entry, spec, in_nds, params, dev):
        """A recorded call: the key's forward and backward graphs,
        captured at its first call and replayed as one autograd node."""
        leaves = tuple(p._sync() for p in params)
        raws = [x._data for x in in_nds]
        sub = (tuple(r.requires_grad for r in raws),
               tuple(v.requires_grad for v in leaves))
        rec = entry.recorded.get(sub)
        if rec is not None and any(
                a is not b for a, b in zip(rec.leaves, leaves)):
            rec = None                  # a parameter's leaf was replaced
        if rec is None:
            return self._capture_recorded(key, entry, sub, spec, in_nds,
                                          leaves, dev)
        if rec.call.busy():
            self.eager_calls += 1
            return self._eager(key, spec, in_nds)
        outs = rec.call(raws)
        return _unflatten(rec.out[0], [NDArray(t) for t in outs])

    def _capture_recorded(self, key, entry, sub, spec, in_nds, leaves, dev):
        self._no_nesting(dev)
        out = [None]

        params = self._params()[0]

        def fn(tensors, values):
            # grad mode is off in a remat forward: record nothing there
            prev = _tape.set_recording(torch.is_grad_enabled())
            subst = contextlib.nullcontext() if values is None else \
                substituted({id(p): NDArray(v)
                             for p, v in zip(params, values)})
            try:
                with subst, _Tracing():
                    res = self.block.forward(*_unflatten(
                        spec, [NDArray(t) for t in tensors]))
            finally:
                _tape.set_recording(prev)
            outs, out[0] = _flatten(res, inputs=False)
            return [o._data for o in outs]

        call = _graphs.GraphedCall(fn, leaves, dev,
                                   _rng.graph_generators(dev),
                                   remat=self.remat, recompute=_recomputing)
        try:
            with _capturing():
                warm = call.first_call([x._data for x in in_nds])
        except HostStopError:
            return self._stop_on_host(key, spec, in_nds)
        except DynamicShapeError:
            return self._go_dynamic(key, spec, in_nds)
        entry.recorded[sub] = _Recorded(call, leaves, out)
        self.captures += call.captures
        return _unflatten(out[0], [NDArray(t) for t in warm])


class HybridBlock(Block):
    """Reference gluon/block.py:859: a Block that ``hybridize()`` caches
    (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._cached_graph = None
        self._first_forward_done = False

    def hybridize(self, active=True, backend=None, backend_opts=None,
                  static_alloc=True, static_shape=False, inline_limit=2,
                  forward_bulk_size=None, backward_bulk_size=None,
                  remat=False, check=False, donate_inputs=False, **kwargs):
        """Reference block.py:1217. ``remat=True`` recomputes the forward's
        activations in the backward instead of keeping them (the
        reference's backward mirroring, as a per-block switch; see the
        module docstring). ``backend`` is kept and the whole graph
        captured, as the JAX package keeps it;
        ``donate_inputs`` donates the inputs of every call that is not
        recorded (see the module docstring). ``check`` waits with the
        analysis rules (ROADMAP A11) and raises."""
        if check:
            _pending('hybridize(check=True)')
        self._clear_cache()
        self._active = active
        self._cached_graph = _CachedGraph(
            self, static_alloc=static_alloc, remat=remat, backend=backend,
            donate_inputs=donate_inputs) if active else None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cache(self):
        if self._cached_graph is not None:
            self._cached_graph.clear()

    def optimize_for(self, x, *args, backend=None, clear=True, **kwargs):
        """Reference block.py:1038, partition for a backend: the port
        captures the whole forward as CUDA graphs, so this hybridizes and
        calls, as the JAX package does."""
        self.hybridize(True)
        return self(x, *args)

    def pure_function(self, *args, train=False):
        """This block's forward as a function of explicit tensors (JAX
        ``block.py:758-786``), for training loops built outside the
        Trainer, such as K steps captured as one CUDA graph.

        Returns ``(fn, in_tensors, main_tensors, aux_tensors)``:
        ``main_tensors`` are copies of the trained parameters (``grad_req``
        not ``'null'``), ``aux_tensors`` of the rest (BatchNorm's running
        statistics), in ``collect_params()`` order. ``fn(generator, ins,
        mains, auxs) -> (outs, new_auxs)`` runs the forward with those
        tensors in place of the parameters, in train mode if ``train``,
        drawing random numbers from ``generator`` (a ``torch.Generator``,
        the counterpart of the JAX ``rng_key``; None for the device's).
        It writes no parameter: the new running statistics come back as
        ``new_auxs`` (unchanged without ``train``). Gradients flow to the
        ``mains`` that require grad (``torch.autograd.grad``)."""
        if not isinstance(self._cached_graph, _CachedGraph):
            self.hybridize(True)
        if not self._first_forward_done:
            self(*args)             # materialize deferred parameters
        leaves, spec = _flatten(args, inputs=True)
        in_tensors = tuple(x._data if isinstance(x, NDArray)
                           else array(x)._data for x in leaves)
        params = self._cached_graph._params()[0]
        main = [p for p in params if p.grad_req != 'null']
        aux = [p for p in params if p.grad_req == 'null']

        def fn(generator, ins, mains, auxs):
            values = {id(p): NDArray(t) for p, t in
                      zip(main + aux, list(mains) + list(auxs))}
            prev_writes = getattr(_BLOCK_TRACE, 'aux_writes', None)
            _BLOCK_TRACE.aux_writes = writes = {}
            prev_rec = _tape.set_recording(True)
            prev_train = _tape.set_training(train)
            try:
                with substituted(values), (
                        _rng.drawing_from(generator) if generator is not None
                        else contextlib.nullcontext()), _Tracing():
                    out = self.forward(*_unflatten(
                        spec, [NDArray(t) for t in ins]))
            finally:
                _BLOCK_TRACE.aux_writes = prev_writes
                _tape.set_recording(prev_rec)
                _tape.set_training(prev_train)
            outs, _ = _flatten(out, inputs=False)
            return (tuple(o._data for o in outs),
                    tuple(writes.get(id(p), t) for p, t in zip(aux, auxs)))

        def copy(p):
            return p.data()._data.detach().clone()

        return (fn, in_tensors, tuple(copy(p) for p in main),
                tuple(copy(p) for p in aux))

    def prewarm(self, input_specs, dtype='float32'):
        """Build the keys of declared input shapes before they see traffic
        (JAX ``block.py:794-829``): one call that is not recorded for each
        entry of ``input_specs`` (a shape for a one-input block, a
        ``(shape, dtype)`` pair, or a tuple of shapes), on zeros of the
        current context, whose output is dropped. On a card each new key
        is captured. Returns the number of new keys."""
        before = self.compile_count
        for spec in input_specs:
            d = dtype
            if (isinstance(spec, tuple) and len(spec) == 2
                    and isinstance(spec[0], tuple)
                    and isinstance(spec[1], str)):
                spec, d = spec
            if isinstance(spec, tuple) and spec \
                    and isinstance(spec[0], tuple):
                shapes = spec
            else:
                shapes = (tuple(spec),)
            args = [array(_np.zeros(s, dtype=_np.dtype(d))) for s in shapes]
            prev = _tape.set_recording(False)
            try:
                first = not self._first_forward_done
                self(*args)
                if first:
                    # the first call runs eagerly and builds no key: call
                    # again so that this shape is warm
                    self(*args)
            finally:
                _tape.set_recording(prev)
        return self.compile_count - before

    def register_op_hook(self, callback, monitor_all=False):
        """``callback(block, out)`` after each cached call of this block
        (reference cached_op.cc:1212 RegisterOpHook; a whole-graph monitor,
        as in the JAX package). A later ``hybridize()`` drops it."""
        if self._cached_graph is not None:
            self._cached_graph._monitor_callbacks.append(callback)

    @property
    def compile_count(self):
        own = self._cached_graph.compiles if self._cached_graph else 0
        return own + sum(c.compile_count for c in self._children.values())

    @property
    def capture_count(self):
        """CUDA graphs this block's cache captured since its last
        ``hybridize()``: one for each key's calls that are not recorded,
        two (forward, backward) for its recorded calls (0 on the CPU)."""
        return self._cached_graph.captures if self._cached_graph else 0

    @property
    def eager_call_count(self):
        """Calls run eagerly on the card: recorded calls whose key's replay
        still waited for its backward, and training-mode calls of a block
        that runs collectives (see the module docstring)."""
        return self._cached_graph.eager_calls if self._cached_graph else 0

    def infer_shape(self, *args):
        """Reference block.py:1278: resolve deferred parameter shapes from
        the inputs by abstract evaluation, the forward on meta tensors of
        the inputs' shapes and dtypes (no FLOP runs; the parameters are
        initialized on their own contexts as their shapes become known).
        A forward whose shapes depend on its data (``DynamicShapeError``)
        runs once on ``args`` instead, unrecorded."""
        metas = [NDArray(_dc.meta_like(a.shape, a._data.dtype))
                 if isinstance(a, NDArray) else a for a in args]
        try:
            with pause():
                try:
                    with _dc.abstract():
                        self.forward(*metas)
                except DynamicShapeError:
                    self.forward(*args)
        except DeferredInitializationError:
            pass

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        d = self.__dict__     # plain attributes: no registration to do
        if args and all(isinstance(a, NDArray) for a in args):
            d['_last_in_specs'] = [(a.shape, a._data.dtype) for a in args]
        if _dc.is_deferred_compute():
            # a capture records the forward's ops, never a graph replay
            out = self.forward(*args, **kwargs)
            for hook in self._forward_hooks:
                hook(self, args, out)
            return out
        if self._active and not self._first_forward_done and \
                not is_tracing() and not kwargs:
            from ..sharding import current
            if current() is not None:
                # a sharded first call: deferred shapes resolve on an
                # unrecorded whole forward, then the call is sharded
                if any(p._var is None
                       for p in self.collect_params().values()):
                    with current_unsharded():
                        self.infer_shape(*args)
                self._first_forward_done = True
        if self._active and self._first_forward_done and not is_tracing() \
                and not _stream_capturing():
            if kwargs:
                raise ValueError(
                    'keyword arguments are not supported when a HybridBlock '
                    'is hybridized (reference block.py raises the same); '
                    'pass them positionally or call hybridize(False)')
            out = self._cached_graph(args)
        else:
            out = self.forward(*args, **kwargs)
            d['_first_forward_done'] = True
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args, **kwargs):
        if hasattr(self, 'hybrid_forward'):
            # the legacy hybrid_forward(F, x, **params) protocol
            from .. import ndarray as F
            pdata = {name: p.data() for name, p in self._reg_params.items()}
            return self.hybrid_forward(F, *args, **pdata)
        raise NotImplementedError(
            f'{type(self).__name__} must implement forward')

    def _trace_device(self, args):
        """Where a trace makes its concrete arrays (constants, fresh
        creations): the parameters' context, else the inputs', else the
        current one."""
        for p in self.collect_params().values():
            if p._var is not None:
                return context_of(p._var.device)
        for a in args:
            if isinstance(a, NDArray) and not a._data.is_meta:
                return a.context
        return None

    def _trace_symbol(self, *args):
        """The inference-mode forward as a Symbol, captured by deferred
        compute (the reference's ``_get_graph_v2``, block.py:959).

        ``args``: example NDArrays or shape tuples (float32) of the data
        inputs, named ``data`` (one) or ``data0``, ``data1``, ... The
        parameters become variables named by their structural names, so
        the params file's keys match ``list_arguments()``. Abstract: the
        inputs and parameters are meta tensors inside the trace."""
        in_specs = [(a.shape, a._data.dtype) if isinstance(a, NDArray)
                    else (tuple(a), 'float32') for a in args]
        in_names = ['data'] if len(args) == 1 else \
            [f'data{i}' for i in range(len(args))]
        p_items = list(self.collect_params().items())
        for name, p in p_items:
            if p._var is None:
                raise DeferredInitializationError(
                    f'Parameter {name} is not initialized: run a forward '
                    f'before exporting')
        where = self._trace_device(args)
        prev_rec = _tape.set_recording(False)
        prev_train = _tape.set_training(False)
        prev_aux = getattr(_BLOCK_TRACE, 'aux_writes', None)
        _BLOCK_TRACE.aux_writes = {}
        try:
            with (where if where is not None else contextlib.nullcontext()), \
                    _dc.abstract(), _dc.context():
                nds = [NDArray(_dc.meta_like(shp, dt)) for shp, dt in in_specs]
                _dc.set_variable(nds, in_names)
                values = {}
                for name, p in p_items:
                    nd = NDArray(_dc.meta_like(p.shape, p._var.dtype))
                    _dc.set_variable(nd, name)
                    values[id(p)] = nd
                with substituted(values):
                    out = self.forward(*nds)
                outs = out if isinstance(out, (list, tuple)) else [out]
                return _dc.get_symbol(list(outs))
        finally:
            _tape.set_recording(prev_rec)
            _tape.set_training(prev_train)
            _BLOCK_TRACE.aux_writes = prev_aux

    def export(self, path, epoch=0, remove_amp_cast=True, input_shapes=None):
        """Reference block.py:1299: the graph and the parameters for
        deployment, ``{path}-symbol.json`` (loaded back by
        :meth:`SymbolBlock.imports`) and ``{path}-{epoch:04d}.params.npz``
        (hoisted constants beside the weights). The input shapes are the
        last call's, or ``input_shapes=[...]`` (NDArrays or shape
        tuples). Returns the two paths."""
        from ..model import save_ndarray_map
        if input_shapes is None:
            specs = getattr(self, '_last_in_specs', None)
            if not specs:
                raise ValueError(
                    'export() needs input shapes: run a forward first, or '
                    'pass input_shapes=[...] (the reference has the same '
                    'run-before-export requirement, block.py:1299)')
            args = [NDArray(_dc.meta_like(shp, dt)) for shp, dt in specs]
        else:
            args = list(input_shapes)
        sym = self._trace_symbol(*args)
        opaque = sorted({n.attrs['__opaque_name__'] for n in sym._topo()
                         if n.op == '_opaque'})
        if opaque:
            raise MXNetError(
                f'{type(self).__name__}: the graph holds closure-based ops '
                f'{opaque}, which do not serialize to a symbol file; their '
                f'StableHLO-style export waits with gluon/rnn (ROADMAP A11)')
        param_path = f'{path}-{epoch:04d}.params.npz'
        data = {k: v.data() for k, v in self.collect_params().items()}
        data.update(sym._aux)
        save_ndarray_map(param_path, data)
        sym.save(f'{path}-symbol.json', remove_amp_cast)
        return f'{path}-symbol.json', param_path


class SymbolBlock(HybridBlock):
    """A Symbol run as a block (reference block.py:1485).

    Every variable of the symbol that is not an input becomes a
    :class:`Parameter` of its ``__shape__``/``__dtype__``, set from
    ``params`` (name -> NDArray or array) or from the symbol's hoisted
    constants, else initialized as any parameter. ``forward`` replays the
    graph through the op registry, so autograd, ``hybridize()`` (one
    capture a key, then replays) and the Trainer work on an imported
    model."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__()
        from ..symbol.symbol import Group, Symbol
        if not isinstance(outputs, Symbol):
            outputs = Group(list(outputs))
        self._sym = outputs
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._input_names = [i if isinstance(i, str) else i.name
                             for i in inputs]
        shape_attrs = {n.name: (n.attrs.get('__shape__'),
                                n.attrs.get('__dtype__', 'float32'))
                       for n in self._sym._topo() if n.op == 'null'}
        self._sym_param_names = [n for n in self._sym.list_arguments()
                                 if n not in self._input_names]
        # a traced symbol's hoisted constants are parameters too
        params = dict(outputs._aux, **(params or {}))
        for name in self._sym_param_names:
            shape, dtype = shape_attrs.get(name, (None, 'float32'))
            p = Parameter(name, shape=shape, dtype=dtype,
                          allow_deferred_init=True)
            if name in params:
                v = params[name]
                if not isinstance(v, NDArray):
                    v = array(v)
                p.dtype = str(v.dtype)
                p.set_data(v)
            self._reg_params[name] = p

    @staticmethod
    def imports(symbol_file, input_names='data', param_file=None, ctx=None):
        """Load an exported model (reference SymbolBlock.imports): its
        parameters on ``ctx``, the current context by default."""
        from ..model import load_ndarray_map
        from ..symbol import load as sym_load
        sym = sym_load(symbol_file)
        params = load_ndarray_map(param_file, ctx=ctx) if param_file else {}
        if isinstance(input_names, str):
            input_names = [input_names]
        return SymbolBlock(sym, list(input_names), params=params)

    def forward(self, *args):
        bindings = {}
        for name, a in zip(self._input_names, args):
            bindings[name] = a if isinstance(a, NDArray) else array(a)
        for name in self._sym_param_names:
            bindings[name] = self._reg_params[name].data()
        outs = self._sym._execute(bindings)
        return outs[0] if len(outs) == 1 else tuple(outs)
