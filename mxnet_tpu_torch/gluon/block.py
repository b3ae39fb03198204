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
``jax.jit``; here:

* a call in predict mode (not recording, not training) on a CUDA device
  captures the forward once per key as a CUDA graph
  (``_graphs.StepGraph``) and replays it: the inputs are copied into the
  graph's static buffers, and the outputs are cloned out of its output
  tensors, which the next replay overwrites, since NDArrays have value
  semantics. ``compile_count`` counts keys, and a key's graph is captured
  once, again only if a parameter's leaf was replaced (``cast``,
  ``reset_ctx``), since a graph reads the weights at their addresses;
* a recorded or train-mode call runs the forward eagerly under
  ``torch.autograd``, keyed and counted the same way (graphed training
  steps are ROADMAP A5 rest);
* on the CPU every call runs eagerly; a key's first call is its compile,
  so the keying can be held against the JAX package's.

As in the reference, the first call after ``hybridize()`` on a block
that never ran runs eagerly (deferred initialization finishes before any
capture), hybridized children run inline inside a parent's cached call,
keyword arguments to a hybridized call raise, and an op with a
data-dependent output shape switches the block to eager calls with a
warning. Every write of a parameter is in place (``Parameter.set_data``,
the Trainer's update, BatchNorm's running statistics), so a replay sees
it.

Not ported (ROADMAP A5 rest): ``SymbolBlock``, ``export``,
``pure_function``, ``prewarm``, ``register_op_hook``, ``optimize_for``
beyond hybridize-and-call, and ``hybridize``'s ``check``/``remat``/
``donate_inputs``, which raise.
"""

import re
import threading
import warnings

import torch

from .. import _tape
from ..autograd import pause
from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray, array, context_of
from ..ops.registry import DynamicShapeError
from .parameter import DeferredInitializationError, Parameter

__all__ = ['Block', 'HybridBlock', 'ParameterDict', 'is_tracing',
           'record_aux_update']

_BLOCK_TRACE = threading.local()


def is_tracing():
    """True inside a hybridized block's cached call: children run inline
    there, and an op with a data-dependent output shape raises
    ``DynamicShapeError``."""
    return getattr(_BLOCK_TRACE, 'depth', 0) > 0


class _Tracing:
    def __enter__(self):
        _BLOCK_TRACE.depth = getattr(_BLOCK_TRACE, 'depth', 0) + 1

    def __exit__(self, *exc):
        _BLOCK_TRACE.depth -= 1


def record_aux_update(param, value):
    """Write an auxiliary state (BatchNorm's running statistics) into the
    parameter's leaf in place, so that a captured graph and every later
    call read the new value (the JAX package rebinds eagerly and returns
    the value from a compiled graph)."""
    raw = value._data if isinstance(value, NDArray) else value
    var = param._sync()
    with torch.no_grad():
        var.copy_(raw.detach())


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
    raise NotImplementedError(f'{what} is not ported yet (ROADMAP A5 rest)')


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
    """One key of a :class:`_CachedGraph`: its CUDA graph (predict mode on
    a card), the leaves it captured, its static input buffers and its
    output tree."""

    __slots__ = ('graph', 'leaves', 'inputs', 'out_spec')

    def __init__(self):
        self.graph = None
        self.leaves = ()
        self.inputs = ()
        self.out_spec = None


class _CachedGraph:
    """The cache of one hybridized block (the role of CachedOp, reference
    src/imperative/cached_op.h:463); see the module docstring."""

    def __init__(self, block, static_alloc=True):
        self.block = block
        self.static_alloc = static_alloc
        self.compiles = 0   # keys built
        self.captures = 0   # CUDA graphs captured
        self._entries = {}
        self._param_order = None
        self._dynamic = False
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

    def __call__(self, args):
        if self._dynamic:
            return self.block.forward(*args)
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
        key = (tuple((x.shape, str(x.dtype)) for x in in_nds), train_mode,
               donate, spec)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _Entry()
                self.compiles += 1
            if recording or train_mode or dev is None or dev.type != 'cuda':
                return self._eager(key, spec, in_nds)
            return self._replay(key, entry, spec, in_nds, params, dev)

    def _eager(self, key, spec, in_nds):
        try:
            with _Tracing():
                return self.block.forward(*_unflatten(spec, in_nds))
        except DynamicShapeError:
            return self._go_dynamic(key, spec, in_nds)

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
        from .._graphs import StepGraph
        if torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f'{type(self.block).__name__}: a hybridized call inside '
                f'another CUDA graph capture; nested captures are not '
                f'supported')
        entry.inputs = tuple(x._data.detach().clone() for x in in_nds)

        def body():
            with _Tracing():
                out = self.block.forward(*_unflatten(
                    spec, [NDArray(t) for t in entry.inputs]))
            outs, entry.out_spec = _flatten(out, inputs=False)
            return [o._data for o in outs]

        graph = StepGraph(body, dev)
        try:
            graph.capture(keep_warmup=True)
        except DynamicShapeError:
            return self._go_dynamic(key, spec, in_nds)
        warm, graph.warmup_outputs = graph.warmup_outputs, None
        cur = torch.cuda.current_stream(dev)
        for t in warm:
            t.record_stream(cur)
        entry.graph, entry.leaves = graph, leaves
        self.captures += 1
        return _unflatten(entry.out_spec, [NDArray(t) for t in warm])


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
        """Reference block.py:1217. ``backend``, ``remat``, ``check`` and
        ``donate_inputs`` are not ported (ROADMAP A5 rest)."""
        for flag, what in ((backend, 'backend='), (remat, 'remat=True'),
                           (check, 'check=True'),
                           (donate_inputs, 'donate_inputs=True')):
            if flag:
                _pending(f'hybridize({what})')
        self._clear_cache()
        self._active = active
        self._cached_graph = _CachedGraph(
            self, static_alloc=static_alloc) if active else None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cache(self):
        if self._cached_graph is not None:
            self._cached_graph.clear()

    def optimize_for(self, x, *args, backend=None, clear=True, **kwargs):
        """Reference block.py:1038: hybridize and call."""
        if backend is not None:
            _pending(f'optimize_for(backend={backend!r})')
        self.hybridize(True)
        return self(x, *args)

    @property
    def compile_count(self):
        own = self._cached_graph.compiles if self._cached_graph else 0
        return own + sum(c.compile_count for c in self._children.values())

    @property
    def capture_count(self):
        """CUDA graphs this block's cache captured since its last
        ``hybridize()`` (0 on the CPU)."""
        return self._cached_graph.captures if self._cached_graph else 0

    def infer_shape(self, *args):
        """Reference block.py:1278: resolve deferred parameter shapes from
        the inputs. The port has no abstract evaluation: the forward runs
        once on ``args``, unrecorded, and its output is dropped."""
        try:
            with pause():
                self.forward(*args)
        except DeferredInitializationError:
            pass

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        if self._active and self._first_forward_done and not is_tracing():
            if kwargs:
                raise ValueError(
                    'keyword arguments are not supported when a HybridBlock '
                    'is hybridized (reference block.py raises the same); '
                    'pass them positionally or call hybridize(False)')
            out = self._cached_graph(args)
        else:
            out = self.forward(*args, **kwargs)
            self._first_forward_done = True
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
