"""Symbol: composable, serializable computation graphs.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (reference
``python/mxnet/symbol/symbol.py``: compose, infer_shape, tojson; backed
in C++ by nnvm ``Node``/``NodeEntry``/``Graph``). A Symbol is a light DAG
over the same op registry the imperative frontend uses
(:mod:`..ops.registry`): execution binds the variables to NDArrays and
replays each node through ``registry.invoke``, so autograd, hybridize's
CUDA graphs and the kernels' wrappers all work on a symbol's execution,
with no second executor. It runs on its bindings' context (their device,
else ``ctx``, else the current context), which the replayed creation ops
make their arrays on.

The file is the JAX package's, byte for byte where the graph is the same:
a JSON node list tagged ``"format": "mxnet_tpu-symbol-v1"`` with
``nodes``, ``arg_nodes`` and ``heads`` and the typed attribute codec of
:func:`_attr_to_json`, so a symbol either package writes loads and runs
in the other. Node names of ops come from a process-wide counter
(:func:`_auto_name`), so two traces of one net differ in them only.

``infer_shape``/``infer_type`` evaluate the graph abstractly, on meta
tensors (:mod:`.._deferred_compute`), where the JAX package uses
``jax.eval_shape``: no FLOP runs.
"""

import itertools
import json
import threading

import numpy as _np

_JSON_VERSION = 'mxnet_tpu-symbol-v1'

_name_lock = threading.Lock()
_name_counts = {}


def _auto_name(op):
    base = op.lstrip('_').replace('.', '_') or 'op'
    with _name_lock:
        n = _name_counts.get(base, 0)
        _name_counts[base] = n + 1
    return f'{base}{n}'


class _SymNode:
    """One graph node (≙ nnvm::Node). ``op`` is a registry op name, 'null'
    for variables, or '_constant' for embedded literals."""

    __slots__ = ('op', 'name', 'args_spec', 'kwargs', 'inputs', 'attrs',
                 'n_out', 'uid')
    _counter = itertools.count()

    def __init__(self, op, name, args_spec, kwargs, inputs, attrs=None):
        self.op = op
        self.name = name if name is not None else _auto_name(op)
        self.args_spec = args_spec
        self.kwargs = kwargs or {}
        self.inputs = inputs            # list of (node, out_index)
        self.attrs = attrs or {}
        self.n_out = 1
        self.uid = next(_SymNode._counter)


# --------------------------------------------------------------- attr codec

def _attr_to_json(v):
    if isinstance(v, _np.dtype):
        return {'__dtype__': v.name}
    if isinstance(v, slice):
        return {'__slice__': [v.start, v.stop, v.step]}
    if v is Ellipsis:
        return {'__ellipsis__': True}
    if isinstance(v, tuple):
        return {'__tuple__': [_attr_to_json(e) for e in v]}
    if isinstance(v, list):
        return [_attr_to_json(e) for e in v]
    if isinstance(v, dict):
        if '__arr__' in v:
            return dict(v)
        return {'__dict__': {k: _attr_to_json(e) for k, e in v.items()}}
    if isinstance(v, _np.generic):
        return v.item()
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if callable(v):
        raise TypeError(
            f'cannot serialize callable attr {v!r}; symbols must be built '
            'from registry ops with static attrs')
    return str(v)


def _attr_from_json(v):
    if isinstance(v, dict):
        if '__dtype__' in v:
            return _np.dtype(v['__dtype__'])
        if '__slice__' in v:
            return slice(*v['__slice__'])
        if '__ellipsis__' in v:
            return Ellipsis
        if '__tuple__' in v:
            return tuple(_attr_from_json(e) for e in v['__tuple__'])
        if '__arr__' in v:
            return dict(v)
        if '__dict__' in v:
            return {k: _attr_from_json(e) for k, e in v['__dict__'].items()}
        return v
    if isinstance(v, list):
        return [_attr_from_json(e) for e in v]
    return v


class Symbol:
    """A set of output entries over a shared DAG (≙ nnvm::Symbol)."""

    __array_priority__ = 1000.0

    def __init__(self, outputs):
        self._outputs = list(outputs)   # list of (node, out_index)
        # big captured constants (name -> NDArray); saved beside params by
        # export(), merged into eval bindings here
        self._aux = {}

    # ------------------------------------------------------------- structure
    @property
    def name(self):
        return self._outputs[0][0].name

    def attr(self, key):
        return self._outputs[0][0].attrs.get(key)

    def attr_dict(self):
        return {n.name: {k: str(v) for k, v in n.attrs.items()}
                for n in self._topo()}

    def _topo(self):
        """Reachable nodes in deterministic topological (creation) order."""
        seen = {}
        stack = [n for n, _ in self._outputs]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen[id(node)] = node
            stack.extend(n for n, _ in node.inputs)
        return sorted(seen.values(), key=lambda n: n.uid)

    def list_arguments(self):
        """Names of free variables (reference symbol.py list_arguments)."""
        return [n.name for n in self._topo() if n.op == 'null']

    def list_inputs(self):
        return self.list_arguments()

    def list_outputs(self):
        return [f'{n.name}_output{i}' if n.n_out > 1 else f'{n.name}_output'
                for n, i in self._outputs]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo()
                if n.op == 'null' and n.attrs.get('__aux__')]

    def _derive(self, outputs):
        s = Symbol(outputs)
        s._aux.update(self._aux)
        return s

    def get_internals(self):
        return self._derive([(n, i) for n in self._topo() if n.op != 'null'
                             for i in range(n.n_out)])

    def get_children(self):
        ins = []
        for n, _ in self._outputs:
            ins.extend(n.inputs)
        return self._derive(ins) if ins else None

    @property
    def num_outputs(self):
        return len(self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            for n in self._topo():
                for i in range(n.n_out):
                    tag = f'{n.name}_output{i}' if n.n_out > 1 \
                        else f'{n.name}_output'
                    if tag == idx or n.name == idx:
                        return self._derive([(n, i)])
            raise KeyError(idx)
        if isinstance(idx, slice):
            return self._derive(self._outputs[idx])
        return self._derive([self._outputs[idx]])

    def __iter__(self):
        return (self._derive([e]) for e in self._outputs)

    def __repr__(self):
        return f'<Symbol {self.name}>'

    # -------------------------------------------------------------- compose
    def compose(self, **kwargs):
        """Substitute named variables with other symbols (nnvm compose)."""
        mapping = {}
        for n in self._topo():
            if n.op == 'null' and n.name in kwargs:
                ent = kwargs[n.name]._outputs[0]
                mapping[id(n)] = ent
        memo = {}
        out = self._derive([_remap(n, i, mapping, memo)
                            for n, i in self._outputs])
        for sub in kwargs.values():        # carry captured-constant bindings
            out._aux.update(sub._aux)
        return out

    __call__ = compose

    # ------------------------------------------------------------ execution
    def _device(self, bindings, ctx=None):
        """The device a replay runs on: the first bound NDArray's, else
        ``ctx``'s, else the current context's."""
        from ..context import resolve_device
        from ..ndarray.ndarray import NDArray
        for v in bindings.values():
            if isinstance(v, NDArray):
                return v._data.device
        return resolve_device(ctx)

    def _execute(self, bindings, default=None, tap=None, ctx=None):
        """Replay through ``registry.invoke``. ``bindings``: name ->
        NDArray (or array-like, made on the replay's device).
        ``tap(node, outputs)`` is called after each node."""
        from ..ndarray.ndarray import NDArray, array, context_of
        from ..ops.registry import Op, apply_op, get_op, invoke

        dev = self._device(bindings, ctx)
        where = context_of(dev)
        values = {}   # id(node) -> tuple of NDArray outputs

        def subst(spec, node):
            if isinstance(spec, dict) and '__arr__' in spec:
                n, i = node.inputs[spec['__arr__']]
                return values[id(n)][i]
            if isinstance(spec, list):
                return [subst(e, node) for e in spec]
            return spec

        with where:
            for node in self._topo():
                if node.op == 'null':
                    if node.name in bindings:
                        v = bindings[node.name]
                    elif default is not None:
                        v = default(node)
                    else:
                        raise ValueError(
                            f'unbound symbol variable {node.name!r}')
                    if not isinstance(v, NDArray):
                        v = array(v, ctx=where)
                    values[id(node)] = (v,)
                elif node.op == '_opaque':
                    ins = [values[id(n)][i] for n, i in node.inputs]
                    fn = node.attrs['__opaque_fn__']
                    res = apply_op(Op(node.attrs['__opaque_name__'], fn),
                                   ins, fn)
                    values[id(node)] = res if isinstance(res, tuple) \
                        else (res,)
                elif node.op == '_constant':
                    values[id(node)] = (array(
                        _np.asarray(node.kwargs['value'],
                                    dtype=node.kwargs.get('dtype',
                                                          'float32')),
                        ctx=where),)
                else:
                    op = get_op(node.op)
                    args = [subst(s, node) for s in (node.args_spec or [])]
                    kwargs = {k: subst(v, node)
                              for k, v in node.kwargs.items()}
                    res = invoke(op, tuple(args), kwargs)
                    values[id(node)] = res if isinstance(res, tuple) \
                        else (res,)
                if tap is not None:
                    tap(node, values[id(node)])
        return [values[id(n)][i] for n, i in self._outputs]

    def eval(self, ctx=None, **kwargs):
        """Evaluate with variable bindings: a list of NDArrays (reference
        symbol.py eval), on ``ctx`` when no binding is an NDArray."""
        return self._execute({**self._aux, **kwargs}, ctx=ctx)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req='write',
             aux_states=None, **kwargs):
        """Legacy executor surface (reference executor.py wrapper)."""
        return Executor(self, ctx, args or {}, args_grad, grad_req)

    # the 2.x path: Symbol → runnable block
    def simple_bind(self, ctx=None, grad_req='write', **shapes):
        from ..ndarray.ndarray import array
        args = {}
        a_shapes, _, _ = self.infer_shape(**shapes)
        for name, shp in zip(self.list_arguments(), a_shapes):
            args[name] = array(_np.zeros(shp, dtype=_np.float32), ctx=ctx)
        return Executor(self, ctx, args, None, grad_req)

    # ------------------------------------------------------------- inference
    def _positional_given(self, args, kwargs):
        if not args:
            return kwargs
        if kwargs:
            raise ValueError('pass shapes positionally or by name, not both')
        return dict(zip(self.list_arguments(), args))

    def infer_shape(self, *args, **kwargs):
        return self._infer(self._positional_given(args, kwargs),
                           want='shape')

    def infer_type(self, *args, **kwargs):
        return self._infer(self._positional_given(args, kwargs),
                           want='dtype')

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self._infer(kwargs, want='shape')
        except Exception:
            return (None, None, None)

    def _infer(self, given, want):
        """Evaluate the graph abstractly on meta tensors (the role of the
        reference's InferShape/InferType passes, exec_pass.h:238,251)."""
        from .. import _deferred_compute as _dc
        from ..context import abstract_context
        from ..ndarray.ndarray import NDArray

        arg_names = self.list_arguments()
        specs = {}
        for n in self._topo():
            if n.op != 'null':
                continue
            if want == 'shape' and n.name in given:
                specs[n.name] = (tuple(given[n.name]),
                                 _np.dtype(n.attrs.get('__dtype__',
                                                       'float32')))
            elif want == 'dtype' and n.name in given:
                specs[n.name] = (tuple(n.attrs.get('__shape__', ())),
                                 _np.dtype(given[n.name]))
            elif '__shape__' in n.attrs:
                specs[n.name] = (tuple(n.attrs['__shape__']),
                                 _np.dtype(n.attrs.get('__dtype__',
                                                       'float32')))
            else:
                raise ValueError(
                    f'insufficient information to infer {want} for variable '
                    f'{n.name!r}')

        with _dc.abstract():
            out = self._execute(
                {nm: NDArray(_dc.meta_like(shp, dt))
                 for nm, (shp, dt) in specs.items()},
                ctx=abstract_context())
        if want == 'shape':
            return ([specs[nm][0] for nm in arg_names],
                    [tuple(o.shape) for o in out], [])
        return ([specs[nm][1] for nm in arg_names],
                [_np.dtype(o.dtype) for o in out], [])

    # ---------------------------------------------------------- serialization
    def tojson(self, remove_amp_cast=True):
        sym = self._strip_amp_cast() if remove_amp_cast else self
        nodes = sym._topo()
        return sym._tojson_nodes(nodes)

    def _strip_amp_cast(self):
        """Drop amp_cast nodes (reference remove_amp_cast semantics:
        the saved JSON is the clean fp32 graph; the AMP rewrite is a
        runtime optimization, not part of the model definition)."""
        if not any(n.op in ('amp_cast', 'amp_multicast')
                   for n in self._topo()):
            return self

        def resolve(entry):
            node, idx = entry
            while node.op in ('amp_cast', 'amp_multicast'):
                node, idx = node.inputs[idx if node.op == 'amp_multicast'
                                        else 0]
            return (node, idx)

        clones = {}
        for node in self._topo():
            if node.op in ('null', 'amp_cast', 'amp_multicast'):
                clones[id(node)] = node
                continue
            new_inputs = []
            for e in node.inputs:
                n2, i2 = resolve(e)
                n2 = clones.get(id(n2), n2)
                new_inputs.append((n2, i2))
            new = _SymNode(node.op, node.name, node.args_spec,
                           dict(node.kwargs), new_inputs,
                           dict(node.attrs))
            new.n_out = node.n_out
            clones[id(node)] = new
        out = Symbol([(clones.get(id(n), n), i)
                      for n, i in map(resolve, self._outputs)])
        out._aux = dict(self._aux)
        return out

    def _tojson_nodes(self, nodes):
        opaque = [n.attrs['__opaque_name__'] for n in nodes
                  if n.op == '_opaque']
        if opaque:
            raise ValueError(
                'symbol contains closure-based op(s) that cannot be '
                f'serialized: {sorted(set(opaque))}; only registry ops with '
                'static attrs export to JSON (use StableHLO export for '
                'models containing these layers)')
        index = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            rec = {'op': n.op, 'name': n.name,
                   'inputs': [[index[id(m)], i] for m, i in n.inputs]}
            if n.args_spec is not None:
                rec['args_spec'] = [_attr_to_json(s) for s in n.args_spec]
            if n.kwargs:
                rec['attrs'] = {k: _attr_to_json(v)
                                for k, v in n.kwargs.items()}
            if n.attrs:
                rec['node_attrs'] = {k: _attr_to_json(v)
                                     for k, v in n.attrs.items()}
            if n.n_out != 1:
                rec['num_outputs'] = n.n_out
            out_nodes.append(rec)
        return json.dumps({
            'format': _JSON_VERSION,
            'nodes': out_nodes,
            'arg_nodes': [i for i, n in enumerate(nodes) if n.op == 'null'],
            'heads': [[index[id(n)], i] for n, i in self._outputs],
        }, indent=2)

    def save(self, fname, remove_amp_cast=True):
        with open(fname, 'w') as f:
            f.write(self.tojson(remove_amp_cast))

    @staticmethod
    def fromjson(json_str):
        data = json.loads(json_str)
        if data.get('format') != _JSON_VERSION:
            raise ValueError(
                f"unsupported symbol json format {data.get('format')!r}")
        nodes = []
        for rec in data['nodes']:
            node = _SymNode(
                rec['op'], rec['name'],
                ([_attr_from_json(s) for s in rec['args_spec']]
                 if 'args_spec' in rec else None),
                {k: _attr_from_json(v)
                 for k, v in rec.get('attrs', {}).items()},
                [(nodes[i], j) for i, j in rec['inputs']],
                attrs={k: _attr_from_json(v)
                       for k, v in rec.get('node_attrs', {}).items()})
            node.n_out = rec.get('num_outputs', 1)
            nodes.append(node)
        return Symbol([(nodes[i], j) for i, j in data['heads']])

    def optimize_for(self, backend=None, args=None, aux=None, ctx=None,
                     **kwargs):
        """Reference symbol.py optimize_for, the partition hook: the port
        partitions nothing (a hybridized ``SymbolBlock`` captures the
        whole replay as CUDA graphs), so it returns the symbol itself, as
        the JAX package does."""
        return self

    # ------------------------------------------------------------- operators
    def _binop(self, other, opname, reverse=False):
        a, b = (other, self) if reverse else (self, other)
        return _symbol_invoke_name(opname, (a, b), {})

    def __add__(self, o): return self._binop(o, 'add')
    def __radd__(self, o): return self._binop(o, 'add', True)
    def __sub__(self, o): return self._binop(o, 'subtract')
    def __rsub__(self, o): return self._binop(o, 'subtract', True)
    def __mul__(self, o): return self._binop(o, 'multiply')
    def __rmul__(self, o): return self._binop(o, 'multiply', True)
    def __truediv__(self, o): return self._binop(o, 'true_divide')
    def __rtruediv__(self, o): return self._binop(o, 'true_divide', True)
    def __pow__(self, o): return self._binop(o, 'power')
    def __mod__(self, o): return self._binop(o, 'mod')
    def __matmul__(self, o): return self._binop(o, 'matmul')
    def __neg__(self): return _symbol_invoke_name('negative', (self,), {})
    def __abs__(self): return _symbol_invoke_name('abs', (self,), {})
    def __eq__(self, o): return self._binop(o, 'equal')
    def __ne__(self, o): return self._binop(o, 'not_equal')
    def __lt__(self, o): return self._binop(o, 'less')
    def __le__(self, o): return self._binop(o, 'less_equal')
    def __gt__(self, o): return self._binop(o, 'greater')
    def __ge__(self, o): return self._binop(o, 'greater_equal')
    __hash__ = object.__hash__

    def astype(self, dtype):
        return _symbol_invoke_name('cast', (self,),
                                   {'dtype': _np.dtype(dtype)})

    def reshape(self, shape):
        return _symbol_invoke_name('reshape', (self, shape), {})

    def transpose(self, axes=None):
        return _symbol_invoke_name('transpose', (self,), {'axes': axes})

    def __getattr__(self, name):
        """Fluent op methods (``sym.sum()``, ``sym.mean(axis=1)`` …) resolve
        against the op registry, mirroring NDArray's method surface."""
        if name.startswith('_'):
            raise AttributeError(name)
        from ..ops.registry import _OPS
        op = _OPS.get(name)
        if op is None:
            raise AttributeError(
                f'Symbol has no attribute/op {name!r}')

        def method(*args, **kwargs):
            return _symbol_invoke(op, (self,) + args, kwargs)

        method.__name__ = name
        return method


def _remap(node, idx, mapping, memo):
    if id(node) in mapping:
        return mapping[id(node)]
    if id(node) in memo:
        return (memo[id(node)], idx)
    new_inputs = [_remap(m, i, mapping, memo) for m, i in node.inputs]
    if all(a is b for (a, _), (b, _) in zip(new_inputs, node.inputs)):
        memo[id(node)] = node
        return (node, idx)
    nn = _SymNode(node.op, node.name + '_c', node.args_spec, node.kwargs,
                  new_inputs, dict(node.attrs))
    nn.n_out = node.n_out
    memo[id(node)] = nn
    return (nn, idx)


class Executor:
    """Legacy bind()/forward()/backward() surface (reference executor.py).
    Forward replays the graph imperatively; backward runs autograd over
    the recorded replay."""

    def __init__(self, symbol, ctx, args, args_grad, grad_req):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_dict = dict(args)
        self.grad_req = grad_req
        self.grad_dict = dict(args_grad) if args_grad else {}
        self.outputs = []
        self._tracked = []

    def forward(self, is_train=False, **kwargs):
        from .. import autograd
        self.arg_dict.update(kwargs)
        if is_train and self.grad_req != 'null':
            for v in self.arg_dict.values():
                if v._ag is None or not v._ag.variable:
                    v.attach_grad(self.grad_req)
            with autograd.record():
                self.outputs = self._symbol._execute(self.arg_dict,
                                                     ctx=self._ctx)
        else:
            self.outputs = self._symbol._execute(self.arg_dict, ctx=self._ctx)
        return self.outputs

    def backward(self, out_grads=None):
        from .. import autograd
        heads = self.outputs
        autograd.backward(heads, out_grads)
        for name, arr in self.arg_dict.items():
            if arr.grad is not None:
                self.grad_dict[name] = arr.grad
        return self.grad_dict

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n)
                for n in self._symbol.list_arguments()]


# ------------------------------------------------------------ symbol frontend

def var(name, attr=None, shape=None, dtype=None, init=None,
        stype=None, **kwargs):
    """Create a symbolic variable (reference symbol.py var/Variable)."""
    node = _SymNode('null', name, None, {}, [])
    if shape is not None:
        node.attrs['__shape__'] = tuple(shape)
    if dtype is not None:
        node.attrs['__dtype__'] = str(_np.dtype(dtype))
    if attr:
        node.attrs.update(attr)
    return Symbol([(node, 0)])


Variable = var


def Group(symbols):
    """Symbol grouping multiple outputs (reference symbol.py Group)."""
    outs = []
    aux = {}
    for s in symbols:
        outs.extend(s._outputs)
        aux.update(s._aux)
    g = Symbol(outs)
    g._aux.update(aux)
    return g


def load(fname):
    with open(fname) as f:
        return Symbol.fromjson(f.read())


def fromjson(json_str):
    return Symbol.fromjson(json_str)


load_json = fromjson


def _symbol_invoke_name(op_name, args, kwargs):
    from ..ops.registry import get_op
    return _symbol_invoke(get_op(op_name), args, kwargs)


def _symbol_invoke(op, args, kwargs):
    """A graph node from a symbolic op call (nnvm node creation in the
    reference's compose path)."""
    from .. import _deferred_compute as dc

    name = kwargs.pop('name', None)
    kwargs.pop('out', None)
    inputs = []

    def spec_of(v):
        if isinstance(v, Symbol):
            ent = v._outputs[0]
            inputs.append(ent)
            return {'__arr__': len(inputs) - 1}
        if isinstance(v, (list, tuple)) and any(
                isinstance(e, Symbol) for e in v):
            return [spec_of(e) for e in v]
        return dc._encode_static(v)

    args_spec = [spec_of(a) for a in args]
    kw = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol) or (isinstance(v, (list, tuple)) and any(
                isinstance(e, Symbol) for e in v)):
            kw[k] = spec_of(v)
        else:
            kw[k] = dc._encode_static(v)
    node = _SymNode(op.name, name, args_spec, kw, inputs)
    n_out = op.n_out(args, kwargs) if callable(op.n_out) else op.n_out
    node.n_out = n_out
    return Symbol([(node, i) for i in range(n_out)])


def make_symbol_frontend(op_name):
    """The ``mx.sym.<op>`` function (the reference's symbol op codegen,
    python/mxnet/symbol/register.py)."""
    from ..ops.registry import get_op
    op = get_op(op_name)

    def frontend(*args, **kwargs):
        return _symbol_invoke(op, args, kwargs)

    frontend.__name__ = op_name
    frontend.__qualname__ = op_name
    frontend.__doc__ = (op.fn.__doc__ or '') + \
        '\n\n(symbolic variant; returns Symbol)'
    return frontend
