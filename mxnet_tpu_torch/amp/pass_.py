"""Op-list-driven mixed-precision graph rewrite.

Counterpart of ``mxnet_tpu/amp/pass_.py`` (reference
``src/nnvm/low_precision_pass.cc:404``, ReducePrecision, and
``python/mxnet/contrib/amp/lists/symbol_fp16.py``). It walks a Symbol's
DAG and inserts ``amp_cast`` nodes, one per (source, target dtype), so
that the ops of :data:`.lists.TARGET_DTYPE_OPS` take low-precision inputs
(the tensor-core ops) and those of :data:`.lists.FP32_OPS` take fp32
(fragile statistics); parameters stay fp32 at rest, as in the reference.
On the card a converted graph's ``layer_norm`` and attention nodes reach
the bf16 entry points of the fused norm and flash attention kernels.
"""

from ..symbol.symbol import Symbol, _SymNode
from . import lists as _lists

__all__ = ['convert_symbol', 'convert_model']


def _cast_entry(entry, dtype, cache):
    """A graph entry wrapped in an amp_cast node (one per target)."""
    key = (id(entry[0]), entry[1], dtype)
    node = cache.get(key)
    if node is None:
        node = _SymNode('amp_cast', None, [{'__arr__': 0}],
                        {'dtype': dtype}, [entry])
        cache[key] = node
    return (node, 0)


def convert_symbol(sym, target_dtype='bfloat16', target_dtype_ops=None,
                   fp32_ops=None, conditional_fp32_ops=None,
                   excluded_sym_names=None, cast_optional_params=False):
    """A Symbol rewritten with amp_cast nodes by the op lists (reference
    ``amp.convert_symbol``): a new Symbol over a cloned DAG; the input
    graph is untouched.

    ``conditional_fp32_ops``: [(op_name, param_name, [values])] — force
    fp32 when the node's attribute matches (reference conditional list
    surface).
    """
    target_ops = set(target_dtype_ops if target_dtype_ops is not None
                     else _lists.TARGET_DTYPE_OPS)
    fp32 = set(fp32_ops if fp32_ops is not None else _lists.FP32_OPS)
    excluded = set(excluded_sym_names or ())
    conditional = list(conditional_fp32_ops or ())

    clones = {}      # id(old node) -> new node
    casts = {}       # (id(new src node), idx, dtype) -> cast node

    def cloned_entry(entry):
        node, idx = entry
        return (clones[id(node)], idx)

    def policy_of(node):
        if node.name in excluded:
            return None
        for op_name, param, values in conditional:
            if node.op == op_name and str(
                    node.kwargs.get(param)) in [str(v) for v in values]:
                return 'float32'
        if node.op in target_ops:
            return target_dtype
        if node.op in fp32:
            return 'float32'
        return None   # widest-type / pass-through

    for node in sym._topo():
        if node.op == 'null':
            clones[id(node)] = node      # variables are shared, not cloned
            continue
        new_inputs = [cloned_entry(e) for e in node.inputs]
        dtype = policy_of(node)
        if dtype is not None:
            new_inputs = [_cast_entry(e, dtype, casts) for e in new_inputs]
        new = _SymNode(node.op, node.name, node.args_spec,
                       dict(node.kwargs), new_inputs, dict(node.attrs))
        new.n_out = node.n_out
        clones[id(node)] = new

    out = Symbol([cloned_entry(e) for e in sym._outputs])
    out._aux = dict(sym._aux)
    return out


def convert_model(sym, arg_params, aux_params=None,
                  target_dtype='bfloat16', target_dtype_ops=None,
                  fp32_ops=None, conditional_fp32_ops=None,
                  excluded_sym_names=None, cast_optional_params=False):
    """Reference ``amp.convert_model``: the rewritten symbol, and the
    parameters, which stay fp32 (cast at the graph's edges) unless
    ``cast_optional_params`` casts those whose every consumer is a cast to
    the target dtype."""
    out = convert_symbol(sym, target_dtype, target_dtype_ops, fp32_ops,
                         conditional_fp32_ops, excluded_sym_names,
                         cast_optional_params)
    if cast_optional_params:
        # only params whose every consumer is a target-dtype cast: a
        # param that also feeds an fp32-list op keeps its fp32 mantissa
        consumers = {}
        for node in out._topo():
            for (src, _i) in node.inputs:
                if src.op == 'null':
                    consumers.setdefault(src.name, []).append(node)
        castable = {
            name for name, cons in consumers.items()
            if cons and all(c.op == 'amp_cast' and
                            str(c.kwargs.get('dtype')) ==
                            str(target_dtype) for c in cons)}
        arg_params = {k: (v.astype(target_dtype) if k in castable else v)
                      for k, v in arg_params.items()}
        if aux_params:
            aux_params = {k: (v.astype(target_dtype) if k in castable
                              else v) for k, v in aux_params.items()}
    return out, arg_params, (aux_params or {})
