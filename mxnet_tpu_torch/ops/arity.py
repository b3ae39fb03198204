"""Output arity of the multi-output ops, for symbols.

The reference declares it on each op (``FNumOutputs``; the JAX package's
``register(..., n_out=...)``). A symbolic call (``mx.sym.np.split(x,
2)``) has no values to count, so it reads the op's ``n_out``: an int, or
a function of the call's ``(args, kwargs)``. The port keeps the table in
one place and sets ``Op.n_out`` from it once every op is registered;
every op it does not name has one output.
"""

from .registry import _OPS

__all__ = ['N_OUT', 'apply']


def _split_n_out(args, kwargs):
    ios = args[1] if len(args) > 1 else kwargs.get('indices_or_sections')
    return ios if isinstance(ios, int) else len(ios) + 1


def _unique_n_out(args, kwargs):
    flags = ('return_index', 'return_inverse', 'return_counts')
    n = 1
    for i, f in enumerate(flags):
        v = kwargs.get(f, args[1 + i] if len(args) > 1 + i else False)
        n += bool(v)
    return n


def _gradient_n_out(a, kw):
    axis = kw.get('axis')
    if axis is None:
        nd = getattr(a[0], 'ndim', None)
        return nd if nd else 1
    return len(axis) if isinstance(axis, (tuple, list)) else 1


def _per_weight(outs, key, arrays_each, extra=0):
    """``outs`` outputs for each weight of a multi-tensor update: the
    count is ``key`` when given, else the arrays over ``arrays_each``."""
    def n_out(a, kw):
        return outs * (kw.get(key) or (len(a) - extra) // arrays_each)
    return n_out


def _multi_sgd_n_out(a, kw):
    return kw.get('num_weights') or (
        len(a[0]) if a and isinstance(a[0], (list, tuple)) else len(a)) // 2


N_OUT = {
    # 2 or more outputs, whatever the call
    'histogram': 2, 'tril_indices': 2, 'triu_indices': 2,
    'triu_indices_from': 2, 'linalg_slogdet': 2, 'linalg_eigh': 2,
    'linalg_syevd': 2, 'linalg_eig': 2, 'linalg_lstsq': 4, 'moments': 2,
    'group_adagrad_update': 2, 'calibrate_entropy': 2,
    'batch_norm_with_relu': 3, 'hawkesll': 2, 'fused_adam_step': 3,
    'fused_sgd_mom_step': 2, 'sgd_mom_update': 2, 'mp_sgd_update': 2,
    'mp_sgd_mom_update': 3, 'nag_mom_update': 2, 'signum_update': 2,
    'adam_update': 3, 'adamw_update': 3, 'ftrl_update': 3,
    'rmsprop_update': 2, 'rmspropalex_update': 4, 'lamb_update_phase1': 3,
    'ftml_update': 4, 'mp_nag_mom_update': 3, 'mp_adamw_update': 4,
    'mp_lamb_update_phase1': 3, 'mp_lamb_update_phase2': 2,
    'sparse_adagrad_update': 2, 'quantize_v2': 3, 'requantize': 3,
    'modf': 2, 'frexp': 2, 'divmod': 2, 'histogram2d': 3,
    # by the call
    'topk': lambda args, kw: 2 if (
        kw.get('ret_typ', args[3] if len(args) > 3 else 'indices')
        == 'both') else 1,
    'unique': _unique_n_out,
    'split': _split_n_out, 'array_split': _split_n_out,
    'hsplit': _split_n_out, 'dsplit': _split_n_out, 'vsplit': _split_n_out,
    'meshgrid': lambda args, kw: len(args),
    'broadcast_arrays': lambda args, kw: len(args),
    'linalg_svd': lambda args, kw: 3 if (
        kw.get('compute_uv', args[2] if len(args) > 2 else True)) else 1,
    'linalg_qr': lambda args, kw: 1 if (
        kw.get('mode', args[1] if len(args) > 1 else 'reduced')
        == 'r') else 2,
    'random_multinomial': lambda a, kw: 2 if kw.get('get_prob') else 1,
    'gradient': _gradient_n_out,
    'amp_multicast': lambda a, kw: kw.get('num_outputs') or len(a),
    'reset_arrays': lambda a, kw: kw.get('num_arrays') or len(a),
    'multi_sgd_update': _multi_sgd_n_out,
    'multi_sgd_mom_update': _per_weight(2, 'num_weights', 3),
    'multi_mp_sgd_update': _per_weight(2, 'num_weights', 3),
    'multi_mp_sgd_mom_update': _per_weight(3, 'num_weights', 4),
    'preloaded_multi_sgd_update': _per_weight(1, 'num_weights', 2, 2),
    'preloaded_multi_sgd_mom_update': _per_weight(2, 'num_weights', 3, 2),
    'preloaded_multi_mp_sgd_update': _per_weight(2, 'num_weights', 3, 2),
    'preloaded_multi_mp_sgd_mom_update': _per_weight(3, 'num_weights', 4,
                                                     2),
    'multi_lamb_update': _per_weight(3, 'num_tensors', 4),
    'multi_mp_lamb_update': _per_weight(4, 'num_tensors', 5),
    'multi_lans_update': _per_weight(3, 'num_tensors', 4),
    'multi_mp_lans_update': _per_weight(4, 'num_tensors', 5),
    'multi_adamw_update': _per_weight(3, 'num_tensors', 4),
    'multi_mp_adamw_update': _per_weight(4, 'num_tensors', 5),
}


def apply():
    """Set ``n_out`` on every registered op the table names (aliases
    share their op's record)."""
    for name, n in N_OUT.items():
        op = _OPS.get(name)
        if op is not None:
            op.n_out = n
