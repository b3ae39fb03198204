"""The inputs of the A3 op families' parity cases, shared by the CPU
tests (``tests/test_torch_linalg.py``, ``test_torch_ops_a3.py``,
``test_torch_ops_legacy.py``, ``test_torch_ops_contrib.py``,
``test_torch_fft_control_flow.py``), which hold the port against the JAX
package, and by ``chip_smoke.py``'s sparse phase, which holds the port on
the card against the port on the host. It imports neither JAX nor either
package (and the CSR the sparse tests and phase share). Each case is
``(op name, args, kwargs)``; numpy arrays become
NDArrays, lists of them lists of NDArrays. ``A3_NAMES`` lists every op
name the A3 slice registered; the card's phase runs each of them.
"""

import numpy as np


def scipy_like_csr(rng, R, C, per_row):
    """The oracle's CSR (``tests/test_sparse.py``): ``per_row`` sorted
    column ids a row, repeats dropped; (data, indptr, cols, rows)."""
    cols = np.sort(rng.integers(0, C, (R, per_row), dtype=np.int64), axis=1)
    dup = np.zeros_like(cols, dtype=bool)
    dup[:, 1:] = cols[:, 1:] == cols[:, :-1]
    keep = ~dup.ravel()
    rows = np.repeat(np.arange(R, dtype=np.int64), per_row)[keep]
    cols = cols.ravel()[keep]
    data = rng.standard_normal(len(cols), dtype=np.float32)
    indptr = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=R), out=indptr[1:])
    return data, indptr, cols, rows


def _r(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype('f')


def _spd(n, seed=0):
    a = _r(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype('f')


def _u(*shape, lo=-0.9, hi=0.9, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype('f')


def _i(*shape, lo=0, hi=5, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


def _nans(seed=0):
    x = _r(4, 5, seed=seed)
    x[1, 2] = x[3, 0] = np.nan
    return x

LINALG_PRODUCTS = [
    ('inner', (_r(3, 4), _r(5, 4, seed=1)), {}),
    ('outer', (_r(3), _r(2, 2, seed=1)), {}),
    ('vdot', (_r(2, 3), _r(2, 3, seed=1)), {}),
    ('tensordot', (_r(2, 3, 4), _r(3, 4, 5, seed=1)), {'axes': 2}),
    ('tensordot', (_r(2, 3, 4), _r(4, 3, 5, seed=1)),
     {'axes': ([1, 2], [1, 0])}),
    ('einsum', ('ij,jk->ik', _r(3, 4), _r(4, 2, seed=1)), {}),
    ('kron', (_r(2, 3), _r(3, 2, seed=1)), {}),
    ('batch_dot', (_r(2, 3, 4), _r(2, 5, 4, seed=1)), {'transpose_b': True}),
    ('batch_dot', (_r(2, 4, 3), _r(2, 4, 5, seed=1)), {'transpose_a': True}),
    ('khatri_rao', ([_r(3, 4), _r(2, 4, seed=1), _r(2, 4, seed=2)],), {}),
    ('linalg_multi_dot', ([_r(3, 4), _r(4, 5, seed=1), _r(5, 2, seed=2)],),
     {}),
    ('linalg_gemm', (_r(3, 4), _r(5, 4, seed=1), _r(3, 5, seed=2)),
     {'transpose_b': True, 'alpha': 2.0, 'beta': 0.5}),
    ('linalg_gemm2', (_r(2, 4, 3), _r(2, 4, 5, seed=1)),
     {'transpose_a': True, 'alpha': 0.5}),
    ('linalg_syrk', (_r(3, 4),), {'alpha': 1.5}),
    ('linalg_syrk', (_r(2, 3, 4),), {'transpose': True}),
    ('linalg_extractdiag', (_r(2, 4, 4),), {'offset': 1}),
    ('linalg_makediag', (_r(2, 3),), {'offset': -1}),
    ('linalg_sumlogdiag', (np.abs(_r(2, 3, 3)) + 0.5,), {}),
    ('linalg_matrix_power', (_r(3, 3) / 2,), {'n': 3}),
    ('linalg_norm', (_r(3, 4),), {}),
    ('linalg_norm', (_r(3, 4),), {'ord': 'fro'}),
    ('linalg_norm', (_r(3, 4),), {'ord': 1, 'axis': 0}),
    ('linalg_norm', (_r(5),), {'ord': np.inf}),
    ('linalg_norm', (_r(2, 3, 4),), {'axis': (1, 2), 'keepdims': True}),
]

LINALG_TRIANGULAR = [(n, (_spd(4, 3), _r(4, 4, seed=4)), kw) for n, kw in [
    ('linalg_trmm', {}), ('linalg_trmm', {'transpose': True}),
    ('linalg_trmm', {'rightside': True, 'lower': False, 'alpha': 2.0}),
    ('linalg_trsm', {}), ('linalg_trsm', {'transpose': True}),
    ('linalg_trsm', {'rightside': True, 'lower': False, 'alpha': 0.5}),
]]

LINALG_SOLVERS = [
    ('linalg_inv', (_spd(4),), {}),
    ('linalg_pinv', (_r(5, 3),), {}),
    ('linalg_det', (_r(3, 3),), {}),
    ('linalg_slogdet', (_r(2, 3, 3),), {}),
    ('linalg_solve', (_spd(4), _r(4, 2, seed=1)), {}),
    ('linalg_cholesky', (_spd(4),), {}),
    ('linalg_cholesky', (_spd(4),), {'lower': False}),
    ('linalg_potrf', (_spd(4),), {}),
    ('linalg_potri', (np.linalg.cholesky(_spd(4)).astype('f'),), {}),
    ('potri', (np.linalg.cholesky(_spd(4)).T.copy().astype('f'),),
     {'lower': False}),
    ('linalg_tensorinv', (_spd(6).reshape(6, 2, 3),), {'ind': 1}),
    ('linalg_tensorsolve', (_spd(6).reshape(2, 3, 6), _r(2, 3, seed=2)),
     {}),
    ('linalg_eigvalsh', (_spd(5),), {}),
    ('linalg_cond', (_spd(4),), {}),
    ('linalg_matrix_rank', (np.diag([1.0, 2.0, 0.0]).astype('f'),), {}),
    ('linalg_lstsq', (_r(6, 3), _r(6, 2, seed=1)), {}),
    ('linalg_lstsq', (_r(6, 3), _r(6, seed=1)), {'rcond': 1e-3}),
]


EXTRAS = [
    ('acos', (_u(3, 4),), {}), ('asin', (_u(3, 4),), {}),
    ('atan', (_r(3, 4),), {}), ('acosh', (_u(3, 4, lo=1.1, hi=3),), {}),
    ('asinh', (_r(3, 4),), {}), ('atanh', (_u(3, 4),), {}),
    ('bitwise_invert', (_i(3, 4, lo=-9, hi=9),), {}),
    ('matrix_transpose', (_r(2, 3, 4),), {}),
    ('nancumsum', (_nans(),), {'axis': 1}), ('nancumsum', (_nans(),), {}),
    ('nancumprod', (_nans() / 2,), {'axis': 0}),
    ('modf', (_r(3, 4) * 3,), {}), ('frexp', (_r(3, 4) * 9,), {}),
    ('atan2', (_r(3, 4), _r(3, 4, seed=1)), {}),
    ('logaddexp2', (_r(3, 4), _r(1, 4, seed=1)), {}),
    ('pow', (_u(3, 4, lo=0.5, hi=2), _r(3, 4, seed=1)), {}),
    ('bitwise_left_shift', (_i(3, 4, hi=50), _i(3, 4, hi=4, seed=1)), {}),
    ('bitwise_right_shift', (_i(3, 4, hi=500), _i(3, 4, hi=4, seed=1)), {}),
    ('vecdot', (_r(3, 4), _r(3, 4, seed=1)), {}),
    ('vecdot', (_r(3, 4), _r(3, 4, seed=1)), {'axis': 0}),
    ('divmod', (_r(3, 4) * 5, _u(3, 4, lo=0.5, hi=2, seed=1)), {}),
    ('divmod', (_i(3, 4, lo=-9, hi=9), _i(3, 4, lo=1, hi=4, seed=1)), {}),
    ('permute_dims', (_r(2, 3, 4),), {'axes': (2, 0, 1)}),
    ('gradient', (_r(6),), {}), ('gradient', (_r(6), 2.0), {}),
    ('gradient', (_r(4, 5),), {}), ('gradient', (_r(4, 5),), {'axis': 1}),
    ('digitize', (_r(10), np.array([-1.0, 0.0, 0.5, 1.5], 'f')), {}),
    ('digitize', (_r(10), np.array([-1.0, 0.0, 0.5, 1.5], 'f')),
     {'right': True}),
    ('isin', (_i(3, 4), np.array([1, 3], np.int32)), {}),
    ('isin', (_i(3, 4), np.array([1, 3], np.int32)), {'invert': True}),
    ('nanmedian', (_nans(),), {'axis': 1}), ('nanmedian', (_nans(),), {}),
    ('nanpercentile', (_nans(), 30.0), {'axis': 0}),
    ('nanquantile', (_nans(), 0.25), {}),
    ('nanquantile', (_nans(), 0.7), {'axis': (0, 1), 'keepdims': True}),
    ('nanstd', (_nans(),), {'axis': 1, 'ddof': 1}),
    ('nanvar', (_nans(),), {'axis': 0}), ('nanvar', (_nans(),), {}),
    ('trapezoid', (_r(3, 5),), {'dx': 0.5}),
    ('trapezoid', (_r(3, 5), np.cumsum(_u(5, lo=0.1, hi=1))), {}),
    ('put_along_axis', (_r(3, 4), _i(3, 2, hi=4), _r(3, 2, seed=1)),
     {'axis': 1}),
    ('put_along_axis', (_r(3, 4), _i(1, 4, hi=3), 7.0), {'axis': 0}),
    ('select', ([_r(3, 4) < 0, _r(3, 4, seed=1) > 1],
                [_r(3, 4, seed=2), _r(3, 4, seed=3)]), {'default': 0.5}),
    ('choose', (_i(3, 4, hi=3), [_r(3, 4), _r(3, 4, seed=1),
                                 _r(3, 4, seed=2)]), {}),
    ('choose', (_i(3, 4, lo=-2, hi=6), [_r(3, 4), _r(3, 4, seed=1)]),
     {'mode': 'wrap'}),
    ('lexsort', ([_i(8, hi=3), _i(8, hi=2, seed=1)],), {}),
    ('lexsort', ([_i(3, 6, hi=3), _i(3, 6, hi=2, seed=1)],), {'axis': 1}),
    ('histogram2d', (_r(50), _r(50, seed=1)), {'bins': 5}),
    ('histogram2d', (_r(50), _r(50, seed=1)),
     {'bins': (3, 4), 'range': ((-1, 1), (-2, 2)), 'density': True}),
    ('histogram_bin_edges', (_r(40),), {'bins': 7}),
    ('geomspace', (1.0, 1000.0), {'num': 7}),
    ('geomspace', (2.0, 64.0), {'num': 5, 'endpoint': False}),
    ('compress', (np.array([True, False, True, True]), _r(4, 3)),
     {'axis': 0}),
    ('compress', (np.array([False, True, True]), _r(4, 3)), {'axis': 1}),
    ('compress', (np.array([1, 0, 1, 0, 0, 1], 'f'), _r(2, 3)),
     {'size': 5, 'fill_value': -1.0}),
]


LEGACY = [
    ('broadcast_add', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_sub', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_mul', (_r(2, 3), _r(2, 1, seed=1)), {}),
    ('broadcast_div', (_r(2, 3), _u(1, 3, lo=0.5, hi=2)), {}),
    ('broadcast_mod', (_r(2, 3) * 4, _u(1, 3, lo=0.5, hi=2)), {}),
    ('broadcast_power', (_u(2, 3, lo=0.5, hi=2), _r(1, 3, seed=1)), {}),
    ('broadcast_maximum', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_minimum', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_hypot', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_equal', (_i(2, 3, hi=2).astype('f'),
                         _i(1, 3, hi=2, seed=1).astype('f')), {}),
    ('broadcast_not_equal', (_i(2, 3, hi=2).astype('f'),
                             _i(1, 3, hi=2, seed=1).astype('f')), {}),
    ('broadcast_greater', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_greater_equal', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_lesser', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_lesser_equal', (_r(2, 3), _r(1, 3, seed=1)), {}),
    ('broadcast_logical_and', (_i(2, 3, hi=2).astype('f'),
                               _i(1, 3, hi=2, seed=1).astype('f')), {}),
    ('broadcast_logical_or', (_i(2, 3, hi=2).astype('f'),
                              _i(1, 3, hi=2, seed=1).astype('f')), {}),
    ('broadcast_logical_xor', (_i(2, 3, hi=2).astype('f'),
                               _i(1, 3, hi=2, seed=1).astype('f')), {}),
    ('elemwise_add', (_r(2, 3), _r(2, 3, seed=1)), {}),
    ('elemwise_sub', (_r(2, 3), _r(2, 3, seed=1)), {}),
    ('elemwise_mul', (_r(2, 3), _r(2, 3, seed=1)), {}),
    ('elemwise_div', (_r(2, 3), _u(2, 3, lo=0.5, hi=2)), {}),
    ('slice', (_r(4, 5, 6),), {'begin': (1, None, 2), 'end': (3, 4, None),
                              'step': (1, 2, None)}),
    ('slice', (_r(4, 5),), {'begin': (None, 4), 'end': (None, 0),
                           'step': (None, -2)}),
    ('slice', (_r(4, 5, 6),), {'begin': (1,), 'end': (5,), 'axes': (-1,)}),
    ('broadcast_axis', (_r(1, 3, 1),), {'axis': (0, 2), 'size': (2, 4)}),
    ('broadcast_axes', (_r(1, 3),), {'axis': 0, 'size': 5}),
    ('cast_storage', (_r(3, 4),), {'stype': 'default'}),
    ('sparse_retain', (_r(5, 3), np.array([0, 3], np.int32)), {}),
    ('extracttrian', (_r(2, 4, 4),), {}),
    ('linalg_extracttrian', (_r(4, 4),), {'offset': 1, 'lower': False}),
    ('maketrian', (_r(10),), {}),
    ('linalg_maketrian', (_r(2, 6),), {'offset': -1}),
    ('deformable_convolution', (_r(1, 4, 5, 5), _r(1, 36, 5, 5, seed=1),
                                _r(2, 4, 3, 3, seed=2), _r(2, seed=3)),
     {'kernel': (3, 3), 'pad': (1, 1), 'num_filter': 2,
      'num_deformable_group': 2}),
    ('cast_storage', (_r(3, 4),), {}),
]


CONTRIB = [
    ('interleaved_matmul_selfatt_qk', (_r(4, 2, 18),), {'heads': 2}),
    ('interleaved_matmul_selfatt_valatt', (_r(4, 2, 18), _r(4, 4, 4,
                                                           seed=1)),
     {'heads': 2}),
    ('interleaved_matmul_encdec_qk', (_r(3, 2, 6), _r(5, 2, 12, seed=1)),
     {'heads': 2}),
    ('interleaved_matmul_encdec_valatt', (_r(5, 2, 12), _r(4, 3, 5,
                                                          seed=1)),
     {'heads': 2}),
    ('sldwin_atten_mask_like', (_r(2, 2, 6, 6), np.ones(2, 'f'),
                                np.array([6, 4], 'f')), {'w': 2}),
    ('sldwin_atten_score', (_r(1, 6, 2, 3), _r(1, 6, 2, 3, seed=1),
                            np.ones(2, 'f')), {'w': 2, 'symmetric': False}),
    ('sldwin_atten_context', (_r(1, 2, 6, 6), _r(1, 6, 2, 3, seed=1),
                              np.ones(2, 'f')), {'w': 2}),
    ('all_finite', (_r(3, 4),), {}),
    ('all_finite', (_r(3, 4), np.array([1.0, np.inf], 'f')), {}),
    ('index_copy', (_r(5, 3), np.array([0, 2], np.int32), _r(2, 3, seed=1)),
     {}),
    ('index_add', (_r(5, 3), np.array([4, 4, 1], np.int32),
                   _r(3, 3, seed=1)), {}),
    ('getnnz', (_i(4, 5, hi=2).astype('f'),), {}),
    ('getnnz', (_i(4, 5, hi=2).astype('f'),), {'axis': 0}),
    ('sparse_embedding', (_i(2, 3, hi=6).astype('f'), _r(6, 4)), {}),
    ('SparseEmbedding', (_i(2, 3, hi=6).astype('f'), _r(6, 4)), {}),
    ('count_sketch', (_r(2, 6), _i(6, hi=4), np.sign(_r(6, seed=2))),
     {'out_dim': 4}),
    ('quadratic', (_r(3, 4),), {'a': 0.5, 'b': -1.0, 'c': 2.0}),
    ('div_sqrt_dim', (_r(2, 3, 8),), {}),
    ('edge_id', (_r(4, 4), _i(3, hi=4), _i(3, hi=4, seed=1)), {}),
    ('index_array', (_r(2, 3),), {}),
    ('index_array', (_r(2, 3, 2),), {'axes': (1,)}),
    ('gradient_multiplier', (_r(3, 4),), {'scalar': -0.5}),
    ('round_ste', (_r(3, 4) * 3,), {}), ('sign_ste', (_r(3, 4),), {}),
    ('identity_attach_kl_sparse_reg', (_r(3, 4),),
     {'sparseness_target': 0.2, 'penalty': 0.1}),
    ('batch_norm_with_relu', (_r(2, 3, 4), _r(3), _r(3, seed=1),
                              _r(3, seed=2), _u(3, lo=0.5, hi=2)), {}),
    ('hawkesll', (_u(2, 3, lo=0.2, hi=1), _u(3, lo=0.1, hi=0.5),
                  _u(3, lo=0.5, hi=2, seed=1), np.zeros((2, 3), 'f'),
                  _u(2, 4, lo=0.1, hi=1, seed=2), _i(2, 4, hi=3),
                  np.array([4, 2], 'f'), np.array([5.0, 4.0], 'f')), {}),
]


_X2 = np.random.default_rng(4).standard_normal((4, 6)).astype('f')
_C2 = (_X2 + 1j * np.random.default_rng(5).standard_normal((4, 6))
       ).astype('complex64')

FFT = [
    ('fft', _X2, {'n': 8}), ('ifft', _C2, {'axis': 0}),
    ('rfft', _X2, {'norm': 'ortho'}), ('irfft', _C2, {'n': 10}),
    ('fft2', _X2, {}), ('ifft2', _C2, {'s': (4, 4)}),
    ('fftn', _X2, {'axes': (0,)}), ('ifftn', _C2, {}),
    ('hfft', _C2, {}), ('ihfft', _X2, {}),
    ('fftshift', _X2, {'axes': 1}), ('ifftshift', _X2, {}),
]

#: factors unique only up to sign or order: the card's phase holds them to
#: the host's by their invariants (chip_smoke.py ``_invariants``)
FACTORS = [
    ('linalg_eigh', (_spd(4, 8),), {}), ('linalg_syevd', (_spd(4, 8),), {}),
    ('linalg_svd', (_r(5, 3, seed=7),), {}),
    ('linalg_qr', (_r(5, 3, seed=7),), {}),
    ('linalg_gelqf', (_r(5, 3, seed=7),), {}),
    ('linalg_eig', (_r(4, 4, seed=9),), {}),
    ('linalg_eigvals', (_r(4, 4, seed=9),), {}),
]

#: the other calls the card's phase makes (the CPU tests make them with
#: their own checks)
MISC = [
    ('partition', (_r(3, 7),), {'kth': 3}),
    ('argpartition', (_r(3, 7),), {'kth': 3}),
    ('contrib_fft', (_r(2, 8, seed=3),), {}), ('fft', (_r(2, 8, seed=3),), {}),
    ('contrib_ifft', (_r(2, 16, seed=3),), {}),
    ('ifft', (_r(2, 16, seed=3),), {}),
    ('fft_fftfreq', (8, 0.5), {}), ('fft_rfftfreq', (9, 2.0), {}),
    ('softsign', (_r(3, 4),), {}), ('square_sum', (_r(3, 4),), {'axis': 1}),
]

#: the gamma-family samplers: (name, kwargs, mean, variance) at n draws
SAMPLERS = [
    ('random_gamma', {'shape_param': 2.5, 'scale': 0.5}, 1.25, 0.625),
    ('gamma_sample', {'shape_param': 0.4}, 0.4, 0.4),
    ('random_beta', {'a': 2.0, 'b': 3.0}, 0.4, 0.04),
    ('beta_sample', {'a': 0.5, 'b': 0.5}, 0.5, 0.125),
    ('random_chisquare', {'df': 3.0}, 3.0, 6.0),
    ('chisquare', {'df': 0.7}, 0.7, 1.4),
    ('random_negative_binomial', {'k': 3, 'p': 0.4}, 4.5, 11.25),
    ('sample_generalized_negative_binomial', {'mu': 2.0, 'alpha': 0.5},
     2.0, 4.0),
]


def moments_ok(x, mean, var):
    """True when the draws ``x`` have the mean and the variance within 5
    standard errors (the variance's from the draws' fourth central
    moment); and the two gaps in standard errors."""
    n = x.size
    se_mean = np.sqrt(var / n)
    m4 = np.mean((x - x.mean()) ** 4)
    se_var = np.sqrt(max(m4 - var ** 2, 1e-12) / n)
    zm, zv = abs(x.mean() - mean) / se_mean, abs(x.var() - var) / se_var
    return bool(zm < 5 and zv < 5), float(zm), float(zv)


#: every op name the A3 slice registered
A3_NAMES = (        # ops/linalg.py: the products other than dot and matmul
        'batch_dot', 'einsum', 'inner', 'kron', 'outer', 'tensordot',
        'vdot',
        # ops/linalg.py: decompositions, solvers, la_op family
        'khatri_rao', 'linalg_cholesky', 'linalg_cond', 'linalg_det',
        'linalg_eig', 'linalg_eigh', 'linalg_eigvals', 'linalg_eigvalsh',
        'linalg_extractdiag', 'linalg_gelqf', 'linalg_gemm',
        'linalg_gemm2', 'linalg_inv', 'linalg_lstsq', 'linalg_makediag',
        'linalg_matrix_power', 'linalg_matrix_rank', 'linalg_multi_dot',
        'linalg_norm', 'linalg_pinv', 'linalg_potrf', 'linalg_potri',
        'linalg_qr', 'linalg_slogdet', 'linalg_solve', 'linalg_sumlogdiag',
        'linalg_svd', 'linalg_syevd', 'linalg_syrk', 'linalg_tensorinv',
        'linalg_tensorsolve', 'linalg_trmm', 'linalg_trsm', 'potri',
        # ops/fft_ops.py
        'contrib_fft', 'contrib_ifft', 'fft', 'fft_fft', 'fft_fft2',
        'fft_fftfreq', 'fft_fftn', 'fft_fftshift', 'fft_hfft', 'fft_ifft',
        'fft_ifft2', 'fft_ifftn', 'fft_ifftshift', 'fft_ihfft',
        'fft_irfft', 'fft_rfft', 'fft_rfftfreq', 'ifft',
        # ops/numpy_extras.py
        'acos', 'acosh', 'argpartition', 'asin', 'asinh', 'atan', 'atan2',
        'atanh', 'bitwise_invert', 'bitwise_left_shift',
        'bitwise_right_shift', 'choose', 'compress', 'digitize', 'divmod',
        'frexp', 'geomspace', 'gradient', 'histogram2d',
        'histogram_bin_edges', 'isin', 'lexsort', 'logaddexp2',
        'matrix_transpose', 'modf', 'nancumprod', 'nancumsum', 'nanmedian',
        'nanpercentile', 'nanquantile', 'nanstd', 'nanvar', 'partition',
        'permute_dims', 'pow', 'put_along_axis', 'select', 'trapezoid',
        'vecdot',
        # ops/legacy_ops.py: the broadcast_*/elemwise_* names, slice,
        # broadcast_axis and the small legacy ops
        'broadcast_add', 'broadcast_axes',
        'broadcast_axis', 'broadcast_div', 'broadcast_equal',
        'broadcast_greater', 'broadcast_greater_equal', 'broadcast_hypot',
        'broadcast_lesser', 'broadcast_lesser_equal',
        'broadcast_logical_and', 'broadcast_logical_or',
        'broadcast_logical_xor', 'broadcast_maximum', 'broadcast_minimum',
        'broadcast_mod', 'broadcast_mul', 'broadcast_not_equal',
        'broadcast_power', 'broadcast_sub', 'cast_storage', 'elemwise_add',
        'elemwise_div', 'elemwise_mul', 'elemwise_sub', 'slice', 'softsign',
        'square_sum',
        # ops/legacy_ops.py: triangle packing, sparse, deformable conv
        'deformable_convolution', 'extracttrian', 'linalg_extracttrian',
        'linalg_maketrian', 'maketrian', 'sparse_retain',
        'sample_generalized_negative_binomial',
        # ops/contrib.py: the contrib ops off the attention path
        'div_sqrt_dim', 'gradient_multiplier',
        'interleaved_matmul_encdec_qk', 'interleaved_matmul_encdec_valatt',
        'interleaved_matmul_selfatt_qk', 'interleaved_matmul_selfatt_valatt',
        'quadratic', 'round_ste', 'sign_ste',
        'SparseEmbedding', 'all_finite', 'batch_norm_with_relu',
        'count_sketch', 'edge_id', 'getnnz', 'hawkesll',
        'identity_attach_kl_sparse_reg', 'index_add', 'index_array',
        'index_copy', 'sldwin_atten_context', 'sldwin_atten_mask_like',
        'sldwin_atten_score', 'sparse_embedding',
        # ops/random_ops.py: the gamma family (torch's gamma sampler takes
        # no generator)
        'beta_sample', 'chisquare', 'gamma_sample', 'random_beta',
        'random_chisquare', 'random_gamma', 'random_negative_binomial',
    
)
