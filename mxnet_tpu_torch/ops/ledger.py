"""The op ledger of the port: what of the reference's registry is not
ported yet, by ROADMAP label.

Every name in the JAX package's op registry (its ``ops.registry.
list_ops()``, aliases included) is either registered here
(:mod:`.registry`) or listed in :data:`PENDING` under the ROADMAP item
that will port it; ``tests/test_torch_ledger.py`` holds the two lists
against the JAX registry, so an unported op stays visible and a name is
never both. The labels are queue A's in ROADMAP.md:

* ``A3 rest``: the op families not ported with NDArray (the linalg
  products other than ``dot``/``matmul`` and the decompositions, FFT, the
  numpy extras, the legacy-name ops, the contrib ops off the attention
  path, the gamma-family samplers; and, with ``ndarray/sparse.py``, the
  optimizers' row-sparse lazy update, which no op name carries);
* ``A4 rest``: the replayable creation ops of deferred compute;
* ``A11``: the fused RNN, CTC loss, detection, image and probability ops.
"""

__all__ = ['PENDING', 'pending', 'LABELS', 'PendingOpError']


class PendingOpError(NotImplementedError, AttributeError):
    """An op of the reference that the port has not ported yet. It is an
    ``AttributeError`` too, so ``hasattr(mx.np, name)`` is False for it."""

PENDING = {
    'A3 rest': (
        # ops/linalg.py: the products other than dot and matmul
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
    ),
    'A4 rest': (
        # ops/creation.py: replayable creation for deferred compute
        '_creation_arange', '_creation_blackman', '_creation_eye',
        '_creation_full', '_creation_hamming', '_creation_hanning',
        '_creation_indices', '_creation_linspace', '_creation_logspace',
        '_creation_ones', '_creation_tri', '_creation_zeros',
    ),
    'A11': (
        # ops/nn.py: fused RNN and CTC loss (gluon/rnn)
        'RNN', 'rnn', 'CTCLoss', 'ctc_loss',
        # ops/contrib.py: detection (the yolo/rcnn/ssd zoo)
        'Proposal', 'proposal', 'bipartite_matching', 'box_decode',
        'box_encode', 'box_iou', 'box_nms', 'multibox_detection',
        'multibox_prior', 'multibox_target', 'onnx_nms', 'roi_align',
        'roi_pooling',
        # ops/legacy_ops.py: image ops (image/)
        'image_crop', 'image_normalize', 'image_random_crop',
        'image_random_resized_crop', 'image_to_tensor',
        # gluon/probability
        '_prob_gamma_rsample',
    ),
}

#: the ROADMAP labels the pending ops wait on
LABELS = tuple(PENDING)


def pending():
    """``{op name: ROADMAP label}`` for every op not ported yet."""
    return {name: label for label, names in PENDING.items()
            for name in names}
