"""AMP op lists: the port's own copy of ``mxnet_tpu/amp/lists.py``
(reference ``python/mxnet/contrib/amp/lists/symbol_fp16.py`` — the per-op
dtype policy driving the ReducePrecision graph pass,
``src/nnvm/low_precision_pass.cc:404``), the same three sets.

Names are the registry's canonical op names. Three classes:

* ``TARGET_DTYPE_OPS`` — run in the low-precision target dtype (bf16):
  the tensor-core ops (matmul/conv/attention) where low precision pays.
* ``FP32_OPS`` — numerically fragile: reductions feeding statistics,
  exp/log/softmax-family, losses, norms. Inputs are cast UP to fp32.
* ``WIDEST_TYPE_CASTS`` — dtype-polymorphic ops (elementwise, shape
  moves): run in whatever dtype arrives; the pass leaves them alone
  (equivalent to the reference's widest-type-cast behavior since both
  operands come from the same upstream policy).
"""

TARGET_DTYPE_OPS = {
    # tensor cores: dense matmuls
    'fully_connected', 'dot', 'batch_dot', 'matmul', 'einsum', 'gemm',
    'gemm2', 'tensordot',
    # tensor cores: convolutions
    'convolution', 'deconvolution', 'deformable_convolution',
    # fused attention
    'multi_head_attention', 'interleaved_matmul_selfatt_qk',
    'interleaved_matmul_selfatt_valatt',
    'interleaved_matmul_encdec_qk', 'interleaved_matmul_encdec_valatt',
    # recurrent fused kernel
    'rnn',
}

FP32_OPS = {
    # normalization statistics
    'batch_norm_train', 'batch_norm_inference', 'layer_norm',
    'group_norm', 'instance_norm', 'rms_norm', 'l2_normalization',
    'sync_batch_norm', 'lrn', 'norm', 'linalg_norm',
    # exp/log family
    'softmax', 'log_softmax', 'softmin', 'exp', 'expm1', 'log', 'log1p',
    'log2', 'log10', 'logsumexp',
    # losses
    'softmax_cross_entropy', 'ctc_loss', 'smooth_l1',
    # reductions prone to accumulation error
    'mean', 'sum', 'prod', 'var', 'std', 'moments', 'square_sum',
    # misc fragile
    'erf', 'erfinv', 'gammaln', 'digamma', 'power', 'sqrt', 'rsqrt',
    'reciprocal', 'cumsum',
}

# everything else is widest-type / pass-through: elementwise arithmetic,
# activations, shape ops, indexing — they execute in the dtype handed to
# them. Enumerated subset kept for API parity with the reference lists:
WIDEST_TYPE_CASTS = {
    'add', 'subtract', 'multiply', 'true_divide', 'maximum', 'minimum',
    'where', 'concatenate', 'stack', 'broadcast_axis', 'relu',
    'activation', 'leaky_relu', 'sigmoid', 'tanh', 'gelu', 'softplus',
    'reshape', 'transpose', 'swapaxes', 'flatten', 'split', 'slice',
    'slice_axis', 'take', 'embedding', 'pad', 'pooling', 'upsampling',
    'dropout',
}
