"""2-bit gradient compression with error feedback.

Counterpart of ``mxnet_tpu/kvstore/gradient_compression.py`` (reference
src/kvstore/gradient_compression.{h,cc}): a gradient is thresholded to
{-threshold, 0, +threshold}, the quantization error stays in a per-key
residual, and 16 values pack into one 32-bit word, value j of a block in
bits [2j, 2j+1]: code 0b11 is +threshold, 0b10 -threshold, 0b00 zero.
The words are the JAX package's bit for bit.

PyTorch's ``uint32`` takes few operators on CUDA, so the packing runs in
``int64`` with masks and the words are kept as ``int32`` tensors holding
the same bits (``words.numpy().view(numpy.uint32)`` reads them as the
JAX package's ``uint32``). Plain PyTorch, as the JAX package leaves both
directions to XLA.
"""

import math

import torch

__all__ = ['GradientCompression', 'quantize_2bit', 'dequantize_2bit']

_BLOCK = 16     # values per 32-bit word
_MASK32 = (1 << 32) - 1


def _shifts(device):
    return torch.arange(_BLOCK, dtype=torch.int64, device=device) * 2


def quantize_2bit(grad, residual, threshold):
    """``(words, new residual)`` of a flat fp32 gradient (reference
    quantize_2bit::Map): ``acc = residual + grad``; ±threshold where
    ``|acc|`` reaches it, the emitted value taken off the residual."""
    thr = torch.tensor(threshold, dtype=torch.float32, device=grad.device)
    acc = residual + grad
    up, down = acc >= thr, acc <= -thr
    q = torch.where(up, thr, torch.where(down, -thr, 0.0))
    codes = torch.where(up, 3, torch.where(down, 2, 0)).to(torch.int64)
    pad = (-codes.numel()) % _BLOCK
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    words = (codes.view(-1, _BLOCK) << _shifts(grad.device)).sum(1)
    # the uint32 bit pattern as int32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32), acc - q


def dequantize_2bit(words, threshold, size):
    """The first ``size`` values that ``words`` (int32, any leading
    shape flattened) code."""
    w = words.reshape(-1).to(torch.int64) & _MASK32
    codes = (w[:, None] >> _shifts(words.device)) & 3
    thr = torch.tensor(threshold, dtype=torch.float32, device=words.device)
    vals = torch.where(codes == 3, thr, torch.where(codes == 2, -thr, 0.0))
    return vals.reshape(-1)[:size]


class GradientCompression:
    """Per-kvstore compression state (reference GradientCompression,
    gradient_compression.h:52): one residual per key, as each worker of
    the reference owns one per parameter."""

    def __init__(self):
        self.type = 'none'
        self.threshold = 0.5
        self._residuals = {}

    def set_params(self, compression_params):
        params = dict(compression_params or {})
        ctype = params.pop('type', 'none')
        if ctype not in ('none', '2bit'):
            raise ValueError(
                f'unsupported gradient compression type {ctype!r} '
                "(reference supports only '2bit', gradient_compression.h:37)")
        threshold = float(params.pop('threshold', 0.5))
        if ctype == '2bit' and threshold <= 0:
            raise ValueError('threshold must be positive')
        if params:
            raise ValueError(f'unknown compression params {sorted(params)}')
        self.type = ctype
        self.threshold = threshold
        self._residuals = {}

    @property
    def active(self):
        return self.type == '2bit'

    def get_compression_factor(self):
        """Reference GetCompressionFactor: fp32 to 2 bits is 16."""
        return 16 if self.active else 1

    def get_compressed_size(self, original_size):
        """Bytes of the words for ``original_size`` floats (reference
        GetCompressedSize)."""
        if not self.active:
            return original_size * 4
        return 4 * ((original_size + _BLOCK - 1) // _BLOCK)

    def quantize(self, key, grad):
        """Compress one gradient (a tensor), accumulating the error into
        the key's residual (reference Quantize, gradient_compression.h:103);
        returns the int32 words."""
        flat = grad.reshape(-1).float()
        res = self._residuals.get(key)
        if res is None or res.shape != flat.shape or \
                res.device != flat.device:
            res = torch.zeros_like(flat)
        words, self._residuals[key] = quantize_2bit(flat, res,
                                                    self.threshold)
        return words

    def dequantize(self, words, shape, dtype=torch.float32):
        """Reference Dequantize: the values ``words`` code, as ``shape``."""
        size = math.prod(shape)
        return dequantize_2bit(words, self.threshold, size).reshape(
            shape).to(dtype)

    def dequantize_sum(self, stacked_words, shape, dtype=torch.float32):
        """Decode an ``(n_workers, n_words)`` stack and sum over the
        workers: the dist store's merge of every worker's compressed
        gradient."""
        size = math.prod(shape)
        n, width = stacked_words.shape
        vals = dequantize_2bit(stacked_words, self.threshold,
                               n * width * _BLOCK).view(n, -1)[:, :size]
        return vals.sum(0).reshape(shape).to(dtype)
