"""Contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``, reference
python/mxnet/gluon/contrib/nn/basic_layers.py): Concurrent,
HybridConcurrent, Identity, SparseEmbedding, PixelShuffle1D/2D/3D, through
the registered ops; ``SyncBatchNorm`` lives in the main ``gluon.nn``."""

from ... import nn
from ...block import Block, HybridBlock
from .... import numpy as np

__all__ = ['Concurrent', 'HybridConcurrent', 'Identity',
           'SparseEmbedding', 'PixelShuffle1D', 'PixelShuffle2D',
           'PixelShuffle3D']


class Concurrent(nn.Sequential):
    """Run the children on the same input and concatenate their outputs
    along ``axis`` (reference Concurrent)."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return np.concatenate(out, axis=self.axis)


class HybridConcurrent(nn.HybridSequential):
    """Hybridizable Concurrent (reference HybridConcurrent)."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return np.concatenate(out, axis=self.axis)


class Identity(HybridBlock):
    """Pass-through block (reference Identity), the placeholder arm of a
    Concurrent."""

    def forward(self, x):
        return x


class SparseEmbedding(Block):
    """An embedding whose gradient is row-sparse (reference
    SparseEmbedding, over ``Embedding(sparse_grad=True)``): a backward
    gives one row a token occurrence, and an optimizer's lazy update
    touches only those rows."""

    def __init__(self, input_dim, output_dim, dtype='float32',
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._embed = nn.Embedding(input_dim, output_dim, dtype=dtype,
                                   weight_initializer=weight_initializer,
                                   sparse_grad=True)
        self.weight = self._embed.weight

    def forward(self, x):
        return self._embed(x)

    def __repr__(self):
        return (f'SparseEmbedding({self._embed._input_dim} -> '
                f'{self._embed._output_dim})')


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, dims, **kwargs):
        super().__init__(**kwargs)
        self._factors = (factor,) * dims if isinstance(factor, int) \
            else tuple(factor)
        if len(self._factors) != dims:
            raise ValueError(f'{type(self).__name__} takes {dims} factors, '
                             f'got {self._factors}')


class PixelShuffle1D(_PixelShuffle):
    """``(N, C f, W) -> (N, C, W f)`` sub-pixel upsampling (reference
    PixelShuffle1D; Shi et al. 2016)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)

    def forward(self, x):
        (f,) = self._factors
        N, C, W = x.shape
        x = x.reshape(N, C // f, f, W)
        x = x.transpose(0, 1, 3, 2)
        return x.reshape(N, C // f, W * f)


class PixelShuffle2D(_PixelShuffle):
    """``(N, C f1 f2, H, W) -> (N, C, H f1, W f2)`` (reference
    PixelShuffle2D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)

    def forward(self, x):
        f1, f2 = self._factors
        N, C, H, W = x.shape
        c = C // (f1 * f2)
        x = x.reshape(N, c, f1, f2, H, W)
        x = x.transpose(0, 1, 4, 2, 5, 3)
        return x.reshape(N, c, H * f1, W * f2)


class PixelShuffle3D(_PixelShuffle):
    """``(N, C f1 f2 f3, D, H, W) -> (N, C, D f1, H f2, W f3)`` (reference
    PixelShuffle3D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)

    def forward(self, x):
        f1, f2, f3 = self._factors
        N, C, D, H, W = x.shape
        c = C // (f1 * f2 * f3)
        x = x.reshape(N, c, f1, f2, f3, D, H, W)
        x = x.transpose(0, 1, 5, 2, 6, 3, 7, 4)
        return x.reshape(N, c, D * f1, H * f2, W * f3)
