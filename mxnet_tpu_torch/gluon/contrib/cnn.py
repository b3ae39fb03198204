"""Contrib CNN layers (counterpart of ``mxnet_tpu/gluon/contrib/cnn.py``,
reference python/mxnet/gluon/contrib/cnn/conv_layers.py).

``DeformableConvolution`` (deformable convolution v1) over the registered
``deformable_convolution`` op (``ops/legacy_ops.py``): an offset
convolution predicts two offsets a kernel tap a position, each tap is
sampled bilinearly at its offset position, and one product with the
weights follows, in plain PyTorch, as the JAX package leaves it to XLA
(the reference's hand-written kernel is
src/operator/contrib/deformable_convolution.cu). A sample whose four
corners all lie inside the padded input is the JAX layer's exactly; past
the last row or column the JAX layer extrapolates where its own registered
op, and so this layer, reads the edge pixel (ROADMAP C18).
"""

from ..block import HybridBlock
from ..parameter import Parameter
from ..nn import Activation, Conv2D
from ...ops.registry import invoke

__all__ = ['DeformableConvolution']


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1 (reference contrib/cnn/conv_layers.py:44):
    NCHW input, ``channels`` filters of ``kernel_size``, offsets from the
    ``offset_conv`` child (zeros at initialization: the plain
    convolution)."""

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, weight_initializer=None,
                 bias_initializer='zeros',
                 offset_weight_initializer='zeros',
                 offset_bias_initializer='zeros', **kwargs):
        super().__init__(**kwargs)
        k = _pair(kernel_size)
        self._k = k
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._channels = channels
        self._use_bias = use_bias
        self._deformable_groups = num_deformable_group
        self.offset_conv = Conv2D(
            2 * k[0] * k[1] * num_deformable_group, kernel_size=k,
            strides=self._strides, padding=self._padding,
            dilation=self._dilation,
            weight_initializer=offset_weight_initializer,
            bias_initializer=offset_bias_initializer,
            in_channels=in_channels)
        self.weight = Parameter('weight', shape=(channels, in_channels, *k),
                                init=weight_initializer,
                                allow_deferred_init=True)
        if use_bias:
            self.bias = Parameter('bias', shape=(channels,),
                                  init=bias_initializer,
                                  allow_deferred_init=True)
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        offsets = self.offset_conv(x)
        if self.weight.shape[1] == 0:
            w = list(self.weight.shape)
            w[1] = x.shape[1]
            self.weight.shape = tuple(w)
            self.weight._finish_deferred_init()
        if self._use_bias and self.bias._var is None:
            self.bias._finish_deferred_init()
        args = (x, offsets, self.weight.data()) + (
            (self.bias.data(),) if self._use_bias else ())
        out = invoke('deformable_convolution', args, dict(
            kernel=self._k, stride=self._strides, pad=self._padding,
            dilate=self._dilation, num_filter=self._channels,
            num_deformable_group=self._deformable_groups,
            no_bias=not self._use_bias))
        return out if self.act is None else self.act(out)
