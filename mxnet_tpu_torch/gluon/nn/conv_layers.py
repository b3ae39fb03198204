"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``, reference
python/mxnet/gluon/nn/conv_layers.py): Conv1D-3D, Conv1D-3DTranspose,
MaxPool/AvgPool/GlobalMaxPool/GlobalAvgPool 1-3D and ReflectionPad2D.
They go through the registered ``convolution``, ``deconvolution``,
``pooling`` and ``pad`` ops: cuDNN (in fp32, TF32 off) and ATen on the
card, as the reference leaves them to XLA. An unknown ``in_channels`` (0)
resolves at the first forward.
"""

from .activations import Activation
from ..block import HybridBlock
from ..parameter import Parameter
from ...ops.registry import invoke

__all__ = ['Conv1D', 'Conv2D', 'Conv3D', 'Conv1DTranspose',
           'Conv2DTranspose', 'Conv3DTranspose', 'MaxPool1D', 'MaxPool2D',
           'MaxPool3D', 'AvgPool1D', 'AvgPool2D', 'AvgPool3D',
           'GlobalMaxPool1D', 'GlobalMaxPool2D', 'GlobalMaxPool3D',
           'GlobalAvgPool1D', 'GlobalAvgPool2D', 'GlobalAvgPool3D',
           'ReflectionPad2D']


def _op(name, *args, **kw):
    return invoke(name, args, kw)


def _pair(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """Base conv (reference conv_layers.py:_Conv). Weights are ``(O,
    I/groups, *k)`` (transposed: ``(I, O/groups, *k)``) whatever the data
    layout; data is channels-first unless ``layout`` says otherwise."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', op_name='convolution',
                 adj=None, output_padding=None, **kwargs):
        super().__init__(**kwargs)
        ndim = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._strides = strides
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._layout = layout
        self._use_bias = use_bias
        self._op_name = op_name
        self._adj = adj
        if op_name == 'convolution':
            wshape = (channels, in_channels // groups if in_channels else 0)\
                + kernel_size
        else:  # transposed: (in, out//groups, *k)
            wshape = (in_channels if in_channels else 0,
                      channels // groups) + kernel_size
        self.weight = Parameter('weight', shape=wshape,
                                init=weight_initializer,
                                allow_deferred_init=True)
        if use_bias:
            self.bias = Parameter('bias', shape=(channels,),
                                  init=bias_initializer,
                                  allow_deferred_init=True)
        self.act = Activation(activation) if activation else None

    def _infer(self, x):
        c_axis = self._layout.index('C')
        in_c = x.shape[c_axis]
        w = list(self.weight.shape)
        if self._op_name == 'convolution' and w[1] == 0:
            w[1] = in_c // self._groups
            self.weight.shape = tuple(w)
            self.weight._finish_deferred_init()
        elif self._op_name == 'deconvolution' and w[0] == 0:
            w[0] = in_c
            self.weight.shape = tuple(w)
            self.weight._finish_deferred_init()
        if self._use_bias and self.bias._var is None:
            self.bias._finish_deferred_init()

    def forward(self, x):
        self._infer(x)
        kwargs = dict(kernel=self._kernel, stride=self._strides,
                      dilate=self._dilation, pad=self._padding,
                      num_filter=self._channels, num_group=self._groups,
                      no_bias=not self._use_bias, layout=self._layout)
        if self._op_name == 'deconvolution':
            kwargs['adj'] = self._adj
        args = [x, self.weight.data()]
        if self._use_bias:
            args.append(self.bias.data())
        out = _op(self._op_name, *args, **kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return (f'{type(self).__name__}({self._channels}, '
                f'kernel_size={self._kernel}, stride={self._strides})')


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout='NCW', **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, **kwargs)


class Conv2D(_Conv):
    """Reference conv_layers.py:Conv2D."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout='NCHW', **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout='NCDHW', **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout='NCW',
                 **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, op_name='deconvolution',
                         adj=_pair(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout='NCHW', **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, op_name='deconvolution',
                         adj=_pair(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout='NCDHW', **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, op_name='deconvolution',
                         adj=_pair(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = dict(
            kernel=pool_size, stride=strides or pool_size, pad=padding,
            pool_type=pool_type, global_pool=global_pool,
            pooling_convention='full' if ceil_mode else 'valid',
            count_include_pad=count_include_pad, layout=layout)

    def forward(self, x):
        return _op('pooling', x, **self._kwargs)

    def __repr__(self):
        return (f'{type(self).__name__}(size={self._kwargs["kernel"]}, '
                f'stride={self._kwargs["stride"]})')


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout='NCW',
                 ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 1),
                         _pair(strides, 1) if strides else None,
                         _pair(padding, 1), ceil_mode, False, 'max', layout,
                         **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides else None,
                         _pair(padding, 2), ceil_mode, False, 'max', layout,
                         **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout='NCDHW', ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 3),
                         _pair(strides, 3) if strides else None,
                         _pair(padding, 3), ceil_mode, False, 'max', layout,
                         **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout='NCW',
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_pair(pool_size, 1),
                         _pair(strides, 1) if strides else None,
                         _pair(padding, 1), ceil_mode, False, 'avg', layout,
                         count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides else None,
                         _pair(padding, 2), ceil_mode, False, 'avg', layout,
                         count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout='NCDHW', ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_pair(pool_size, 3),
                         _pair(strides, 3) if strides else None,
                         _pair(padding, 3), ceil_mode, False, 'avg', layout,
                         count_include_pad, **kwargs)


class _GlobalPool(_Pooling):
    def __init__(self, pool_type, layout, **kwargs):
        ndim = len(layout) - 2
        super().__init__((1,) * ndim, (1,) * ndim, (0,) * ndim, False, True,
                         pool_type, layout, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout='NCW', **kw):
        super().__init__('max', layout, **kw)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout='NCHW', **kw):
        super().__init__('max', layout, **kw)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout='NCDHW', **kw):
        super().__init__('max', layout, **kw)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout='NCW', **kw):
        super().__init__('avg', layout, **kw)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout='NCHW', **kw):
        super().__init__('avg', layout, **kw)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout='NCDHW', **kw):
        super().__init__('avg', layout, **kw)


class ReflectionPad2D(HybridBlock):
    """Reference conv_layers.py:ReflectionPad2D."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            p = (padding,) * 4
        else:
            p = tuple(padding)
        if len(p) == 8:
            # reference 8-tuple (N, C, H, W begin/end pairs)
            self._pad = ((p[0], p[1]), (p[2], p[3]), (p[4], p[5]),
                         (p[6], p[7]))
        elif len(p) == 4:
            self._pad = ((0, 0), (0, 0), (p[0], p[1]), (p[2], p[3]))
        else:
            raise ValueError(f'padding must be int, 4- or 8-tuple, got '
                             f'{padding!r}')

    def forward(self, x):
        return _op('pad', x, pad_width=self._pad, mode='reflect')
