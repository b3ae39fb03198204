"""MobileNet v1/v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``, reference
python/mxnet/gluon/model_zoo/vision/mobilenet.py). A depthwise conv is a
grouped ``Conv2D`` (``groups`` = channels)."""

from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridLambda, HybridSequential)
from ....ops.registry import get_op, invoke

__all__ = ['MobileNet', 'MobileNetV2', 'mobilenet1_0', 'mobilenet0_75',
           'mobilenet0_5', 'mobilenet0_25', 'mobilenet_v2_1_0',
           'mobilenet_v2_0_75', 'mobilenet_v2_0_5', 'mobilenet_v2_0_25']


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False))
    out.add(BatchNorm(scale=True))
    if active:
        if relu6:
            out.add(HybridLambda(
                lambda x: invoke(get_op('relu6'), (x,), {})))
        else:
            out.add(Activation('relu'))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """Reference mobilenet.py:LinearBottleneck (v2)."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride, pad=1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    """Reference mobilenet.py:MobileNet (v1)."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2,
                  pad=1)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dwc, c, s)
        self.features.add(GlobalAvgPool2D())
        self.features.add(Flatten())
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """Reference mobilenet.py:MobileNetV2."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2,
                  pad=1, relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 +
                             [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 +
                          [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2] + [1] * 2 + [2] + [1] * 2 + [2] + [1] * 3 + \
            [1] * 3 + [2] + [1] * 3
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                 strides):
            self.features.add(LinearBottleneck(in_c, c, t, s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, last_channels, relu6=True)
        self.features.add(GlobalAvgPool2D())
        self.output = HybridSequential()
        self.output.add(Conv2D(classes, 1, use_bias=False))
        self.output.add(Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def mobilenet1_0(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNet(1.0, **kw), pretrained,
                            'mobilenet1.0', ctx, root)


def mobilenet0_75(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNet(0.75, **kw), pretrained,
                            'mobilenet0.75', ctx, root)


def mobilenet0_5(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNet(0.5, **kw), pretrained,
                            'mobilenet0.5', ctx, root)


def mobilenet0_25(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNet(0.25, **kw), pretrained,
                            'mobilenet0.25', ctx, root)


def mobilenet_v2_1_0(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNetV2(1.0, **kw), pretrained,
                            'mobilenetv2_1.0', ctx, root)


def mobilenet_v2_0_75(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNetV2(0.75, **kw), pretrained,
                            'mobilenetv2_0.75', ctx, root)


def mobilenet_v2_0_5(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNetV2(0.5, **kw), pretrained,
                            'mobilenetv2_0.5', ctx, root)


def mobilenet_v2_0_25(pretrained=False, ctx=None, root=None, **kw):
    from ..model_store import apply_pretrained
    return apply_pretrained(MobileNetV2(0.25, **kw), pretrained,
                            'mobilenetv2_0.25', ctx, root)
