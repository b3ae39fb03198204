"""SqueezeNet 1.0/1.1 (reference
python/mxnet/gluon/model_zoo/vision/squeezenet.py)."""

from ...block import HybridBlock
from ...nn import (Activation, AvgPool2D, Conv2D, Dropout, Flatten,
                   HybridConcatenate, HybridSequential, MaxPool2D)

__all__ = ['SqueezeNet', 'squeezenet1_0', 'squeezenet1_1']


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = HybridSequential()
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = HybridConcatenate(axis=1)
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = HybridSequential()
    out.add(Conv2D(channels, kernel_size, padding=padding))
    out.add(Activation('relu'))
    return out


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ('1.0', '1.1')
        self.features = HybridSequential()
        if version == '1.0':
            self.features.add(Conv2D(96, kernel_size=7, strides=2))
            self.features.add(Activation('relu'))
            self.features.add(MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True))
            self.features.add(_make_fire(64, 256, 256))
        else:
            self.features.add(Conv2D(64, kernel_size=3, strides=2))
            self.features.add(Activation('relu'))
            self.features.add(MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(_make_fire(64, 256, 256))
        self.features.add(Dropout(0.5))
        self.output = HybridSequential()
        self.output.add(Conv2D(classes, kernel_size=1))
        self.output.add(Activation('relu'))
        self.output.add(AvgPool2D(13))
        self.output.add(Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kwargs):
    from ..model_store import apply_pretrained
    return apply_pretrained(SqueezeNet('1.0', **kwargs), pretrained,
                            'squeezenet1.0', ctx, root)


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kwargs):
    from ..model_store import apply_pretrained
    return apply_pretrained(SqueezeNet('1.1', **kwargs), pretrained,
                            'squeezenet1.1', ctx, root)
