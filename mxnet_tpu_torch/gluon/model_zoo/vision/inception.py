"""Inception V3 (reference
python/mxnet/gluon/model_zoo/vision/inception.py)."""

from ...block import HybridBlock
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   HybridConcatenate, HybridSequential, MaxPool2D)
from ....ops.registry import get_op, invoke

__all__ = ['Inception3', 'inception_v3']


def _make_basic_conv(**kwargs):
    out = HybridSequential()
    out.add(Conv2D(use_bias=False, **kwargs))
    out.add(BatchNorm(epsilon=0.001))
    out.add(Activation('relu'))
    return out


def _make_branch(use_pool, *conv_settings):
    out = HybridSequential()
    if use_pool == 'avg':
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == 'max':
        out.add(MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        kwargs = {}
        for key, value in zip(['channels', 'kernel_size', 'strides',
                               'padding'], setting):
            if value is not None:
                kwargs[key] = value
        out.add(_make_basic_conv(**kwargs))
    return out


def _concat(*branches):
    c = HybridConcatenate(axis=1)
    for b in branches:
        c.add(b)
    return c


def _make_A(pool_features):
    return _concat(
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch('avg', (pool_features, 1, None, None)))


def _make_B():
    return _concat(
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch('max'))


def _make_C(channels_7x7):
    return _concat(
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch('avg', (192, 1, None, None)))


def _make_D():
    return _concat(
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None),
                     (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _make_branch('max'))


class _InceptionE(HybridBlock):
    """E block needs a nested concat, so it's a Block (reference uses the
    same trick via nested Concurrent)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.branch1 = _make_branch(None, (320, 1, None, None))
        self.branch2_stem = _make_basic_conv(channels=384, kernel_size=1)
        self.branch2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch3_stem = _make_branch(None, (448, 1, None, None),
                                         (384, 3, None, 1))
        self.branch3_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch3_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch4 = _make_branch('avg', (192, 1, None, None))

    def forward(self, x):
        cat = lambda *xs: invoke(get_op('concatenate'), xs, {'axis': 1})
        b1 = self.branch1(x)
        b2 = self.branch2_stem(x)
        b2 = cat(self.branch2_a(b2), self.branch2_b(b2))
        b3 = self.branch3_stem(x)
        b3 = cat(self.branch3_a(b3), self.branch3_b(b3))
        b4 = self.branch4(x)
        return cat(b1, b2, b3, b4)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = HybridSequential()
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=2))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                           padding=1))
        self.features.add(MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3))
        self.features.add(MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_InceptionE())
        self.features.add(_InceptionE())
        self.features.add(AvgPool2D(pool_size=8))
        self.features.add(Dropout(0.5))
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    from ..model_store import apply_pretrained
    return apply_pretrained(Inception3(**kwargs), pretrained,
                            'inceptionv3', ctx, root)
