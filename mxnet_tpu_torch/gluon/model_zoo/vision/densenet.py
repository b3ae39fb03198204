"""DenseNet 121/161/169/201 (reference
python/mxnet/gluon/model_zoo/vision/densenet.py)."""

from ...block import HybridBlock
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ....ops.registry import get_op, invoke

__all__ = ['DenseNet', 'densenet121', 'densenet161', 'densenet169',
           'densenet201']


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = HybridSequential()
        self.body.add(BatchNorm())
        self.body.add(Activation('relu'))
        self.body.add(Conv2D(bn_size * growth_rate, kernel_size=1,
                             use_bias=False))
        self.body.add(BatchNorm())
        self.body.add(Activation('relu'))
        self.body.add(Conv2D(growth_rate, kernel_size=3, padding=1,
                             use_bias=False))
        if dropout:
            from ...nn import Dropout
            self.body.add(Dropout(dropout))

    def forward(self, x):
        out = self.body(x)
        return invoke(get_op('concatenate'), (x, out), {'axis': 1})


def _make_dense_block(num_layers, bn_size, growth_rate, dropout):
    out = HybridSequential()
    for _ in range(num_layers):
        out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = HybridSequential()
    out.add(BatchNorm())
    out.add(Activation('relu'))
    out.add(Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = HybridSequential()
        self.features.add(Conv2D(num_init_features, kernel_size=7, strides=2,
                                 padding=3, use_bias=False))
        self.features.add(BatchNorm())
        self.features.add(Activation('relu'))
        self.features.add(MaxPool2D(pool_size=3, strides=2, padding=1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_make_dense_block(num_layers, bn_size,
                                                growth_rate, dropout))
            num_features = num_features + num_layers * growth_rate
            if i != len(block_config) - 1:
                num_features = num_features // 2
                self.features.add(_make_transition(num_features))
        self.features.add(BatchNorm())
        self.features.add(Activation('relu'))
        self.features.add(GlobalAvgPool2D())
        self.features.add(Flatten())
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _get(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    from ..model_store import apply_pretrained
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config, **kwargs)
    return apply_pretrained(net, pretrained, f'densenet{num_layers}',
                            ctx, root)


def densenet121(**kw):
    return _get(121, **kw)


def densenet161(**kw):
    return _get(161, **kw)


def densenet169(**kw):
    return _get(169, **kw)


def densenet201(**kw):
    return _get(201, **kw)
