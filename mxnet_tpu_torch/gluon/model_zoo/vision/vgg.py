"""VGG 11/13/16/19 (+BN) (reference
python/mxnet/gluon/model_zoo/vision/vgg.py)."""

from ...block import HybridBlock
from ...nn import (BatchNorm, Conv2D, Dense, Dropout, HybridSequential,
                   MaxPool2D)

__all__ = ['VGG', 'vgg11', 'vgg13', 'vgg16', 'vgg19', 'vgg11_bn', 'vgg13_bn',
           'vgg16_bn', 'vgg19_bn', 'get_vgg']

vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        self.features = self._make_features(layers, filters, batch_norm)
        self.features.add(Dense(4096, activation='relu', weight_initializer
                                ='normal'))
        self.features.add(Dropout(rate=0.5))
        self.features.add(Dense(4096, activation='relu',
                                weight_initializer='normal'))
        self.features.add(Dropout(rate=0.5))
        self.output = Dense(classes, weight_initializer='normal')

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(Conv2D(filters[i], kernel_size=3, padding=1))
                if batch_norm:
                    featurizer.add(BatchNorm())
                from ...nn import Activation
                featurizer.add(Activation('relu'))
            featurizer.add(MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    from ..model_store import apply_pretrained
    layers, filters = vgg_spec[num_layers]
    bn = '_bn' if kwargs.get('batch_norm') else ''
    return apply_pretrained(VGG(layers, filters, **kwargs), pretrained,
                            f'vgg{num_layers}{bn}', ctx, root)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(19, **kwargs)
