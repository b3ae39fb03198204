"""Activation layers (counterpart of ``mxnet_tpu/gluon/nn/activations.py``,
reference python/mxnet/gluon/nn/activations.py), over the registered
ops."""

from ..block import HybridBlock
from ..parameter import Parameter
from ...ops.registry import invoke

__all__ = ['Activation', 'LeakyReLU', 'PReLU', 'ELU', 'SELU', 'GELU',
           'SiLU', 'Swish']


def _op(name, x, **kw):
    return invoke(name, (x,), kw)


class Activation(HybridBlock):
    """Generic activation (reference activations.py:Activation)."""

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def forward(self, x):
        return _op('activation', x, act_type=self._act_type)

    def __repr__(self):
        return f'Activation({self._act_type})'


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return _op('leaky_relu', x, act_type='leaky', slope=self._alpha)


class PReLU(HybridBlock):
    """Reference activations.py:PReLU (a learned negative slope)."""

    def __init__(self, alpha_initializer='zeros', in_channels=1, **kwargs):
        super().__init__(**kwargs)
        self.alpha = Parameter('alpha', shape=(in_channels,),
                               init=alpha_initializer)

    def forward(self, x):
        return invoke('leaky_relu', (x,), {'gamma': self.alpha.data(),
                                           'act_type': 'prelu'})


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return _op('leaky_relu', x, act_type='elu', slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return _op('leaky_relu', x, act_type='selu')


class GELU(HybridBlock):
    """The exact (``'erf'``) GELU by default; ``'tanh'`` for the
    approximation (reference activations.py:62-68)."""

    def __init__(self, approximation='erf', **kwargs):
        super().__init__(**kwargs)
        self._approx = approximation != 'erf'

    def forward(self, x):
        return _op('gelu', x, approximate=self._approx)


class SiLU(HybridBlock):
    def forward(self, x):
        return _op('silu', x)


Swish = SiLU
