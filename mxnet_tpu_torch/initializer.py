"""``mx.init`` / ``mx.initializer``: weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference
python/mxnet/initializer.py), with the same classes, registry names,
name-suffix rules and scales. The reference draws from numpy's global
stream on the host; here the draws come from the generator of the
array's device (``_rng.generator``, reseeded by ``mx.random.seed``) and
land on the device directly, so a 110 M-parameter net initializes on the
card without a host copy. The same seed gives other numbers than the
reference, from the same distributions.

An initializer is called as ``init(desc, arr)`` with ``arr`` an NDArray
whose value it replaces (``Parameter`` then takes that value into its
leaf).
"""

import math
import re

import numpy as _np
import torch

from . import _rng
from .base import register, registry_create

__all__ = ['InitDesc', 'Initializer', 'create', 'register', 'Zero', 'One',
           'Constant', 'Uniform', 'Normal', 'Xavier', 'MSRAPrelu',
           'Orthogonal', 'Bilinear', 'LSTMBias', 'Mixed']


class InitDesc(str):
    """Name and attributes passed to an initializer (reference
    initializer.py:InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer (reference initializer.py:Initializer): by the
    name's suffix, biases, betas and running means take zeros, gammas and
    running variances ones, the rest :meth:`_init_weight`."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            desc = InitDesc('weight')
        name = desc.lower()
        init_hint = getattr(desc, 'attrs', {}).get('__init__', '')
        if init_hint:
            create(init_hint)._init_weight(desc, arr)
        elif name.endswith(('bias', 'beta', 'running_mean', 'moving_mean')):
            self._init_zero(desc, arr)
        elif name.endswith(('gamma', 'running_var', 'moving_var')):
            self._init_one(desc, arr)
        else:
            self._init_weight(desc, arr)

    def init_weight(self, desc, arr):
        self._init_weight(desc, arr)

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _set(arr, value):
        """Replace ``arr``'s value with ``value`` (a tensor or numpy
        array), cast to ``arr``'s dtype on its device."""
        t = arr._data
        if not torch.is_tensor(value):
            value = torch.from_numpy(_np.asarray(value, dtype=_np.float64))
        arr._rebind(value.to(device=t.device, dtype=t.dtype).reshape(
            t.shape))

    @staticmethod
    def _uniform(arr, low, high):
        t = arr._data
        return torch.empty(t.shape, dtype=torch.float32,
                           device=t.device).uniform_(
            low, high, generator=_rng.generator(t.device))

    @staticmethod
    def _normal(arr, sigma, shape=None):
        t = arr._data
        return torch.empty(t.shape if shape is None else shape,
                           dtype=torch.float32, device=t.device).normal_(
            0.0, sigma, generator=_rng.generator(t.device))

    def _init_zero(self, desc, arr):
        t = arr._data
        arr._rebind(torch.zeros(t.shape, dtype=t.dtype, device=t.device))

    def _init_one(self, desc, arr):
        t = arr._data
        arr._rebind(torch.ones(t.shape, dtype=t.dtype, device=t.device))

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def __repr__(self):
        return f'{type(self).__name__}({self._kwargs})'


register = register(Initializer)


def create(name, **kwargs):
    """An initializer by its registered name (``'zeros'``, ``'xavier'``,
    ...), or the instance itself."""
    return registry_create(Initializer, name, **kwargs)


@register('zeros')
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._init_zero(desc, arr)


@register('ones')
class One(Initializer):
    def _init_weight(self, desc, arr):
        self._init_one(desc, arr)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        self._set(arr, torch.full(arr.shape, float(self.value)))


@register
class Uniform(Initializer):
    """U(-scale, scale) (reference initializer.py:Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        self._set(arr, self._uniform(arr, -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma^2) (reference initializer.py:Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        self._set(arr, self._normal(arr, self.sigma))


def _fans(shape, factor_type='avg'):
    """(fan_in, fan_out) of a weight: dim 1 and dim 0 times the kernel's
    spatial size (reference initializer.py:Xavier)."""
    hw = 1
    for d in shape[2:]:
        hw *= d
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    return fan_in, fan_out


@register
class Xavier(Initializer):
    """Reference initializer.py:Xavier (Glorot): uniform on (-s, s) or
    N(0, s^2), ``s = sqrt(magnitude / factor)``."""

    def __init__(self, rnd_type='uniform', factor_type='avg', magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape):
        """The scale ``s`` for a weight of ``shape``."""
        fan_in, fan_out = _fans(shape)
        if self.factor_type == 'avg':
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == 'in':
            factor = fan_in
        elif self.factor_type == 'out':
            factor = fan_out
        else:
            raise ValueError('Incorrect factor type')
        return math.sqrt(self.magnitude / max(factor, 1))

    def _init_weight(self, desc, arr):
        scale = self.scale(arr.shape)
        if self.rnd_type == 'uniform':
            w = self._uniform(arr, -scale, scale)
        elif self.rnd_type == 'gaussian':
            w = self._normal(arr, scale)
        else:
            raise ValueError('Unknown random type')
        self._set(arr, w)


@register
class MSRAPrelu(Xavier):
    """Reference initializer.py:MSRAPrelu (He): Gaussian Xavier with
    magnitude ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type='avg', slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__('gaussian', factor_type, magnitude)
        self._kwargs = {'factor_type': factor_type, 'slope': slope}


@register
class Orthogonal(Initializer):
    """A scaled orthogonal matrix from the SVD of a random one (reference
    initializer.py:Orthogonal)."""

    def __init__(self, scale=1.414, rand_type='uniform'):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        t = arr._data
        gen = _rng.generator(t.device)
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=t.device)
        if self.rand_type == 'uniform':
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        self._set(arr, self.scale * q)


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel (reference initializer.py:Bilinear)."""

    def _init_weight(self, desc, arr):
        shape = arr.shape
        i = _np.arange(arr.size)
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        self._set(arr, (1 - abs(x / f - c)) * (1 - abs(y / f - c)))


@register
class LSTMBias(Initializer):
    """Forget-gate bias ``forget_bias``, the rest 0 (reference
    initializer.py:LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = torch.zeros(arr.shape)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)


@register
class Mixed(Initializer):
    """The first initializer whose pattern matches the name (reference
    initializer.py:Mixed)."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError(f'no initializer matches {name}')
