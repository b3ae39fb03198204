"""Vision transforms as blocks (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``, reference
python/mxnet/gluon/data/vision/transforms.py). Random transforms draw from
numpy's global generator, as the reference's do. ``Resize``,
``CenterCrop`` and ``RandomResizedCrop`` resample through ``image``,
which is not ported yet (ROADMAP A11): they raise.
"""

import numpy as _np

from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential
from ....ndarray.ndarray import array
from ....ops.registry import get_op, invoke


def _op(name, *args, **kw):
    return invoke(get_op(name), args, kw)


class Compose(Sequential):
    """Reference transforms.py:Compose."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


#: reference transforms HybridCompose — every transform here is traceable,
#: so the hybrid variant is the same class
HybridCompose = Compose


class RandomApply(Sequential):
    """Reference transforms/__init__.py:138 — apply ``transforms`` with
    probability ``p`` (host-side coin flip, like the reference)."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        for t in (transforms if isinstance(transforms, (list, tuple))
                  else [transforms]):
            self.add(t)          # registered children: init/cast/save see them
        self.p = p

    def forward(self, x, *args):
        import random as _random
        if self.p >= _random.random():
            for t in self._children.values():
                x = t(x)
        return (x,) + args if args else x


HybridRandomApply = RandomApply


class Cast(HybridBlock):
    def __init__(self, dtype='float32'):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference
    transforms.py:ToTensor)."""

    def forward(self, x):
        x = x.astype('float32') / 255.0
        if x.ndim == 3:
            return x.transpose((2, 0, 1))
        return x.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """Channel-wise normalize of CHW input (reference
    transforms.py:Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32).reshape(-1, 1, 1)
        self._std = _np.asarray(std, dtype=_np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        mean = array(self._mean, ctx=x.context)
        std = array(self._std, ctx=x.context)
        return (x - mean) / std


def _resample_pending(name):
    raise NotImplementedError(
        f'{name} resamples through image, which is not ported yet '
        f'(ROADMAP A11)')


class Resize(HybridBlock):
    """Reference transforms.py:Resize (HWC input). Not ported yet (ROADMAP
    A11)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        _resample_pending('Resize')


class CenterCrop(Block):
    """Reference transforms.py:CenterCrop. Not ported yet (ROADMAP A11)."""

    def __init__(self, size, interpolation=1):
        _resample_pending('CenterCrop')


class RandomResizedCrop(Block):
    """Reference transforms.py:RandomResizedCrop. Not ported yet (ROADMAP
    A11)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        _resample_pending('RandomResizedCrop')


class RandomFlipLeftRight(HybridBlock):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return _op('flip', x, axis=1 if x.ndim == 3 else 2)
        return x


class RandomFlipTopBottom(HybridBlock):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return _op('flip', x, axis=0 if x.ndim == 3 else 1)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        f = 1.0 + _np.random.uniform(-self._b, self._b)
        return (x.astype('float32') * f).clip(0, 255)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        f = 1.0 + _np.random.uniform(-self._c, self._c)
        x = x.astype('float32')
        mean = x.mean()
        return ((x - mean) * f + mean).clip(0, 255)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        f = 1.0 + _np.random.uniform(-self._s, self._s)
        x = x.astype('float32')
        gray = x.mean(axis=-1, keepdims=True)
        return (x * f + gray * (1 - f)).clip(0, 255)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        for t in _np.random.permutation(len(self._ts)):
            x = self._ts[t](x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise (reference transforms.py:RandomLighting)."""

    _eigval = _np.array([55.46, 4.794, 1.148], dtype=_np.float32)
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]], dtype=_np.float32)

    def __init__(self, alpha_std=0.05):
        super().__init__()
        self._std = alpha_std

    def forward(self, x):
        alpha = _np.random.normal(0, self._std, 3).astype(_np.float32)
        rgb = (self._eigvec * alpha) @ self._eigval
        return (x.astype('float32') + array(rgb, ctx=x.context)).clip(0, 255)
