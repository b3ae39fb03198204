"""Elementwise ops.

Counterpart of ``mxnet_tpu/ops/elemwise.py`` (reference
src/operator/tensor/elemwise_* and src/operator/numpy/np_elemwise_*):
unary and broadcasting binary ops, each one PyTorch call. A binary op
casts its operands to JAX's result type first (:func:`.._dtypes.
result_type`: a Python scalar is weak, a numpy scalar strong), so that
``int32 * 2.5`` is float32 and ``uint8 + np.int64(3)`` is int32, as in the
reference. The AMP casts (``amp_cast``, ``amp_multicast``; the reference
has them in ``ops/legacy_ops.py``) sit beside ``cast``.
"""

import torch

from .. import _dtypes
from .registry import register


def _operand(x, dtype, device):
    if torch.is_tensor(x):
        return x if x.dtype == dtype else x.to(dtype)
    return _dtypes.tensor_of(x, dtype, device)


def _binary(tfn):
    def op(a, b):
        dev = a.device if torch.is_tensor(a) else b.device
        dt = _dtypes.result_type(a, b)
        return tfn(_operand(a, dt, dev), _operand(b, dt, dev))
    return op


def _spacing(x):
    toward = torch.where(torch.signbit(x), float('-inf'), float('inf'))
    return torch.nextafter(x, toward.to(x.dtype)) - x


def _cbrt(x):
    x = x if x.is_floating_point() else x.float()
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _float(fn):
    def op(x):
        return fn(x if x.is_floating_point() or x.is_complex()
                  else x.float())
    return op


def _float2(fn):
    """A binary op defined on floats only: integer operands go to float32
    first, as the reference's ``jnp`` promotes them."""
    def op(a, b):
        if not a.is_floating_point():
            a = a.float()
        if not b.is_floating_point():
            b = b.to(a.dtype)
        return fn(a, b)
    return op


def _ldexp(a, b):
    return torch.ldexp(a if a.is_floating_point() else a.float(),
                       b.to(torch.int32))


_BINARY = {
    'add': torch.add, 'subtract': torch.sub, 'multiply': torch.mul,
    'true_divide': torch.true_divide, 'floor_divide': torch.floor_divide,
    'mod': torch.remainder, 'power': torch.pow, 'maximum': torch.maximum,
    'minimum': torch.minimum, 'hypot': _float2(torch.hypot),
    'arctan2': _float2(torch.atan2), 'copysign': _float2(torch.copysign),
    'logaddexp': _float2(torch.logaddexp), 'fmod': torch.fmod,
    'fmax': torch.fmax, 'fmin': torch.fmin, 'remainder': torch.remainder,
    'float_power': torch.float_power, 'ldexp': _ldexp,
    'heaviside': torch.heaviside, 'gcd': torch.gcd, 'lcm': torch.lcm,
    'bitwise_and': torch.bitwise_and, 'bitwise_or': torch.bitwise_or,
    'bitwise_xor': torch.bitwise_xor,
    'left_shift': torch.bitwise_left_shift,
    'right_shift': torch.bitwise_right_shift,
    'nextafter': _float2(torch.nextafter),
}
_COMPARE = {
    'equal': torch.eq, 'not_equal': torch.ne, 'less': torch.lt,
    'less_equal': torch.le, 'greater': torch.gt, 'greater_equal': torch.ge,
    'logical_and': torch.logical_and, 'logical_or': torch.logical_or,
    'logical_xor': torch.logical_xor,
}
_UNARY = {
    'negative': torch.neg, 'abs': torch.abs, 'absolute': torch.abs,
    'fabs': _float(torch.abs), 'sign': torch.sign, 'rint': torch.round,
    'ceil': torch.ceil, 'floor': torch.floor, 'trunc': torch.trunc,
    'fix': torch.trunc, 'sqrt': torch.sqrt, 'cbrt': _cbrt,
    'square': torch.square, 'reciprocal': torch.reciprocal,
    'exp': torch.exp, 'expm1': torch.expm1, 'exp2': torch.exp2,
    'log': torch.log, 'log10': torch.log10, 'log2': torch.log2,
    'log1p': torch.log1p, 'sin': torch.sin, 'cos': torch.cos,
    'tan': torch.tan, 'arcsin': torch.asin, 'arccos': torch.acos,
    'arctan': torch.atan, 'sinh': torch.sinh, 'cosh': torch.cosh,
    'tanh': torch.tanh, 'arcsinh': torch.asinh, 'arccosh': torch.acosh,
    'arctanh': torch.atanh, 'degrees': _float(torch.rad2deg),
    'radians': _float(torch.deg2rad), 'deg2rad': _float(torch.deg2rad),
    'rad2deg': _float(torch.rad2deg), 'logical_not': torch.logical_not,
    'invert': torch.bitwise_not, 'bitwise_not': torch.bitwise_not,
    'positive': torch.positive, 'conjugate': torch.conj_physical,
    'conj': torch.conj_physical, 'real': torch.real,
    'imag': lambda x: torch.imag(x) if x.is_complex()
    else torch.zeros_like(x),
    'angle': _float(torch.angle), 'i0': _float(torch.special.i0),
    'sinc': _float(torch.sinc), 'signbit': torch.signbit,
    'spacing': _float(_spacing),
}
_UNARY_NONDIFF = {
    'isnan': torch.isnan, 'isinf': torch.isinf, 'isfinite': torch.isfinite,
    'isposinf': torch.isposinf, 'isneginf': torch.isneginf,
    'iscomplex': lambda x: torch.imag(x) != 0 if x.is_complex()
    else torch.zeros_like(x, dtype=torch.bool),
    'isreal': torch.isreal,
}


def _named(fn, nm):
    def op(*args, **kwargs):
        return fn(*args, **kwargs)
    op.__name__ = nm
    return op


for _nm, _fn in _BINARY.items():
    register(_nm)(_named(_binary(_fn), _nm))
for _nm, _fn in _COMPARE.items():
    register(_nm, differentiable=False)(_named(_binary(_fn), _nm))
for _nm, _fn in _UNARY.items():
    register(_nm)(_named(_fn, _nm))
for _nm, _fn in _UNARY_NONDIFF.items():
    register(_nm, differentiable=False)(_named(_fn, _nm))


@register('divide', aliases=('div',))
def divide(a, b):
    return _binary(torch.true_divide)(a, b)


@register('rtruediv')
def rtruediv(a, b):
    return _binary(torch.true_divide)(b, a)


@register('cast', aliases=('Cast',), differentiable=True)
def cast(x, dtype):
    return x.to(_dtypes.to_torch(dtype))


@register('amp_cast')
def amp_cast(data, dtype='float32'):
    """The cast an AMP pass inserts (reference ``ops/legacy_ops.py``,
    tensor/amp_cast.cc): ``data`` in ``dtype``, same values. Only floating
    inputs are cast; integer ids and boolean masks pass through, as the
    reference's float-only AMPCast leaves them."""
    if not data.is_floating_point():
        return data
    return data.to(_dtypes.to_torch(dtype))


@register('amp_multicast')
def amp_multicast(*arrays, num_outputs=None, cast_narrow=False):
    """Cast a group of tensors to one dtype (reference tensor/amp_cast.cc
    amp_multicast): the widest one's, or with ``cast_narrow`` the
    narrowest one's, by item size (the first on a tie, as the reference
    picks)."""
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    widths = [a.element_size() for a in arrays]
    pick = min if cast_narrow else max
    target = arrays[widths.index(pick(widths))].dtype
    return tuple(a.to(target) for a in arrays)


@register('clip')
def clip(x, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return x
    dt = _dtypes.result_type(x, a_min, a_max)
    x = x.to(dt)
    if a_min is not None and a_max is not None and not torch.is_tensor(
            a_min) and not torch.is_tensor(a_max):
        return torch.clamp(x, a_min, a_max)
    if a_min is not None:
        x = torch.maximum(x, _dtypes.tensor_of(a_min, dt, x.device))
    if a_max is not None:
        x = torch.minimum(x, _dtypes.tensor_of(a_max, dt, x.device))
    return x


@register('round')
def round_(x, decimals=0):
    if not x.is_floating_point():
        return x
    return torch.round(x, decimals=int(decimals))


@register('where')
def where(cond, x, y):
    if not torch.is_tensor(cond):
        cond = _dtypes.tensor_of(
            cond, device=(x if torch.is_tensor(x) else y).device)
    dev = cond.device
    dt = _dtypes.result_type(x, y)
    return torch.where(cond.to(torch.bool), _operand(x, dt, dev),
                       _operand(y, dt, dev))


@register('erf')
def erf(x):
    return torch.erf(x)


@register('erfinv')
def erfinv(x):
    return torch.erfinv(x)


@register('erfc')
def erfc(x):
    return torch.erfc(x)


@register('gamma')
def gamma_fn(x):
    return torch.exp(torch.lgamma(x))


@register('gammaln')
def gammaln(x):
    return torch.lgamma(x)


@register('digamma')
def digamma(x):
    return torch.digamma(x)


@register('relu6')
def relu6(x):
    return torch.clamp(x, 0, 6)


@register('rsqrt')
def rsqrt(x):
    return torch.rsqrt(x)


@register('rcbrt')
def rcbrt(x):
    return 1.0 / _cbrt(x)


@register('logit')
def logit(x):
    return torch.log(x / (1 - x))


@register('nan_to_num')
def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register('stop_gradient', aliases=('BlockGrad', 'block_grad'),
          differentiable=True)
def stop_gradient(x):
    return x.detach()


@register('smooth_l1')
def smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


@register('softsign')
def softsign(data):
    """x / (1 + |x|) (reference mshadow_op softsign, registered in
    ``mxnet_tpu/ops/legacy_ops.py``; an activation, so it sits here)."""
    return data / (1 + torch.abs(data))
