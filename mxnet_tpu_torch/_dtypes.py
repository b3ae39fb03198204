"""Dtypes of the port's frontend, as the JAX package yields them.

The JAX package runs with 64-bit types off: no array it makes is int64,
uint64, float64 or complex128, and ``array()`` narrows those on the way in
(reference ``ndarray.py:612-620``). PyTorch widens in several places
(``arange``, integer ``sum``/``cumsum``, index outputs), so the frontend
narrows every result with :func:`canonical`. Binary elementwise ops cast
their operands to :func:`result_type` first: JAX's promotion lattice, in
which a Python scalar is weak (it takes the array's type within its kind)
and a numpy scalar is a strong 0-dim array.
"""

import numpy as _np
import torch

__all__ = ['canonical', 'to_torch', 'to_numpy', 'result_type', 'tensor_of',
           'NARROW']

#: what a 64-bit result becomes, as JAX canonicalizes with x64 off
NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
          torch.complex128: torch.complex64}
if hasattr(torch, 'uint64'):
    NARROW[torch.uint64] = torch.uint32

_BY_NAME = {
    'bool': torch.bool, 'bool_': torch.bool,
    'int8': torch.int8, 'int16': torch.int16, 'int32': torch.int32,
    'int64': torch.int64, 'uint8': torch.uint8,
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'float32': torch.float32, 'float64': torch.float64,
    'complex64': torch.complex64, 'complex128': torch.complex128,
}
for _n in ('uint16', 'uint32', 'uint64'):
    if hasattr(torch, _n):
        _BY_NAME[_n] = getattr(torch, _n)
_TO_NAME = {v: k for k, v in _BY_NAME.items() if k != 'bool_'}


def canonical(dtype):
    """The 32-bit counterpart of a 64-bit torch dtype, else ``dtype``."""
    return NARROW.get(dtype, dtype)


def to_torch(dtype, narrow=True):
    """torch dtype for a name, numpy dtype or type, or torch dtype;
    narrowed to 32 bits unless ``narrow`` is False. ``None`` stays
    ``None``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        t = dtype
    else:
        if dtype is float:
            name = 'float32'
        elif dtype is int:
            name = 'int32'
        elif dtype is bool:
            name = 'bool'
        else:
            name = getattr(dtype, 'name', None) if not isinstance(
                dtype, str) else dtype
            if name is None:
                name = _np.dtype(dtype).name
        if name not in _BY_NAME:
            name = _np.dtype(name).name
        t = _BY_NAME[name]
    return canonical(t) if narrow else t


def to_numpy(dtype):
    """numpy dtype of a torch dtype; bfloat16 is ``ml_dtypes``'s where that
    package is there, else the torch dtype itself."""
    name = _TO_NAME[dtype]
    if name == 'bfloat16':
        try:
            import ml_dtypes
            return _np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            return dtype
    return _np.dtype(name)


# ------------------------------------------------- JAX's promotion lattice
_B, _IW, _FW, _CW = 'b1', 'i*', 'f*', 'c*'
_EDGES = {
    _B: (_IW,), _IW: ('u8', 'i8'), _FW: ('bf16', 'f16'), _CW: ('c64',),
    'u8': ('i16', 'u16'), 'u16': ('i32', 'u32'), 'u32': ('i64', 'u64'),
    'u64': (_FW,), 'i8': ('i16',), 'i16': ('i32',), 'i32': ('i64',),
    'i64': (_FW,), 'bf16': ('f32',), 'f16': ('f32',),
    'f32': ('f64', 'c64'), 'f64': ('c128',), 'c64': ('c128',),
    'c128': (),
}
_CODE = {torch.bool: _B, torch.uint8: 'u8', torch.int8: 'i8',
         torch.int16: 'i16', torch.int32: 'i32', torch.int64: 'i64',
         torch.bfloat16: 'bf16', torch.float16: 'f16',
         torch.float32: 'f32', torch.float64: 'f64',
         torch.complex64: 'c64', torch.complex128: 'c128'}
for _n, _c in (('uint16', 'u16'), ('uint32', 'u32'), ('uint64', 'u64')):
    if hasattr(torch, _n):
        _CODE[getattr(torch, _n)] = _c
_DTYPE = {v: k for k, v in _CODE.items()}
# weak types that survive to the result take the default of their kind
_DTYPE.update({_IW: torch.int32, _FW: torch.float32, _CW: torch.complex64})


def _above(code):
    seen, todo = set(), [code]
    while todo:
        c = todo.pop()
        if c not in seen:
            seen.add(c)
            todo.extend(_EDGES[c])
    return seen


_UP = {c: _above(c) for c in _EDGES}


def _lub(codes):
    common = set.intersection(*[_UP[c] for c in codes])
    # the least element of the common upper bounds: the one below all
    for c in common:
        if all(d in _UP[c] for d in common):
            return c
    raise TypeError(f'no common type for {codes}')


def _code(x):
    if torch.is_tensor(x):
        return _CODE[x.dtype]
    if isinstance(x, bool):
        return _B
    if isinstance(x, int):
        return _IW
    if isinstance(x, float):
        return _FW
    if isinstance(x, complex):
        return _CW
    if isinstance(x, _np.generic):       # a strong 0-dim array
        return _CODE[to_torch(x.dtype)]
    return _CODE[to_torch(x)]


def result_type(*operands):
    """The torch dtype JAX gives an elementwise op over ``operands``
    (tensors, Python scalars, numpy scalars or dtypes), narrowed."""
    return canonical(_DTYPE[_lub([_code(x) for x in operands
                                  if x is not None])])


def tensor_of(v, dtype=None, device=None):
    """``v`` as a tensor of ``dtype`` on ``device``. A Python or numpy
    scalar is filled on the device (``torch.full``, a kernel): a host copy
    of a pageable scalar would synchronize the card's stream."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=dtype)
    if isinstance(v, (bool, int, float, complex, _np.generic)):
        return torch.full((), v.item() if isinstance(v, _np.generic) else v,
                          dtype=dtype or result_type(v), device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)
