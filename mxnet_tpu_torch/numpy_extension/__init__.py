"""``mx.npx`` — the NumPy-extension namespace for neural ops.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py`` (reference
python/mxnet/numpy_extension/): every registered op is reachable here
(``npx.rms_norm``, ``npx.flash_attention``, ``npx.fused_adam_step``, ...),
beside the ``set_np`` switches, the device helpers and ``save``/``load``
(the NDArray-map files of :mod:`..model`), and the control flow
(``cond``, ``foreach``, ``while_loop``: plain functions over Python
callables, ``ops/control_flow.py``).
"""

import sys as _sys

from ..ndarray import register as _register
from ..ops import registry as _reg

_mod = _sys.modules[__name__]

_register.populate(_mod.__dict__, 'np')
_register.populate(_mod.__dict__, 'nd')

from ..ops.control_flow import cond, foreach, while_loop  # noqa: E402
from ..model import save_ndarray_map as save     # noqa: E402
from ..model import load_ndarray_map as load     # noqa: E402

_np_flags = {'shape': True, 'array': True}


def set_np(shape=True, array=True, dtype=False):
    """NumPy semantics are native here; this records the flags."""
    _np_flags['shape'] = shape
    _np_flags['array'] = array


def reset_np():
    set_np(False, False)


def is_np_shape():
    return _np_flags['shape']


def is_np_array():
    return _np_flags['array']


def use_np(func):
    return func


def waitall():
    from ..ndarray import waitall as w
    w()


def current_device():
    from ..context import current_context
    return current_context()


def cpu(i=0):
    from ..context import cpu as _cpu
    return _cpu(i)


def gpu(i=0):
    from ..context import gpu as _gpu
    return _gpu(i)


def num_gpus():
    from ..context import num_gpus as n
    return n()


def seed(s):
    from ..ops.random_ops import seed as _s
    _s(s)


def softmax(data, axis=-1, **kw):
    return _reg.make_frontend('softmax')(data, axis=axis, **kw)
