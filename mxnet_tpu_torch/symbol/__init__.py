"""``mx.sym``/``mx.symbol``: the symbolic graph frontend.

Counterpart of ``mxnet_tpu/symbol/__init__.py`` (reference
``python/mxnet/symbol/``: graph building, compose, infer_shape, tojson;
``symbol/numpy/_symbol.py``, the numpy namespace deferred compute uses).
Every registered op of the port gets a symbolic variant here, generated
from the op registry as the reference generates ``mx.sym.*``
(symbol/register.py): ``mx.sym`` from the ``nd`` namespace, ``mx.sym.np``
from ``np`` and ``mx.sym.npx`` from ``npx``.
"""

import sys as _sys
import types as _types

from .symbol import (Executor, Group, Symbol, Variable, fromjson, load,
                     load_json, make_symbol_frontend, var)
from ..ops import registry as _reg

__all__ = ['Symbol', 'Variable', 'var', 'Group', 'load', 'load_json',
           'fromjson', 'Executor', 'np', 'npx']


def _populate(module_dict, namespace):
    for name, op in _reg.list_ops().items():
        if namespace not in op.namespaces:
            continue
        module_dict.setdefault(name, make_symbol_frontend(name))
    return module_dict


_mod = _sys.modules[__name__]
_populate(_mod.__dict__, 'nd')

# mx.sym.np / mx.sym.npx — numpy-flavoured symbol namespaces
np = _types.ModuleType(__name__ + '.np')
np.__doc__ = 'numpy-flavoured symbolic ops (reference symbol/numpy/_symbol.py)'
_populate(np.__dict__, 'np')
np.Symbol = Symbol

npx = _types.ModuleType(__name__ + '.npx')
npx.__doc__ = 'npx-flavoured symbolic ops (reference symbol/numpy_extension)'
_populate(npx.__dict__, 'npx')

_sys.modules[np.__name__] = np
_sys.modules[npx.__name__] = npx
