"""``mx.random`` namespace (reference python/mxnet/random.py)."""

import sys as _sys

from ._rng import get_state, set_state  # noqa: F401
from .ops import registry as _reg
from .ops.random_ops import seed  # noqa: F401

_mod = _sys.modules[__name__]
for _name, _op in _reg.list_ops().items():
    if _name.startswith('random_'):
        setattr(_mod, _name[len('random_'):], _reg.make_frontend(_op.name))
