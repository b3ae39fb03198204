"""Legacy ``mx.nd`` namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: one NDArray class backs
``mx.nd`` and ``mx.np``; the creators and every op tagged ``'nd'`` are
injected here. ``waitall`` synchronizes every visible card; ``save`` and
``load`` read and write the NDArray-map files of :mod:`..model`.
"""

import sys as _sys

import torch

from .ndarray import NDArray, array  # noqa: F401
from ..ops.creation import FRONTEND_CREATORS as _CREATORS
from . import register as _register


def waitall():
    """Block until every card's queued work is done (reference
    mx.nd.waitall); a deferred device error is raised here."""
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        torch.cuda.synchronize(i)


_mod = _sys.modules[__name__]
for _n, _f in _CREATORS.items():
    setattr(_mod, _n, _f)

_register.populate(_mod.__dict__, 'nd')

from .ndarray import array as from_numpy  # noqa: E402,F401
from . import sparse  # noqa: E402,F401  (mx.nd.sparse)
from . import contrib  # noqa: E402,F401  (mx.nd.contrib.foreach, ...)


def save(fname, data):
    """Write an NDArray, a list or a dict of them (``mx.nd.save``)."""
    from ..model import save_ndarray_map
    save_ndarray_map(fname, data)


def load(fname):
    """Read what :func:`save` wrote (``mx.nd.load``)."""
    from ..model import load_ndarray_map
    return load_ndarray_map(fname)
