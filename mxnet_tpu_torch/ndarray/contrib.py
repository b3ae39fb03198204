"""``mx.nd.contrib``: the control flow (``foreach``, ``while_loop``,
``cond``) and every op of the ``nd`` namespace, as the reference's
python/mxnet/ndarray/contrib.py reaches them (counterpart of
``mxnet_tpu/ndarray/contrib.py``)."""

import sys as _sys

from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401
from . import register as _register

_register.populate(_sys.modules[__name__].__dict__, 'nd')
