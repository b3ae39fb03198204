"""Operator library of the port.

Counterpart of ``mxnet_tpu/ops/``: importing this package registers every
ported op in :mod:`.registry`; the frontend namespaces (``mx.nd``,
``mx.np``, ``mx.npx``) are generated from it. The op families are plain
PyTorch, as the reference leaves them to XLA; the ops that reach a
Pallas kernel there (the norms, the attention ops, the fused optimizer
steps, the int8 product) reach the hand-written CUDA kernels of
:mod:`.kernels` here. :mod:`.ledger` lists the reference's ops that are
not ported yet. The control flow (:mod:`.control_flow`) is plain
functions over Python callables, not registered ops, as in the
reference.
"""

from . import registry
from .registry import apply_op, get_op, list_ops, register

from . import creation      # noqa: F401
from . import elemwise      # noqa: F401
from . import reduce        # noqa: F401
from . import manipulation  # noqa: F401
from . import linalg        # noqa: F401
from . import random_ops    # noqa: F401
from . import nn            # noqa: F401
from . import contrib       # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import quantization_ops  # noqa: F401
from . import fft_ops       # noqa: F401
from . import numpy_extras  # noqa: F401
from . import legacy_ops    # noqa: F401
from . import control_flow  # noqa: F401
from . import arity

arity.apply()
