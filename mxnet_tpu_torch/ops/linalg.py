"""The two products that NDArray's operators reach: ``matmul`` (``a @ b``)
and ``dot`` (``a.dot(b)``).

Counterpart of ``dot`` and ``matmul`` in ``mxnet_tpu/ops/linalg.py``
(reference src/operator/tensor/dot*): each one cuBLAS call through
PyTorch, as the reference leaves them to XLA. The other products and the
``linalg_*`` decompositions and solvers of that module are not ported yet
(``ops/ledger.py``).
"""

import torch

from .. import _dtypes
from .registry import register


def _common(*arrays):
    dt = _dtypes.result_type(*arrays)
    return [a.to(dt) for a in arrays]


@register('dot')
def dot(a, b):
    a, b = _common(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() <= 2:
        return torch.matmul(a, b)
    # numpy: sum over a's last axis and b's second to last
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


@register('matmul')
def matmul(a, b):
    a, b = _common(a, b)
    return torch.matmul(a, b)
