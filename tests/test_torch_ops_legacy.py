"""The port's legacy-name ops (``ops/legacy_ops.py``, with ``softsign``
and ``square_sum`` swept in their families) against the JAX package's
(the A3 cases of ``tests/test_op_additions.py``,
``test_op_additions_r2.py`` and ``test_op_gap_closure.py`` are the
oracles; the contrib ops are in ``tests/test_torch_ops_contrib.py``),
forward and, where both
packages differentiate the op, the gradient of ``sum()`` of the first
output (harness and tolerances: ``tests/test_torch_linalg.py``'s
``check``).
"""

import numpy as np
import pytest

import mxnet_tpu_torch as tmx

from test_torch_linalg import check
from test_torch_ops_a3 import _grad_ok
from torch_a3_cases import LEGACY


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield




@pytest.mark.parametrize('name, args, kw', LEGACY,
                         ids=[f'{n}{i}' for i, (n, _, _) in
                              enumerate(LEGACY)])
def test_op_matches_jax(name, args, kw):
    check(name, args, kw, rtol=1e-5, atol=1e-5, grad=_grad_ok(name) and any(
        isinstance(a, np.ndarray) and a.dtype == np.float32 for a in args))


def test_legacy_binary_names_are_nd_only():
    for name in ('broadcast_add', 'elemwise_mul', 'broadcast_logical_xor'):
        assert hasattr(tmx.nd, name) and not hasattr(tmx.np, name), name
