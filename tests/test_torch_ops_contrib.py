"""The port's contrib ops off the attention path (``ops/contrib.py``:
the interleaved products, sliding-window attention, the index and sketch
ops, the straight-through and gradient-scaling ops, ``hawkesll``, ...)
against the JAX package's (the contrib cases of
``tests/test_op_additions_r2.py`` and ``test_op_gap_closure.py`` are the
oracles), forward and, where both packages differentiate the op, the
gradient of ``sum()`` of the first output (harness and tolerances:
``tests/test_torch_linalg.py``'s ``check``).
"""

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag

from test_torch_linalg import check
from test_torch_ops_a3 import _grad_ok
from torch_a3_cases import CONTRIB, _r


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield




@pytest.mark.parametrize('name, args, kw', CONTRIB,
                         ids=[f'{n}{i}' for i, (n, _, _) in
                              enumerate(CONTRIB)])
def test_op_matches_jax(name, args, kw):
    check(name, args, kw, rtol=1e-5, atol=1e-5, grad=_grad_ok(name) and any(
        isinstance(a, np.ndarray) and a.dtype == np.float32 for a in args))


def test_straight_through_and_scaled_gradients():
    x = tmx.np.array(_r(3, 4))
    x.attach_grad()
    with tag.record():
        loss = (tmx.npx.round_ste(x) * 2 + tmx.npx.gradient_multiplier(
            x, scalar=-3.0)).sum()
    loss.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full((3, 4), -1.0))
