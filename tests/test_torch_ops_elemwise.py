"""Forward and gradient parity of the port's elemwise ops with the JAX
package's, at the opperf rules' small sizes (tolerances and method:
tests/test_torch_ops_sweep.py)."""

import pytest

from test_torch_ops_sweep import check_forward, check_grad, \
    differentiable, ruled

NAMES = ruled('elemwise')


@pytest.mark.parametrize('name', NAMES)
def test_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize('name', [n for n in NAMES if differentiable(n)])
def test_grad_of_sum_matches_jax(name):
    check_grad(name)
