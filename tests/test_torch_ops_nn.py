"""Forward and gradient parity of the port's nn, contrib and optimizer
update ops with the JAX package's, at the opperf rules' small sizes
(tolerances and method: tests/test_torch_ops_sweep.py)."""

import pytest

from test_torch_ops_sweep import check_forward, check_grad, \
    differentiable, ruled

NAMES = ruled('nn', 'contrib', 'optimizer_ops')


@pytest.mark.parametrize('name', NAMES)
def test_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize('name', [n for n in NAMES if differentiable(n)])
def test_grad_of_sum_matches_jax(name):
    check_grad(name)
