"""The port's fused optimizer steps (``ops/optimizer_ops.py`` over
``ops/kernels/fused_optimizer.py``) against the Pallas kernels they
replace.

On the CPU the kernels' wrappers run their plain PyTorch versions (the
CUDA kernels meet those versions on the card in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``). Here the plain versions, through the ops,
meet ``adam_step``/``sgd_mom_step`` of the JAX package in interpret mode on
the same numpy inputs, at the JAX package's own tolerance for these
kernels (tests/test_pallas_kernels.py): rtol = 1e-6, atol = 1e-7. The
Pallas kernels tile by 128 lanes, so a ragged size meets the registered
XLA fallback instead.
"""

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import optimizer_ops as jax_ops
from mxnet_tpu.ops.pallas.fused_optimizer import adam_step, sgd_mom_step

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import kernels, optimizer_ops
from mxnet_tpu_torch.ops.kernels import fused_optimizer

TOL = dict(rtol=1e-6, atol=1e-7)
HYPER = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)


def _slots(shape, seed, n):
    """w ~ N(0, 1), g ~ N(0, 0.3^2) (around the clip of 0.1) and ``n``
    slots at a tenth of the weights' scale, as training leaves them
    (Adam's v non-negative). XLA on the CPU contracts a multiply and an
    add into one FMA where PyTorch rounds twice: slots as large as the
    weights would turn that last-bit difference into a large relative one
    wherever ``w + mom`` cancels."""
    rng = onp.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(onp.float32)
            for _ in range(2 + n)]
    arrs[1] *= 0.3
    for i in range(2, 2 + n):
        arrs[i] *= 0.1
    if n == 2:
        arrs[3] = onp.abs(arrs[3]) * 0.1
    return arrs


def _torch(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _close(got, want):
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **TOL)


def _adam_case(shape, wd, clip, rescale, t, correct_bias, seed=0):
    w, g, m, v = _slots(shape, seed, 2)
    want = adam_step(*(jnp.asarray(a) for a in (w, g, m, v)), 1e-3, wd, t,
                     rescale_grad=rescale, clip_gradient=clip,
                     correct_bias=correct_bias, interpret=True, **HYPER)
    got = optimizer_ops.fused_adam_step(
        *_torch((w, g, m, v)), lr=1e-3, wd=wd, t=t, rescale_grad=rescale,
        clip_gradient=clip, correct_bias=correct_bias, **HYPER)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize('t,correct_bias', [(1, True), (7, True),
                                            (7, False)],
                         ids=['t1', 't7', 't7-nobias'])
@pytest.mark.parametrize('rescale', [1.0, 0.25])
@pytest.mark.parametrize('clip', [None, 0.1], ids=['noclip', 'clip'])
@pytest.mark.parametrize('wd', [0.0, 1e-2])
def test_adam_matches_pallas_interpret(wd, clip, rescale, t, correct_bias):
    _adam_case((8, 128), wd, clip, rescale, t, correct_bias)


@pytest.mark.parametrize('wd,clip,rescale,t', [(1e-2, 0.1, 0.25, 1),
                                               (0.0, None, 1.0, 7)])
def test_adam_matches_pallas_interpret_3x256(wd, clip, rescale, t):
    _adam_case((3, 256), wd, clip, rescale, t, True, seed=1)


def _sgd_case(shape, wd, clip, rescale, seed=0):
    w, g, mom = _slots(shape, seed, 1)
    want = sgd_mom_step(*(jnp.asarray(a) for a in (w, g, mom)), 0.1, wd,
                        momentum=0.9, rescale_grad=rescale,
                        clip_gradient=clip, interpret=True)
    got = optimizer_ops.fused_sgd_mom_step(
        *_torch((w, g, mom)), lr=0.1, wd=wd, momentum=0.9,
        rescale_grad=rescale, clip_gradient=clip)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize('rescale', [1.0, 0.25])
@pytest.mark.parametrize('clip', [None, 0.1], ids=['noclip', 'clip'])
@pytest.mark.parametrize('wd', [0.0, 1e-2])
def test_sgd_mom_matches_pallas_interpret(wd, clip, rescale):
    _sgd_case((8, 128), wd, clip, rescale)


def test_sgd_mom_matches_pallas_interpret_3x256():
    _sgd_case((3, 256), 1e-2, 0.1, 0.25, seed=1)


def test_ragged_size_matches_the_xla_fallback():
    """1000 elements (not a multiple of 128): the reference op takes its
    XLA fallback, which the Pallas kernel matches bit for bit."""
    w, g, m, v = _slots((1000,), 2, 2)
    kw = dict(lr=1e-3, wd=1e-2, t=3, rescale_grad=0.5, clip_gradient=0.1,
              **HYPER)
    want = jax_ops.fused_adam_step(*(jnp.asarray(a) for a in (w, g, m, v)),
                                   **kw)
    for a, b in zip(optimizer_ops.fused_adam_step(*_torch((w, g, m, v)),
                                                  **kw), want):
        _close(a, b)
    w, g, mom = _slots((1000,), 3, 1)
    kw = dict(lr=0.1, wd=1e-2, momentum=0.9, rescale_grad=0.5,
              clip_gradient=0.1)
    want = jax_ops.fused_sgd_mom_step(*(jnp.asarray(a) for a in (w, g, mom)),
                                      **kw)
    for a, b in zip(optimizer_ops.fused_sgd_mom_step(*_torch((w, g, mom)),
                                                     **kw), want):
        _close(a, b)


def test_updates_are_in_place():
    """The weight and the slots come back as the same buffers, updated,
    as the TPU kernels alias them; the gradient is left alone."""
    w, g, m, v = _torch(_slots((4, 128), 4, 2))
    ptrs, g0 = [x.data_ptr() for x in (w, m, v)], g.clone()
    w0 = w.clone()
    out = optimizer_ops.fused_adam_step(w, g, m, v, lr=1e-2, **HYPER)
    assert [x.data_ptr() for x in out] == ptrs
    assert out[0] is w and not torch.equal(w, w0)
    assert torch.equal(g, g0)
    w, g, mom = _torch(_slots((4, 128), 5, 1))
    ptrs = [w.data_ptr(), mom.data_ptr()]
    out = optimizer_ops.fused_sgd_mom_step(w, g, mom, lr=0.1, momentum=0.9)
    assert [x.data_ptr() for x in out] == ptrs


def test_cpu_optimizer_steps_count_no_launch():
    kernels.reset_launch_counts()
    w, g, m, v = _torch(_slots((2, 128), 6, 2))
    optimizer_ops.fused_adam_step(w, g, m, v)
    optimizer_ops.fused_sgd_mom_step(w, g, m, momentum=0.9)
    assert kernels.launch_counts()['adam'] == 0
    assert kernels.launch_counts()['sgd_mom'] == 0


def test_wrappers_refuse_mismatched_or_strided_tensors():
    w = torch.zeros(4, 8)
    with pytest.raises(MXNetError, match='shapes'):
        fused_optimizer.sgd_mom_step(w, torch.zeros(8, 4), w.clone(),
                                     torch.tensor([0.1, 0.0]), momentum=0.9)
    strided = torch.zeros(8, 4).t()
    with pytest.raises(MXNetError, match='contiguous'):
        fused_optimizer.adam_step(strided, w, w.clone(), w.clone(),
                                  torch.tensor([0.1, 0.0, 1.0, 1.0]),
                                  **HYPER)


# ------------------------------------------------ the device-vector interface
def _traced(fn, arrs, *scalars):
    """The Pallas kernel in interpret mode under ``jax.jit``, with the
    step-varying scalars traced, as the JAX Trainer's fused update calls
    it."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrs), *scalars)


@pytest.mark.parametrize('t', [1, 2, 7, 300])
def test_adam_vector_matches_the_traced_pallas_kernel(t):
    """``(lr, wd, bc1, bc2)`` from ``Adam.fill_hyper`` (the bias
    corrections from a float32 count, on the tensor's device) against the
    JAX Trainer's ``1.0 - beta ** t`` with ``t`` a traced int32: within
    one ulp. Through the plain version, the update against ``adam_step``
    with that traced ``t`` at this file's tolerance: XLA contracts the
    kernel's multiply-adds into FMAs on the CPU, with or without
    ``jax.jit``, which leaves hundreds of ulps where ``w + update``
    cancels."""
    from mxnet_tpu_torch.optimizer import Adam
    hyper = torch.tensor([[1e-3, 1e-2, 1.0, 1.0]])
    Adam(**HYPER).fill_hyper(hyper, torch.tensor([float(t)]))
    want_bc = jax.jit(lambda t: (1.0 - HYPER['beta1'] ** t,
                                 1.0 - HYPER['beta2'] ** t))(jnp.int32(t))
    for got_bc, bc in zip(hyper[0, 2:], want_bc):
        onp.testing.assert_array_max_ulp(got_bc.numpy(), onp.asarray(bc), 1)
    w, g, m, v = _slots((8, 128), 20 + t, 2)
    kw = dict(rescale_grad=0.5, clip_gradient=0.1, **HYPER)
    want = _traced(lambda w, g, m, v, lr, wd, t: adam_step(
        w, g, m, v, lr, wd, t, interpret=True, **kw), (w, g, m, v),
        jnp.float32(1e-3), jnp.float32(1e-2), jnp.int32(t))
    got = fused_optimizer.adam_step_plain(*_torch((w, g, m, v)), hyper[0],
                                          **kw)
    for a, b in zip(got, want):
        _close(a, b)


def test_sgd_mom_vector_matches_the_traced_pallas_kernel():
    w, g, mom = _slots((8, 128), 30, 1)
    kw = dict(momentum=0.9, rescale_grad=0.5, clip_gradient=0.1)
    want = _traced(lambda w, g, mom, lr, wd: sgd_mom_step(
        w, g, mom, lr, wd, interpret=True, **kw), (w, g, mom),
        jnp.float32(0.1), jnp.float32(1e-2))
    got = fused_optimizer.sgd_mom_step_plain(
        *_torch((w, g, mom)), torch.tensor([0.1, 1e-2]), **kw)
    for a, b in zip(got, want):
        _close(a, b)


def test_optimizer_update_reads_each_rows_hyperparameters():
    """``Optimizer.update`` over a list builds one vector for the step:
    each index's ``lr_mult`` and count reach its own row."""
    from mxnet_tpu_torch.optimizer import SGD
    opt = SGD(learning_rate=0.1, momentum=0.9)
    opt.set_lr_mult({0: 1.0, 1: 0.5})
    ws = _torch(_slots((4, 128), 40, 0)) + _torch(_slots((4, 128), 41, 0))
    ws, gs = ws[0::2], ws[1::2]
    want = [w.clone() for w in ws]
    moms = [torch.zeros_like(w) for w in ws]
    opt.update([0, 1], ws, gs, moms)
    for w, g, mult in zip(want, gs, (1.0, 0.5)):
        optimizer_ops.fused_sgd_mom_step(w, g, torch.zeros_like(w),
                                         lr=0.1 * mult, momentum=0.9)
    for a, b in zip(ws, want):
        assert torch.equal(a, b)
    assert opt._index_update_count == {0: 1, 1: 1}
