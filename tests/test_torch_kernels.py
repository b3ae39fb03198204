"""Each hand-written kernel of the PyTorch port, held against the Pallas
kernel it replaces.

On the CPU a kernel's wrapper runs its plain PyTorch version (the CUDA
kernel itself is checked against that version on the card by
``chip_smoke.py``). Here the plain versions meet the JAX package's Pallas
kernels in interpret mode on the same inputs, made with numpy from a seed,
at the JAX tests' own fp32 tolerance: rtol = atol = 1e-5. The gradients of
the norm and flash ops (their ``autograd.Function``s) meet ``jax.vjp`` of
the JAX ops, whose ``custom_vjp`` backwards they copy, at the same
tolerance. The optimizer kernels have their own file,
``tests/test_torch_optimizer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import nn as jax_nn
from mxnet_tpu.ops.pallas.flash_attention import flash_attention as \
    jax_flash
from mxnet_tpu.ops.pallas.fused_norms import _ln_pallas, \
    fused_layer_norm as jax_layer_norm, fused_rms_norm as jax_rms_norm
from mxnet_tpu.ops.pallas.paged_attention import \
    paged_attention_decode_pallas

from mxnet_tpu_torch.ops import contrib, kernels, nn as torch_nn
from mxnet_tpu_torch.ops.kernels import fused_norms, fused_optimizer, \
    int8_matmul, paged_attention
from mxnet_tpu_torch.ops.kernels.flash_attention import \
    FlashAttentionFunction, flash_attention_fwd, flash_attention_stats

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                **(tol or TOL))


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(onp.float32)


# ------------------------------------------------------------ fused norms
@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('n,d', [(16, 256), (6, 64)])
def test_fused_norm_matches_pallas_interpret(rms, n, d):
    rng = onp.random.default_rng(0)
    x = _randn(rng, n, d, scale=3.0) + 0.5
    g = _randn(rng, d)
    b = None if rms else _randn(rng, d)
    want = _ln_pallas(jnp.asarray(x), jnp.asarray(g),
                      None if b is None else jnp.asarray(b), 1e-5, rms,
                      interpret=True, out_dtype=jnp.float32)
    got = fused_norms.fused_norm(
        torch.from_numpy(x), torch.from_numpy(g),
        None if b is None else torch.from_numpy(b), 1e-5, rms)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize('axis', [-1, 1])
def test_norm_ops_match_reference_ops(axis):
    """The op layer (last axis → fused kernel, other axes → plain math)
    agrees with the JAX package's registered ops."""
    rng = onp.random.default_rng(1)
    x = _randn(rng, 2, 8, 4)
    g = _randn(rng, x.shape[axis])
    b = _randn(rng, x.shape[axis])
    _close(torch_nn.rms_norm(torch.from_numpy(x), torch.from_numpy(g),
                             axis=axis, eps=1e-6),
           jax_nn.rms_norm(jnp.asarray(x), jnp.asarray(g), axis=axis,
                           eps=1e-6))
    _close(torch_nn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), axis=axis),
           jax_nn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                             jnp.asarray(b), axis=axis))


# -------------------------------------------------------- flash attention
@pytest.mark.parametrize('causal,t,s', [
    (True, 64, 64),       # causal self-attention
    (False, 64, 64),      # non-causal
    (True, 32, 96),       # T < S: bottom-right causal
    (False, 37, 96),      # ragged T
    (True, 37, 96),       # ragged T, bottom-right causal
], ids=['causal', 'noncausal', 'causal-t<s', 'ragged', 'ragged-causal'])
def test_flash_attention_matches_pallas_interpret(causal, t, s):
    rng = onp.random.default_rng(2)
    q, k, v = (_randn(rng, 3, n, 16) for n in (t, s, s))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=32, block_k=32, interpret=True)
    got = contrib.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    _close(got, want)


def test_flash_attention_leading_dims_and_causal_t_gt_s():
    """(B, H, T, d) inputs, and causal with more queries than keys (the
    reference's plain-attention branch)."""
    rng = onp.random.default_rng(3)
    q, k, v = _randn(rng, 2, 2, 12, 8), _randn(rng, 2, 2, 8, 8), \
        _randn(rng, 2, 2, 8, 8)
    for causal in (False, True):
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, interpret=True)
        got = contrib.flash_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
        _close(got, want)


# ------------------------------------------------------------ paged decode
def _paged_case(B=3, H=4, kv=2, dh=16, P=32, psz=4, NP=6, seed=0):
    rng = onp.random.default_rng(seed)
    q = _randn(rng, B, H, dh)
    kp = _randn(rng, P, psz, kv, dh)
    vp = _randn(rng, P, psz, kv, dh)
    # distinct non-garbage pages per row (page 0 reserved as garbage)
    pages = rng.permutation(onp.arange(1, P))[:B * NP].reshape(B, NP)
    return q, kp, vp, pages.astype(onp.int32)


def _paged_both(q, kp, vp, pages, offset):
    B, H, dh = q.shape
    kv = kp.shape[2]
    qg = q.reshape(B, kv, H // kv, dh)
    want = paged_attention_decode_pallas(
        jnp.asarray(qg), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pages), jnp.asarray(offset), dh ** -0.5,
        interpret=True)
    got = paged_attention.paged_attention_decode(
        torch.from_numpy(qg), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pages), torch.from_numpy(offset), dh ** -0.5)
    return got, want


def test_paged_attention_mixed_depths():
    """A fresh join, a mid-sequence row and a row at full depth."""
    q, kp, vp, pages = _paged_case()
    NP, psz = pages.shape[1], kp.shape[1]
    got, want = _paged_both(q, kp, vp, pages,
                            onp.asarray([0, 9, NP * psz - 1], onp.int32))
    _close(got, want)


def test_paged_attention_page_boundaries():
    """Offsets on the last slot of a page and the first of the next."""
    q, kp, vp, pages = _paged_case(B=4, seed=7)
    psz = kp.shape[1]
    got, want = _paged_both(
        q, kp, vp, pages,
        onp.asarray([psz - 1, psz, 2 * psz - 1, 2 * psz], onp.int32))
    _close(got, want)


def test_paged_attention_dead_row_is_finite():
    """A retired row (all garbage pages, offset 0) gives finite values
    and leaves its live neighbours unchanged."""
    q, kp, vp, pages = _paged_case()
    pages[1] = 0
    got, want = _paged_both(q, kp, vp, pages,
                            onp.asarray([3, 0, 5], onp.int32))
    assert torch.isfinite(got).all()
    _close(got, want)


def test_paged_attention_op_groups_heads():
    """The op's (B, H, dh) layout: query heads [j*G, (j+1)*G) share KV
    head j, as in the reference's gather fallback."""
    from mxnet_tpu.ops.contrib import paged_attention_decode as jax_op
    q, kp, vp, pages = _paged_case(seed=5)
    off = onp.asarray([2, 11, 20], onp.int32)
    want = jax_op(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(pages), jnp.asarray(off))
    got = contrib.paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pages), torch.from_numpy(off))
    _close(got, want)


# -------------------------------------------------------------- gradients
def _vjp(fn, args, ct):
    """``jax.vjp`` of ``fn`` at numpy ``args`` for the cotangent ``ct``."""
    _, pull = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return pull(jnp.asarray(ct))


def _torch_grads(fn, args, ct):
    """Gradients of ``fn`` at numpy ``args`` by autograd for ``ct``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    fn(*ts).backward(torch.from_numpy(ct))
    return [t.grad for t in ts]


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('shape', [(2, 8, 64), (5, 48)])
def test_norm_gradients_match_the_reference_vjp(rms, shape):
    """dx, dgamma (and dbeta) of the op against ``_fused_norm_bwd``."""
    rng = onp.random.default_rng(8)
    d = shape[-1]
    x = _randn(rng, *shape, scale=2.0) + 0.3
    args = [x, _randn(rng, d) + 1.0] + ([] if rms else [_randn(rng, d)])
    ct = _randn(rng, *shape)
    if rms:
        want = _vjp(lambda x_, g_: jax_rms_norm(x_, g_, 1e-6), args, ct)
        got = _torch_grads(lambda x_, g_: torch_nn.rms_norm(x_, g_, eps=1e-6),
                           args, ct)
    else:
        want = _vjp(lambda x_, g_, b_: jax_layer_norm(x_, g_, b_, 1e-5),
                    args, ct)
        got = _torch_grads(lambda x_, g_, b_: torch_nn.layer_norm(x_, g_, b_),
                           args, ct)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize('causal,t,s', [
    (True, 32, 32), (False, 32, 32), (True, 24, 40), (False, 24, 40)],
    ids=['causal', 'full', 'causal-t<s', 'full-t<s'])
def test_flash_gradients_match_the_reference_vjp(causal, t, s):
    """dq, dk, dv of the op against ``_flash3_bwd`` (the XLA path of the
    reference's ``custom_vjp`` off the TPU), with leading (B, H) dims."""
    rng = onp.random.default_rng(9)
    args = [_randn(rng, 2, 3, n, 16) for n in (t, s, s)]
    ct = _randn(rng, 2, 3, t, 16)
    want = _vjp(lambda q, k, v: jax_flash(q, k, v, causal=causal), args, ct)
    got = _torch_grads(
        lambda q, k, v: contrib.flash_attention(q, k, v, causal=causal),
        args, ct)
    for a, b in zip(got, want):
        _close(a, b)


def _graph_has(out, fn_cls):
    """True when ``fn_cls``'s backward node is in ``out``'s graph."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if getattr(node, '_forward_cls', None) is fn_cls:
            return True
        todo.extend(n for n, _ in node.next_functions)
    return False


def test_ops_record_their_function_when_autograd_records():
    """With grad on and an input that requires grad, the norm and flash
    ops go through their ``autograd.Function``s, so the kernels' outputs
    have a gradient on the card too (a wrapper's output alone has none)."""
    x = torch.randn(3, 64, requires_grad=True)
    y = torch_nn.rms_norm(x, torch.ones(64))
    assert y.grad_fn._forward_cls is fused_norms.FusedNormFunction
    y = torch_nn.layer_norm(torch.randn(3, 64), torch.ones(64,
                            requires_grad=True), torch.zeros(64))
    assert y.grad_fn._forward_cls is fused_norms.FusedNormFunction
    q = torch.randn(2, 8, 16, requires_grad=True)
    kv = torch.randn(2, 8, 16)
    out = contrib.flash_attention(q, kv, kv, causal=True)
    assert _graph_has(out, FlashAttentionFunction)


def test_ops_skip_their_function_when_nothing_needs_a_gradient(
        monkeypatch):
    """Under ``no_grad``, or with no input that requires grad, the ops
    call the wrappers directly: inference pays nothing for autograd."""
    def refuse(*args):
        raise AssertionError('autograd.Function used without autograd')
    monkeypatch.setattr(fused_norms.FusedNormFunction, 'apply', refuse)
    monkeypatch.setattr(FlashAttentionFunction, 'apply', refuse)
    x = torch.randn(3, 64, requires_grad=True)
    qkv = torch.randn(2, 8, 16, requires_grad=True)
    with torch.no_grad():
        torch_nn.rms_norm(x, torch.ones(64))
        torch_nn.layer_norm(x, torch.ones(64), torch.zeros(64))
        contrib.flash_attention(qkv, qkv, qkv, causal=True)
    y = torch_nn.rms_norm(x.detach(), torch.ones(64))
    assert y.grad_fn is None
    contrib.flash_attention(qkv.detach(), qkv.detach(), qkv.detach())


# --------------------------------------------------------- launch counters
def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    kernels.reset_launch_counts()
    rng = onp.random.default_rng(4)
    x = torch.from_numpy(_randn(rng, 4, 64))
    fused_norms.fused_rms_norm(x, torch.ones(64))
    fused_norms.fused_layer_norm(x, torch.ones(64), torch.zeros(64))
    qkv = torch.from_numpy(_randn(rng, 2, 8, 32))
    flash_attention_fwd(qkv, qkv, qkv, 0.1, True)
    flash_attention_stats(qkv, qkv, qkv, 0.1, True)
    q, kp, vp, pages = _paged_case()
    _paged_both(q, kp, vp, pages, onp.asarray([1, 2, 3], onp.int32))
    fused_optimizer.adam_step(x, x.clone(), x.clone(), x.clone() ** 2,
                              1e-3, 0.0, 0.1, 0.001, beta1=0.9, beta2=0.999,
                              epsilon=1e-8)
    fused_optimizer.sgd_mom_step(x, x.clone(), x.clone(), 0.1, 0.0,
                                 momentum=0.9)
    xq = torch.ones(4, 64, dtype=torch.int8)
    int8_matmul.int8_matmul(xq, xq[:3], torch.ones(3), None, 'bfloat16')
    assert kernels.launch_counts() == {
        'fused_norm': 0, 'flash_attention': 0, 'paged_attention_decode': 0,
        'adam': 0, 'sgd_mom': 0, 'int8_matmul': 0,
        'flash_attention_stats': 0, 'rtc': 0}


def test_tensors_off_the_cpu_never_take_the_plain_path():
    """A tensor that is not on the CPU (here on the meta device) goes to
    the kernel or raises; a layout the kernel cannot take raises on the
    CPU too."""
    from mxnet_tpu_torch import MXNetError
    kernels.reset_launch_counts()
    x = torch.empty(4, 64, device='meta')
    with pytest.raises(MXNetError, match='CUDA'):
        fused_norms.fused_rms_norm(x, torch.empty(64, device='meta'))
    qkv = torch.empty(2, 8, 32, device='meta')
    with pytest.raises(MXNetError, match='CUDA'):
        flash_attention_fwd(qkv, qkv, qkv, 0.1, False)
    q, kp, vp, pages = (torch.from_numpy(a) for a in _paged_case())
    with pytest.raises(MXNetError, match='CUDA'):
        paged_attention.paged_attention_decode(
            q.reshape(3, 2, 2, 16).to('meta'), kp.to('meta'), vp.to('meta'),
            pages.to('meta'), torch.zeros(3, dtype=torch.int32,
                                          device='meta'), 0.25)
    w = torch.empty(4, 64, device='meta')
    with pytest.raises(MXNetError, match='CUDA'):
        fused_optimizer.adam_step(w, w.clone(), w.clone(), w.clone(), 1e-3,
                                  0.0, 1.0, 1.0, beta1=0.9, beta2=0.999,
                                  epsilon=1e-8)
    with pytest.raises(MXNetError, match='CUDA'):
        fused_optimizer.sgd_mom_step(w, w.clone(), w.clone(), 0.1, 0.0,
                                     momentum=0.9)
    xq = torch.empty(4, 64, dtype=torch.int8, device='meta')
    with pytest.raises(MXNetError, match='CUDA'):
        int8_matmul.int8_matmul(xq, xq, torch.empty(4, device='meta'))
    with pytest.raises(MXNetError, match='int8'):
        int8_matmul.int8_matmul(torch.ones(4, 64), torch.ones(4, 64),
                                torch.ones(4))
    with pytest.raises(MXNetError, match='contiguous'):
        int8_matmul.int8_matmul(torch.ones(64, 4, dtype=torch.int8).t(),
                                torch.ones(4, 64, dtype=torch.int8),
                                torch.ones(4))
    strided = torch.zeros(2, 8, 64).transpose(1, 2)
    with pytest.raises(MXNetError, match='contiguous'):
        flash_attention_fwd(strided, strided, strided, 0.1, False)
    with pytest.raises(MXNetError, match='contiguous'):
        fused_norms.fused_rms_norm(strided, torch.ones(8))
    assert set(kernels.launch_counts().values()) == {0}


def test_kernel_sources_are_in_the_package():
    from mxnet_tpu_torch.ops.kernels import _build
    assert _build.sources() == ['flash_attention', 'fused_norms',
                                'fused_optimizer', 'int8_matmul',
                                'paged_attention']
    assert _build.BUILD_DIR.parent.name == 'build'
