"""Each hand-written kernel of the PyTorch port, held against the Pallas
kernel it replaces.

On the CPU a kernel's wrapper runs its plain PyTorch version (the CUDA
kernel itself is checked against that version on the card by
``chip_smoke.py``). Here the plain versions meet the JAX package's Pallas
kernels in interpret mode on the same inputs, made with numpy from a seed,
at the JAX tests' own fp32 tolerance: rtol = atol = 1e-5. The gradients of
the norm and flash ops (their ``autograd.Function``s) meet ``jax.vjp`` of
the JAX ops, whose ``custom_vjp`` backwards they copy, at the same
tolerance. The flash kernel's 3xTF32 split and order of accumulation,
emulated on the CPU with a model of the tensor cores' adder, meet the
Pallas kernel at the card's tolerance (1e-4), where one TF32 pass does
not. The optimizer kernels have their own file,
``tests/test_torch_optimizer.py``; the designs the CUDA kernels plan,
``tests/test_torch_kernel_plans.py``.
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
#: the card's design for RMS at each shape below (LayerNorm takes regs
#: where RMS takes a cluster)
NORM_DESIGNS = {
    (16, 256): 'cluster', (6, 64): 'regs',
    (4, 4096): 'cluster',       # llama3_8b's width, a decode step's rows
    (64, 4096): 'regs',         # llama3_8b's width, more rows
    (32, 768): 'cluster',       # BERT-base's width
    (3, 4100): 'regs',          # a multiple of 4 with a masked tail
    (5, 6): 'general'}          # not a multiple of 4


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('n,d', list(NORM_DESIGNS))
def test_fused_norm_matches_pallas_interpret(rms, n, d):
    """The plain version, which the card's kernel is held to, against
    the Pallas kernel at widths that select each design of the kernel."""
    design = NORM_DESIGNS[n, d]
    if not rms and design == 'cluster':
        design = 'regs'
    assert fused_norms.plan(n, d, True, 132, rms).path == design
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


def _llama_case(B, NP, seed):
    """llama3_8b's head layout (8 KV heads, 4 query heads each, head dim
    128) over pages of 16 positions, at small depths."""
    return _paged_case(B=B, H=32, kv=8, dh=128, P=B * NP + 1, psz=16,
                       NP=NP, seed=seed)


def test_paged_attention_at_llama3_8b_heads():
    """Two rows at depths inside the first and the third page."""
    q, kp, vp, pages = _llama_case(2, 3, seed=11)
    got, want = _paged_both(q, kp, vp, pages,
                            onp.asarray([5, 40], onp.int32))
    _close(got, want)


def test_paged_attention_at_llama3_8b_heads_mixed_depths():
    """A depth-0 row, a row on a page boundary, a row at the table's end
    and a retired row whose table is all garbage pages."""
    q, kp, vp, pages = _llama_case(4, 3, seed=12)
    pages[3] = 0
    got, want = _paged_both(q, kp, vp, pages,
                            onp.asarray([0, 15, 47, 0], onp.int32))
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
                              torch.tensor([1e-3, 0.0, 0.1, 0.001]),
                              beta1=0.9, beta2=0.999, epsilon=1e-8)
    fused_optimizer.sgd_mom_step(x, x.clone(), x.clone(),
                                 torch.tensor([0.1, 0.0]), momentum=0.9)
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
    hyper = torch.empty(4, device='meta')
    with pytest.raises(MXNetError, match='CUDA'):
        fused_optimizer.adam_step(w, w.clone(), w.clone(), w.clone(), hyper,
                                  beta1=0.9, beta2=0.999, epsilon=1e-8)
    with pytest.raises(MXNetError, match='CUDA'):
        fused_optimizer.sgd_mom_step(w, w.clone(), w.clone(), hyper,
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


# ------------------------------------------- flash attention in 3xTF32
def _tf32(x, nearest=True):
    """An fp32 value as TF32, on its bit pattern: the mantissa cut to 10
    bits, rounded to nearest with ties away from zero as ``cvt.rna.tf32.f32``
    does, or toward zero as the tensor cores read an fp32 register."""
    u = onp.ascontiguousarray(x, onp.float32).view(onp.uint32)
    mag = ((u & 0x7fffffff) + (0x1000 if nearest else 0)) & 0xffffe000
    return ((u & 0x80000000) | mag).view(onp.float32)


def _mma_step(c, a, b):
    """``c + a @ b`` for one MMA k step of 8, ``a (..., m, 8)`` and ``b
    (..., 8, n)`` TF32 values, in a model of the tensor cores' adder: the
    products exact, every term (c's too) cut toward zero 24 bits below the
    largest, summed, and the sum cut toward zero to fp32."""
    f64 = onp.float64
    terms = onp.concatenate([c[..., :, None, :].astype(f64),
                             a[..., :, :, None].astype(f64)
                             * b[..., None, :, :].astype(f64)], axis=-2)
    top = onp.abs(terms).max(-2, keepdims=True)
    quantum = onp.exp2(onp.floor(onp.log2(onp.where(top > 0, top, 1.0))) - 23)
    total = (onp.trunc(terms / quantum) * quantum).sum(-2)
    out = total.astype(onp.float32)
    over = onp.abs(out.astype(f64)) > onp.abs(total)
    out[over] = onp.nextafter(out[over], onp.float32(0))
    return out


def _products(a, b, passes, apart):
    """``a (..., m, k) @ b (..., k, n)`` from zero in MMA k steps of 8, the
    kernel's order. Three passes split each operand as the kernel does, hi
    = cvt.rna(x) and lo = x - hi read as TF32 (toward zero), and take hi*lo
    and lo*hi, then hi*hi: with ``apart`` (the scores) the two small
    products sum in their own accumulator, added to hi*hi's once at the
    end; without (one tile's p v) all three sum in one. One pass takes
    hi*hi alone."""
    big = onp.zeros(a.shape[:-1] + b.shape[-1:], onp.float32)
    small = onp.zeros_like(big)
    for k0 in range(0, a.shape[-1], 8):
        x, y = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        xh, yh = _tf32(x), _tf32(y)
        if passes == 3:
            xl, yl = _tf32(x - xh, nearest=False), _tf32(y - yh, nearest=False)
            acc = _mma_step(small if apart else big, xh, yl)
            acc = _mma_step(acc, xl, yh)
            if apart:
                small = acc
            else:
                big = acc
        big = _mma_step(big, xh, yh)
    return (big + small).astype(onp.float32)


def _flash_tf32_emulated(q, k, v, causal, passes):
    """The CUDA flash kernel's arithmetic on the CPU: q pre-scaled, key
    tiles of 32 rows at d 128 and 64 below, q k^T and p v through
    :func:`_products`, each tile's p v from zero and added to the output
    in fp32, the online softmax in fp32 (exp2 of the scaled difference)
    with masked scores at -1e30, bottom-right causal."""
    t, s_len, d = q.shape[1], k.shape[1], q.shape[2]
    block_k = 32 if d == 128 else 64
    log2e = onp.float32(1.4426950408889634)
    qs = (q * onp.float32(d ** -0.5)).astype(onp.float32)
    m = onp.full(q.shape[:2], -1e30, onp.float32)
    l = onp.zeros(q.shape[:2], onp.float32)
    o = onp.zeros(q.shape, onp.float32)
    rows = onp.arange(t)[:, None] + (s_len - t)
    for j0 in range(0, s_len, block_k):
        kt, vt = k[:, j0:j0 + block_k], v[:, j0:j0 + block_k]
        cols = onp.arange(j0, j0 + kt.shape[1])[None, :]
        keep = rows >= cols if causal else onp.full((t, kt.shape[1]), True)
        s = onp.where(keep, _products(qs, kt.transpose(0, 2, 1), passes,
                                      apart=True), onp.float32(-1e30))
        m_new = onp.maximum(m, s.max(-1))
        alpha = onp.exp2((m - m_new) * log2e).astype(onp.float32)
        p = onp.where(keep, onp.exp2((s - m_new[..., None]) * log2e),
                      0).astype(onp.float32)
        l = (alpha * l + p.sum(-1)).astype(onp.float32)
        m = m_new
        o = (o * alpha[..., None]
             + _products(p, vt, passes, apart=False)).astype(onp.float32)
    return o / onp.maximum(l, 1e-30)[..., None]


@pytest.mark.parametrize('causal,t,s,d', [
    (True, 64, 64, 16), (False, 64, 64, 16), (True, 32, 96, 16),
    (False, 37, 96, 16), (True, 37, 96, 16), (True, 64, 64, 128)],
    ids=['causal', 'noncausal', 'causal-t<s', 'ragged', 'ragged-causal',
         'causal-d128'])
def test_flash_3xtf32_emulation_matches_pallas_interpret(causal, t, s, d):
    """The card's flash kernel computes q k^T and p v on the tensor cores
    in 3xTF32. Its hi/lo split and its order of accumulation (key tiles
    of 32 at d 128, a score's small products apart from its big ones,
    each tile's p v from zero), emulated on the CPU at the shapes of
    test_flash_attention_matches_pallas_interpret, meet the Pallas kernel
    within the card's tolerance (rtol = atol = 1e-4); one TF32 pass on the
    same inputs does not, which is why the kernel takes three. The adder
    is a model: how many bits the tensor cores keep as they align the
    terms is not documented, and this model keeps more than the card
    showed (every product summed in one accumulator missed 1e-4 on the
    card and passes here), so the card-only tests at 1e-4 are what hold
    the kernel's accumulation order."""
    rng = onp.random.default_rng(2)
    q, k, v = (_randn(rng, 3, n, d) for n in (t, s, s))
    want = onp.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, block_q=32,
                                 block_k=32, interpret=True))
    three = _flash_tf32_emulated(q, k, v, causal, passes=3)
    one = _flash_tf32_emulated(q, k, v, causal, passes=1)
    onp.testing.assert_allclose(three, want, rtol=1e-4, atol=1e-4)
    err1 = onp.abs(one - want)
    print(f'3xTF32 max error {onp.abs(three - want).max():.3e}, one pass '
          f'{err1.max():.3e}')
    assert (err1 > 1e-4 + 1e-4 * onp.abs(want)).any()
