"""Contrib ops of the port: the attention ops, ``flash_attention``,
``paged_attention_decode`` and ``multi_head_attention``, and the
calibration op ``calibrate_entropy``.

Counterpart of the same ops in ``mxnet_tpu/ops/contrib.py``. The attention
ops reshape their operands and call the hand-written kernel's wrapper
(:mod:`.kernels.flash_attention`, :mod:`.kernels.paged_attention`), which
runs the plain PyTorch version for CPU tensors. Where autograd records,
``flash_attention`` goes through
:class:`.kernels.flash_attention.FlashAttentionFunction`, whose backward
is the reference's ``_flash3_bwd``. ``multi_head_attention`` without a
mask or dropout is ``flash_attention``; with them, plain PyTorch, as the
reference leaves that case to XLA. ``calibrate_entropy`` reuses the
calibration collector of :mod:`mxnet_tpu_torch.quantization`.
``group_adagrad_update`` is the reference's row-wise AdaGrad in plain
PyTorch. The contrib ops off the attention path (the interleaved products,
sliding-window attention, ``index_add``/``index_copy``, ``count_sketch``,
``hawkesll``, the straight-through estimators, ...) are plain PyTorch too;
the ones whose gradient the reference writes by hand
(``gradient_multiplier``, ``round_ste``, ``sign_ste``,
``identity_attach_kl_sparse_reg``) are ``torch.autograd.Function``s with
that gradient. The detection ops wait under ROADMAP A11
(``ops/ledger.py``).
"""

import math

import numpy as _np
import torch

from .kernels import needs_grad
from .kernels.flash_attention import FlashAttentionFunction, \
    flash_attention_fwd, flash_attention_plain
from .kernels.paged_attention import paged_attention_decode as _paged
from .registry import register

__all__ = ['flash_attention', 'paged_attention_decode',
           'multi_head_attention', 'calibrate_entropy',
           'group_adagrad_update']


@register('flash_attention')
def flash_attention(q, k, v, sm_scale=None, causal=False, block_q=128,
                    block_k=128):
    """Blockwise fused attention. q ``(..., T, d)``; k/v ``(..., S, d)``
    with matching leading dims; ``sm_scale`` defaults to 1/sqrt(d);
    causal masking is bottom-right aligned. Returns ``(..., T, d)`` in
    q's dtype, softmax and accumulation in fp32. ``block_q``/``block_k``
    are the TPU kernel's tiles, taken for the reference's signature and
    not used: the kernel's plan picks its own."""
    q_shape = q.shape
    d = q_shape[-1]
    t, s = q.shape[-2], k.shape[-2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    qr = q.reshape(-1, t, d).contiguous()
    kr = k.reshape(-1, s, d).contiguous()
    vr = v.reshape(-1, s, d).contiguous()
    if causal and t > s:
        # more queries than keys leaves fully masked rows: the reference
        # takes plain attention there (its kernel would emit zeros), and
        # autograd differentiates it as it stands
        return flash_attention_plain(qr, kr, vr, sm_scale,
                                     causal).reshape(q_shape)
    if needs_grad(qr, kr, vr):
        out = FlashAttentionFunction.apply(qr, kr, vr, sm_scale, causal)
    else:
        out = flash_attention_fwd(qr, kr, vr, sm_scale, causal)
    return out.reshape(q_shape)


@register('paged_attention_decode')
def paged_attention_decode(q, k_pool, v_pool, pages, offset,
                           sm_scale=None):
    """One decode step of attention over a paged KV pool.

    q ``(B, H, dh)``: this step's queries, RoPE applied; k_pool/v_pool
    ``(num_pages, page_size, kv_heads, dh)``, already holding this step's
    K/V; pages ``(B, pages_per_seq)`` int32 block table; offset ``(B,)``
    int32, the absolute position of row b's current token (row b attends
    logical positions ``<= offset[b]``). Query heads ``[j*G, (j+1)*G)``
    share KV head ``j``."""
    B, H, dh = q.shape
    kv = k_pool.shape[2]
    scale = (dh ** -0.5) if sm_scale is None else sm_scale
    out = _paged(q.reshape(B, kv, H // kv, dh).contiguous(), k_pool, v_pool,
                 pages, offset, scale)
    return out.reshape(B, H, dh)


@register('multi_head_attention')
def multi_head_attention(q, k, v, num_heads, mask=None, dropout_p=0.0,
                         causal=False, key=None):
    """Scaled-dot-product attention over ``(batch, seq, embed)``. With no
    mask and no dropout it is :func:`flash_attention` over the heads;
    otherwise plain PyTorch in fp32, where ``key`` (a ``torch.Generator``
    on q's device) draws the dropout mask."""
    b, sq, e = q.shape
    hd = e // num_heads
    qh = q.reshape(b, sq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], num_heads, hd).transpose(1, 2)
    if mask is None and dropout_p == 0.0:
        out = flash_attention(qh, kh, vh, causal=causal)
        return out.transpose(1, 2).reshape(b, sq, e)
    sk = k.shape[1]
    if causal:
        # bottom-right aligned, as the flash path when T != S
        tri = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril(sk - sq)
        mask = tri if mask is None else mask.to(torch.bool) & tri
    s = torch.einsum('bhqd,bhkd->bhqk', qh.float(), kh.float()) * hd ** -0.5
    if mask is not None:
        s = torch.where(mask.to(torch.bool), s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    if dropout_p > 0.0:
        if key is None:
            raise ValueError(
                'multi_head_attention with dropout_p > 0 needs key= (a '
                'torch.Generator); pass one or apply dropout outside')
        keep = torch.rand(p.shape, generator=key, device=p.device) \
            < 1.0 - dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    out = torch.einsum('bhqk,bhkd->bqhd', p, vh.float()).to(q.dtype)
    return out.reshape(b, sq, e)


@register('calibrate_entropy', differentiable=False)
def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-optimal int8 threshold from a histogram (reference
    quantization/calibrate.cc ``_contrib_calibrate_entropy``); returns
    ``(threshold, divergence)`` as fp32 0-dim tensors, the divergence 0
    as in the reference."""
    from ..quantization import _HistogramCollector
    c = _HistogramCollector.__new__(_HistogramCollector)
    c.hist = _np.asarray(hist.cpu() if torch.is_tensor(hist) else hist)
    c.edges = _np.asarray(hist_edges.cpu() if torch.is_tensor(hist_edges)
                          else hist_edges)
    c.num_bins = int(c.hist.shape[0])
    c.min = float(c.edges[0])
    c.max = float(c.edges[-1])
    _, hi = c.entropy(num_quantized_bins=int(num_quantized_bins))
    return (torch.tensor(hi, dtype=torch.float32),
            torch.tensor(0.0, dtype=torch.float32))


@register('group_adagrad_update')
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """AdaGrad over each row's mean squared gradient (reference
    src/operator/contrib/optimizer_op.cc ``_contrib_group_adagrad_update``):
    ``history`` holds one value a row (``(rows, 1, ...)``); returns
    ``(weight, history)``."""
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if g.dim() > 1:
        hist = history + torch.mean(g * g, dim=tuple(range(1, g.dim())),
                                    keepdim=True)
    else:
        hist = history + g * g
    return weight - lr * g / (torch.sqrt(hist) + epsilon), hist


# ---------------------------------------------------- interleaved attention
# reference layout: qkv (seq, batch, heads * 3 * head_dim), interleaved
@register('interleaved_matmul_selfatt_qk')
def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """Reference transformer.cc:650: scaled Q Kᵀ from interleaved QKV;
    (batch * heads, seq, seq)."""
    s, b, e = queries_keys_values.shape
    hd = e // (3 * heads)
    x = queries_keys_values.reshape(s, b, heads, 3, hd)
    q = x[:, :, :, 0] * (hd ** -0.5)
    scores = torch.einsum('sbhd,tbhd->bhst', q, x[:, :, :, 1])
    return scores.reshape(b * heads, s, s)


@register('interleaved_matmul_selfatt_valatt')
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads):
    """Reference transformer.cc:710: attention times V, back to the
    interleaved layout."""
    s, b, e = queries_keys_values.shape
    hd = e // (3 * heads)
    v = queries_keys_values.reshape(s, b, heads, 3, hd)[:, :, :, 2]
    att = attention.reshape(b, heads, s, s)
    return torch.einsum('bhst,tbhd->sbhd', att, v).reshape(s, b, heads * hd)


@register('interleaved_matmul_encdec_qk')
def interleaved_matmul_encdec_qk(queries, keys_values, heads):
    """Reference transformer.cc:770: cross-attention scaled Q Kᵀ."""
    sq, b, e = queries.shape
    sk = keys_values.shape[0]
    hd = e // heads
    q = queries.reshape(sq, b, heads, hd) * (hd ** -0.5)
    k = keys_values.reshape(sk, b, heads, 2, hd)[:, :, :, 0]
    return torch.einsum('sbhd,tbhd->bhst', q, k).reshape(b * heads, sq, sk)


@register('interleaved_matmul_encdec_valatt')
def interleaved_matmul_encdec_valatt(keys_values, attention, heads):
    sk, b, e = keys_values.shape
    hd = e // (2 * heads)
    v = keys_values.reshape(sk, b, heads, 2, hd)[:, :, :, 1]
    sq = attention.shape[1]
    att = attention.reshape(b, heads, sq, sk)
    return torch.einsum('bhst,tbhd->sbhd', att, v).reshape(sq, b,
                                                           heads * hd)


# ------------------------------------------------ sliding-window attention
def _band(seq, left, right, device):
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    return (j >= i - left) & (j <= i + right)


@register('sldwin_atten_mask_like', differentiable=False)
def sldwin_atten_mask_like(score, dilation, valid_length, w,
                           symmetric=True):
    """Reference _contrib_sldwin_atten_mask_like: the 0/1 band of ``w``
    tokens each side (left only unless ``symmetric``) within the valid
    lengths, shaped like ``score`` (B, H, S, S)."""
    B, H, S, _ = score.shape
    band = _band(S, w, w if symmetric else 0, score.device)[None, None]
    valid = torch.arange(S, device=score.device)[None, :] < \
        valid_length.reshape(-1, 1)
    vmask = valid[:, None, :, None] & valid[:, None, None, :]
    return torch.broadcast_to(band & vmask, score.shape).to(score.dtype)


@register('sldwin_atten_score')
def sldwin_atten_score(query, key, dilation, w, symmetric=True):
    """Reference _contrib_sldwin_atten_score: Q Kᵀ of (B, S, H, D)
    operands in the band, -1e30 outside it."""
    s = torch.einsum('bqhd,bkhd->bhqk', query, key)
    band = _band(query.shape[1], w, w if symmetric else 0,
                 query.device)[None, None]
    return torch.where(band, s, torch.full((), -1e30, dtype=s.dtype,
                                           device=s.device))


@register('sldwin_atten_context')
def sldwin_atten_context(score, value, dilation, w, symmetric=True):
    """Reference _contrib_sldwin_atten_context: the banded weights times
    the values (B, S, H, D)."""
    return torch.einsum('bhqk,bkhd->bqhd', score, value)


# ------------------------------------------------------------ small helpers
@register('all_finite', differentiable=False)
def all_finite(*arrays, init_output=True):
    """Reference all_finite.cc: every value of every array finite."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok


@register('index_copy')
def index_copy(old, index, new_tensor):
    return old.index_copy(0, index.long(), new_tensor.to(old.dtype))


@register('index_add')
def index_add(old, index, new_tensor):
    return old.index_add(0, index.long(), new_tensor.to(old.dtype))


@register('getnnz', differentiable=False)
def getnnz(data, axis=None):
    return torch.count_nonzero(data, dim=axis)


@register('sparse_embedding', aliases=('SparseEmbedding',))
def sparse_embedding(data, weight, input_dim=None, output_dim=None,
                     dtype=None, sparse_grad=False):
    """Reference indexing_op.cc _contrib_SparseEmbedding: the
    ``embedding`` op; its gradient is dense, as the reference op's is
    (``gluon.nn.Embedding(sparse_grad=True)`` gives row-sparse ones)."""
    from .nn import embedding
    return embedding(data, weight)


@register('count_sketch')
def count_sketch(data, h, s, out_dim):
    """Reference count_sketch.cc: ``data * s`` summed into the buckets
    ``h`` of the last axis."""
    out = torch.zeros(data.shape[:-1] + (int(out_dim),), dtype=data.dtype,
                      device=data.device)
    return out.index_add(-1, h.long().reshape(-1),
                         data * s.to(data.dtype))


@register('quadratic')
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """Reference quadratic_op.cc: ``a x^2 + b x + c``."""
    return a * data * data + b * data + c


@register('div_sqrt_dim')
def div_sqrt_dim(data):
    """Reference transformer.cc _contrib_div_sqrt_dim: ``x / sqrt(last
    dim)``."""
    root = math.sqrt(data.shape[-1])
    return data / torch.full((), root, dtype=data.dtype, device=data.device)


@register('edge_id', differentiable=False)
def edge_id(data, u, v):
    """Reference dgl_graph.cc _contrib_edge_id on a dense adjacency: the
    value of the edge u -> v."""
    return data[u.long(), v.long()]


@register('index_array', differentiable=False)
def index_array(data, axes=None):
    """Reference index_array.cc: each element's N-d index, (*shape,
    len(axes))."""
    shape = tuple(data.shape)
    if not shape:
        return torch.zeros((0,), dtype=torch.int64, device=data.device)
    axes = tuple(range(len(shape))) if axes is None else tuple(axes)
    grids = torch.meshgrid(*[torch.arange(n, device=data.device)
                             for n in shape], indexing='ij')
    return torch.stack([grids[a] for a in axes], dim=-1)


class _ScaledGrad(torch.autograd.Function):
    """The identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _StraightThrough(torch.autograd.Function):
    """``fn(x)`` forward, the gradient passed through unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@register('gradient_multiplier')
def gradient_multiplier(data, scalar=1.0):
    """Reference gradient_multiplier_op.cc: the identity, its gradient
    scaled by ``scalar`` (the gradient-reversal trick)."""
    return _ScaledGrad.apply(data, scalar)


@register('round_ste')
def round_ste(data):
    """Reference stes_op.cc: round, with a straight-through gradient."""
    return _StraightThrough.apply(data, torch.round)


@register('sign_ste')
def sign_ste(data):
    """Reference stes_op.cc: sign, with a straight-through gradient."""
    return _StraightThrough.apply(data, torch.sign)


class _KLSparseReg(torch.autograd.Function):
    """The identity forward; the backward adds the gradient of the KL
    sparsity penalty of ``mean(sigmoid(x))`` against its target."""

    @staticmethod
    def forward(ctx, x, target, penalty):
        ctx.save_for_backward(x)
        ctx.target, ctx.penalty = target, penalty
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        rho = torch.clamp(s.mean(), 1e-6, 1 - 1e-6)
        t = ctx.target
        dpen = ctx.penalty * (-t / rho + (1 - t) / (1 - rho))
        return g + dpen * s * (1 - s) / x.numel(), None, None


@register('identity_attach_kl_sparse_reg')
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Reference identity_attach_KL_sparse_reg.cc: the identity, with the
    KL sparsity penalty's gradient in its backward."""
    return _KLSparseReg.apply(data, sparseness_target, penalty)


@register('batch_norm_with_relu')
def batch_norm_with_relu(data, gamma, beta, moving_mean, moving_var,
                         eps=1e-3, momentum=0.9, axis=1):
    """Reference batch_norm_relu.cc, inference form: BatchNorm with the
    moving statistics, then ReLU; the statistics come back unchanged."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = (data - moving_mean.reshape(shape)) * (
        gamma.reshape(shape) / torch.sqrt(moving_var.reshape(shape) + eps)) \
        + beta.reshape(shape)
    return torch.clamp(out, min=0), moving_mean, moving_var


@register('hawkesll')
def hawkesll(mu, alpha, beta, state, lags, marks, valid_length, max_time):
    """Reference hawkes_ll.cc: the log-likelihood of a marked Hawkes
    process with exponential kernels, and the excitation carried to
    ``max_time``; one step an event slot, entries past ``valid_length``
    no-ops. Returns ``(ll (N,), state (N, K))``."""
    N, K = mu.shape
    T = lags.shape[1]
    m_all = marks.long()
    rows = torch.arange(N, device=mu.device)
    r = state
    elapsed = torch.zeros(N, dtype=mu.dtype, device=mu.device)
    ll = torch.zeros(N, dtype=mu.dtype, device=mu.device)
    vlen = valid_length.to(mu.dtype)
    for t in range(T):
        valid = (t < vlen).to(mu.dtype)
        dt = lags[:, t] * valid
        r = r * torch.exp(-beta[None, :] * dt[:, None])
        m = m_all[:, t]
        lam = mu[rows, m] + alpha[m] * beta[m] * r[rows, m]
        ll = ll + valid * torch.log(torch.clamp(lam, min=1e-30))
        bump = torch.nn.functional.one_hot(m, K).to(mu.dtype) * \
            valid[:, None]
        r = r + bump
        elapsed = elapsed + dt * valid
    rem = torch.clamp(max_time - elapsed, min=0.0)
    r_T = r * torch.exp(-beta[None, :] * rem[:, None])
    live = (torch.arange(T, device=mu.device)[None, :, None]
            < vlen[:, None, None]).to(mu.dtype)
    counts = (torch.nn.functional.one_hot(m_all, K).to(mu.dtype)
              * live).sum(1)
    comp = (max_time[:, None] * mu
            + alpha[None, :] * (counts + state - r_T)).sum(-1)
    return ll - comp, r_T
