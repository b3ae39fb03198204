"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention.cu`` in
its two forms and their plain PyTorch versions.

:func:`flash_attention_fwd`, the normalised form, is the counterpart of
``_flash_fwd`` in ``mxnet_tpu/ops/pallas/flash_attention.py``;
:func:`flash_attention_stats`, the stats form that ring attention merges
across ranks, of ``flash_attention_stats`` there. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel, or raises on a dtype,
shape or layout the kernel does not take. As the Pallas kernel does, the
kernel takes q, k and v in fp32 or bf16 (one dtype), computes in fp32 and
stores the normalised form's output in q's dtype; the stats form's
``(acc, m, l)`` are fp32 whatever q's dtype, as the reference gives them.

:class:`FlashAttentionFunction` gives the op its gradient, as the
reference's ``custom_vjp`` (``_flash3``) does: the forward is the wrapper
(the kernel on the card) and the backward is the reference's
``_flash3_bwd``, a blockless recompute of the softmax in fp32 plain
PyTorch. That backward is XLA in the reference, not a Pallas kernel, so it
is no kernel here either.

:func:`plan` picks the kernel's design for a call before the launch:
``'tf32x3'`` (Q k^T and p v on the tensor cores in 3xTF32, one block a
batch*head and 64 query rows) or ``'tf32x3_splitkv'`` (the same, with the
keys split where those blocks would leave SMs idle, the partials merged by
the last block to arrive). Both forms count their launches in
``launches`` and, by design, in ``launches_by_path``.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from ...base import MXNetError
from . import _build

__all__ = ['flash_attention_fwd', 'flash_attention_plain',
           'flash_attention_bwd', 'FlashAttentionFunction',
           'flash_attention_stats', 'flash_attention_stats_plain',
           'HEAD_DIMS', 'PATHS', 'DTYPES', 'FlashPlan', 'plan']

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128)

#: the kernel's designs, by the plan's name
PATHS = ('tf32x3', 'tf32x3_splitkv')
#: query rows a block takes
BLOCK_Q = 64
#: most key splits of one call
MAX_SPLITS = 64
#: the dtypes the kernel takes, by the suffix of its C entries
DTYPES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}

_NEG_INF = -1e30
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
_STATS_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3

#: one call's design: ``path`` (one of :data:`PATHS`), ``block_k`` key
#: rows a tile (the C entry checks it against its own), ``splits`` of the
#: key tiles, each taking ``chunk`` tiles (split i takes tiles ``i *
#: chunk`` up to ``(i + 1) * chunk``, the last one to the end of S),
#: ``blocks`` (bh * query blocks, one counter each) and ``workspace``
#: (fp32 partials, 0 when the keys are not split)
FlashPlan = namedtuple('FlashPlan',
                       'path block_k splits chunk blocks workspace')


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(bh, t, s, d, sm_count):
    """The design of one call over ``bh`` heads, ``t`` queries, ``s`` keys
    and head dim ``d`` on a card with ``sm_count`` SMs. The keys are split
    when the ``bh * ceil(t / 64)`` blocks are fewer than the SMs, into as
    many splits as one wave of two blocks an SM holds. Pure Python: the
    CPU tests check it, and the C entry checks what it is given."""
    block_k = 32 if d == 128 else 64
    blocks = bh * _cdiv(t, BLOCK_Q)
    nt = _cdiv(s, block_k)
    splits = 1
    if blocks < sm_count:
        splits = max(1, min(2 * sm_count // blocks, nt, MAX_SPLITS))
    # equal chunks of key tiles, and no split left empty
    chunk = _cdiv(nt, splits)
    splits = _cdiv(nt, chunk)
    ws = blocks * splits * BLOCK_Q * (d + 2) if splits > 1 else 0
    return FlashPlan('tf32x3_splitkv' if splits > 1 else 'tf32x3', block_k,
                     splits, chunk, blocks, ws)


def _launch_args(dev, bh, t, s, d):
    """The plan of a call, its workspace and counters (or None) and the
    stream it launches on."""
    p = plan(bh, t, s, d, _build.sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if p.splits == 1:
        return p, None, None, stream
    ws = torch.empty(p.workspace, dtype=torch.float32, device=dev)
    return p, ws, _build.counters('flash_attention', dev, stream,
                                  p.blocks), stream


def _ptr(x):
    return None if x is None else x.data_ptr()


def _probs(q, k, sm_scale, causal):
    """fp32 softmax of the scaled scores, bottom-right causal mask."""
    s = torch.einsum('bqd,bkd->bqk', q.float(), k.float()) * sm_scale
    if causal:
        t, src = s.shape[-2], s.shape[-1]
        mask = torch.ones(t, src, dtype=torch.bool, device=s.device).tril(
            src - t)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return torch.softmax(s, dim=-1)


def flash_attention_plain(q, k, v, sm_scale, causal):
    """The kernel's function in plain PyTorch (``_reference_attention``
    of the reference): q ``(BH, T, d)``, k/v ``(BH, S, d)``, fp32
    softmax, bottom-right causal mask."""
    p = _probs(q, k, sm_scale, causal)
    return torch.einsum('bqk,bkd->bqd', p, v.float()).to(q.dtype)


def flash_attention_bwd(q, k, v, g, sm_scale, causal):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` for the output
    gradient ``g`` (``_flash3_bwd`` of the reference): ``p`` recomputed
    without blocks, the rest in fp32, each result cast to its input's
    dtype. It holds four ``(BH, T, S)`` fp32 tensors at a time."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = _probs(qf, kf, sm_scale, causal)
    dv = torch.einsum('bqk,bqd->bkd', p, gf)
    dp = torch.einsum('bqd,bkd->bqk', gf, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum('bqk,bkd->bqd', ds, kf)
    dk = torch.einsum('bqk,bqd->bkd', ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention_fwd` with a gradient through
    :func:`flash_attention_bwd`. ``apply(q, k, v, sm_scale, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return flash_attention_fwd(q, k, v, sm_scale, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, g, ctx.sm_scale,
                                   ctx.causal) + (None, None)


def _check(what, q, k, v):
    """The shape and layout checks of both forms, on any device; returns
    ``(bh, t, s, d)``."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise MXNetError(f'{what}: want q (BH, T, d) and k, v '
                         f'(BH, S, d); got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise MXNetError(f'{what}: q, k, v must be contiguous')
    return (*q.shape[:2], k.shape[1], q.shape[2])


def _check_cuda(what, q, k, v):
    """What the kernel takes, checked before a launch."""
    if q.device.type != 'cuda' or k.device != q.device \
            or v.device != q.device:
        raise MXNetError(f'{what}: q, k, v must share one CUDA device')
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError(f'{what}: the kernel takes q, k, v of one dtype, '
                         f'float32 or bfloat16, got {q.dtype}, {k.dtype}, '
                         f'{v.dtype}')
    if q.shape[2] not in HEAD_DIMS:
        raise MXNetError(f'{what}: head dim {q.shape[2]} not in '
                         f'{HEAD_DIMS}')
    if not all(x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise MXNetError(f'{what}: q, k, v must be 16-byte aligned')
    if max(q.shape[0], q.shape[1], k.shape[1]) >= 2 ** 31:
        raise MXNetError(f'{what}: shape too large')


def flash_attention_fwd(q, k, v, sm_scale, causal):
    """Normalised blockwise attention over q ``(BH, T, d)`` and k/v
    ``(BH, S, d)``, all contiguous; bottom-right causal (``q_offset = S -
    T``) when ``causal``, which needs T <= S. Output in q's dtype."""
    bh, t, s, d = _check('flash_attention', q, k, v)
    if causal and t > s:
        raise MXNetError('flash_attention: causal with T > S leaves rows '
                         'with no key; the op takes the plain path there')
    if _build.plain_here(q):
        return flash_attention_plain(q, k, v, sm_scale, causal)
    _check_cuda('flash_attention', q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function('flash_attention',
                         f'flash_attention_fwd_{DTYPES[q.dtype]}', _ARGS)
    with _build.on_device(q.device):
        p, ws, counters, stream = _launch_args(q.device, bh, t, s, d)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, t, s, d, float(sm_scale), int(bool(causal)), p.block_k,
                p.splits, p.chunk, _ptr(ws), _ptr(counters), stream)
    _build.check('flash_attention', rc, 'flash_attention')
    _build.count(flash_attention_fwd, q.device, p.path)
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_path = dict.fromkeys(PATHS, 0)


def flash_attention_stats_plain(q, k, v, sm_scale, causal):
    """The stats form's function in plain PyTorch (``_stats_xla`` of the
    reference): ``(acc, m, l)`` with ``acc = sum_j exp(s_j - m) v_j``
    unnormalised, ``m`` the row max of the scaled scores ``s = (q k^T) *
    sm_scale`` and ``l = sum_j exp(s_j - m)``, all fp32. ``causal`` is the
    diagonal-block mask (T == S, query i keeps key j when i >= j).

    The kernel scales q before the product, as the Pallas kernel does;
    this version scales the scores, as ``_stats_xla`` does. The two differ
    by the rounding of one product per score, within the tolerances the
    tests state (1e-5 against the Pallas kernel, 1e-4 on the card)."""
    s = torch.einsum('bqd,bkd->bqk', q.float(), k.float()) * sm_scale
    if causal:
        t, src = s.shape[-2], s.shape[-1]
        mask = torch.ones(t, src, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return torch.einsum('bqk,bkd->bqd', p, v.float()), m, p.sum(-1)


def flash_attention_stats(q, k, v, sm_scale, causal=False):
    """Blockwise attention that returns ``(acc, m, l)`` (see
    :func:`flash_attention_stats_plain`) so that a caller can merge blocks
    from other ranks: q ``(BH, T, d)``, k/v ``(BH, S, d)``, contiguous;
    acc ``(BH, T, d)``, m and l ``(BH, T)``, all fp32. ``causal`` is the
    diagonal-block mask and needs T == S. No gradient: the ring that calls
    it refuses autograd (``parallel.ring_attention``)."""
    bh, t, s, d = _check('flash_attention_stats', q, k, v)
    if causal and t != s:
        raise MXNetError(f'flash_attention_stats: the causal mask is the '
                         f'diagonal block and needs T == S, got T={t}, '
                         f'S={s}')
    if _build.plain_here(q):
        return flash_attention_stats_plain(q, k, v, sm_scale, causal)
    _check_cuda('flash_attention_stats', q, k, v)
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    l = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    if acc.numel() == 0:
        return acc, m, l
    fn = _build.function('flash_attention',
                         f'flash_attention_stats_{DTYPES[q.dtype]}',
                         _STATS_ARGS)
    with _build.on_device(q.device):
        p, ws, counters, stream = _launch_args(q.device, bh, t, s, d)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), bh, t, s, d, float(sm_scale),
                int(bool(causal)), p.block_k, p.splits, p.chunk, _ptr(ws),
                _ptr(counters), stream)
    _build.check('flash_attention', rc, 'flash_attention_stats')
    _build.count(flash_attention_stats, q.device, p.path)
    return acc, m, l


flash_attention_stats.launches = 0
flash_attention_stats.launches_by_path = dict.fromkeys(PATHS, 0)
