"""Paged attention decode: the CUDA kernel ``csrc/paged_attention.cu`` and
its plain PyTorch version.

Counterpart of ``paged_attention_decode_pallas`` in
``mxnet_tpu/ops/pallas/paged_attention.py``. The plain version is the
gather math of the reference op (``ops/contrib.py:paged_attention_decode``
off the TPU). A CPU tensor takes it; a CUDA tensor launches the kernel, or
raises on a dtype, shape or layout the kernel does not take. The kernel
takes q and the pools in one dtype, fp32 or bf16, as the reference's gate
asks that the pool have q's dtype (``use_pallas``); it computes in fp32 and
returns q's dtype.

:func:`plan` picks the split count of a call from its shapes alone; the
kernel launches the splits of one (row, KV head) as one thread-block
cluster, which merges them before it ends: one launch a call, counted in
``launches`` and, by split count, in ``launches_by_path``. The kernel reads
``offset`` and ``pages`` on the card and the wrapper never does, so one
launch captured in a CUDA graph stays right when both are rewritten in
place.
"""

import ctypes
import functools

import torch

from ...base import MXNetError
from . import _build

__all__ = ['paged_attention_decode', 'paged_attention_decode_plain',
           'HEAD_DIMS', 'GROUPS', 'TILE', 'MAX_SPLITS', 'PATHS', 'DTYPES',
           'plan']

#: head dims and query-group sizes the kernel is built for
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
#: positions a block takes a step (one page at a page size of 16)
TILE = 16
#: most splits of one (row, KV head): the largest portable cluster, as
#: the kernel launches the splits of one (row, KV head) as one
MAX_SPLITS = 8
#: the kernel's designs by split count, as ``launches_by_path`` counts them
PATHS = tuple(f'splits{n}' for n in range(1, MAX_SPLITS + 1))
#: the dtypes the kernel takes, by the suffix of its C entries
DTYPES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}

_NEG_INF = -1e30
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p]


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(b, kv, np_, psz, sm_count):
    """The split count of a call over ``b`` rows, ``kv`` KV heads and a
    block table of ``np_`` pages of ``psz`` positions, on a card with
    ``sm_count`` SMs: as many splits as keep the ``b * kv * splits``
    blocks within one and a half an SM, at most :data:`MAX_SPLITS` and at
    most the table's tiles of :data:`TILE` positions. The kernel holds two
    blocks an SM, but clusters of up to 8 blocks are placed whole on one
    of the card's processing clusters, and on the H100 a split count that
    filled both slots of every SM left some clusters for a second wave
    (PERF.md). Shapes only, never the offsets: the work of each split
    follows the depth on the card. A row at ``offset`` has ``n_live =
    ceil(e / TILE)`` live tiles, ``e = min(offset + 1, np_ * psz)`` (0 for
    a negative offset), and split ``s`` of ``n`` takes tiles
    ``floor(n_live * s / n)`` up to ``floor(n_live * (s + 1) / n)``, the
    kernel's own integer formula, so the splits' shares differ by one tile
    at most. Pure Python: the CPU tests check it, and the C entry refuses a
    count outside 1..8."""
    tiles = _cdiv(np_ * psz, TILE)
    return max(1, min(MAX_SPLITS, tiles, 3 * sm_count // 2 // (b * kv)))


def paged_attention_decode_plain(q, k_pool, v_pool, pages, offset,
                                 sm_scale):
    """The kernel's function in plain PyTorch: gather each row's logical
    cache out of the pool, repeat KV heads over the group, masked fp32
    softmax over positions ``<= offset[b]``. q ``(B, kv, G, dh)``."""
    B, kv, G, dh = q.shape
    psz = k_pool.shape[1]
    L = pages.shape[1] * psz
    idx = pages.long()
    kf = k_pool[idx].reshape(B, L, kv, dh)
    vf = v_pool[idx].reshape(B, L, kv, dh)
    if G > 1:
        kf = kf.repeat_interleave(G, 2)
        vf = vf.repeat_interleave(G, 2)
    qh = q.reshape(B, kv * G, dh)
    scores = torch.einsum('bshd,blhd->bhsl', qh[:, None].float(),
                          kf.float()) * sm_scale
    mask = torch.arange(L, device=q.device)[None, :] \
        <= offset.long()[:, None]                                 # (B, L)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum('bhsl,blhd->bshd', probs, vf.float()).to(q.dtype)
    return out[:, 0].reshape(B, kv, G, dh)


def paged_attention_decode(q, k_pool, v_pool, pages, offset, sm_scale):
    """One decode token per row against the paged pool. q ``(B, kv, G,
    dh)``; pools ``(P, page_size, kv, dh)``; pages ``(B, NP)`` int32;
    offset ``(B,)`` int32, the absolute position of each row's current
    token. Returns ``(B, kv, G, dh)`` in q's dtype."""
    tensors = (q, k_pool, v_pool, pages, offset)
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise MXNetError(f'paged_attention_decode: want q (B, kv, G, dh) '
                         f'and pools (P, page_size, kv, dh); got '
                         f'{tuple(q.shape)}, {tuple(k_pool.shape)}, '
                         f'{tuple(v_pool.shape)}')
    B, kv, G, dh = q.shape
    P, psz = k_pool.shape[:2]
    if k_pool.shape[2:] != (kv, dh) or pages.dim() != 2 \
            or pages.shape[0] != B or offset.shape != (B,):
        raise MXNetError(f'paged_attention_decode: shapes disagree: q '
                         f'{tuple(q.shape)}, pool {tuple(k_pool.shape)}, '
                         f'pages {tuple(pages.shape)}, offset '
                         f'{tuple(offset.shape)}')
    if pages.dtype != torch.int32 or offset.dtype != torch.int32:
        raise MXNetError('paged_attention_decode: pages and offset must be '
                         'int32')
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError('paged_attention_decode: tensors must be '
                         'contiguous')
    if q.device.type == 'cpu':
        return paged_attention_decode_plain(q, k_pool, v_pool, pages,
                                            offset, sm_scale)
    if q.device.type != 'cuda' or any(t.device != q.device
                                      for t in tensors):
        raise MXNetError('paged_attention_decode: tensors must share one '
                         'CUDA device')
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise MXNetError(f'paged_attention_decode: the kernel takes q and '
                         f'pools of one dtype, float32 or bfloat16, got '
                         f'{q.dtype}, {k_pool.dtype}, {v_pool.dtype}')
    if dh not in HEAD_DIMS or G not in GROUPS:
        raise MXNetError(f'paged_attention_decode: head dim {dh} / group '
                         f'{G} not in {HEAD_DIMS} / {GROUPS}')
    if not all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)):
        raise MXNetError('paged_attention_decode: q and the pools must be '
                         '16-byte aligned')
    NP = pages.shape[1]
    if B == 0 or P == 0 or NP == 0:
        raise MXNetError('paged_attention_decode: empty batch, pool or '
                         'table')
    splits = plan(B, kv, NP, psz, _build.sm_count(q.device))
    if B * kv * splits >= 2 ** 31 or NP * psz >= 2 ** 31 - TILE:
        raise MXNetError('paged_attention_decode: batch or table too large')
    out = torch.empty_like(q)
    _launch(q, k_pool, v_pool, pages, offset, out, sm_scale, splits)
    _build.count(paged_attention_decode, q.device, PATHS[splits - 1])
    return out


def _launch(q, k_pool, v_pool, pages, offset, out, sm_scale, splits):
    """One launch of the kernel on checked tensors, in ``splits`` splits
    (the cluster size)."""
    B, kv, G, dh = q.shape
    P, psz = k_pool.shape[:2]
    fn = _build.function('paged_attention',
                         f'paged_attention_decode_{DTYPES[q.dtype]}', _ARGS)
    with _build.on_device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                pages.data_ptr(), offset.data_ptr(), out.data_ptr(), B, kv,
                G, dh, P, psz, pages.shape[1], splits, float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check('paged_attention', rc, 'paged_attention_decode')


paged_attention_decode.launches = 0
paged_attention_decode.launches_by_path = dict.fromkeys(PATHS, 0)
