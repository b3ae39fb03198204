"""Int8 matrix product with a fused dequantize epilogue: the CUDA kernel
``csrc/int8_matmul.cu`` and its plain PyTorch version.

Counterpart of ``int8_matmul`` in ``mxnet_tpu/ops/pallas/int8_matmul.py``:
``out = cast(float(x @ w.T) * scale (+ bias))`` with x ``(..., K)`` int8,
w ``(N, K)`` int8, an exact int32 sum, scale and bias ``(N,)`` fp32 and an
fp32 or bf16 output. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel, or raises on a dtype, shape or layout the kernel does
not take. The kernel takes any M, N and K (up to :data:`MAX_K`) and any
alignment: the reference's ``use_pallas`` gate (M % 32, N % 128, K % 128)
has no counterpart.

:func:`plan` picks the kernel's design for a call before the launch, from
the shape and the layout alone, and the C entry checks what it is given:
``'tma_splitk'`` (M <= 64: wgmma on TMA-staged tiles, the product
computed transposed, K split so that the grid fills the card), ``'tma'``
(M > 64: two warpgroups on 128 x 128 tiles, K split only where the tiles
leave SMs idle) or ``'sm80'`` (x or w off 16-byte alignment, or K not a
multiple of 16, which TMA refuses: ``mma.sync`` tiles through
``cp.async`` or byte loads). Launches count in ``int8_matmul.launches``
and, by design, in ``int8_matmul.launches_by_path``.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from ...base import MXNetError
from . import _build

__all__ = ['int8_matmul', 'int8_matmul_plain', 'OUT_DTYPES', 'MAX_K',
           'PATHS', 'Plan', 'plan']

#: output dtypes the kernel writes
OUT_DTYPES = (torch.float32, torch.bfloat16)
#: longest K whose int32 sum of int8 products cannot overflow
MAX_K = 131071

#: the kernel's designs, by the plan's name
PATHS = ('tma_splitk', 'tma', 'sm80')
_PATH_CODE = {'sm80': 0, 'tma': 1, 'tma_splitk': 2}
#: K bytes a TMA stage holds (one 128-byte swizzled row)
TMA_BK = 128
#: most K splits of one call
MAX_SPLITS = 32

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3

#: one call's design: ``path`` (one of :data:`PATHS`), ``tile_a`` x
#: ``tile_b`` output tile (A rows: w's for tma_splitk, x's for tma; B rows
#: the other's; 0 for sm80, which picks its own tile by M), ``splits`` of
#: K, each summing ``chunk`` 128-byte K tiles (split s takes tiles ``s *
#: chunk`` up to ``(s + 1) * chunk``, the last one to the end of K; 0 for
#: sm80), ``tiles`` (output tiles, one counter each) and ``workspace``
#: (int32 partials, 0 when K is not split)
Plan = namedtuple('Plan', 'path tile_a tile_b splits chunk tiles workspace')


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(M, N, K, aligned, sm_count):
    """The design of one ``(M, K) x (N, K)`` product on a card with
    ``sm_count`` SMs; ``aligned`` says that x and w start on 16-byte
    boundaries. Pure Python: the CPU tests check it, and the C entry checks
    what it is given."""
    if not aligned or K % 16:
        return Plan('sm80', 0, 0, 1, 0, 0, 0)
    ktiles = _cdiv(K, TMA_BK)
    if M <= 64:
        # out^T = w x^T: w's 64-row tiles against all of x's rows, rounded
        # up to a wgmma width; as many splits as one wave of two blocks an
        # SM holds
        tile_a, tile_b = 64, next(n for n in (8, 16, 32, 64) if M <= n)
        tiles = _cdiv(N, tile_a)
        splits = min(2 * sm_count // tiles, ktiles, MAX_SPLITS)
        path = 'tma_splitk'
    else:
        tile_a, tile_b = 128, 128
        tiles = _cdiv(M, tile_a) * _cdiv(N, tile_b)
        splits = min(sm_count // tiles, ktiles, MAX_SPLITS)
        path = 'tma'
    # equal chunks of K tiles, and no split left empty
    chunk = _cdiv(ktiles, max(1, splits))
    splits = _cdiv(ktiles, chunk)
    ws = tiles * splits * tile_a * tile_b if splits > 1 else 0
    return Plan(path, tile_a, tile_b, splits, chunk, tiles, ws)


def _dtype(out_dtype):
    return getattr(torch, out_dtype) if isinstance(out_dtype, str) \
        else out_dtype


def int8_matmul_plain(x, w, scale, bias=None, out_dtype=torch.float32):
    """The kernel's function in plain PyTorch. The sum is exact: int64 on
    the CPU (an int8 product there stays int8 and wraps), float64 on the
    card, which has no integer matmul and holds every sum exactly
    (|sum| <= 128**2 * K < 2**53). Then one rounding to fp32, ``* scale``,
    ``+ bias`` and the cast, each its own op as in the reference."""
    if _build.plain_here(x):
        acc = torch.matmul(x.long(), w.long().t())
    else:
        acc = torch.matmul(x.double(), w.double().t())
    out = acc.float() * scale
    if bias is not None:
        out = out + bias
    return out.to(_dtype(out_dtype))


def int8_matmul(x, w, scale, bias=None, out_dtype=torch.float32):
    """``(..., N)`` in ``out_dtype`` (fp32 or bf16) for x ``(..., K)`` and
    w ``(N, K)`` int8, scale and bias ``(N,)`` fp32, all contiguous."""
    out_dtype = _dtype(out_dtype)
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[1]:
        raise MXNetError(f'int8_matmul: want x (..., K) and w (N, K); got '
                         f'{tuple(x.shape)}, {tuple(w.shape)}')
    N, K = w.shape
    if scale.shape != (N,) or (bias is not None and bias.shape != (N,)):
        raise MXNetError(f'int8_matmul: scale and bias must be ({N},); got '
                         f'{tuple(scale.shape)}, '
                         f'{None if bias is None else tuple(bias.shape)}')
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise MXNetError(f'int8_matmul: x and w must be int8, got {x.dtype}, '
                         f'{w.dtype}')
    if scale.dtype != torch.float32 or (bias is not None
                                        and bias.dtype != torch.float32):
        raise MXNetError('int8_matmul: scale and bias must be float32')
    if out_dtype not in OUT_DTYPES:
        raise MXNetError(f'int8_matmul: out_dtype {out_dtype} not in '
                         f'{OUT_DTYPES}')
    tensors = [t for t in (x, w, scale, bias) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError('int8_matmul: tensors must be contiguous')
    if _build.plain_here(x):
        return int8_matmul_plain(x, w, scale, bias, out_dtype)
    if x.device.type != 'cuda' or any(t.device != x.device for t in tensors):
        raise MXNetError('int8_matmul: tensors must share one CUDA device')
    if K == 0 or K > MAX_K:
        raise MXNetError(f'int8_matmul: K = {K} outside 1..{MAX_K}')
    M = x.numel() // K
    if max(M, N) >= 2 ** 31:
        raise MXNetError('int8_matmul: shape too large')
    out = torch.empty(x.shape[:-1] + (N,), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = plan(M, N, K, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
             _build.sm_count(x.device))
    _launch(x, w, scale, bias, out, M, N, K, p)
    _build.count(int8_matmul, x.device, p.path)
    return out


def _launch(x, w, scale, bias, out, M, N, K, p):
    """One launch of the kernel on checked tensors, in the design of the
    plan ``p``."""
    fn = _build.function('int8_matmul', 'int8_matmul_s8', _ARGS)
    with _build.on_device(x.device):
        ws = counters = None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if p.splits > 1:
            ws = torch.empty(p.workspace, dtype=torch.int32, device=x.device)
            counters = _build.counters('int8_matmul', x.device, stream,
                                       p.tiles)
        rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                M, N, K, int(out.dtype == torch.bfloat16),
                _PATH_CODE[p.path], p.tile_b, p.splits, p.chunk,
                None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), stream)
    _build.check('int8_matmul', rc, 'int8_matmul')


int8_matmul.launches = 0
int8_matmul.launches_by_path = dict.fromkeys(PATHS, 0)
