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
"""

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ['int8_matmul', 'int8_matmul_plain', 'OUT_DTYPES', 'MAX_K']

#: output dtypes the kernel writes
OUT_DTYPES = (torch.float32, torch.bfloat16)
#: longest K whose int32 sum of int8 products cannot overflow
MAX_K = 131071

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _dtype(out_dtype):
    return getattr(torch, out_dtype) if isinstance(out_dtype, str) \
        else out_dtype


def int8_matmul_plain(x, w, scale, bias=None, out_dtype=torch.float32):
    """The kernel's function in plain PyTorch. The sum is exact: int64 on
    the CPU (an int8 product there stays int8 and wraps), float64 on the
    card, which has no integer matmul and holds every sum exactly
    (|sum| <= 128**2 * K < 2**53). Then one rounding to fp32, ``* scale``,
    ``+ bias`` and the cast, each its own op as in the reference."""
    if x.device.type == 'cpu':
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
    if x.device.type == 'cpu':
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
    fn = _build.function('int8_matmul', 'int8_matmul_s8', _ARGS)
    rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check('int8_matmul', rc, 'int8_matmul')
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
