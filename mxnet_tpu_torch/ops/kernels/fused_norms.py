"""Fused row normalisation, RMS or LayerNorm: the CUDA kernels
``csrc/fused_norms.cu`` and their plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas/fused_norms.py``. A CPU tensor takes
the plain version; a CUDA tensor launches a kernel, or raises on a dtype,
shape or layout the kernels do not take. As the Pallas kernel does, the
kernels take ``x`` and the weights (``gamma`` and ``beta``, one dtype) in
fp32 or bf16, compute in fp32 and store the output in the reference's
promotion of their dtypes (:func:`_out_dtype`).

:func:`plan` picks the kernel's design from the shapes, the mode and the
pointers' alignment alone: ``regs`` (one block a row, the row held in
registers), ``cluster`` (each row of a short RMS batch split over a
thread-block cluster, the slices held in registers) or ``general`` (the
earlier design, for widths that are not a multiple of a vector's elements
or above :data:`MAX_VECS` vectors, and for data off 16-byte alignment). A
vector is the 16 bytes of ``x`` a thread loads at once: 4 elements in
fp32, 8 in bf16. Launches are counted
in ``fused_norm.launches`` and, by design, in
``fused_norm.launches_by_path``.

:class:`FusedNormFunction` gives the op its gradient, as the reference's
``custom_vjp`` does: the forward is the wrapper (the kernel on the card)
and the backward is the reference's ``_fused_norm_bwd``, a recompute of
the statistics in fp32 plain PyTorch. That backward is XLA in the
reference, not a Pallas kernel, so it is no kernel here either.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from ...base import MXNetError
from . import _build

__all__ = ['fused_norm', 'fused_norm_plain', 'fused_norm_bwd',
           'FusedNormFunction', 'fused_rms_norm', 'fused_layer_norm',
           'PATHS', 'DTYPES', 'Plan', 'plan']

#: the kernel's designs, by the plan's name
PATHS = ('regs', 'cluster', 'general')
_PATH_CODE = {'general': 0, 'regs': 1, 'cluster': 2}
#: threads of a block and 16-byte vectors of a thread the register-resident
#: designs are built for (regs: one block a row; cluster: a block a slice)
REGS_THREADS = (64, 128, 256, 512)
CLUSTER_THREADS = (32, 64, 128, 256)
VECS = (1, 2, 3, 4)
#: most vectors of a row the register-resident designs hold, and the
#: widest fp32 row (a bf16 row holds twice the elements)
MAX_VECS = REGS_THREADS[-1] * VECS[-1]
MAX_D = 4 * MAX_VECS
#: the dtypes the kernels take, by their code in the C entry
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: most rows of a call whose rows are split over clusters, the cluster
#: sizes built (the largest the portable limit) and the most partial sums
#: (one a warp of a row's blocks) a sum adds
CLUSTER_ROWS = 32
CLUSTERS = (8, 4, 2)
MAX_PARTS = 32
#: the general design's block
GENERAL_THREADS = 256

#: one call's design: ``path`` (one of :data:`PATHS`), ``threads`` a
#: block, ``vecs`` 16-byte vectors a thread (0 for general, which strides)
#: and ``cluster`` blocks a row. Thread ``t`` of block ``r`` of a row takes
#: the vectors ``r * threads * vecs + k * threads + t``, ``k < vecs``, that
#: are below ``d / elems`` (``elems`` 4 in fp32, 8 in bf16).
Plan = namedtuple('Plan', 'path threads vecs cluster')

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float] + [ctypes.c_int] * 7 + [
                                     ctypes.c_void_p]


def _fit(nv, threads, c):
    """``(threads, vecs)`` of the ``c`` blocks of a row of ``nv`` vectors
    with the fewest idle slots, then the most vectors a thread, among those
    that leave no vector column of the last block empty and add at most
    :data:`MAX_PARTS` partials (the C entry's own conditions); None if
    none does."""
    fits = [(t * v * c - nv, -v, t, v) for t in threads for v in VECS
            if t * v * c >= nv > t * (v * c - 1)
            and c * t // 32 <= MAX_PARTS]
    return min(fits)[2:] if fits else None


@functools.lru_cache(maxsize=4096)
def plan(n, d, aligned, sm_count, rms, elems=4):
    """The design of a call over ``n`` rows of ``d`` on a card with
    ``sm_count`` SMs, RMS or (``rms`` False) LayerNorm; ``aligned`` says
    that x, gamma, beta and the output start on 16-byte boundaries, and
    ``elems`` is the elements of x in a 16-byte vector (4 fp32, 8 bf16).
    ``cluster`` takes an RMS batch of at most :data:`CLUSTER_ROWS` rows, in
    the largest cluster of :data:`CLUSTERS` whose blocks fit one wave
    (``n * cluster <= sm_count``) and split the row evenly; ``regs`` the
    other rows of up to :data:`MAX_VECS` vectors that are a multiple of
    ``elems``; ``general`` the rest. LayerNorm's two sums would cross the
    cluster twice, and on the H100 that took longer than the split saved
    (PERF.md). Pure Python:
    the CPU tests check it, and the C entry refuses a plan that does not
    fit."""
    if not aligned or d % elems or d > elems * MAX_VECS:
        return Plan('general', GENERAL_THREADS, 0, 1)
    nv = d // elems
    if rms and n <= CLUSTER_ROWS:
        for c in CLUSTERS:
            tv = _fit(nv, CLUSTER_THREADS, c) if n * c <= sm_count else None
            if tv:
                return Plan('cluster', *tv, c)
    return Plan('regs', *_fit(nv, REGS_THREADS, 1), 1)


def _out_dtype(x, gamma, beta):
    """The reference's promotion (``out * gamma + beta``): norm weights
    kept in fp32 give fp32 out."""
    dt = torch.promote_types(x.dtype, gamma.dtype)
    return dt if beta is None else torch.promote_types(dt, beta.dtype)


def fused_norm_plain(x, gamma, beta, eps, rms):
    """The kernel's function in plain PyTorch (``_ln_xla`` of the
    reference): fp32 statistics over the last axis."""
    xf = x.float()
    if rms:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        xc = xf - xf.mean(-1, keepdim=True)
        y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(_out_dtype(x, gamma, beta))


def fused_norm(x, gamma, beta=None, eps=1e-5, rms=False):
    """Normalise contiguous ``x`` over its last axis: RMS (``rms=True``,
    ``beta`` None) or LayerNorm. On the card ``x`` and the weights are
    fp32 or bf16, ``gamma`` and ``beta`` of one dtype; the output is bf16
    when both are bf16, fp32 otherwise."""
    d = x.shape[-1]
    tensors = (x, gamma) if beta is None else (x, gamma, beta)
    if any(t.shape != (d,) for t in tensors[1:]):
        raise MXNetError(f'fused_norm: gamma/beta must be ({d},)')
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError('fused_norm: tensors must be contiguous')
    if rms and beta is not None:
        raise MXNetError('fused_norm: RMS mode takes no beta')
    if _build.plain_here(x):
        return fused_norm_plain(x, gamma, beta, eps, rms)
    if x.device.type != 'cuda' or any(t.device != x.device
                                      for t in tensors):
        raise MXNetError(f'fused_norm: tensors must share one CUDA device, '
                         f'got {[str(t.device) for t in tensors]}')
    if x.dtype not in DTYPES or gamma.dtype not in DTYPES or (
            beta is not None and beta.dtype != gamma.dtype):
        raise MXNetError(f'fused_norm: the kernel takes float32 or bfloat16 '
                         f'x and weights (gamma and beta of one dtype), got '
                         f'{[t.dtype for t in tensors]}')
    out = torch.empty(x.shape, dtype=_out_dtype(x, gamma, beta),
                      device=x.device)
    n = x.numel() // d if d else 0
    if n == 0:
        return out
    if n >= 2 ** 31 or d >= 2 ** 31:
        raise MXNetError(f'fused_norm: shape {tuple(x.shape)} too large')
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors + (out,))
    p = plan(n, d, aligned, _build.sm_count(x.device), bool(rms),
             16 // x.element_size())
    _launch(x, gamma, beta, out, eps, rms, p)
    _build.count(fused_norm, x.device, p.path)
    return out


def _launch(x, gamma, beta, out, eps, rms, p):
    """One launch of the kernel on checked tensors, in the design of plan
    ``p``."""
    d = x.shape[-1]
    fn = _build.function('fused_norms', 'fused_norm_run', _ARGS)
    with _build.on_device(x.device):
        rc = fn(x.data_ptr(), gamma.data_ptr(),
                None if beta is None else beta.data_ptr(), out.data_ptr(),
                x.numel() // d, d, float(eps), int(rms), DTYPES[x.dtype],
                DTYPES[gamma.dtype], _PATH_CODE[p.path], p.threads, p.vecs,
                p.cluster, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check('fused_norms', rc, 'fused_norm')


fused_norm.launches = 0
fused_norm.launches_by_path = dict.fromkeys(PATHS, 0)


def fused_rms_norm(x, gamma, eps=1e-6):
    """RMSNorm over the last axis (Llama family)."""
    return fused_norm(x, gamma, None, eps, rms=True)


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis."""
    return fused_norm(x, gamma, beta, eps, rms=False)


def fused_norm_bwd(x, gamma, beta, g, eps, rms):
    """``(dx, dgamma, dbeta)`` of :func:`fused_norm` for the output
    gradient ``g`` (``_fused_norm_bwd`` of the reference): the statistics
    recomputed in fp32, each result cast to its input's dtype; ``dbeta``
    is ``None`` when ``beta`` is."""
    xf, gf, gm = x.float(), g.float(), gamma.float()
    red = tuple(range(x.dim() - 1))

    def lead_sum(t):        # sum over every axis but the last
        return t.sum(red) if red else t

    if rms:
        rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        xhat = xf * rstd
        dy = gf * gm
        # d/dx of x * rsqrt(mean(x^2)+eps)
        dx = rstd * (dy - xhat * (dy * xhat).mean(-1, keepdim=True))
    else:
        xc = xf - xf.mean(-1, keepdim=True)
        rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        xhat = xc * rstd
        dy = gf * gm
        dx = rstd * (dy - dy.mean(-1, keepdim=True)
                     - xhat * (dy * xhat).mean(-1, keepdim=True))
    dgamma = lead_sum(gf * xhat)
    dbeta = None if beta is None else lead_sum(gf).to(beta.dtype)
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta


class FusedNormFunction(torch.autograd.Function):
    """:func:`fused_norm` with a gradient through
    :func:`fused_norm_bwd`. ``apply(x, gamma, beta, eps, rms)``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, rms):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.rms = eps, rms
        return fused_norm(x, gamma, beta, eps, rms)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        return fused_norm_bwd(x, gamma, beta, g, ctx.eps, ctx.rms) + (
            None, None)
