"""Linear algebra ops: the products and the ``linalg_*`` family.

Counterpart of ``mxnet_tpu/ops/linalg.py`` (reference
src/operator/tensor/dot* and la_op.cc, src/operator/numpy/linalg/).
Each op is PyTorch (cuBLAS and cuSOLVER on the card, LAPACK on the host),
as the reference leaves each to XLA. Operands are promoted to JAX's result
type first. Decompositions whose factors are unique only up to sign or
order return what the solver returns, with one exception: on the host,
``linalg_eigh`` and ``linalg_svd`` take the factors of the LAPACK routines
the JAX package's CPU backend calls (scipy's ``?syevd`` and ``?gesdd``),
so that their signs and null-space bases are the reference's there
(:func:`_host_lapack`); torch's own factors, sign-aligned to those, carry
the gradient. On the card they are cuSOLVER's. The ``la_op`` names the
reference aliases (``linalg_potrf`` to ``cholesky``, ``linalg_gelqf`` to
``qr``, ``linalg_syevd`` to ``eigh``) are aliased alike.
"""

import numpy as _np
import torch

from .. import _dtypes
from .registry import register


def _common(*arrays):
    dt = _dtypes.result_type(*arrays)
    return [a.to(dt) for a in arrays]


def _inexact(a):
    return a if a.is_floating_point() or a.is_complex() else a.float()


def _t(a):
    return a.transpose(-1, -2)


def _seq(args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return list(args[0])
    return list(args)


@register('dot')
def dot(a, b):
    a, b = _common(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() <= 2:
        return torch.matmul(a, b)
    # numpy: sum over a's last axis and b's second to last
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


@register('matmul')
def matmul(a, b):
    a, b = _common(a, b)
    return torch.matmul(a, b)


# ----------------------------------------------------------------- products
@register('inner')
def inner(a, b):
    a, b = _common(a, b)
    return torch.inner(a, b)


@register('outer')
def outer(a, b):
    a, b = _common(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


@register('vdot')
def vdot(a, b):
    a, b = _common(a, b)
    return torch.vdot(a.reshape(-1), b.reshape(-1))


@register('tensordot')
def tensordot(a, b, axes=2):
    a, b = _common(a, b)
    if not isinstance(axes, int):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return torch.tensordot(a, b, dims=axes)


@register('einsum')
def einsum(*operands, subscripts=None, optimize=True):
    if subscripts is None:
        subscripts, operands = operands[0], operands[1:]
    return torch.einsum(subscripts, *_common(*_seq(operands)))


@register('kron')
def kron(a, b):
    a, b = _common(a, b)
    return torch.kron(a, b)


@register('batch_dot')
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    """Reference src/operator/tensor/dot.cc batch_dot: one batched
    product."""
    a, b = _common(a, b)
    return torch.matmul(_t(a) if transpose_a else a,
                        _t(b) if transpose_b else b)


@register('khatri_rao')
def khatri_rao(*args):
    """Reference src/operator/contrib/krprod.cc: the column-wise Kronecker
    product of matrices with one column count."""
    args = _common(*_seq(args))
    out = args[0]
    for m in args[1:]:
        out = torch.einsum('ik,jk->ijk', out, m).reshape(-1, out.shape[1])
    return out


@register('linalg_multi_dot')
def linalg_multi_dot(*arrays):
    return torch.linalg.multi_dot(_common(*_seq(arrays)))


# ------------------------------------------------------------ decompositions
@register('linalg_norm')
def linalg_norm(x, ord=None, axis=None, keepdims=False):
    """``jnp.linalg.norm``: a vector norm along one axis (2 by default),
    a matrix norm over two, the 2-norm of everything with neither."""
    x = _inexact(x)
    if isinstance(axis, list):
        axis = tuple(axis)
    if isinstance(axis, int) or (axis is None and ord is not None
                                 and x.dim() == 1):
        return torch.linalg.vector_norm(x, ord=2 if ord is None else ord,
                                        dim=axis, keepdim=keepdims)
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


def _host_lapack(routine, a, **kw):
    """The outputs of scipy's LAPACK ``routine`` (``'syevd'``,
    ``'gesdd'``) for each matrix of the host tensor ``a`` (float32 or
    float64), as tensors; None for a card's tensor or another dtype."""
    if a.device.type != 'cpu' or a.dtype not in (torch.float32,
                                                 torch.float64):
        return None
    from scipy.linalg import lapack
    fn = getattr(lapack, ('s' if a.dtype == torch.float32 else 'd')
                 + routine)
    mats = a.detach().reshape((-1,) + tuple(a.shape[-2:])).numpy()
    outs = [fn(m, **kw)[:-1] for m in mats]
    return [torch.from_numpy(_np.stack(o)).reshape(
        tuple(a.shape[:-2]) + o[0].shape) for o in zip(*outs)]


def _on(ref, t, vec_dim=None):
    """``ref``'s values with ``t``'s gradient: ``t`` itself where no
    gradient is taken; with ``vec_dim``, ``t``'s vectors along it first
    flipped to ``ref``'s signs."""
    if not t.requires_grad:
        return ref
    if vec_dim is not None:
        flip = torch.sign((t.detach() * ref).sum(vec_dim, keepdim=True))
        t = t * torch.where(flip == 0, 1, flip)
    return t + (ref - t).detach()


@register('linalg_svd')
def linalg_svd(a, full_matrices=True, compute_uv=True):
    a = _inexact(a)
    if not compute_uv:
        return torch.linalg.svdvals(a)
    t = torch.linalg.svd(a, full_matrices=full_matrices)
    ref = _host_lapack('gesdd', a, compute_uv=1,
                       full_matrices=int(full_matrices))
    if ref is None:
        return tuple(t)
    return (_on(ref[0], t[0], -2), _on(ref[1], t[1]), _on(ref[2], t[2], -1))


@register('linalg_inv')
def linalg_inv(a):
    return torch.linalg.inv(_inexact(a))


@register('linalg_pinv')
def linalg_pinv(a, rcond=None):
    """JAX's default cutoff, ``10 * max(M, N) * eps`` of the largest
    singular value."""
    a = _inexact(a)
    if rcond is None:
        rcond = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rcond)


@register('linalg_det')
def linalg_det(a):
    return torch.linalg.det(_inexact(a))


@register('linalg_slogdet')
def linalg_slogdet(a):
    return tuple(torch.linalg.slogdet(_inexact(a)))


@register('linalg_cholesky', aliases=('linalg_potrf',))
def linalg_cholesky(a, lower=True):
    """Reference la_op potrf."""
    L = torch.linalg.cholesky(_inexact(a))
    return L if lower else _t(L)


@register('linalg_qr', aliases=('linalg_gelqf',))
def linalg_qr(a, mode='reduced'):
    q, r = torch.linalg.qr(_inexact(a), mode=mode)
    return r if mode == 'r' else (q, r)


@register('linalg_eigh', aliases=('linalg_syevd',))
def linalg_eigh(a, UPLO='L'):
    a = _inexact(a)
    w, v = torch.linalg.eigh(a, UPLO=UPLO)
    ref = _host_lapack('syevd', a, compute_v=1, lower=int(UPLO == 'L'))
    if ref is None:
        return w, v
    return _on(ref[0], w), _on(ref[1], v, -2)


@register('linalg_eigvalsh', differentiable=False)
def linalg_eigvalsh(a, UPLO='L'):
    return torch.linalg.eigvalsh(_inexact(a), UPLO=UPLO)


@register('linalg_eig', differentiable=False)
def linalg_eig(a):
    return tuple(torch.linalg.eig(_inexact(a)))


@register('linalg_eigvals', differentiable=False)
def linalg_eigvals(a):
    return torch.linalg.eigvals(_inexact(a))


@register('linalg_solve')
def linalg_solve(a, b):
    a, b = _common(_inexact(a), _inexact(b))
    return torch.linalg.solve(a, b)


@register('linalg_lstsq', differentiable=False)
def linalg_lstsq(a, b, rcond=None):
    """JAX's least squares through the SVD (``jnp.linalg.lstsq``): the
    solution, the squared residual of every column (always given), the
    rank and the singular values; the same on every device (cuSOLVER's
    ``gels`` gives no rank)."""
    a, b = _common(_inexact(a), _inexact(b))
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    elif rcond < 0:
        rcond = torch.finfo(a.dtype).eps
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0)[:, None]
    x = _t(vt.conj()) @ (s_inv * (_t(u.conj()) @ b))
    resid = torch.linalg.vector_norm(b - a @ x, dim=0) ** 2
    return (x.reshape(-1) if vec else x), resid, rank, s


@register('linalg_matrix_rank', differentiable=False)
def linalg_matrix_rank(a, tol=None):
    a = _inexact(a)
    if a.dim() < 2:
        return (a != 0).any().to(torch.int32)
    s = torch.linalg.svdvals(a)
    if tol is None:
        tol = s.max(-1).values * max(a.shape[-2:]) * \
            torch.finfo(s.dtype).eps
    tol = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
    return (s > tol[..., None]).sum(-1).to(torch.int32)


@register('linalg_matrix_power')
def linalg_matrix_power(a, n):
    return torch.linalg.matrix_power(a, n)


@register('linalg_cond', differentiable=False)
def linalg_cond(a, p=None):
    return torch.linalg.cond(_inexact(a), p=p)


@register('linalg_tensorinv')
def linalg_tensorinv(a, ind=2):
    return torch.linalg.tensorinv(_inexact(a), ind=ind)


@register('linalg_tensorsolve')
def linalg_tensorsolve(a, b, axes=None):
    a, b = _common(_inexact(a), _inexact(b))
    return torch.linalg.tensorsolve(a, b, dims=axes)


# ------------------------------------------------------- la_op (BLAS forms)
def _tri(A, lower):
    return torch.tril(A) if lower else torch.triu(A)


@register('linalg_trmm')
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Reference la_op trmm: a triangular matrix times ``B``."""
    A, B = _common(A, B)
    tri = _tri(A, lower)
    if transpose:
        tri = _t(tri)
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out


@register('linalg_trsm')
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Reference la_op trsm: solve a triangular system for ``alpha *
    B``."""
    A, B = _common(A, B)
    tri = _tri(A, lower)
    if transpose:
        tri = _t(tri)
        lower = not lower
    return torch.linalg.solve_triangular(tri, alpha * B, upper=not lower,
                                         left=not rightside)


@register('linalg_gemm')
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    """Reference la_op gemm."""
    A, B, C = _common(A, B, C)
    return alpha * torch.matmul(_t(A) if transpose_a else A,
                                _t(B) if transpose_b else B) + beta * C


@register('linalg_gemm2')
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    A, B = _common(A, B)
    return alpha * torch.matmul(_t(A) if transpose_a else A,
                                _t(B) if transpose_b else B)


@register('linalg_syrk')
def linalg_syrk(A, transpose=False, alpha=1.0):
    At = _t(A)
    return alpha * (torch.matmul(At, A) if transpose else
                    torch.matmul(A, At))


@register('linalg_extractdiag')
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register('linalg_makediag')
def linalg_makediag(a, offset=0):
    return torch.diag_embed(a, offset=offset)


@register('linalg_sumlogdiag')
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register('linalg_potri', aliases=('potri',))
def linalg_potri(a, lower=True):
    """Reference la_op potri: ``(L Lᵀ)⁻¹`` from the Cholesky factor
    ``L`` (``Uᵀ U`` from an upper one)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype,
                    device=a.device).expand(a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=not lower)
    lt = _t(linv)
    return (lt @ linv) if lower else (linv @ lt)
