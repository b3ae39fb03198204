"""FFT ops: ``mx.np.fft.*`` and the reference's contrib FFTs.

Counterpart of ``mxnet_tpu/ops/fft_ops.py``. The ``fft_*`` ops are
``torch.fft`` on the arrays' device, cuFFT on the card: complex outputs
stay there, where the JAX package takes a host round trip on a TPU (its
``_cpu_eager``, a gap of that backend that the port does not carry over).
``contrib_fft``/``contrib_ifft`` keep the reference's interleaved real
layout (``src/operator/contrib/fft.cc``): the last axis holds ``[re, im,
re, im, ...]``, and the inverse is cuFFT's unnormalized one.
"""

import torch

from ..context import resolve_device
from .registry import register


def _inexact(a):
    return a if a.is_floating_point() or a.is_complex() else a.float()


def _axes(axes):
    return None if axes is None else (
        (axes,) if isinstance(axes, int) else tuple(axes))


@register('fft_fft')
def fft_fft(a, n=None, axis=-1, norm=None):
    return torch.fft.fft(_inexact(a), n=n, dim=axis, norm=norm)


@register('fft_ifft')
def fft_ifft(a, n=None, axis=-1, norm=None):
    return torch.fft.ifft(_inexact(a), n=n, dim=axis, norm=norm)


@register('fft_rfft')
def fft_rfft(a, n=None, axis=-1, norm=None):
    return torch.fft.rfft(_inexact(a), n=n, dim=axis, norm=norm)


@register('fft_irfft')
def fft_irfft(a, n=None, axis=-1, norm=None):
    return torch.fft.irfft(_inexact(a), n=n, dim=axis, norm=norm)


@register('fft_fft2')
def fft_fft2(a, s=None, axes=(-2, -1), norm=None):
    return torch.fft.fft2(_inexact(a), s=s, dim=_axes(axes), norm=norm)


@register('fft_ifft2')
def fft_ifft2(a, s=None, axes=(-2, -1), norm=None):
    return torch.fft.ifft2(_inexact(a), s=s, dim=_axes(axes), norm=norm)


@register('fft_fftn')
def fft_fftn(a, s=None, axes=None, norm=None):
    return torch.fft.fftn(_inexact(a), s=s, dim=_axes(axes), norm=norm)


@register('fft_ifftn')
def fft_ifftn(a, s=None, axes=None, norm=None):
    return torch.fft.ifftn(_inexact(a), s=s, dim=_axes(axes), norm=norm)


@register('fft_hfft')
def fft_hfft(a, n=None, axis=-1, norm=None):
    return torch.fft.hfft(_inexact(a), n=n, dim=axis, norm=norm)


@register('fft_ihfft')
def fft_ihfft(a, n=None, axis=-1, norm=None):
    return torch.fft.ihfft(_inexact(a), n=n, dim=axis,
                           norm=norm).resolve_conj()


@register('fft_fftshift', differentiable=False)
def fft_fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=_axes(axes))


@register('fft_ifftshift', differentiable=False)
def fft_ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=_axes(axes))


@register('fft_fftfreq', differentiable=False)
def fft_fftfreq(n, d=1.0, ctx=None, device=None):
    """The sample frequencies, float32, on ``ctx`` (default: the current
    context)."""
    return torch.fft.fftfreq(n, d=d, device=resolve_device(
        ctx if ctx is not None else device), dtype=torch.float32)


@register('fft_rfftfreq', differentiable=False)
def fft_rfftfreq(n, d=1.0, ctx=None, device=None):
    return torch.fft.rfftfreq(n, d=d, device=resolve_device(
        ctx if ctx is not None else device), dtype=torch.float32)


@register('contrib_fft', aliases=('fft',))
def contrib_fft(data, compute_size=128):
    """Reference ``_contrib_fft``: real (..., d) to interleaved (..., 2d).
    ``compute_size`` (cuFFT's batching knob there) is accepted and
    ignored."""
    c = torch.fft.fft(_inexact(data))
    return torch.view_as_real(c).reshape(c.shape[:-1] + (2 * c.shape[-1],))


@register('contrib_ifft', aliases=('ifft',))
def contrib_ifft(data, compute_size=128):
    """Reference ``_contrib_ifft``: interleaved (..., 2d) to real (..., d),
    unnormalized (no 1/d: callers rescale)."""
    x = _inexact(data)
    c = torch.view_as_complex(
        x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2)).contiguous())
    return torch.fft.ifft(c).real * c.shape[-1]
