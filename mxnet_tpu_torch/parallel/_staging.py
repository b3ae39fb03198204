"""Pinned host buffers that carry CUDA tensors through gloo.

Gloo moves host tensors; NCCL moves device tensors. Where several ranks
share one card (gloo, since NCCL refuses two ranks on one device), a
collective on CUDA data goes card -> pinned host buffer -> gloo -> pinned
host buffer -> card. :class:`HostStage` owns those buffers: one per
``key`` (a ring's two rotating slots, a kvstore's bucket size), allocated
once and reused, and the CUDA event of the last copy that read each one
back to the card, so that a buffer is not overwritten before that copy
has finished. The ring (:mod:`.ring_attention`) and the kvstore's
cross-process transport (:mod:`..kvstore.fusion`) both stage through it.
"""

import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ['HostStage', 'staged', 'refuse_capture']


def refuse_capture(what):
    """Raise when a CUDA graph is being captured: a collective in a graph
    would replay without its peers (and under gloo it waits for the card
    on the host, which a capture forbids), so none runs in one."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError(f'{what}: a collective inside a CUDA graph capture; '
                         f'run it outside the captured region')


def staged(group, device):
    """True when a collective over ``group`` on tensors of ``device`` must
    pass through host buffers (gloo and a CUDA tensor); False when the
    backend takes the tensors as they are (gloo and host tensors, NCCL and
    CUDA tensors). Any other pairing raises."""
    backend = dist.get_backend(group)
    if backend == 'nccl' and device.type == 'cuda':
        return False
    if backend == 'gloo':
        return device.type == 'cuda'
    raise MXNetError(f'backend {backend!r} with {device.type} tensors is not '
                     f'taken (NCCL moves CUDA tensors, gloo host ones)')


class HostStage:
    """Pinned host buffers by key, each allocated at its first use."""

    def __init__(self):
        self._bufs = {}
        self._read = {}     # key -> event of the last copy back to the card

    def buffer(self, key, shape, dtype):
        """The pinned buffer of ``key`` (made, or made again when the shape
        or dtype changed), once the card has finished reading it."""
        buf = self._bufs.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) or \
                buf.dtype != dtype:
            buf = self._bufs[key] = torch.empty(shape, dtype=dtype,
                                                pin_memory=True)
            self._read.pop(key, None)
        ev = self._read.pop(key, None)
        if ev is not None:
            ev.synchronize()
        return buf

    def held(self, key):
        """The buffer of ``key`` as it is, to be read (sent): reading it
        while the card copies from it is safe, so nothing is waited for."""
        return self._bufs[key]

    def to_host(self, key, t, parts=None):
        """``t`` copied into the buffer of ``key``; the copy is complete
        when this returns. With ``parts`` (a list of tensors), ``t`` is
        the buffer's ``(shape, dtype)`` and ``parts[i]`` goes to
        ``buf[i]``."""
        if parts is None:
            buf = self.buffer(key, t.shape, t.dtype)
            buf.copy_(t)
            return buf
        buf = self.buffer(key, *t)
        for dst, src in zip(buf, parts):
            dst.copy_(src)
        return buf

    def to_device(self, key, device, out=None, part=None):
        """The buffer of ``key`` (its slice ``part`` when given) copied to
        ``device`` (into ``out`` when given) without blocking the host;
        the buffer is held until the copy has run."""
        buf = self._bufs[key]
        if part is not None:
            buf = buf[part]
        if out is None:
            out = buf.to(device, non_blocking=True)
        else:
            out.copy_(buf, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        self._read[key] = ev
        return out
