"""Device contexts: ``mx.cpu()``, ``mx.gpu(i)``.

Counterpart of the JAX package's ``context.py``. A :class:`Context` names
a logical device and resolves to a ``torch.device``: ``cpu()`` to the
host, ``gpu(i)`` to ``cuda:i``. The default context is ``gpu(0)``: entry
points run on the card unless the caller names the CPU, and asking for a
card that is not there raises instead of carrying on on the CPU.
"""

import threading

import torch

from .base import MXNetError

__all__ = ['Context', 'cpu', 'gpu', 'num_gpus', 'current_context',
           'resolve_device', 'abstract_context']


class Context:
    """A logical device, usable in a ``with`` block to set the
    thread-local default context."""

    _thread = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in ('cpu', 'gpu'):
            raise ValueError(f'unknown device type {device_type!r}')
        self.device_type = device_type
        self.device_id = int(device_id)

    def to_torch(self):
        """The ``torch.device`` this context names. Raises
        :class:`MXNetError` for a card that is not there."""
        if self.device_type == 'cpu':
            return torch.device('cpu')
        if not torch.cuda.is_available():
            raise MXNetError(
                f'{self!r} needs a CUDA device and none is available; '
                f"pass device='cpu' to run on the host")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(
                f'{self!r}: only {torch.cuda.device_count()} CUDA '
                f'device(s) visible')
        return torch.device('cuda', self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __repr__(self):
        return f'{self.device_type}({self.device_id})'

    def __enter__(self):
        if not hasattr(self._thread, 'stack'):
            self._thread.stack = []
        self._thread.stack.append(self)
        return self

    def __exit__(self, *exc):
        self._thread.stack.pop()

    @classmethod
    def default_ctx(cls):
        stack = getattr(cls._thread, 'stack', None)
        return stack[-1] if stack else Context('gpu', 0)


class _Abstract(Context):
    """The context of an abstract evaluation (``_deferred_compute``):
    arrays made there are ``torch.device('meta')`` tensors, with a shape
    and a dtype and no storage."""

    def __init__(self):
        self.device_type = 'meta'
        self.device_id = 0

    def to_torch(self):
        return torch.device('meta')


def abstract_context():
    """The context whose arrays are meta tensors."""
    return _Abstract()


def cpu(device_id=0):
    """Return a CPU context."""
    return Context('cpu', device_id)


def gpu(device_id=0):
    """Return the context of CUDA device ``device_id``."""
    return Context('gpu', device_id)


def num_gpus():
    """Number of CUDA devices visible."""
    return torch.cuda.device_count()


def current_context():
    """The thread-local default context (``gpu(0)`` unless a ``with``
    block set another)."""
    return Context.default_ctx()


def resolve_device(device=None):
    """``torch.device`` for a ``device=`` argument: ``None`` (the current
    context), a :class:`Context`, a ``torch.device`` or a string such as
    ``'cpu'`` or ``'cuda:0'``. A CUDA device that is not there raises."""
    if device is None:
        return current_context().to_torch()
    if isinstance(device, Context):
        return device.to_torch()
    dev = torch.device(device)
    if dev.type in ('cpu', 'meta'):
        return dev
    if dev.type != 'cuda':
        raise MXNetError(f'unsupported device {dev}')
    return Context('gpu', dev.index or 0).to_torch()
