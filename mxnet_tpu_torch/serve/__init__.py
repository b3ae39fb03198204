"""``mx.serve`` of the PyTorch port: the paged-KV continuous-batching
decode server (:class:`DecodeServer`) and the pieces it stands on."""

from .decode import DecodeServer
from .errors import (ServeError, ServerOverloaded, DeadlineExceeded,
                     ServerClosed, PagesExhausted)
from .metrics import registry as _registry
from .pages import PageAllocator, chain_key
from .buckets import chunk_spans

__all__ = ['DecodeServer', 'ServeError', 'ServerOverloaded',
           'DeadlineExceeded', 'ServerClosed', 'PagesExhausted',
           'PageAllocator', 'chain_key', 'chunk_spans', 'stats']


def stats():
    """Snapshot of every live server's metrics: name -> stats dict."""
    return {name: m.snapshot() for name, m in _registry().items()}
