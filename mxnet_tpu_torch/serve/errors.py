"""Typed serving errors (``mx.serve``).

Admission control needs machine-distinguishable rejections: a client
retrying a shed request backs off differently from one whose deadline
expired in queue, and a request racing ``close()`` must see a terminal
error, not a hang. All three derive from :class:`MXNetError` so existing
catch-all handlers keep working.
"""

from ..base import MXNetError

__all__ = ['ServeError', 'ServerOverloaded', 'DeadlineExceeded',
           'ServerClosed', 'PagesExhausted']


class ServeError(MXNetError):
    """Base class for serving-runtime errors."""


class ServerOverloaded(ServeError):
    """The bounded request queue is at capacity — the request was shed
    at admission (load shedding, never silent queueing without bound).
    Clients should back off and retry."""


class PagesExhausted(ServerOverloaded):
    """The paged KV pool cannot supply the pages a request needs — a
    memory-shaped overload (``serve/pages.py``), shed like any other:
    clients back off and retry. Raised at ``submit`` when the request
    could never fit the pool, and by the allocator when a transient
    shortage outlives every evictable prefix-cache entry."""


class DeadlineExceeded(ServeError):
    """The request's deadline expired while it waited in queue — it was
    aborted before any device dispatch (no work wasted on a response
    nobody is waiting for)."""


class ServerClosed(ServeError):
    """The server is draining or closed; no new work is accepted and
    still-queued requests are rejected when ``close(drain=False)``."""
