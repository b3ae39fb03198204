"""``mx.engine``: execution-engine controls.

Counterpart of ``mxnet_tpu/engine.py`` (reference ``python/mxnet/
engine.py`` over the C++ ThreadedEngine, src/engine/). The port does not
rebuild the dependency scheduler: CUDA streams order the work, and
``wait_to_read``/``asnumpy`` are the sync points. The reference's
operation bulking (engine.h:310 ``StartBulk``/``StopBulk``,
``MXNET_ENGINE_BULK_SIZE``) is :mod:`._bulk`: consecutive eager ops are
recorded into a segment, which a flush runs as one captured CUDA graph
(replayed after its first flush).

* ``bulk(n)``: a scope in which up to n eager ops join one segment
  (reference engine.py:15); ``n <= 1`` turns bulking off for the scope.
* ``set_bulk_size(n)``: the process default; 0 or 1 turns it off.
* ``naive_engine()``: the reference's ``MXNET_ENGINE_TYPE=NaiveEngine``
  (src/engine/engine.cc:32): no bulking, no graph captured or replayed
  (a hybridized block's calls run eagerly), and every op waits for the
  card before it returns, so that a device error surfaces at its op.
* ``bulk_stats()``: the bulking counters (trie hits and misses, flushes,
  segment shapes captured).

The default: off on the CPU, as in the reference, and off on the card,
where ``chip_smoke.py`` measured a bulked segment's replay against eager
dispatch (PERF.md); ``MXNET_ENGINE_BULK=1`` turns it on.
"""

import contextlib
import os

from . import _bulk, _graphs

__all__ = ['bulk', 'naive_engine', 'set_bulk_size', 'bulk_stats',
           'engine_type']


@contextlib.contextmanager
def bulk(size):
    """Up to ``size`` eager ops a segment in this scope (reference
    engine.py:15 bulk); ``size <= 1`` turns bulking off, as
    :func:`set_bulk_size` does."""
    with _bulk.force(size is not None and size > 1, size):
        yield


@contextlib.contextmanager
def naive_engine():
    """Synchronous op-by-op execution (``MXNET_ENGINE_TYPE=NaiveEngine``):
    see the module docstring."""
    with _bulk.force(False), _graphs.uncaptured():
        yield


def set_bulk_size(size):
    """The default segment size; 0 or 1 turns bulking off (reference
    engine.py set_bulk_size, ``MXNET_ENGINE_BULK_SIZE``). Returns
    ``size``."""
    if size and size > 1:
        _bulk.set_enabled(True)
        _bulk.set_size(size)
    else:
        _bulk.set_enabled(False)
    return size


def bulk_stats():
    """The bulking counters of this thread (``hits``, ``misses``,
    ``flushes``, ``compiles``), to check that a loop reuses its captured
    segments."""
    return _bulk.stats()


_ENGINE_TYPE = os.environ.get('MXNET_ENGINE_TYPE', 'ThreadedEnginePerDevice')


def engine_type():
    """The reference-compatible engine name: ``NaiveEngine`` inside
    :func:`naive_engine`, else ``MXNET_ENGINE_TYPE`` (default
    ``ThreadedEnginePerDevice``)."""
    return 'NaiveEngine' if _graphs.is_uncaptured() else _ENGINE_TYPE
