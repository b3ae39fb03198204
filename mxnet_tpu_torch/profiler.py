"""The part of ``mx.profiler`` that serving needs: the nearest-rank
percentile estimator and the registry of serving-stats providers.

The JAX package's ``profiler.py`` imports JAX for its trace surface, so
the port keeps its own copy of these two pieces.
"""

import threading

__all__ = ['percentiles', 'attach_serving', 'detach_serving',
           'serving_stats']

_lock = threading.Lock()
_serving = {}            # server name -> stats-snapshot provider (mx.serve)


def percentiles(samples, qs=(50, 95, 99)):
    """Nearest-rank percentiles of a latency sample set, as ``{q:
    value}``. Empty input yields all-zero percentiles; a single sample
    reports itself for every ``q``."""
    s = sorted(float(x) for x in samples)
    if not s:
        return {q: 0.0 for q in qs}
    if len(s) == 1:
        return {q: s[0] for q in qs}
    return {q: s[min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))]
            for q in qs}


def attach_serving(name, provider):
    """Register a serving-stats snapshot provider (``mx.serve`` servers
    call this at construction)."""
    with _lock:
        _serving[name] = provider


def detach_serving(name):
    """Drop a serving provider (called from ``Server.close()``)."""
    with _lock:
        _serving.pop(name, None)


def serving_stats():
    """``{server name: stats dict}`` over every attached provider."""
    with _lock:
        providers = dict(_serving)
    return {name: fn() for name, fn in providers.items()}
