"""Unified metrics registry: Counter / Gauge / Histogram + Prometheus
text exposition (``mx.telemetry.metrics``).

One process-wide :class:`MetricsRegistry` (``default_registry()``)
replaces the seven ad-hoc ``stats()`` dicts across the serving tier,
the RPC transport and elastic training — those dicts remain as thin
views, but the registry is the aggregation surface: every instrument
serializes to a JSON-safe snapshot, snapshots from different processes
**merge** (the router's ``fleet_metrics()`` over the RPC ``metrics``
verb), and :func:`render_prometheus` emits the text exposition format.

Design points:

* instruments are keyed by ``name{label="value",...}`` exactly as
  Prometheus renders them, so snapshot keys merge across processes by
  string identity;
* :class:`Histogram` uses FIXED log-scale bucket bounds (powers of two
  from 2^-20 s to 2^24) shared by every histogram ever created —
  merging is elementwise addition of counts, no bound negotiation.
  Percentiles are nearest-rank over the cumulative counts, clamped to
  the observed min/max (a single sample reports itself exactly);
* **collectors** are zero-arg callables yielding ``(kind, name,
  labels, value)`` samples at scrape time — how the existing
  ``stats()`` surfaces register without restructuring their locking.
  Collectors run OUTSIDE the registry lock (they take their owners'
  locks, which sit above ``telemetry.metrics`` in the hierarchy);
* :class:`Reservoir` (Vitter's Algorithm R) gives bounded-memory
  whole-run percentile samples — ``ServingMetrics`` uses it instead of
  sliding-window deques, and ``ElasticTrainer`` instead of unbounded
  lists.

Locking: one module lock at level ``telemetry.metrics`` (below every
runtime lock, above nothing) guards instrument values and the registry
tables. :class:`Reservoir` is deliberately unlocked — its owners
already serialize updates under their own leaf locks.
"""

import bisect
import math
import random
import threading

from . import trace as _trace

__all__ = ['Counter', 'Gauge', 'Histogram', 'Reservoir',
           'MetricsRegistry', 'default_registry', 'counter', 'gauge',
           'histogram', 'register_collector', 'unregister_collector',
           'merge_snapshots', 'render_prometheus', 'BUCKET_BOUNDS']

#: fixed log2-scale bucket upper bounds, identical for every histogram:
#: ~1 µs to ~1.9e7 (seconds, but unit-agnostic); one overflow bucket on
#: top. Fixed bounds are what make counts mergeable across processes.
BUCKET_BOUNDS = tuple(2.0 ** e for e in range(-20, 25))

_LOCK = _trace._maybe_tracked(threading.Lock(), 'telemetry.metrics')


def _key(name, labels):
    if not labels:
        return name
    inner = ','.join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f'{name}{{{inner}}}'


class Counter:
    """Monotonic counter (float increments allowed)."""

    __slots__ = ('key', '_v')

    def __init__(self, key):
        self.key = key
        self._v = 0

    def inc(self, n=1):
        with _LOCK:
            self._v += n

    @property
    def value(self):
        with _LOCK:
            return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ('key', '_v')

    def __init__(self, key):
        self.key = key
        self._v = 0

    def set(self, v):
        with _LOCK:
            self._v = v

    def inc(self, n=1):
        with _LOCK:
            self._v += n

    def dec(self, n=1):
        with _LOCK:
            self._v -= n

    @property
    def value(self):
        with _LOCK:
            return self._v


class Histogram:
    """Fixed-bucket log-scale histogram; mergeable by construction."""

    __slots__ = ('key', '_counts', '_sum', '_count', '_min', '_max')

    def __init__(self, key=''):
        self.key = key
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(BUCKET_BOUNDS, v)
        with _LOCK:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self):
        with _LOCK:
            return self._count

    @property
    def sum(self):
        with _LOCK:
            return self._sum

    def snapshot(self):
        with _LOCK:
            return {'counts': list(self._counts), 'sum': self._sum,
                    'count': self._count,
                    'min': self._min if self._count else 0.0,
                    'max': self._max if self._count else 0.0}

    def percentile(self, q):
        return _hist_percentile(self.snapshot(), q)

    def percentiles(self, qs=(50, 95, 99)):
        snap = self.snapshot()
        return {q: _hist_percentile(snap, q) for q in qs}


def _hist_percentile(snap, q):
    """Nearest-rank percentile off a histogram snapshot: the upper
    bound of the bucket holding the rank, clamped to the observed
    [min, max] so sparse histograms degrade gracefully (one sample
    reports exactly itself)."""
    n = snap['count']
    if not n:
        return 0.0
    lo, hi = snap['min'], snap['max']
    rank = min(n - 1, int(round(q / 100.0 * (n - 1))))
    cum = 0
    for i, c in enumerate(snap['counts']):
        cum += c
        if cum > rank:
            ub = BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else hi
            return min(max(ub, lo), hi)
    return hi


def merge_histograms(a, b):
    """Elementwise merge of two histogram snapshots (fixed bounds)."""
    return {'counts': [x + y for x, y in zip(a['counts'], b['counts'])],
            'sum': a['sum'] + b['sum'],
            'count': a['count'] + b['count'],
            'min': min(a['min'], b['min']) if (a['count'] and b['count'])
            else (a['min'] if a['count'] else b['min']),
            'max': max(a['max'], b['max']) if (a['count'] and b['count'])
            else (a['max'] if a['count'] else b['max'])}


class Reservoir:
    """Vitter's Algorithm R: a fixed-size uniform sample over an
    unbounded stream, plus exact running count/sum/min/max. NOT
    internally locked — owners update under their own (leaf) lock."""

    __slots__ = ('k', '_buf', '_n', '_sum', '_min', '_max', '_rng')

    def __init__(self, k=2048, seed=0x5EED):
        self.k = int(k)
        self._buf = []
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._rng = random.Random(seed)

    def add(self, v):
        v = float(v)
        self._n += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if len(self._buf) < self.k:
            self._buf.append(v)
        else:
            j = self._rng.randrange(self._n)
            if j < self.k:
                self._buf[j] = v

    def extend(self, vals):
        for v in vals:
            self.add(v)

    def samples(self):
        return list(self._buf)

    def __len__(self):
        return self._n

    @property
    def count(self):
        return self._n

    @property
    def sum(self):
        return self._sum

    @property
    def mean(self):
        return self._sum / self._n if self._n else 0.0

    @property
    def min(self):
        return self._min if self._n else 0.0

    @property
    def max(self):
        return self._max if self._n else 0.0


class MetricsRegistry:
    """Instruments + collectors; snapshots merge across processes."""

    def __init__(self):
        import os
        self._rid = f'reg-{os.getpid()}-{os.urandom(4).hex()}'
        self._metrics = {}              # key -> (kind, instrument)
        self._collectors = {}           # collector key -> fn

    # -------------------------------------------------------- instruments
    def _get(self, kind, cls, name, labels):
        key = _key(name, labels)
        with _LOCK:
            got = self._metrics.get(key)
            if got is not None:
                if got[0] != kind:
                    raise TypeError(
                        f'metric {key!r} already registered as {got[0]}')
                return got[1]
            inst = cls(key)
            self._metrics[key] = (kind, inst)
            return inst

    def counter(self, name, **labels):
        return self._get('counter', Counter, name, labels)

    def gauge(self, name, **labels):
        return self._get('gauge', Gauge, name, labels)

    def histogram(self, name, **labels):
        return self._get('histogram', Histogram, name, labels)

    # --------------------------------------------------------- collectors
    def register_collector(self, key, fn):
        """Register a scrape-time sample source (zero-arg callable
        yielding ``(kind, name, labels, value)``; kind ``'counter'`` or
        ``'gauge'``). Suffixes the key on collision; returns the final
        key (pass it to :meth:`unregister_collector`)."""
        with _LOCK:
            base, n = key, 1
            while key in self._collectors:
                n += 1
                key = f'{base}#{n}'
            self._collectors[key] = fn
        return key

    def unregister_collector(self, key):
        with _LOCK:
            self._collectors.pop(key, None)

    # ----------------------------------------------------------- snapshot
    def snapshot(self):
        """JSON-safe point-in-time view of every instrument plus every
        collector's samples. Collector callables run OUTSIDE the
        registry lock — they take their owners' locks, which sit above
        ``telemetry.metrics`` in the declared hierarchy."""
        out = {'proc': _trace.proc_name(), 'rid': self._rid,
               'counters': {}, 'gauges': {}, 'histograms': {}}
        with _LOCK:
            items = list(self._metrics.values())
            collectors = list(self._collectors.values())
        for kind, inst in items:
            if kind == 'counter':
                out['counters'][inst.key] = inst.value
            elif kind == 'gauge':
                out['gauges'][inst.key] = inst.value
            else:
                out['histograms'][inst.key] = inst.snapshot()
        for fn in collectors:
            try:
                samples = fn()
            except Exception:   # a closed/broken owner must not kill scrape
                continue
            for kind, name, labels, value in samples:
                key = _key(name, labels)
                if kind == 'counter':
                    out['counters'][key] = \
                        out['counters'].get(key, 0) + value
                else:
                    out['gauges'][key] = value
        return out


_DEFAULT = MetricsRegistry()


def default_registry():
    return _DEFAULT


def counter(name, **labels):
    return _DEFAULT.counter(name, **labels)


def gauge(name, **labels):
    return _DEFAULT.gauge(name, **labels)


def histogram(name, **labels):
    return _DEFAULT.histogram(name, **labels)


def register_collector(key, fn):
    return _DEFAULT.register_collector(key, fn)


def unregister_collector(key):
    _DEFAULT.unregister_collector(key)


def merge_snapshots(snaps):
    """Merge registry snapshots fleet-wide: counters and histogram
    buckets sum, gauges last-write-wins. Snapshots with a repeated
    registry id (``rid``) are counted ONCE — in-process replica
    clusters share one registry, and double-counting a shared registry
    would inflate every counter by the replica count."""
    seen = set()
    out = {'counters': {}, 'gauges': {}, 'histograms': {}}
    for s in snaps:
        if not s:
            continue
        rid = s.get('rid')
        if rid is not None:
            if rid in seen:
                continue
            seen.add(rid)
        for k, v in s.get('counters', {}).items():
            out['counters'][k] = out['counters'].get(k, 0) + v
        for k, v in s.get('gauges', {}).items():
            out['gauges'][k] = v
        for k, h in s.get('histograms', {}).items():
            prev = out['histograms'].get(k)
            out['histograms'][k] = h if prev is None \
                else merge_histograms(prev, h)
    return out


def _fmt(v):
    if isinstance(v, float):
        return f'{v:.10g}'
    return str(v)


def _split_key(key):
    i = key.find('{')
    if i < 0:
        return key, ''
    return key[:i], key[i:]


def _with_label(key, extra):
    name, labels = _split_key(key)
    if not labels:
        return f'{name}{{{extra}}}'
    return f'{name}{{{labels[1:-1]},{extra}}}'


def render_prometheus(snapshot=None):
    """Prometheus text exposition of a registry snapshot (default: this
    process's registry; pass ``Router.fleet_metrics()`` output for the
    fleet-wide view)."""
    snap = _DEFAULT.snapshot() if snapshot is None else snapshot
    lines = []
    typed = set()

    def _type_line(key, kind):
        name, _ = _split_key(key)
        if name not in typed:
            typed.add(name)
            lines.append(f'# TYPE {name} {kind}')

    for key in sorted(snap.get('counters', {})):
        _type_line(key, 'counter')
        lines.append(f'{key} {_fmt(snap["counters"][key])}')
    for key in sorted(snap.get('gauges', {})):
        _type_line(key, 'gauge')
        lines.append(f'{key} {_fmt(snap["gauges"][key])}')
    for key in sorted(snap.get('histograms', {})):
        h = snap['histograms'][key]
        _type_line(key, 'histogram')
        name, labels = _split_key(key)
        cum = 0
        for i, c in enumerate(h['counts']):
            cum += c
            if not c and i < len(BUCKET_BOUNDS):
                continue            # sparse: only emit occupied buckets
            le = _fmt(BUCKET_BOUNDS[i]) if i < len(BUCKET_BOUNDS) \
                else '+Inf'
            lines.append('%s %d' % (
                _with_label(name + '_bucket' + labels,
                            'le="%s"' % le), cum))
        lines.append(f'{name}_sum{labels} {_fmt(h["sum"])}')
        lines.append(f'{name}_count{labels} {h["count"]}')
    return '\n'.join(lines) + '\n'
