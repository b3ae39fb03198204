"""Spans, trace context and the flight recorder (``mx.telemetry``).

Dapper-style distributed tracing with zero dependencies:

* a **span** is one timed region ``(trace_id, span_id, parent_id,
  t_start, t_end, attrs)``; :func:`span` opens one as a context
  manager, :func:`emit` records one retroactively (schedulers that
  learn a region's start time only when it ends — queue waits).
* **trace context** is thread-local ``(trace_id, span_id)``; a span
  installs itself as the context for its body, so nested spans chain
  parent edges automatically. :func:`current_tc` exports the context
  as a small JSON-safe dict (the ``tc`` field on RPC envelopes) and
  :func:`attach` adopts one on the receiving side — that is the entire
  propagation protocol.
* the **flight recorder** is a bounded per-process ring buffer
  (``MXNET_TELEMETRY_BUFFER`` events, default 4096): the newest spans
  are always retained, the oldest silently overwritten, so tracing can
  stay on in production and a postmortem reads the last few thousand
  events. :func:`snapshot_buffer` serializes it for the RPC
  ``telemetry`` verb and the Chrome-trace exporter.

Timestamps are wall-clock (``time.time()``) so buffers from different
processes land on one axis; per-peer clock offsets measured off RPC
ping replies (:func:`note_clock`) let the exporter normalize them.

``MXNET_TELEMETRY=0`` disables tracing: :func:`span` returns a shared
no-op context manager, :func:`current_tc` returns ``None`` after a
single flag check — the disabled path is a near-no-op, machine-checked
by the overhead guard in ``tests/test_telemetry.py``.
``MXNET_TELEMETRY_SAMPLE`` (default 1.0) samples ROOT spans: an
unsampled root records nothing and propagates nothing, while children
of a live context always record (a trace is all-or-nothing).

Locking: the recorder lock is level ``telemetry.buffer`` — below every
runtime lock in the declared hierarchy (``analysis/locks.py``), so a
span may be recorded while holding any other lock; nothing is ever
acquired under it.
"""

import os
import random
import threading
import time

__all__ = ['span', 'child_span', 'attach', 'emit', 'current_tc',
           'enabled', 'configure', 'events', 'clear', 'snapshot_buffer',
           'note_clock', 'clock_offsets', 'proc_name', 'walltime']

_FALSY = ('0', 'false', 'off', 'no')


def _env_enabled():
    return os.environ.get('MXNET_TELEMETRY', '1').strip().lower() \
        not in _FALSY


def _env_buffer():
    try:
        n = int(os.environ.get('MXNET_TELEMETRY_BUFFER', '') or 4096)
    except ValueError:
        n = 4096
    return max(16, n)


def _env_sample():
    try:
        s = float(os.environ.get('MXNET_TELEMETRY_SAMPLE', '') or 1.0)
    except ValueError:
        s = 1.0
    return min(1.0, max(0.0, s))


#: stable identity of this process in every record and buffer snapshot
_PROC = f'proc-{os.getpid()}'

_enabled = _env_enabled()
_sample = _env_sample()

def _maybe_tracked(lock, level):
    """Race-checker wrapping, import-robust: this module is imported
    early in package init (via kvstore/rpc.py) and must also load
    standalone (tools/), so the analysis import may not be available —
    an untracked lock is the correct degradation either way."""
    if os.environ.get('MXNET_RACE_CHECK', '').strip() in ('', '0'):
        return lock
    try:
        from ..analysis import race as _race
        if _race.enabled():
            return _race.tracked(lock, level)
    except Exception:
        pass
    return lock


_lock = _maybe_tracked(threading.Lock(), 'telemetry.buffer')

_ring = [None] * _env_buffer()
_seq = 0                                # total records ever appended
_offsets = {}                           # peer proc name -> clock offset (s)

_tls = threading.local()

#: recorder identity: dedups buffers when several RPC peers live in one
#: process (in-process tests) and the fleet sweep collects each once
_RECORDER = f'{_PROC}-{os.urandom(4).hex()}'

walltime = time.time


def proc_name():
    return _PROC


def enabled():
    return _enabled


def configure(enabled=None, buffer=None, sample=None):
    """Runtime reconfiguration (tests; production uses the env knobs
    ``MXNET_TELEMETRY`` / ``MXNET_TELEMETRY_BUFFER`` /
    ``MXNET_TELEMETRY_SAMPLE`` read at import). Resizing the buffer
    drops recorded events."""
    global _enabled, _sample, _ring, _seq
    with _lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if sample is not None:
            _sample = min(1.0, max(0.0, float(sample)))
        if buffer is not None:
            _ring = [None] * max(16, int(buffer))
            _seq = 0


def _rng():
    r = getattr(_tls, 'rng', None)
    if r is None:
        r = _tls.rng = random.Random(
            int.from_bytes(os.urandom(8), 'big'))
    return r


def _new_id():
    return '%016x' % _rng().getrandbits(64)


def _record(name, trace_id, span_id, parent_id, t0, t1, attrs):
    rec = {'name': name, 'trace': trace_id, 'span': span_id,
           'parent': parent_id, 't0': t0, 't1': t1, 'proc': _PROC,
           'thread': threading.current_thread().name}
    if attrs:
        rec['attrs'] = attrs
    global _seq
    with _lock:
        rec['seq'] = _seq
        _ring[_seq % len(_ring)] = rec
        _seq += 1
    return rec


class _NoopSpan:
    """Shared do-nothing span: the entire disabled/unsampled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ('name', 'trace_id', 'span_id', 'parent_id', 'attrs',
                 't0', '_prev')

    def __init__(self, name, trace_id, parent_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.attrs = attrs

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        self.span_id = _new_id()
        self._prev = getattr(_tls, 'ctx', None)
        _tls.ctx = (self.trace_id, self.span_id)
        self.t0 = walltime()
        return self

    def __exit__(self, etype, exc, tb):
        t1 = walltime()
        _tls.ctx = self._prev
        if etype is not None:
            self.attrs['error'] = f'{etype.__name__}: {exc}'
        _record(self.name, self.trace_id, self.span_id, self.parent_id,
                self.t0, t1, self.attrs)
        return False


def span(name, parent=None, **attrs):
    """Open a span as a context manager. Child of the current context
    when one exists (or of ``parent``, a ``tc`` dict, when given);
    otherwise the root of a new trace, subject to
    ``MXNET_TELEMETRY_SAMPLE``. The span records on exit; an exception
    in the body lands in ``attrs['error']`` and propagates."""
    if not _enabled:
        return _NOOP
    if parent is not None:
        return _Span(name, str(parent.get('t')), str(parent.get('s')),
                     attrs)
    cur = getattr(_tls, 'ctx', None)
    if cur is not None:
        return _Span(name, cur[0], cur[1], attrs)
    if _sample < 1.0 and _rng().random() >= _sample:
        return _NOOP
    return _Span(name, _new_id(), None, attrs)


def child_span(name, **attrs):
    """Like :func:`span` but a no-op when there is no current context:
    instrumentation for hot library paths (kvstore push/pull) that
    should only trace inside a caller-opened trace, never start one."""
    if not _enabled:
        return _NOOP
    cur = getattr(_tls, 'ctx', None)
    if cur is None:
        return _NOOP
    return _Span(name, cur[0], cur[1], attrs)


class _Attach:
    __slots__ = ('_tc', '_prev')

    def __init__(self, tc):
        self._tc = tc

    def __enter__(self):
        self._prev = getattr(_tls, 'ctx', None)
        tc = self._tc
        if tc:
            _tls.ctx = (str(tc.get('t')), str(tc.get('s')))
        return self

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def attach(tc):
    """Adopt a propagated trace context (``tc`` dict off an RPC
    envelope) as the current context for the body — the server side of
    context propagation. Falsy ``tc`` (or disabled telemetry) attaches
    nothing; always returns a context manager."""
    return _Attach(tc if (_enabled and tc) else None)


def current_tc():
    """The current context as a wire-safe dict ``{'t': trace_id, 's':
    span_id}``, or ``None`` — what ``RpcClient`` injects as the
    envelope's ``tc`` field."""
    if not _enabled:
        return None
    cur = getattr(_tls, 'ctx', None)
    if cur is None:
        return None
    return {'t': cur[0], 's': cur[1]}


def emit(name, t0, t1, parent=None, **attrs):
    """Record a completed span retroactively: ``parent`` is a ``tc``
    dict (a queued request's captured context) or, when ``None``, the
    current context. Returns the record, or ``None`` when nothing was
    recorded (disabled, or no parent and no context — retroactive
    spans never root a trace)."""
    if not _enabled:
        return None
    if parent is not None:
        trace_id, parent_id = str(parent.get('t')), str(parent.get('s'))
    else:
        cur = getattr(_tls, 'ctx', None)
        if cur is None:
            return None
        trace_id, parent_id = cur
    return _record(name, trace_id, _new_id(), parent_id,
                   float(t0), float(t1), attrs)


def events():
    """Snapshot of the flight recorder, oldest first."""
    with _lock:
        n, ring = _seq, _ring
        cap = len(ring)
        if n <= cap:
            return list(ring[:n])
        i = n % cap
        return ring[i:] + ring[:i]


def clear():
    """Drop every recorded event (tests; clock offsets survive)."""
    global _seq
    with _lock:
        for i in range(len(_ring)):
            _ring[i] = None
        _seq = 0


def snapshot_buffer():
    """Serializable flight-recorder snapshot: the payload of the RPC
    ``telemetry`` verb and the exporter's merge unit."""
    return {'proc': _PROC, 'recorder': _RECORDER, 'clock': walltime(),
            'events': events()}


def note_clock(proc, remote_ts, t_send, t_recv):
    """Record a peer's clock offset from one RPC round trip: the peer
    stamped ``remote_ts`` (its wall clock) between our ``t_send`` and
    ``t_recv`` — the midpoint estimate is NTP's, good to half the RTT,
    plenty for trace alignment. Our own proc is always offset 0."""
    if proc == _PROC:
        return
    off = float(remote_ts) - (float(t_send) + float(t_recv)) / 2.0
    with _lock:
        _offsets[proc] = off


def clock_offsets():
    """``{peer proc name: seconds ahead of our clock}``."""
    with _lock:
        return dict(_offsets)
