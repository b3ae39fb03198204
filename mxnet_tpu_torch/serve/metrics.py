"""Serving metrics: latency/queue-time percentiles, occupancy, shed and
timeout counters.

One :class:`ServingMetrics` per server, registered into
``mx.profiler``'s Serving section (``profiler.dumps()``) and aggregated
by :func:`mxnet_tpu_torch.serve.stats`. Percentiles use the same nearest-rank
estimator as the profiler's per-op table (``profiler.percentiles``) so
the two surfaces always agree on what "p99" means.

Thread-safety: counters are updated from the scheduler thread while
``snapshot()`` is called from client threads / the profiler — everything
mutable sits behind ``_lock`` (a leaf lock: nothing else is ever
acquired while holding it, level ``misc.leaf`` in
``analysis/locks.py``).
"""

import threading

from .. import profiler
from ..analysis import race as _race
from ..telemetry import metrics as _tmetrics
from ..telemetry.metrics import Reservoir

__all__ = ['ServingMetrics', 'registry', 'register', 'unregister']

_SAMPLES = 2048

# live servers: name -> ServingMetrics (module-level so serve.stats()
# can aggregate without holding server references)
_REGISTRY = {}
_REGISTRY_LOCK = threading.Lock()


class ServingMetrics:
    """Bounded-memory serving counters for one server."""

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        if _race.enabled():
            self._lock = _race.tracked(self._lock, 'misc.leaf')
        # bounded WHOLE-RUN percentile samples (reservoir sampling,
        # uniform over every observation) — a sliding-window deque
        # only ever showed the last few thousand events, so long-run
        # percentiles silently became recent-window percentiles
        self._latency_s = Reservoir(_SAMPLES)   # submit -> result
        self._queue_s = Reservoir(_SAMPLES)     # submit -> dispatch
        self._ttft_s = Reservoir(_SAMPLES)      # submit -> 1st token
        self._intertok_s = Reservoir(_SAMPLES)  # token -> next token
        # registry binding (histograms + collector): installed by
        # module-level register() once the public name is settled
        self._hist = None
        self._collector_key = None
        self._requests = 0
        self._completed = 0
        self._failed = 0
        self._shed = 0
        self._expired = 0
        self._batches = 0
        self._batched_rows = 0      # real rows across dispatched batches
        self._padded_rows = 0       # pad rows burned to reach a bucket
        self._steps = 0             # decode steps (continuous batching)
        self._active_rows = 0       # active slots across decode steps
        self._dispatched_rows = 0   # pool rows dispatched (active + idle)
        self._recompiles = 0        # compiles observed AFTER warmup
        self._prefill_chunks = 0    # chunked-prefill dispatches
        self._prefix_hit = 0        # prompt chunks served from warm pages
        self._prefix_miss = 0       # prompt chunks that needed prefill
        self._page_evictions = 0    # prefix-cache entries dropped LRU
        self._pages_in_use = 0      # gauge: pool pages held right now
        self._pages_usable = 0      # gauge: pool pages available to seqs
        self._page_util_sum = 0.0   # per-step utilization accumulator

    # ------------------------------------------------------------ events
    def on_submit(self):
        with self._lock:
            self._requests += 1

    def on_shed(self):
        with self._lock:
            self._shed += 1

    def on_expired(self):
        with self._lock:
            self._expired += 1

    def on_dispatch(self, n_real, n_pad, queue_times_s):
        with self._lock:
            self._batches += 1
            self._batched_rows += n_real
            self._padded_rows += n_pad
            self._queue_s.extend(queue_times_s)
        self._observe('queue', queue_times_s)

    def on_admit(self, queue_times_s):
        """Queue-time samples for slot-pool admission (decode server —
        no per-batch dispatch event to hang them on)."""
        with self._lock:
            self._queue_s.extend(queue_times_s)
        self._observe('queue', queue_times_s)

    def on_step(self, n_active, n_rows=None):
        """One continuous-batching decode step: ``n_active`` live
        sequences out of ``n_rows`` dispatched pool rows (the compiled
        step always runs the full pool shape — idle rows are honest
        waste, tracked separately from the active count)."""
        with self._lock:
            self._steps += 1
            self._active_rows += n_active
            self._dispatched_rows += n_rows if n_rows is not None \
                else n_active
            if self._pages_usable:
                self._page_util_sum += \
                    self._pages_in_use / self._pages_usable

    def on_first_token(self, ttft_s):
        """Time-to-first-token: submit → the prompt's first generated
        token (the tail of the last prefill chunk)."""
        with self._lock:
            self._ttft_s.add(ttft_s)
        self._observe('ttft', (ttft_s,))

    def on_token_gap(self, gap_s):
        """Inter-token gap for one live sequence — the latency a
        streaming client perceives between tokens; chunked prefill
        exists to bound its tail while long prompts load."""
        with self._lock:
            self._intertok_s.add(gap_s)
        self._observe('intertok', (gap_s,))

    def on_prefill_chunk(self, n=1):
        with self._lock:
            self._prefill_chunks += n

    def on_prefix(self, hits, misses):
        """Prompt admission outcome in chunks: ``hits`` resolved to
        warm prefix-cache pages (no prefill compute), ``misses`` will
        be prefilled."""
        with self._lock:
            self._prefix_hit += hits
            self._prefix_miss += misses

    def on_page_eviction(self, n=1):
        with self._lock:
            self._page_evictions += n

    def on_pages(self, in_use, usable):
        """Page-pool gauge (sampled by the scheduler each iteration)."""
        with self._lock:
            self._pages_in_use = in_use
            self._pages_usable = usable

    def on_complete(self, latency_s):
        with self._lock:
            self._completed += 1
            self._latency_s.add(latency_s)
        self._observe('latency', (latency_s,))

    def on_failed(self):
        with self._lock:
            self._failed += 1

    def on_recompile(self, n=1):
        """A post-warmup XLA compile — the event the bucketed-shape
        discipline exists to prevent; any nonzero count is a bug."""
        with self._lock:
            self._recompiles += n

    # --------------------------------------------------- registry binding
    def _observe(self, which, values):
        """Feed registry histograms (fleet-mergeable duplicates of the
        reservoir samples). Outside ``self._lock``: the histogram's own
        lock (``telemetry.metrics``) is all it takes."""
        h = self._hist
        if h is not None:
            hist = h[which]
            for v in values:
                hist.observe(v)

    def _bind(self, reg_name):
        """Install registry instruments under the deduplicated public
        name (called by :func:`register`): four latency histograms plus
        a collector exporting the counters/gauges."""
        labels = {'server': reg_name}
        self._hist = {
            'latency': _tmetrics.histogram('mx_serve_latency_seconds',
                                           **labels),
            'queue': _tmetrics.histogram('mx_serve_queue_seconds',
                                         **labels),
            'ttft': _tmetrics.histogram('mx_serve_ttft_seconds',
                                        **labels),
            'intertok': _tmetrics.histogram(
                'mx_serve_intertoken_seconds', **labels),
        }
        self._collector_key = _tmetrics.register_collector(
            f'serving:{reg_name}', lambda: self._collect(labels))

    def _unbind(self):
        if self._collector_key is not None:
            _tmetrics.unregister_collector(self._collector_key)
            self._collector_key = None
        self._hist = None

    def _collect(self, labels):
        with self._lock:
            counters = {
                'mx_serve_requests_total': self._requests,
                'mx_serve_completed_total': self._completed,
                'mx_serve_failed_total': self._failed,
                'mx_serve_shed_total': self._shed,
                'mx_serve_expired_total': self._expired,
                'mx_serve_batches_total': self._batches,
                'mx_serve_steps_total': self._steps,
                'mx_serve_recompiles_total': self._recompiles,
                'mx_serve_prefill_chunks_total': self._prefill_chunks,
                'mx_serve_prefix_hit_total': self._prefix_hit,
                'mx_serve_prefix_miss_total': self._prefix_miss,
            }
            in_use = self._pages_in_use
        for name, v in counters.items():
            yield ('counter', name, labels, v)
        yield ('gauge', 'mx_serve_pages_in_use', labels, in_use)

    # ---------------------------------------------------------- snapshot
    def snapshot(self):
        """Point-in-time stats dict (the ``serve.stats()`` payload and
        the profiler Serving section's data source)."""
        with self._lock:
            lat = self._latency_s.samples()
            qt = self._queue_s.samples()
            ttft = self._ttft_s.samples()
            gaps = self._intertok_s.samples()
            batches = self._batches
            rows = self._batched_rows
            steps = self._steps
            active = self._active_rows
            dispatched = self._dispatched_rows
            util_sum = self._page_util_sum
            out = {
                'requests': self._requests,
                'completed': self._completed,
                'failed': self._failed,
                'shed': self._shed,
                'expired': self._expired,
                'batches': batches,
                'padded_rows': self._padded_rows,
                'steps': steps,
                'recompiles': self._recompiles,
                'prefill_chunks': self._prefill_chunks,
                'prefix_hit': self._prefix_hit,
                'prefix_miss': self._prefix_miss,
                'page_evictions': self._page_evictions,
                'pages_in_use': self._pages_in_use,
            }
        # percentiles off-lock: sorting 2k samples under the leaf lock
        # would stall the scheduler's counter updates
        out['latency_ms'] = {q: v * 1e3 for q, v in
                             profiler.percentiles(lat).items()}
        out['queue_ms'] = {q: v * 1e3 for q, v in
                           profiler.percentiles(qt).items()}
        out['ttft_ms'] = {q: v * 1e3 for q, v in
                          profiler.percentiles(ttft).items()}
        out['intertoken_ms'] = {q: v * 1e3 for q, v in
                                profiler.percentiles(gaps).items()}
        # occupancy: mean real rows per dispatched batch (batcher) or
        # mean active slots per step (decode server)
        if steps:
            out['occupancy_avg'] = active / steps
        elif batches:
            out['occupancy_avg'] = rows / batches
        else:
            out['occupancy_avg'] = 0.0
        # honest decode-pool accounting, kept separate (the old single
        # number conflated them): slot_occupancy is the fraction of
        # DISPATCHED pool rows that carried a live sequence (idle rows
        # during drain drag it down — that is the point), and
        # page_utilization is the per-step mean fraction of usable KV
        # pages actually held by sequences/prefix entries.
        out['slot_occupancy'] = active / dispatched if dispatched else 0.0
        out['page_utilization'] = util_sum / steps if steps else 0.0
        return out


def register(name, metrics):
    """Register a server's metrics under a unique name (suffixing on
    collision) and attach it to the profiler Serving section. Returns
    the registered name."""
    with _REGISTRY_LOCK:
        base, n = name, 1
        while name in _REGISTRY:
            n += 1
            name = f'{base}#{n}'
        _REGISTRY[name] = metrics
    metrics._bind(name)
    profiler.attach_serving(name, metrics.snapshot)
    return name


def unregister(name):
    with _REGISTRY_LOCK:
        metrics = _REGISTRY.pop(name, None)
    if metrics is not None:
        metrics._unbind()
    profiler.detach_serving(name)


def registry():
    """Snapshot of live server metrics: name -> ServingMetrics."""
    with _REGISTRY_LOCK:
        return dict(_REGISTRY)
