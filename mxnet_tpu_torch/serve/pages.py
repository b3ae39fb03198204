"""Paged KV-cache page allocator + prefix cache for the decode server.

Device memory holds a global pool of fixed-size **pages** ``(num_pages,
page_size, kv_heads, dh)`` per layer (vLLM's *PagedAttention*, Kwon et
al., SOSP 2023), and a sequence holds only the pages its actual depth
needs — the per-slot *block table* (an int32 tensor of page ids, passed
to every step as an input) maps logical positions onto pool pages.

Everything here is host-side bookkeeping — no torch imports:

* a free list + per-page refcounts (pages shared across sequences by
  the prefix cache carry one reference per holder);
* page id 0 is reserved as the **garbage sink**: inactive decode rows
  and unfilled block-table entries point at it, so the step's
  unconditional scatter for dead rows lands in memory nobody ever
  attends to (the same positional-masking invariant as before, see
  serve/decode.py);
* a **prefix cache** keyed by a chain hash over full prefill chunks
  (``key_i = H(key_{i-1} || chunk_i)``) — a repeated shared prefix
  (system prompt) resolves to warm pages copy-free, pinned by a cache
  reference until evicted LRU when the pool runs dry.

Thread-safety: all state sits behind one lock at level ``serve.pages``
in the declared hierarchy — between ``serve.queue`` (held while
admitting) and ``serve.slots`` (never held while calling in here); see
``analysis/locks.py`` and docs/threading.md.
"""

import hashlib
import os
import threading

from ..analysis import race as _race
from ..telemetry import metrics as _tmetrics
from .errors import PagesExhausted

__all__ = ['PageAllocator', 'PagesExhausted', 'chain_key', 'EMPTY_KEY',
           'GARBAGE_PAGE', 'default_page_size', 'default_num_pages',
           'default_prefill_chunk', 'prefix_cache_enabled']

#: block-table entries that map no live position point here; the
#: allocator never hands page 0 to a sequence.
GARBAGE_PAGE = 0

#: the chain-hash seed: the key of the empty prefix.
EMPTY_KEY = ''


def chain_key(prev_key, chunk_tokens):
    """Chain hash over prefill chunks: the cache key of a prefix is a
    function of every token before it, so two prompts share an entry
    iff they share the *entire* prefix up to that chunk boundary."""
    h = hashlib.sha1(prev_key.encode('ascii'))
    h.update(b'|')
    h.update(','.join(str(int(t)) for t in chunk_tokens).encode('ascii'))
    return h.hexdigest()


def default_page_size():
    """``MXNET_SERVE_PAGE_SIZE`` (default 16 token positions/page)."""
    return int(os.environ.get('MXNET_SERVE_PAGE_SIZE', '') or 16)


def default_num_pages(slots, max_length, page_size):
    """``MXNET_SERVE_PAGES``, defaulting to the dense-carve equivalent
    (``slots * max_length`` positions) plus the reserved garbage page —
    same byte budget as the old contiguous pool, but shallow sequences
    leave the unused depth allocatable to others."""
    env = os.environ.get('MXNET_SERVE_PAGES', '')
    if env:
        return int(env)
    return slots * (max_length // page_size) + 1


def default_prefill_chunk():
    """``MXNET_SERVE_PREFILL_CHUNK`` (default 32 tokens/chunk)."""
    return int(os.environ.get('MXNET_SERVE_PREFILL_CHUNK', '') or 32)


def prefix_cache_enabled():
    """``MXNET_SERVE_PREFIX_CACHE`` (default on; ``0`` disables)."""
    return os.environ.get('MXNET_SERVE_PREFIX_CACHE', '1') not in \
        ('0', 'false', 'off')


class _PrefixEntry:
    __slots__ = ('key', 'pages', 'tick')

    def __init__(self, key, pages, tick):
        self.key = key
        self.pages = tuple(pages)
        self.tick = tick


class PageAllocator:
    """Free list + refcounts over a fixed pool of KV pages, with an
    integrated LRU prefix cache.

    ``metrics`` (a :class:`~.metrics.ServingMetrics`, optional) receives
    ``on_page_eviction`` calls; hit/miss accounting stays with the
    caller (the decode server knows chunk granularity).
    """

    def __init__(self, num_pages, page_size, name='pages', metrics=None):
        if num_pages < 2:
            raise ValueError(
                f'need at least 2 pages (1 usable + the garbage sink), '
                f'got {num_pages}')
        if page_size < 1:
            raise ValueError(f'page_size must be >= 1, got {page_size}')
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = _race.tracked(threading.Lock(), 'serve.pages')
        self._state = _race.shared_state(f'{name}.table',
                                         guard='serve.pages')
        # LIFO free list (reuse warm pages first); page 0 excluded
        self._free = list(range(self.num_pages - 1, GARBAGE_PAGE, -1))
        self._ref = {}                  # page id -> refcount (allocated)
        self._prefix = {}               # chain key -> _PrefixEntry
        self._tick = 0                  # LRU clock
        self._evictions = 0
        self._metrics = metrics
        self._name = str(name)
        self._collector_key = _tmetrics.register_collector(
            f'pages:{self._name}', self._collect)

    def _collect(self):
        """Registry collector: pool occupancy + prefix-cache churn as
        Prometheus samples (the ``stats()`` dict stays the local
        view)."""
        s = self.stats()
        labels = {'pool': self._name}
        yield ('gauge', 'mx_pages_in_use', labels, s['pages_in_use'])
        yield ('gauge', 'mx_pages_free', labels, s['pages_free'])
        yield ('gauge', 'mx_prefix_entries', labels,
               s['prefix_entries'])
        yield ('counter', 'mx_page_evictions_total', labels,
               s['page_evictions'])

    def detach(self):
        """Unhook this allocator from the metrics registry (owner
        close path); idempotent."""
        _tmetrics.unregister_collector(self._collector_key)

    # ------------------------------------------------------------- sizing
    @property
    def usable(self):
        """Pages available to sequences (total minus the garbage sink)."""
        return self.num_pages - 1

    def pages_for(self, positions):
        """Pages needed to cover ``positions`` token positions."""
        return -(-int(positions) // self.page_size)

    # ---------------------------------------------------------- alloc/free
    def alloc(self, n):
        """Take ``n`` pages off the free list (refcount 1 each),
        evicting LRU prefix-cache entries if the list runs short.
        Raises :class:`PagesExhausted` (a ``ServerOverloaded``) when the
        pool genuinely cannot supply ``n`` pages."""
        if n <= 0:
            return []
        with self._lock:
            self._state.write()
            if len(self._free) < n:
                self._evict_locked(n - len(self._free))
            if len(self._free) < n:
                raise PagesExhausted(
                    f'KV page pool exhausted: want {n} pages, '
                    f'{len(self._free)} free of {self.usable} usable '
                    f'({len(self._prefix)} prefix entries, all pinned)')
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._ref[p] = 1
            return out

    def retain(self, pages):
        """Add one reference to each page (a new holder of shared
        pages — prefix-cache reuse)."""
        with self._lock:
            self._state.write()
            for p in pages:
                self._ref[p] += 1

    def release(self, pages):
        """Drop one reference per page; pages at refcount 0 return to
        the free list. Returns the number of pages actually freed."""
        freed = 0
        with self._lock:
            self._state.write()
            for p in pages:
                r = self._ref[p] - 1
                if r:
                    self._ref[p] = r
                else:
                    del self._ref[p]
                    self._free.append(p)
                    freed += 1
        return freed

    # --------------------------------------------------------- prefix cache
    def lookup(self, key):
        """Prefix-cache probe. On a hit, the entry's pages gain one
        reference for the caller (pin) and the entry is LRU-touched;
        returns the page tuple, or ``None`` on a miss."""
        with self._lock:
            self._state.write()
            ent = self._prefix.get(key)
            if ent is None:
                return None
            self._tick += 1
            ent.tick = self._tick
            for p in ent.pages:
                self._ref[p] += 1
            return ent.pages

    def insert(self, key, pages):
        """Publish ``pages`` (a just-prefilled full chunk) under ``key``.
        The cache takes its own reference on each page, so the pages
        stay warm after the writing sequence retires. No-op when the
        key is already present."""
        with self._lock:
            self._state.write()
            if key in self._prefix:
                return
            self._tick += 1
            for p in pages:
                self._ref[p] += 1
            self._prefix[key] = _PrefixEntry(key, pages, self._tick)

    def _evict_locked(self, want_pages):
        """Drop LRU prefix entries whose pages are held ONLY by the
        cache (refcount == 1 each — evicting anything hotter frees no
        memory and destroys reuse) until ``want_pages`` pages came back
        or no candidate remains. Caller holds the lock."""
        victims = sorted(self._prefix.values(), key=lambda e: e.tick)
        freed = 0
        for ent in victims:
            if freed >= want_pages:
                break
            if any(self._ref[p] != 1 for p in ent.pages):
                continue                # pinned by a live sequence
            del self._prefix[ent.key]
            self._evictions += 1
            for p in ent.pages:
                del self._ref[p]
                self._free.append(p)
                freed += 1
            if self._metrics is not None:
                self._metrics.on_page_eviction()

    # -------------------------------------------------------------- stats
    def stats(self):
        with self._lock:
            in_use = self.usable - len(self._free)
            return {
                'pages_total': self.num_pages,
                'pages_usable': self.usable,
                'pages_in_use': in_use,
                'pages_free': len(self._free),
                'page_size': self.page_size,
                'prefix_entries': len(self._prefix),
                'page_evictions': self._evictions,
            }

    def __repr__(self):
        s = self.stats()
        return (f'<PageAllocator {s["pages_in_use"]}/{s["pages_usable"]} '
                f'pages in use, page_size={self.page_size}, '
                f'{s["prefix_entries"]} prefix entries>')
