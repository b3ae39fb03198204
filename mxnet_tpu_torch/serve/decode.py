"""Continuous-batching decode server over a paged KV cache, in PyTorch.

Counterpart of ``mxnet_tpu/serve/decode.py``, with the same scheduler,
admission, page plans, prefix cache, chunked prefill and ``stats()`` keys.

Orca-style iteration-level scheduling: the server owns a fixed pool of
decode *slots* and re-forms the batch at every decode step — a finished
sequence frees its slot and a queued prompt takes it over between steps.

KV memory is **paged** (vLLM's PagedAttention, Kwon et al. SOSP 2023):
one global pool of fixed-size pages ``(num_pages, page_size, kv_heads,
dh)`` per layer, and each sequence holds only the pages its depth needs,
named through a per-slot int32 **block table**. Slot count is a batch
shape and pool bytes are a memory budget, so admission is gated on pages.

Prompts load via **chunked prefill** (Sarathi-Serve, Agrawal et al. OSDI
2024): fixed ``prefill_chunk``-token chunks interleave with decode steps,
so a long prompt cannot head-of-line block the running decodes. Full
chunks are published to a **prefix cache** (chain hash over the token
prefix), so a repeated shared prefix resolves to warm pages with zero
prefill dispatches.

Where the reference compiles one step and one prefill-chunk program, the
server here captures each as a CUDA graph (``_graphs.StepGraph``) and
replays it: ``warmup`` captures both at construction, ``compile_count``
counts captures and ``recompiles`` any capture after warm-up. Their inputs
are static device buffers filled from one pinned host buffer by
non-blocking copies; the argmax runs inside the graph, so a call's one
host sync is reading its tokens. On the CPU nothing is captured: the same
bodies run eagerly and ``compile_count`` stays 0. The page pool is updated
IN PLACE by index assignment where the reference donates it to a jitted
step (:meth:`DecodeServer.audit_donation` checks it). The decode step
reads the pool through the paged attention kernel; the prefill chunk
attends over the row's pages gathered out of the pool.

Pad/garbage safety is positional: row ``b`` only ever attends to cache
positions ``<= offset[b]``, and every such position was written by the
current occupant (prefill chunks cover ``0..alen``, each step writes its
offset before attending). Idle rows carry an all-garbage block table and
scatter into page 0, which nothing reads. Prefix-cache pages are the one
exception, and they hold exactly the K/V the same tokens would have
produced (the cache key covers the entire prefix).

Under ``mx.sharding.mesh(dp=..., tp=...)`` (reference :245-312) the server
is SPMD: every rank runs this scheduler on the same submitted requests.
The net's parameters are placed by the context's rules (the Llama's
``('llama', 'tp')`` table, as a hybridized Gluon call places them; a net
initialized inside the mesh holds its shards already), and the pool
``P('dp', None, 'tp', None)`` through ``resolve_spec``: each rank holds
its ``tp`` share of the KV heads, and the slots and pages split on ``dp``
(slot ``s`` belongs to ``dp`` rank ``s // (slots / dp)``, whose own range
of the pool, with its own allocator and garbage page, holds its pages). A
decode step computes this ``dp`` rank's slots (B4 reads this rank's KV
heads), picks the global greedy token over ``tp`` and all-gathers the
tokens over ``dp``; a prefill chunk runs on the ranks of its slot's ``dp``
index and its token is all-gathered. The calls hold collectives, so a
sharded server runs them eagerly (no CUDA graph; ``compile_count`` 0); the
unsharded server keeps its graphs.

The ranks' collectives pair up only while every rank admits, prefills and
steps in the same order, so a sharded server's schedule must not hang on
a thread's wake-ups or a rank's own clock: it has no scheduler thread
(``start=True`` raises: each rank calls :meth:`step_once`, and ``close``
drains by it, with no time bound) and no queue deadlines (they raise).
The reference is one program and needs neither rule.

Locking: ``_cv`` (``serve.queue``) guards admission, the page allocator's
lock (``serve.pages``, taken inside the queue lock during admission)
guards the free list / refcounts / prefix cache, and ``_slot_lock``
(``serve.slots``, innermost, never held across a model call or an
allocator call) guards the slot table; ``_run_lock`` (``serve.run``,
taken with no other lock held) serialises the model calls, which the
scheduler thread makes, with ``audit_donation`` and ``close``, which
share the staged inputs and the graphs.
"""

import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .. import _graphs
from ..analysis import race as _race
from ..analysis.report import AnalysisReport
from ..telemetry import trace as _trace
from . import faults as _faults
from . import pages as _pages
from .buckets import chunk_spans
from .errors import DeadlineExceeded, PagesExhausted, ServeError, \
    ServerClosed, ServerOverloaded
from .metrics import ServingMetrics, register as _register, \
    unregister as _unregister
from .pages import PageAllocator

__all__ = ['DecodeServer']


class _Allocators:
    """The page allocators of the ``dp`` groups of a sharded server, seen
    as one for the whole-server checks and stats: capacity is a group's,
    counts are summed."""

    def __init__(self, allocs):
        self.allocs = allocs
        self.page_size = allocs[0].page_size
        self.num_pages = sum(a.num_pages for a in allocs)
        self.usable = allocs[0].usable

    def pages_for(self, positions):
        return self.allocs[0].pages_for(positions)

    def stats(self):
        out = {}
        for a in self.allocs:
            for k, v in a.stats().items():
                out[k] = v if k == 'page_size' else out.get(k, 0) + v
        return out


def _drain_deadline_s():
    """Bound on a draining close: ``MXNET_SERVE_DRAIN_S`` seconds
    (default 30) before residual requests are force-failed."""
    try:
        return max(1e-3, float(os.environ.get('MXNET_SERVE_DRAIN_S', '30')))
    except ValueError:
        return 30.0


class _Seq:
    """One live sequence: its slot, pages, depth and remaining budget."""

    __slots__ = ('request', 'slot', 'offset', 'remaining', 'tokens',
                 'pages', 'filled', 'phase', 'ckey', 'last_t')

    def __init__(self, request, slot):
        self.request = request
        self.slot = slot
        self.offset = 0             # next cache write position
        self.remaining = request.max_new
        self.tokens = []            # generated token ids (host ints)
        self.pages = []             # page ids, logical order
        self.filled = 0             # prompt tokens already in cache
        self.phase = 'prefill'      # 'prefill' -> 'decode'
        self.ckey = _pages.EMPTY_KEY    # chain key of consumed chunks
        self.last_t = 0.0           # last token timestamp (intertoken)


class _DecodeRequest:
    __slots__ = ('prompt', 'max_new', 'future', 'submit_t', 'deadline',
                 'tc', 'wall_t')

    def __init__(self, prompt, max_new, submit_t, deadline):
        self.prompt = prompt
        self.max_new = max_new
        self.future = Future()
        self.submit_t = submit_t
        self.deadline = deadline
        # trace context captured at submission: the scheduler emits
        # queue-wait / prefill / per-step spans against it afterwards
        self.tc = _trace.current_tc()
        self.wall_t = _trace.walltime() if self.tc is not None else 0.0


class DecodeServer:
    """Paged-KV continuous batching over a ``LlamaForCausalLM``.

    Parameters
    ----------
    net : LlamaForCausalLM
        The model; the server runs on the device of its parameters.
    slots : int
        Decode batch shape == max concurrent sequences (default 4).
    max_length : int, optional
        Longest supported sequence (prompt + generated; default
        ``net.cfg.max_length``), rounded up to whole prefill chunks —
        it sizes the block-table width, not any allocation.
    page_size : int, optional
        Token positions per KV page (``MXNET_SERVE_PAGE_SIZE``,
        default 16).
    num_pages : int, optional
        Page-pool size including the reserved garbage page
        (``MXNET_SERVE_PAGES``; default ``slots * max_length /
        page_size + 1``).
    prefill_chunk : int, optional
        Prompt tokens per prefill dispatch (``MXNET_SERVE_PREFILL_CHUNK``,
        default 32) — must be a multiple of ``page_size``. One chunk
        runs per scheduler iteration, interleaved with decode steps.
    prefix_cache : bool, optional
        Reuse warm pages for repeated full prompt chunks
        (``MXNET_SERVE_PREFIX_CACHE``, default on).
    queue_depth : int, optional
        Bound on queued requests (``MXNET_SERVE_QUEUE_DEPTH``, 256);
        beyond it ``submit`` sheds with :class:`ServerOverloaded`.
    deadline_ms : float, optional
        Default queue deadline (``MXNET_SERVE_DEADLINE_MS``; 0 = none).
    clock, name, start
        Time source, metrics name, and whether to start the scheduler
        thread (``start=False``: drive it with :meth:`step_once`).
    warmup : bool
        Capture the prefill-chunk and step graphs at construction
        (default True, as the reference compiles its programs then; on
        the CPU the bodies run once). Without it the first call of each
        captures its graph.

    The net is a Gluon ``LlamaForCausalLM`` whose parameters are
    initialized (on the card, or ``ctx=mx.cpu()``); the server runs its
    cached calls (``net(tokens, caches=pool, offset=..., pages=...)``),
    which never train. A served net should set ``grad_req='null'`` before
    ``initialize()``, as an MXNet user does for inference: otherwise every
    parameter also holds a gradient buffer of its size (32 GB beside the
    32 GB of an fp32 ``llama3_8b``).

    The graphs read the weights through the addresses they had when they
    were captured: updates in place (``set_data``, an optimizer step) are
    seen, new leaves are not (``cast``, ``reset_ctx``, the layers
    ``quantize_net`` swaps in), so a net quantized after a server was
    built needs a new server, as the reference's server takes its
    parameters at construction.
    """

    def __init__(self, net, slots=4, max_length=None, page_size=None,
                 num_pages=None, prefill_chunk=None, prefix_cache=None,
                 queue_depth=None, deadline_ms=None, clock=time.monotonic,
                 name=None, start=True, warmup=True):
        self.net = net
        self.device = net.model.embed_tokens.weight.data()._data.device
        self.slots = int(slots)
        self.page_size = int(page_size or _pages.default_page_size())
        max_length = int(max_length or net.cfg.max_length)
        if prefill_chunk is None:
            prefill_chunk = min(_pages.default_prefill_chunk(), max_length)
            prefill_chunk = max(self.page_size,
                                prefill_chunk - prefill_chunk
                                % self.page_size)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1 or \
                self.prefill_chunk % self.page_size:
            raise ServeError(
                f'prefill_chunk {self.prefill_chunk} must be a positive '
                f'multiple of page_size {self.page_size}')
        # whole chunks must fit the block table (pad positions of the
        # final chunk included), so max_length rounds up to chunks
        c = self.prefill_chunk
        self.max_length = -(-max_length // c) * c
        self._max_pages = self.max_length // self.page_size
        num_pages = num_pages or _pages.default_num_pages(
            self.slots, self.max_length, self.page_size)
        self.queue_depth = queue_depth if queue_depth is not None else \
            int(os.environ.get('MXNET_SERVE_QUEUE_DEPTH', '') or 256)
        if deadline_ms is None:
            deadline_ms = float(
                os.environ.get('MXNET_SERVE_DEADLINE_MS', '') or 0.0)
        self.default_deadline = (deadline_ms / 1e3) or None
        from ..sharding import current
        mesh = current()
        self._spmd = mesh is not None and mesh.n_devices > 1
        if self._spmd and start:
            raise ServeError(
                'under a mesh of more than one rank the server has no '
                'scheduler thread: every rank must admit and step in one '
                'order, so build it with start=False and call step_once() '
                'on every rank')
        if self._spmd and self.default_deadline:
            raise ServeError('under a mesh of more than one rank a request '
                             'has no deadline: each rank has its own clock')
        self._clock = clock
        self.name = name or f'decode:{type(net).__name__}'
        self._prefix_on = prefix_cache if prefix_cache is not None \
            else _pages.prefix_cache_enabled()
        #: prefill chunks dispatched per scheduler iteration — 1 keeps
        #: inter-token latency bounded by a single chunk (Sarathi)
        self.prefill_chunks_per_step = 1

        self._cv = _race.tracked_condition(threading.Condition(),
                                           'serve.queue')
        self._queue = deque()
        self._queue_state = _race.shared_state(
            f'{self.name}._queue', guard='serve.queue')
        self._slot_lock = _race.tracked(threading.Lock(), 'serve.slots')
        self._table = [None] * self.slots      # slot -> _Seq | None
        self._table_state = _race.shared_state(
            f'{self.name}._table', guard='serve.slots')
        self._draining = False
        self._closed = False

        self.metrics = ServingMetrics(self.name)
        self._metrics_name = _register(self.name, self.metrics)
        self._shard_ctx = self._shard(net, num_pages)
        if self._shard_ctx is None:
            self._alloc = PageAllocator(num_pages, self.page_size,
                                        name=self.name, metrics=self.metrics)
            self._allocs = [self._alloc]
            self._pool = net.init_paged_pool(num_pages, self.page_size)

        # the model calls: their static inputs, staged in one pinned host
        # buffer, and the graphs (step and prefill) captured over them;
        # ``serve.run`` serialises the calls with the audit and close
        self._run_lock = _race.tracked(threading.Lock(), 'serve.run')
        self._stage_inputs()
        self._graphs = {}
        self._returned = {}         # call -> the pool it returned
        self._captures = 0
        self._released = False
        if warmup:
            self.warmup_compiles = self._warmup()
            self.compile_baseline = self._captures
        else:
            self.warmup_compiles = 0
            self.compile_baseline = None

        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name=f'{self.name}-sched')
            self._thread.start()

    def _shard(self, net, num_pages):
        """Under a mesh of more than one rank: the net's ``tp`` shards, the
        ``dp`` groups' allocators and this rank's pool; returns the
        context (None unsharded)."""
        from ..sharding import current
        from ..sharding.rules import PartitionSpec as P, resolve_spec
        ctx = current()
        self._dp = (None, 1, 0)
        self._rows = (0, self.slots)
        self._owner = 0
        if ctx is None or ctx.n_devices == 1:
            return None
        ctx.place_params(net)
        dp = ctx.size('dp')
        if self.slots % dp:
            raise ServeError(f'{self.slots} slots do not split over '
                             f'dp = {dp}')
        cfg = net.cfg
        spec = resolve_spec(P('dp', None, 'tp', None),
                            (num_pages, self.page_size, cfg.num_kv_heads,
                             cfg.units // cfg.num_heads), ctx,
                            name='kv_pool')
        self.pool_spec = spec
        local = num_pages // dp if spec and spec[0] == 'dp' else num_pages
        allocs = [PageAllocator(local, self.page_size, name=self.name,
                                metrics=self.metrics) for _ in range(dp)]
        self._allocs = allocs
        self._alloc = _Allocators(allocs)
        self._pool = net.init_paged_pool(local, self.page_size)
        d = ctx.coord('dp')
        per = self.slots // dp
        self._dp = (ctx.group('dp') if dp > 1 else None, dp, d)
        self._rows = (d * per, (d + 1) * per)
        return ctx

    def _alloc_of(self, slot):
        """The page allocator of ``slot``'s ``dp`` group."""
        return self._allocs[slot // (self.slots // len(self._allocs))]

    # ------------------------------------------------------- model calls
    def _stage_inputs(self):
        """The calls' inputs, int32, each call's in one region of a host
        buffer (pinned on the card) and of its device twin, so that one
        non-blocking copy stages a call: the step's tokens and offsets
        ``(slots,)`` and block table ``(slots, max_pages)``; the chunk's
        tokens ``(1, prefill_chunk)``, offset ``()``, table row ``(1,
        max_pages)`` and ``last`` ``(1,)``. Each field starts on 64
        bytes."""
        n, c, mp = self.slots, self.prefill_chunk, self._max_pages
        layout = {'step': {'toks': (n,), 'offs': (n,), 'pages': (n, mp)},
                  'prefill': {'toks': (1, c), 'off': (), 'pages': (1, mp),
                              'last': (1,)}}
        cuda = self.device.type == 'cuda'
        self._host, self._dev, self._in = {}, {}, {}
        for call, fields in layout.items():
            spans, size = {}, 0
            for f, shape in fields.items():
                spans[f] = (size, shape)
                size += -(-math.prod(shape) // 16) * 16
            host = torch.zeros(size, dtype=torch.int32, pin_memory=cuda)
            dev = torch.zeros(size, dtype=torch.int32, device=self.device)
            self._host[call] = (host, {
                f: host[o:o + math.prod(s)].numpy().reshape(s)
                for f, (o, s) in spans.items()})
            self._dev[call] = dev
            self._in[call] = {f: dev[o:o + math.prod(s)].view(s)
                              for f, (o, s) in spans.items()}

    def _upload(self, call):
        host, _ = self._host[call]
        self._dev[call].copy_(host, non_blocking=True)

    @torch.no_grad()
    def _step_body(self):
        i = self._in['step']
        if self._shard_ctx is None:
            logits, pool = self.net(i['toks'][:, None], caches=self._pool,
                                    offset=i['offs'], pages=i['pages'])
            return self.net.pick(logits), pool
        lo, hi = self._rows
        logits, pool = self.net(i['toks'][lo:hi, None], caches=self._pool,
                                offset=i['offs'][lo:hi],
                                pages=i['pages'][lo:hi])
        nxt = self.net.pick(logits)
        if self._dp[0] is not None:
            from ..sharding import _collectives as C
            nxt = C.all_gather(nxt, self._dp[0], 0)
        return nxt, pool

    @torch.no_grad()
    def _prefill_body(self):
        i = self._in['prefill']
        if self._shard_ctx is None:
            logits, pool = self.net(i['toks'], caches=self._pool,
                                    offset=i['off'], pages=i['pages'])
            return self.net.pick(logits, i['last']), pool
        group, _, d = self._dp
        pool = self._pool
        nxt = torch.full((1,), -1, dtype=torch.long, device=self.device)
        if self._owner == d:
            logits, pool = self.net(i['toks'], caches=self._pool,
                                    offset=i['off'], pages=i['pages'])
            nxt = self.net.pick(logits, i['last'])
        if group is not None:
            from ..sharding import _collectives as C
            nxt = C.all_gather(nxt, group, 0)[self._owner:self._owner + 1]
        return nxt, pool

    def _capture(self, call):
        if self._released:
            raise ServerClosed(f'{self.name} released its graphs')
        body = self._step_body if call == 'step' else self._prefill_body
        g = self._graphs[call] = _graphs.StepGraph(body, self.device)
        g.capture()
        self._captures += 1
        return g

    def _call(self, call):
        """Run the step or the chunk over its staged inputs: its graph on
        the card (captured here if warm-up did not), its body on the CPU.
        Returns the picked tokens, on the device."""
        self._upload(call)
        if self.device.type != 'cuda' or self._shard_ctx is not None:
            nxt, pool = (self._step_body if call == 'step'
                         else self._prefill_body)()
        else:
            g = self._graphs.get(call) or self._capture(call)
            nxt, pool = g.replay()
        self._returned[call] = pool
        return nxt

    def _warmup(self):
        """Capture the prefill-chunk graph, then the step graph (on the CPU:
        run each body once), over all-zero block tables, which point every
        write at the garbage page, as the reference's warm-up does."""
        before = self._captures
        with self._run_lock:
            for call in ('prefill', 'step'):
                host, fields = self._host[call]
                host.zero_()
                if call == 'prefill':
                    fields['last'][0] = self.prefill_chunk - 1
                if self.device.type == 'cuda' and self._shard_ctx is None:
                    self._upload(call)
                    self._returned[call] = self._capture(call).outputs[1]
                else:
                    self._call(call)
        return self._captures - before

    def _run_prefill(self, toks, start, row, last, slot=0):
        """One prompt chunk ``(1, prefill_chunk)`` at absolute position
        ``start`` through block-table row ``row`` (of ``slot``); returns
        the greedy token at chunk index ``last`` (float32 argmax)."""
        with self._run_lock:
            self._owner = slot // (self.slots // self._dp[1])
            _, f = self._host['prefill']
            f['toks'][0] = toks
            f['off'][()] = start
            f['pages'][:] = row
            f['last'][0] = last
            return self._call('prefill').tolist()[0]

    def _run_step(self, toks, offs, bt):
        """One decode step over the whole slot pool; returns the greedy
        next token of every row."""
        with self._run_lock:
            _, f = self._host['step']
            f['toks'][:] = toks
            f['offs'][:] = offs
            f['pages'][:] = bt
            return self._call('step').tolist()

    # --------------------------------------------------------- admission
    def submit(self, prompt, max_new_tokens=32, deadline_ms=None):
        """Queue one prompt (1-D int sequence); returns a Future
        resolving to the list of generated token ids (greedy)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ServeError('empty prompt')
        if len(prompt) + max_new_tokens > self.max_length:
            raise ServeError(
                f'prompt {len(prompt)} + max_new {max_new_tokens} '
                f'exceeds the cache length {self.max_length}')
        # a request whose worst-case page need exceeds the whole pool
        # can never be admitted — shed now, not after queueing
        spans = chunk_spans(len(prompt), self.prefill_chunk)
        worst = max(spans[-1][0] + self.prefill_chunk,
                    len(prompt) + max_new_tokens)
        if self._alloc.pages_for(worst) > self._alloc.usable:
            self.metrics.on_shed()
            raise PagesExhausted(
                f'request needs {self._alloc.pages_for(worst)} KV pages '
                f'but the pool holds {self._alloc.usable} '
                f'(MXNET_SERVE_PAGES)')
        if deadline_ms is not None and self._spmd:
            raise ServeError('under a mesh of more than one rank a request '
                             'has no deadline: each rank has its own clock')
        now = self._clock()
        if deadline_ms is None:
            dl = now + self.default_deadline if self.default_deadline \
                else None
        else:
            dl = now + deadline_ms / 1e3
        req = _DecodeRequest(prompt, max_new_tokens, now, dl)
        with self._cv:
            if self._closed or self._draining:
                raise ServerClosed(f'{self.name} is not accepting work')
            if len(self._queue) >= self.queue_depth:
                self.metrics.on_shed()
                raise ServerOverloaded(
                    f'{self.name} queue at capacity '
                    f'({self.queue_depth}); request shed')
            self._queue_state.write()
            self._queue.append(req)
            self.metrics.on_submit()
            self._cv.notify()
        return req.future

    def generate_sync(self, prompt, max_new_tokens=32, deadline_ms=None,
                      timeout=None):
        return self.submit(prompt, max_new_tokens,
                           deadline_ms).result(timeout)

    # -------------------------------------------------------- slot table
    @_race.guarded_by('_slot_lock')
    def _free_slots(self):
        return [i for i, s in enumerate(self._table) if s is None]

    @_race.guarded_by('_slot_lock')
    def _set_slot(self, i, seq):
        self._table_state.write()
        self._table[i] = seq

    # -------------------------------------------------------- page plans
    def _plan_pages(self, req, alloc):
        """Prefix-cache probe + page allocation for a request's whole
        lifetime (padded prompt span and decode budget — admission is
        the gate, so decode can never die of page starvation).
        Returns (pages, chain_key, filled_tokens); raises
        :class:`PagesExhausted` on a transient shortage, with any
        prefix pins rolled back."""
        alen = len(req.prompt)
        c = self.prefill_chunk
        pages, ckey, filled, hits = [], _pages.EMPTY_KEY, 0, 0
        if self._prefix_on:
            # the final chunk always dispatches (its logits seed the
            # first generated token), so only chunks strictly before it
            # are reusable
            limit = (alen - 1) // c
            while filled // c < limit:
                chunk = tuple(req.prompt[filled:filled + c])
                key = _pages.chain_key(ckey, chunk)
                got = alloc.lookup(key)
                if got is None:
                    break
                pages.extend(got)
                ckey = key
                filled += c
                hits += 1
        n_left = -(-(alen - filled) // c)
        span_end = filled + n_left * c      # chunk padding writes too
        lifetime = max(span_end, alen + req.max_new)
        need = alloc.pages_for(lifetime) - len(pages)
        try:
            pages.extend(alloc.alloc(need))
        except PagesExhausted:
            alloc.release(pages)            # roll back the prefix pins
            raise
        self.metrics.on_prefix(hits, n_left)
        return pages, ckey, filled

    def _block_rows(self, seqs):
        """int32 block-table rows for ``seqs``, padded to the table
        width with the garbage page."""
        rows = np.full((len(seqs), self._max_pages), _pages.GARBAGE_PAGE,
                       np.int32)
        for i, s in enumerate(seqs):
            rows[i, :len(s.pages)] = s.pages
        return rows

    def _retire(self, seq, result=None, error=None):
        """Return a sequence's pages to the pool (prefix-cache pins
        survive), free its slot and resolve its future."""
        self._alloc_of(seq.slot).release(seq.pages)
        seq.pages = []
        with self._slot_lock:
            self._set_slot(seq.slot, None)
        if error is not None:
            self._fail(seq.request, error)
        else:
            if seq.request.future.set_running_or_notify_cancel():
                seq.request.future.set_result(result)
            self.metrics.on_complete(
                self._clock() - seq.request.submit_t)

    # ---------------------------------------------------------- prefill
    def _prefill_one(self, seq):
        """Run ONE chunk of ``seq``'s prompt; on the final chunk the
        sequence turns to decode with its first generated token. Returns
        1 (a chunk ran) or 0 (the sequence failed and was retired)."""
        req = seq.request
        c = self.prefill_chunk
        psz = self.page_size
        alen = len(req.prompt)
        start = seq.filled
        real = min(c, alen - start)
        is_final = start + real >= alen
        t0w = _trace.walltime() if req.tc is not None else 0.0
        try:
            _faults.on('prefill')
            toks = req.prompt[start:start + real] + [0] * (c - real)
            nxt = self._run_prefill(toks, start, self._block_rows([seq]),
                                    real - 1 if is_final else c - 1,
                                    seq.slot)
            self.metrics.on_prefill_chunk()
        except Exception as e:              # noqa: BLE001
            self.metrics.on_failed()
            self._retire(seq, error=e)
            return 0
        if req.tc is not None:
            _trace.emit('decode.prefill', t0w, _trace.walltime(),
                        parent=req.tc, server=self.name, start=start,
                        real=real, final=is_final)
        if self._prefix_on and real == c:
            # a full chunk is shareable: publish its pages under the
            # chain key of the entire prefix through this chunk
            key = _pages.chain_key(
                seq.ckey, tuple(req.prompt[start:start + c]))
            self._alloc_of(seq.slot).insert(
                key, seq.pages[start // psz:(start + c) // psz])
            seq.ckey = key
        seq.filled = start + real
        if is_final:
            now = self._clock()
            seq.offset = alen
            seq.tokens.append(nxt)
            seq.remaining -= 1
            seq.phase = 'decode'
            seq.last_t = now
            self.metrics.on_first_token(now - req.submit_t)
        return 1

    # --------------------------------------------------------- the loop
    def step_once(self):
        """One scheduler iteration: expire, admit into free slots, run
        at most ``prefill_chunks_per_step`` prompt chunks, then one
        decode step over the pool. Returns the number of sequences
        touched (admitted + prefilled + stepped + expired) — 0 means
        fully idle. Deterministic: tests call this directly."""
        now = self._clock()
        admitted, expired = [], []
        with self._cv:
            while self._queue and self._queue[0].deadline is not None \
                    and self._queue[0].deadline <= now:
                self._queue_state.write()
                expired.append(self._queue.popleft())
            with self._slot_lock:
                free = self._free_slots()
            while self._queue and free:
                req = self._queue[0]
                if req.deadline is not None and req.deadline <= now:
                    self._queue_state.write()
                    expired.append(self._queue.popleft())
                    continue
                try:
                    pages, ckey, filled = self._plan_pages(
                        req, self._alloc_of(free[0]))
                except PagesExhausted:
                    # transient shortage: the request stays queued
                    # (FIFO backpressure) until sequences retire and
                    # their pages come back
                    break
                self._queue_state.write()
                self._queue.popleft()
                slot = free.pop(0)
                seq = _Seq(req, slot)
                seq.pages, seq.ckey, seq.filled = pages, ckey, filled
                with self._slot_lock:
                    self._set_slot(slot, seq)
                admitted.append(seq)
                self.metrics.on_admit([now - req.submit_t])
        for seq in admitted:
            # queue-wait span: submission wall time -> admission
            req = seq.request
            if req.tc is not None:
                _trace.emit('decode.queue', req.wall_t,
                            _trace.walltime(), parent=req.tc,
                            server=self.name, slot=seq.slot)
        for req in expired:
            self.metrics.on_expired()
            self._fail(req, DeadlineExceeded(
                'deadline expired in queue; aborted before prefill'))
        # ---- locks released: device work below (scheduler thread only)
        with self._slot_lock:
            live = [s for s in self._table if s is not None]
        prefilling = sorted((s for s in live if s.phase == 'prefill'),
                            key=lambda s: s.request.submit_t)
        prefilled = 0
        for seq in prefilling[:self.prefill_chunks_per_step]:
            prefilled += self._prefill_one(seq)
        with self._slot_lock:
            live = [s for s in self._table if s is not None]
        decoding = [s for s in live if s.phase == 'decode']
        stepped = 0
        st = self._alloc.stats()
        self.metrics.on_pages(st['pages_in_use'], st['pages_usable'])
        if decoding:
            alive = [s for s in decoding if s.remaining > 0]
            if alive:
                stepped = len(alive)
                traced = [s for s in alive if s.request.tc is not None]
                t0w = _trace.walltime() if traced else 0.0
                try:
                    _faults.on('step')
                    toks = [0] * self.slots
                    offs = [0] * self.slots
                    # rows with no live decode (idle, mid-prefill or
                    # just-finished) keep all-garbage block tables and
                    # offset 0: the step's unconditional scatter for
                    # them lands in page 0, never in anyone's pages
                    bt = np.full((self.slots, self._max_pages),
                                 _pages.GARBAGE_PAGE, np.int32)
                    rows = self._block_rows(alive)
                    for i, s in enumerate(alive):
                        toks[s.slot] = s.tokens[-1]
                        offs[s.slot] = s.offset
                        bt[s.slot] = rows[i]
                    nxt = self._run_step(toks, offs, bt)
                except Exception as e:       # noqa: BLE001
                    for s in live:
                        self.metrics.on_failed()
                        self._retire(s, error=e)
                    return len(admitted) + prefilled + len(expired)
                now2 = self._clock()
                t1w = _trace.walltime() if traced else 0.0
                for s in traced:
                    # one span per traced sequence per decode step
                    _trace.emit('decode.step', t0w, t1w,
                                parent=s.request.tc, server=self.name,
                                slot=s.slot, token=nxt[s.slot])
                for s in alive:
                    s.tokens.append(nxt[s.slot])
                    s.offset += 1
                    s.remaining -= 1
                    self.metrics.on_token_gap(now2 - s.last_t)
                    s.last_t = now2
                self.metrics.on_step(stepped, self.slots)
            for s in decoding:
                if s.remaining <= 0:
                    self._retire(s, result=list(s.tokens))
        if self.compile_baseline is not None \
                and self._captures != self.compile_baseline:
            self.metrics.on_recompile(
                self._captures - self.compile_baseline)
            self.compile_baseline = self._captures
        return len(admitted) + prefilled + stepped + len(expired)

    @staticmethod
    def _fail(req, exc):
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)

    def _loop(self):
        while True:
            n = self.step_once()
            with self._cv:
                if self._closed:
                    return
                busy = self._queue or any(
                    s is not None for s in self._table)
                if self._draining and not busy:
                    self._closed = True
                    self._cv.notify_all()
                    return
                if n == 0 and not busy:
                    self._cv.wait(0.05)

    # ------------------------------------------------------------- close
    def _abort_residual_locked(self, why):
        """Fail everything still queued or live (caller holds ``_cv``).
        Shared by the no-drain teardown and the drain-deadline expiry."""
        while self._queue:
            self._queue_state.write()
            self._fail(self._queue.popleft(), ServerClosed(
                f'{self.name} {why}'))
        with self._slot_lock:
            live = [s for s in self._table if s is not None]
            for s in live:
                self._set_slot(s.slot, None)
        for s in live:      # page release outside serve.slots
            self._alloc_of(s.slot).release(s.pages)
            s.pages = []
            self._fail(s.request, ServerClosed(f'{self.name} {why}'))

    def close(self, drain=True, timeout=None):
        """Stop admission; drain live sequences or reject everything.

        The drain is *bounded*: after ``timeout`` seconds (default
        ``MXNET_SERVE_DRAIN_S``, 30) any residual queued or live
        request is failed with :class:`ServerClosed` instead of being
        leaked as a forever-pending future."""
        if timeout is None:
            timeout = _drain_deadline_s()
        with self._cv:
            if self._closed:
                return
            self._draining = True
            if not drain:
                self._abort_residual_locked('closed without drain')
                self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                # drain deadline exceeded: the scheduler is wedged.
                # Force-fail the residual work so every submitted future
                # resolves; the thread exits on its next iteration.
                with self._cv:
                    if not self._closed:
                        self._abort_residual_locked(
                            'drain deadline exceeded '
                            '(MXNET_SERVE_DRAIN_S)')
                        self._closed = True
                    self._cv.notify_all()
        else:
            deadline = time.monotonic() + timeout
            while drain and self.step_once():
                if time.monotonic() > deadline and not self._spmd:
                    break
            with self._cv:
                if not self._closed:
                    if drain:
                        self._abort_residual_locked(
                            'drain deadline exceeded '
                            '(MXNET_SERVE_DRAIN_S)')
                    self._closed = True
        if self._thread is None or not self._thread.is_alive():
            with self._run_lock:    # a wedged scheduler keeps them
                for g in self._graphs.values():
                    g.release()
                self._graphs.clear()
                self._returned.clear()
                self._released = True
        for a in self._allocs:
            a.detach()
        _unregister(self._metrics_name)

    @property
    def closed(self):
        with self._cv:
            return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)
        return False

    # --------------------------------------------------------- analysis
    def audit_donation(self):
        """Check that the pool is updated in place, the counterpart of
        the reference's audit of its donated pool. Every per-layer (k, v)
        pool tensor counts as donated; it is aliased when the step (its
        graph at capture, or its last eager call) returned that very
        storage, so that no copy of the pool lives beside it. On the card
        the captured step is then replayed 4 times over an
        all-garbage block table and ``allocations_per_step`` is the
        change of ``torch.cuda.memory_stats()['allocation.all.allocated']``
        a step, which must be 0 (``None`` on the CPU). Returns an
        ``AnalysisReport`` (``stats['donated_args']``,
        ``['aliased_args']``, ``['allocations_per_step']``) with an
        ``error`` finding for each failed check."""
        report = AnalysisReport(f'{self.name}.step')
        report.rules_run.extend(['donation', 'allocations'])
        pool = [t for kv in self._pool for t in kv]
        allocs = None
        with self._run_lock:
            returned = self._returned.get('step')
            if self.device.type == 'cuda' and 'step' in self._graphs:
                host, _ = self._host['step']
                host.zero_()
                torch.cuda.synchronize(self.device)
                stat = 'allocation.all.allocated'
                before = torch.cuda.memory_stats(self.device)[stat]
                for _ in range(4):
                    self._call('step').tolist()
                allocs = (torch.cuda.memory_stats(self.device)[stat]
                          - before) / 4
        if returned is None:
            aliased = 0
            report.add('donation', 'error', 'the step has not run yet: '
                       'build the server with warmup=True or serve first')
        else:
            got = [t for kv in returned for t in kv]
            aliased = sum(a.data_ptr() == b.data_ptr() and a.shape == b.shape
                          for a, b in zip(got, pool))
            if aliased != len(pool):
                report.add('donation', 'error',
                           f'{len(pool) - aliased} of {len(pool)} pool '
                           f'tensors are not the storage the step writes: '
                           f'the pool would be doubly resident')
        if allocs:
            report.add('allocations', 'error',
                       f'a replayed step allocates {allocs} times')
        report.stats.update(donated_args=len(pool), aliased_args=aliased,
                            allocations_per_step=allocs,
                            captures=self._captures)
        return report

    # ------------------------------------------------------------- stats
    def stats(self):
        out = self.metrics.snapshot()
        out['compile_count'] = self._captures
        with self._cv:
            out['queued'] = len(self._queue)
        with self._slot_lock:
            out['active_slots'] = sum(
                1 for s in self._table if s is not None)
        out['slots'] = self.slots
        out['max_length'] = self.max_length
        out['prefill_chunk'] = self.prefill_chunk
        out.update(self._alloc.stats())
        return out

    def __repr__(self):
        return (f'<DecodeServer {self.name!r} slots={self.slots} '
                f'max_length={self.max_length} '
                f'page_size={self.page_size} '
                f'pages={self._alloc.num_pages} '
                f'prefill_chunk={self.prefill_chunk}>')
