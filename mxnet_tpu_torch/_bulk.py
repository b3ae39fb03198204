"""Bulked (lazy) eager execution: the imperative engine's bulking.

Counterpart of ``mxnet_tpu/_bulk.py`` (reference engine.h:310
``StartBulk``/``StopBulk``, imperative_utils.h:636 bulked segments,
``MXNET_ENGINE_BULK_SIZE``): inside ``engine.bulk(n)`` consecutive ops
dispatched through ``ops.registry.invoke`` are recorded into a segment
instead of run, and each returns a lazy NDArray
(``ndarray._LazyNDArray``: its shape, dtype and context are known, its
``_data`` is a sync point). A flush runs the segment:

* a sync point (reading a lazy array's ``_data``: ``asnumpy``,
  ``backward``, an op that is not bulked), the segment-size cap, the exit
  of ``engine.bulk``, or an op of another thread's segment;
* the first flush of a segment shape (the trie path its ops walked, and
  which of its outputs are still alive) captures it as a CUDA graph on
  the card: a segment without gradient as a ``_graphs.StepGraph`` (its
  boundary inputs copied into static buffers, its live outputs cloned out
  of the graph's), a recorded one as a ``_graphs.GraphedCall``, one
  autograd node whose backward is a captured graph too (the role of the
  reference's ``_SegVjp``). Every later flush of that shape replays. On
  the CPU the same objects are ``_graphs.emulated()`` ones, which replay
  by running the ops again, with the same counters: ``stats()['compiles']``
  counts captures;
* outputs the segment's caller dropped before the flush are not kept.

The trie (op name, static-argument key, gradient activity, input wiring,
shapes and dtypes) caches each position's output shapes and dtypes, found
once by running the op on meta tensors. The guards are the reference's:
an op with a static argument that cannot key a cache (a tensor, a numpy
buffer) runs eagerly; a position whose op keeps arriving with new static
arguments (a Python scalar that changes every step) goes eager after
``_MAX_SIBLINGS`` keys, re-admitting every ``_RETRY``-th attempt up to
``_MAX_TOTAL``; an op that fails on meta tensors (a data-dependent shape,
a random draw) runs eagerly; deferred compute, an abstract evaluation, a
sharded call and ``engine.naive_engine()`` bypass bulking.

Autograd is torch's: a flushed output carries the graph its replay made,
edge for edge as eager ops would (an op recorded under ``pause()`` runs
without grad; a ``detach()`` is a sync point).

Threads: a segment belongs to the thread that records it, and any thread
may settle it (under the segment's lock). A record that finds its
segment flushed by another thread starts a fresh one, as in the
reference.
"""

import contextlib
import os
import threading
import weakref

import torch

from . import _dtypes, _graphs, _modes, _rng

__all__ = ['active', 'set_enabled', 'set_size', 'current_size', 'stats',
           'reset', 'force', 'flush_current', 'materialize', 'try_record',
           'cap_check']

_MAX_SIBLINGS = 16     # distinct static-argument keys per (position, op)
#                        before the position is treated as unstable
_RETRY = 13            # re-admit every Nth attempt while unstable
_MAX_TOTAL = 64        # hard cap on keys per (position, op)

#: ``MXNET_ENGINE_BULK=1`` turns bulking on by default; it is off
#: otherwise, on the card too, where ``chip_smoke.py``'s symbol phase (d)
#: measured a bulked segment's replay against eager dispatch (PERF.md:
#: it wins only on host-bound runs of small ops, and each new segment
#: shape costs a capture)
_ENV_ON = os.environ.get('MXNET_ENGINE_BULK') == '1'
if _ENV_ON:
    _modes.add(1)


class LazyRef:
    """A pending value: output ``key`` of a segment, computed at its
    flush."""

    __slots__ = ('seg', 'key', 'shape', 'dtype', 'device', 'requires_grad',
                 'value', '__weakref__')

    def __init__(self, seg, key, shape, dtype, device, requires_grad):
        self.seg = seg
        self.key = key              # (entry index, output index)
        self.shape = shape
        self.dtype = dtype          # a torch dtype
        self.device = device
        self.requires_grad = requires_grad
        self.value = None


class _Entry:
    __slots__ = ('fn', 'in_refs', 'grad', 'out_refs')

    def __init__(self, fn, in_refs, grad):
        self.fn = fn
        self.in_refs = in_refs      # (0, boundary index) | (1, entry, out)
        self.grad = grad
        self.out_refs = []          # weakrefs to LazyRefs


class _TrieNode:
    __slots__ = ('children', 'outs', 'multi', 'plans', 'op_counts',
                 'attempts')

    def __init__(self):
        self.children = {}
        self.outs = None            # [(shape, torch dtype)] of this entry
        self.multi = False
        self.plans = {}             # live output keys -> _Plan
        self.op_counts = {}
        self.attempts = {}


#: a trie position whose op failed on meta tensors: it runs eagerly
_EAGER = _TrieNode()


class _Plan:
    """A captured segment shape: a ``StepGraph`` and its static inputs, or
    a ``GraphedCall``."""

    __slots__ = ('graph', 'inputs', 'call', 'run')

    def __init__(self, run):
        self.run = run              # boundary tensors -> live outputs
        self.graph = self.inputs = self.call = None


def _narrow(t, grad):
    if not torch.is_tensor(t):
        return t
    if not grad and t.requires_grad:
        t = t.detach()
    to = _dtypes.NARROW.get(t.dtype)
    return t if to is None else t.to(to)


def _replayer(entries, keys):
    """``run(boundary) -> [live outputs]`` over the segment's ops, each
    under its own grad mode, narrowed as ``registry.apply_op`` narrows."""
    entries = tuple(entries)

    def run(boundary):
        env = []
        for e in entries:
            ins = [boundary[r[1]] if r[0] == 0 else env[r[1]][r[2]]
                   for r in e.in_refs]
            with torch.set_grad_enabled(e.grad):
                outs = e.fn(*ins)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            env.append([_narrow(o, e.grad) for o in outs])
        return [env[ei][oi] for ei, oi in keys]

    return run


class _Segment:
    def __init__(self, state):
        self.state = state
        self.lock = threading.RLock()
        self.boundary = []          # tensors, by first use
        self.boundary_ids = {}      # id(tensor) -> index
        self.entries = []
        self.trie_pos = state.trie
        self.device = None
        self.grad = False
        self.flushed = False

    # ------------------------------------------------------------ recording
    def add(self, op, arrays, fn, bulk_key, grad_active):
        """Append one op: its output LazyRefs and whether it has several,
        or None (the caller dispatches it eagerly)."""
        in_refs, descr, specs = [], [], []
        new_ids, new_raws = {}, []      # boundary inputs this op adds
        dev = self.device
        for nd in arrays:
            ref = nd._lazy
            if ref is not None and ref.seg is self and ref.value is None:
                ei, oi = ref.key
                in_refs.append((1, ei, oi))
                descr.append((1, ei, oi))
                specs.append((ref.shape, ref.dtype))
                where = ref.device
            else:
                raw = nd._data
                bidx = self.boundary_ids.get(id(raw), new_ids.get(id(raw)))
                if bidx is None:
                    bidx = new_ids[id(raw)] = len(self.boundary) + len(
                        new_raws)
                    new_raws.append(raw)
                in_refs.append((0, bidx))
                descr.append((0, bidx, raw.requires_grad, raw.dtype,
                              tuple(raw.shape)))
                specs.append((tuple(raw.shape), raw.dtype))
                where = raw.device
            if dev is None:
                dev = where
            elif where != dev:
                return None         # one segment, one device
        key = (op.name, bulk_key, grad_active, tuple(descr))
        node = self.trie_pos
        child = node.children.get(key)
        if child is _EAGER:
            return None
        if child is None:
            cnt = node.op_counts.get(op.name, 0)
            if cnt >= _MAX_SIBLINGS:
                a = node.attempts.get(op.name, 0) + 1
                node.attempts[op.name] = a
                if cnt >= _MAX_TOTAL or a % _RETRY:
                    return None
            node.op_counts[op.name] = cnt + 1
            outs = _meta_outputs(fn, specs)
            if outs is None:
                node.children[key] = _EAGER
                return None
            child = _TrieNode()
            child.multi, child.outs = outs
            node.children[key] = child
            self.state.misses += 1
        else:
            self.state.hits += 1
        self.boundary_ids.update(new_ids)
        self.boundary.extend(new_raws)
        self.device = dev
        ei = len(self.entries)
        entry = _Entry(fn, tuple(in_refs), grad_active)
        self.entries.append(entry)
        self.trie_pos = child
        self.grad = self.grad or grad_active
        refs = []
        for oi, (shape, dtype) in enumerate(child.outs):
            ref = LazyRef(self, (ei, oi), shape, dtype, self.device,
                          grad_active and (dtype.is_floating_point
                                           or dtype.is_complex))
            entry.out_refs.append(weakref.ref(ref))
            refs.append(ref)
        return refs, child.multi

    # ------------------------------------------------------------- flushing
    def flush(self):
        with self.lock:
            if self.flushed:
                return
            self.flushed = True
            if not self.entries:
                return
            st = self.state
            st.flushes += 1
            keys, refs = [], []
            for ei, e in enumerate(self.entries):
                for oi, w in enumerate(e.out_refs):
                    ref = w()
                    if ref is not None:
                        keys.append((ei, oi))
                        refs.append(ref)
            if refs:
                outs = self._run(tuple(keys))
                for ref, out in zip(refs, outs):
                    ref.value = out
                    ref.seg = None
            self.entries = []
            self.boundary = []
            self.boundary_ids = {}

    def _run(self, keys):
        """The live outputs: the plan of this segment shape captured at its
        first flush, replayed at the next ones."""
        plan = self.trie_pos.plans.get(keys)
        dev = self.device
        emulate = dev.type != 'cuda'
        if plan is None:
            plan = _Plan(_replayer(self.entries, keys))
            with (_graphs.emulated() if emulate
                  else contextlib.nullcontext()):
                outs = self._capture(plan, dev)
            self.trie_pos.plans[keys] = plan
            self.state.compiles += 1
            return outs
        if plan.call is not None:
            if plan.call.busy():
                # the last replay still waits for its backward
                return plan.run(self.boundary)
            return list(plan.call(self.boundary))
        with torch.no_grad():
            for buf, x in zip(plan.inputs, self.boundary):
                buf.copy_(x)
        return [o.clone() for o in plan.graph.replay()]

    def _capture(self, plan, dev):
        gens = _rng.graph_generators(dev)
        if self.grad:
            plan.call = _graphs.GraphedCall(
                lambda tensors, values: plan.run(tensors), [], dev, gens)
            return list(plan.call.first_call(self.boundary))
        plan.inputs = [x.detach().clone() for x in self.boundary]
        plan.graph = _graphs.step_graph(lambda: plan.run(plan.inputs), dev,
                                        gens)
        plan.graph.capture(keep_warmup=True)
        warm, plan.graph.warmup_outputs = plan.graph.warmup_outputs, None
        if dev.type == 'cuda':
            cur = torch.cuda.current_stream(dev)
            for t in warm:
                t.record_stream(cur)
        return warm


def _meta_outputs(fn, specs):
    """``(multi, [(shape, dtype)])`` of ``fn`` on meta tensors of
    ``specs``, or None where it does not run there."""
    from . import _deferred_compute as _dc
    metas = [torch.empty(shape, dtype=dtype, device='meta')
             for shape, dtype in specs]
    try:
        with _dc.abstract(), torch.no_grad():
            out = fn(*metas)
    except Exception:
        return None
    multi = isinstance(out, (tuple, list))
    outs = list(out) if multi else [out]
    if not all(torch.is_tensor(o) for o in outs):
        return None
    return multi, [(tuple(o.shape), _dtypes.NARROW.get(o.dtype, o.dtype))
                   for o in outs]


# ------------------------------------------------------------------- state
class _State(threading.local):
    def __init__(self):
        self.segment = None
        self.trie = _TrieNode()
        self.size_override = None
        self.force_depth = 0
        self.disabled_depth = 0
        self.hits = 0
        self.misses = 0
        self.flushes = 0
        self.compiles = 0


_st = _State()
#: the process-wide switch and segment-size cap (``engine.set_bulk_size``);
#: ``force`` scopes override them in their thread
_enabled = None                 # None: MXNET_ENGINE_BULK's default
_size = int(os.environ.get('MXNET_ENGINE_BULK_SIZE', 4096))


def active():
    """True when an op dispatched in this thread now is bulked."""
    st = _st
    if st.disabled_depth:
        return False
    if st.force_depth:
        return True
    if _enabled is not None:
        return _enabled
    return _ENV_ON


def set_enabled(flag):
    """The process-wide switch (flushes this thread's segment)."""
    global _enabled
    flush_current()
    was = bool(_enabled) or (_enabled is None and _ENV_ON)
    _enabled = flag
    now = bool(flag) or (flag is None and _ENV_ON)
    _modes.add(int(now) - int(was))


def set_size(n):
    """The process-wide segment-size cap."""
    global _size
    _size = n


def current_size():
    return _st.size_override if _st.size_override is not None else _size


def stats():
    """This thread's counters: trie ``hits`` and ``misses``, ``flushes``
    and ``compiles`` (segment shapes captured)."""
    return {'hits': _st.hits, 'misses': _st.misses,
            'flushes': _st.flushes, 'compiles': _st.compiles}


def reset():
    """Drop this thread's trie and captured segments (flushes first)."""
    flush_current()
    _st.trie = _TrieNode()


class force:
    """Bulking on (``engine.bulk``, with a size cap) or off
    (``engine.naive_engine``) in this thread for a scope."""

    def __init__(self, on, size=None):
        self.on = on
        self.size = size
        self.prev_override = None

    def __enter__(self):
        if self.on:
            _st.force_depth += 1
            _modes.add(1)
            if self.size:
                self.prev_override = _st.size_override
                _st.size_override = self.size
        else:
            flush_current()
            _st.disabled_depth += 1
        return self

    def __exit__(self, *exc):
        if self.on:
            _st.force_depth -= 1
            _modes.add(-1)
            if self.size:
                _st.size_override = self.prev_override
            flush_current()
        else:
            _st.disabled_depth -= 1
        return False


def _current():
    seg = _st.segment
    if seg is not None and seg.flushed:
        _st.segment = None
        seg = None
    return seg


def flush_current():
    seg = _current()
    if seg is not None:
        seg.flush()
        _st.segment = None


def materialize(ref):
    """The value of ``ref``, flushing its segment (whichever thread
    recorded it) when it is pending."""
    seg = ref.seg
    if ref.value is None and seg is not None:
        seg.flush()
    return ref.value


# ------------------------------------------------------------ dispatch hook
def try_record(op, arrays, fn, bulk_key, grad_active):
    """Offer an op to the engine: ``(refs, multi)``, its outputs' LazyRefs,
    or None (the caller dispatches it eagerly)."""
    for nd in arrays:
        ref = nd._lazy
        if ref is not None and ref.value is None and ref.seg is not None \
                and ref.seg is not _st.segment:
            # a value of another thread's segment: settle it first
            ref.seg.flush()
    while True:
        seg = _current()
        if seg is None:
            seg = _Segment(_st)
            _st.segment = seg
        with seg.lock:
            if seg.flushed:
                # another thread flushed it since: record into a new one
                _st.segment = None
                continue
            return seg.add(op, arrays, fn, bulk_key, grad_active)


def cap_check():
    """Flush when this thread's segment reached the size cap."""
    seg = _current()
    if seg is not None and len(seg.entries) >= current_size():
        seg.flush()
        _st.segment = None

