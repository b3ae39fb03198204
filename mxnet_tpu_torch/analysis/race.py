"""Dynamic Eraser-style race/deadlock checker for the host runtime.

Enabled by ``MXNET_RACE_CHECK=1`` (or :func:`enable` in tests). When off,
every entry point degrades to a no-op or identity so the hot paths pay a
single predicate check. When on:

* :func:`tracked` / :func:`tracked_condition` wrap the runtime's
  Lock/RLock/Condition objects. Each acquire updates the calling
  thread's held-lock stack, feeds a global lock-order graph (an edge
  ``A -> B`` for every first observation of acquiring ``B`` while
  holding ``A``), and is checked against the declared hierarchy in
  :mod:`mxnet_tpu_torch.analysis.locks`:

  - acquiring a level at or above a held level → ``lock-hierarchy``
    (deterministic: fires on the first occurrence of the inverted pair);
  - an edge that closes a cycle in the order graph → ``lock-order-cycle``
    (deterministic once both directions have been observed).

* :func:`shared_state` annotates a hot shared structure (``_Segment``,
  ``_AsyncServer._store``, the ``_CachedGraph`` compile cache). Its
  ``read()``/``write()`` hooks run the classic Eraser lockset state
  machine (Savage et al. 1997): Virgin → Exclusive(owner) → Shared →
  Shared-Modified, intersecting the candidate lockset with the locks
  held at each access; an empty lockset on a shared-modified object →
  ``lockset-violation``. A declared ``guard=`` makes the check
  deterministic: any ``write()`` without the guard held →
  ``guarded-by-violation`` on that exact access, no interleaving
  required.

* Happens-before edges (vector clocks, ThreadSanitizer-style) come from
  ``Thread.start``/``join`` (patched while enabled) and from explicit
  ownership handoffs — :func:`handoff_release` / :func:`handoff_acquire`
  bracket the bulk engine's cross-thread segment settle and any
  queue-style transfer. An access ordered after the previous owner's
  release is an ownership transfer, not a race: the object stays
  Exclusive under its new owner.

* :func:`guarded_by` decorates methods that must run under an
  instance's lock (e.g. ``_Segment.add``) — a deterministic assertion,
  active only while the checker is on.

Findings flow through the standard :class:`AnalysisReport` machinery
(``mx.analysis``) under the report name ``concurrency`` and surface in
``mx.profiler.dumps()``'s Concurrency section. ``assert_clean()`` is the
CI hook.
"""

import functools
import os
import sys
import threading
import weakref

from .report import AnalysisReport
from . import locks as _locks

__all__ = ['enabled', 'enable', 'disable', 'tracked', 'tracked_condition',
           'shared_state', 'guarded_by', 'handoff_release',
           'handoff_acquire', 'report', 'reset', 'assert_clean', 'stats',
           'TrackedLock', 'TrackedCondition', 'SharedState']

_ACTIVE = False
_CHECKER = None
_orig_start = None
_orig_join = None


def enabled():
    return _ACTIVE


def _caller():
    """file:line of the first frame outside this module (findings only —
    never on the hot path)."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return '<unknown>'
    return f'{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}'


class _ThreadState:
    __slots__ = ('tid', 'vc', 'held')

    def __init__(self, tid):
        self.tid = tid
        self.vc = {tid: 1}
        self.held = []          # TrackedLock stack, outermost first


class _Checker:
    """All cross-thread metadata lives behind ``_meta`` — the checker's
    own innermost lock (level ``race.internal``; never holds another
    lock while holding it)."""

    def __init__(self):
        self._meta = threading.Lock()
        self._tls = threading.local()
        self._next_tid = 1
        self._adj = {}                  # lock name -> set(successors)
        self._edges = set()             # observed (outer, inner) pairs
        self._hier_reported = set()
        self._cycle_reported = set()
        self._final_vc = weakref.WeakKeyDictionary()   # Thread -> vc
        self._channels = weakref.WeakKeyDictionary()   # handoff obj -> vc
        self.report = AnalysisReport(graph_name='concurrency')
        self.counts = {'acquires': 0, 'accesses': 0, 'handoffs': 0,
                       'threads': 0}

    # ------------------------------------------------------------ threads
    def thread_state(self):
        st = getattr(self._tls, 'st', None)
        if st is None:
            with self._meta:
                tid = self._next_tid
                self._next_tid += 1
                self.counts['threads'] += 1
            st = _ThreadState(tid)
            parent_vc = getattr(threading.current_thread(),
                                '_race_parent_vc', None)
            if parent_vc:
                for k, v in parent_vc.items():
                    if v > st.vc.get(k, 0):
                        st.vc[k] = v
            self._tls.st = st
        return st

    @staticmethod
    def _merge(dst_vc, src_vc):
        for k, v in src_vc.items():
            if v > dst_vc.get(k, 0):
                dst_vc[k] = v

    def tick(self, st):
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1

    def hb(self, st, epoch):
        """Did ``epoch`` (tid, clock) happen-before the current state?"""
        tid, clk = epoch
        return st.vc.get(tid, 0) >= clk

    def publish_exit(self, thread, st):
        with self._meta:
            self._final_vc[thread] = dict(st.vc)

    def absorb_join(self, thread):
        st = self.thread_state()
        with self._meta:
            fin = self._final_vc.pop(thread, None)
        if fin:
            self._merge(st.vc, fin)

    # ----------------------------------------------------------- findings
    def finding(self, rule, severity, message, **data):
        with self._meta:
            self.report.add(rule, severity, message, location=_caller(),
                            **data)

    # ---------------------------------------------------------- lock order
    def _path(self, src, dst):
        """Reachability src ->* dst in the order graph (call with _meta)."""
        seen, stack = set(), [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._adj.get(n, ()))
        return False

    def order_check(self, st, lock):
        """Called before acquiring ``lock`` with ``st.held`` non-empty."""
        for outer in st.held:
            a, b = outer.name, lock.name
            if a == b:
                # same-name (same-level) nesting: by convention ordered
                # by construction; not checkable at name granularity
                continue
            with self._meta:
                if (a, b) in self._edges:
                    continue
                la, lb = outer.level, lock.level
                if la is not None and lb is not None and lb <= la \
                        and (a, b) not in self._hier_reported:
                    self._hier_reported.add((a, b))
                    hier = ' < '.join(
                        n for n, _ in _locks.LOCK_HIERARCHY)
                    self._do_finding(
                        'lock-hierarchy', 'error',
                        f'acquired {b!r} (level {lb}) while holding '
                        f'{a!r} (level {la}); declared order: {hier}')
                if self._path(b, a):
                    key = frozenset((a, b))
                    if key not in self._cycle_reported:
                        self._cycle_reported.add(key)
                        self._do_finding(
                            'lock-order-cycle', 'error',
                            f'lock-order cycle: {a!r} -> {b!r} '
                            f'requested here, but {b!r} ->* {a!r} '
                            f'already observed — deadlock possible '
                            f'under the right interleaving')
                self._adj.setdefault(a, set()).add(b)
                self._edges.add((a, b))

    def _do_finding(self, rule, severity, message):
        # _meta already held
        self.report.add(rule, severity, message, location=_caller())


# ---------------------------------------------------------------- wrappers
class TrackedLock:
    """Lock/RLock proxy feeding the order graph and held-lock stack."""

    __slots__ = ('_inner', 'name', 'level', '_ck', '__weakref__')

    def __init__(self, inner, name, ck):
        self._inner = inner
        self.name = name
        self.level = _locks.level_of(name)
        self._ck = ck

    def acquire(self, blocking=True, timeout=-1):
        ck = self._ck
        st = ck.thread_state()
        reentrant = any(l is self for l in st.held)
        if not reentrant and st.held:
            ck.order_check(st, self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            st.held.append(self)
            # approximate under concurrency on purpose: taking _meta on
            # every acquire would serialize the very paths under test
            ck.counts['acquires'] += 1
        return ok

    def release(self):
        self._inner.release()
        st = self._ck.thread_state()
        for i in range(len(st.held) - 1, -1, -1):
            if st.held[i] is self:
                del st.held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        fn = getattr(self._inner, 'locked', None)
        return fn() if fn is not None else False

    def held_by_me(self):
        return any(l is self for l in self._ck.thread_state().held)

    def __repr__(self):
        return f'<TrackedLock {self.name!r} over {self._inner!r}>'


class TrackedCondition(TrackedLock):
    """Condition proxy: the underlying lock participates in order/held
    tracking; ``wait*`` drops it from the held stack for the duration
    (the condition releases its lock while waiting)."""

    def wait(self, timeout=None):
        st = self._ck.thread_state()
        self._pop_held(st)
        try:
            return self._inner.wait(timeout)
        finally:
            st.held.append(self)

    def wait_for(self, predicate, timeout=None):
        st = self._ck.thread_state()
        self._pop_held(st)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            st.held.append(self)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def _pop_held(self, st):
        for i in range(len(st.held) - 1, -1, -1):
            if st.held[i] is self:
                del st.held[i]
                return


class _NullState:
    """shared_state() result while the checker is off: free no-ops."""

    __slots__ = ()

    def read(self):
        return self

    def write(self):
        return self


_NULL = _NullState()


class SharedState:
    """Eraser lockset state machine for one shared object."""

    __slots__ = ('name', 'guard_name', '_ck', 'state', 'owner',
                 'lockset', 'last_write', '_reported', '__weakref__')

    def __init__(self, name, guard_name, ck):
        self.name = name
        self.guard_name = guard_name
        self._ck = ck
        self.state = 'virgin'
        self.owner = None
        self.lockset = None
        self.last_write = None      # (tid, clock) epoch
        self._reported = False

    def read(self):
        self._access(False)
        return self

    def write(self):
        self._access(True)
        return self

    def _access(self, is_write):
        ck = self._ck
        if ck is not _CHECKER:
            return                  # checker was reset/disabled
        st = ck.thread_state()
        held = {l.name for l in st.held}
        ck.counts['accesses'] += 1
        if is_write and self.guard_name is not None \
                and self.guard_name not in held:
            ck.finding(
                'guarded-by-violation', 'error',
                f'write to {self.name!r} without its declared guard '
                f'{self.guard_name!r} (held: {sorted(held) or "none"})',
                state=self.name)
        with ck._meta:
            if self.state == 'virgin':
                self.state = 'exclusive'
                self.owner = st.tid
            elif self.state == 'exclusive' and st.tid != self.owner:
                if self.last_write is not None \
                        and ck.hb(st, self.last_write):
                    # every prior write happened-before this access:
                    # clean ownership handoff, stays exclusive
                    self.owner = st.tid
                else:
                    self.state = 'shared-mod' if is_write else 'shared'
                    self.lockset = set(held)
            elif self.state in ('shared', 'shared-mod'):
                if is_write:
                    self.state = 'shared-mod'
                self.lockset &= held
                if not self.lockset and self.state == 'shared-mod' \
                        and not self._reported:
                    self._reported = True
                    self._ck._do_finding(
                        'lockset-violation', 'error',
                        f'{self.name!r} is written by multiple threads '
                        f'with no common lock (Eraser lockset is '
                        f'empty) and no happens-before ordering')
            if is_write:
                self.last_write = (st.tid, st.vc.get(st.tid, 0))


# ------------------------------------------------------------- public API
def tracked(lock, name):
    """Wrap a Lock/RLock for checking; identity when disabled."""
    if not _ACTIVE:
        return lock
    if isinstance(lock, TrackedLock):
        return lock
    return TrackedLock(lock, name, _CHECKER)


def tracked_condition(cond, name):
    """Wrap a Condition for checking; identity when disabled."""
    if not _ACTIVE:
        return cond
    if isinstance(cond, TrackedCondition):
        return cond
    return TrackedCondition(cond, name, _CHECKER)


def shared_state(name, guard=None):
    """Annotate a shared structure. Call ``.read()`` / ``.write()`` at
    access points. ``guard`` (a :class:`TrackedLock` or level name)
    declares the lock that must be held for writes."""
    if not _ACTIVE:
        return _NULL
    if isinstance(guard, TrackedLock):
        guard = guard.name
    elif guard is not None and not isinstance(guard, str):
        guard = None            # raw untracked lock: lockset-only mode
    return SharedState(name, guard, _CHECKER)


def guarded_by(lock_attr):
    """Method decorator: the instance attribute ``lock_attr`` must be
    held (if tracked) when the method runs. Free when disabled."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if _ACTIVE:
                lock = getattr(self, lock_attr, None)
                if isinstance(lock, TrackedLock) \
                        and not lock.held_by_me():
                    _CHECKER.finding(
                        'guarded-by-violation', 'error',
                        f'{type(self).__name__}.{fn.__name__}() called '
                        f'without holding self.{lock_attr} '
                        f'({lock.name!r})')
            return fn(self, *args, **kwargs)
        return wrapper
    return deco


def handoff_release(obj):
    """Publish the current thread's clock on ``obj`` — the release half
    of an ownership handoff (queue put, segment flush)."""
    ck = _CHECKER
    if not _ACTIVE or ck is None:
        return
    st = ck.thread_state()
    ck.tick(st)
    with ck._meta:
        ch = ck._channels.get(obj)
        if ch is None:
            ck._channels[obj] = dict(st.vc)
        else:
            ck._merge(ch, st.vc)
        ck.counts['handoffs'] += 1


def handoff_acquire(obj):
    """Merge ``obj``'s published clock into the current thread — the
    acquire half of an ownership handoff (queue get, settling a foreign
    segment's outputs)."""
    ck = _CHECKER
    if not _ACTIVE or ck is None:
        return
    st = ck.thread_state()
    with ck._meta:
        ch = ck._channels.get(obj)
        if ch is not None:
            ck._merge(st.vc, ch)


def report():
    """The live :class:`AnalysisReport` (name ``concurrency``)."""
    if _CHECKER is None:
        return AnalysisReport(graph_name='concurrency')
    return _CHECKER.report


def stats():
    if _CHECKER is None:
        return {}
    return dict(_CHECKER.counts)


def reset():
    """Drop findings and metadata, keep the checker enabled."""
    global _CHECKER
    if _ACTIVE:
        _CHECKER = _Checker()


def assert_clean():
    """Raise if the checker recorded any error finding (the CI hook)."""
    report().raise_if_errors()


def summary_line():
    c = stats()
    r = report()
    return (f'{len(r.errors)} error(s), {len(r.warnings)} warning(s) — '
            f'{c.get("acquires", 0)} acquires, '
            f'{c.get("accesses", 0)} annotated accesses, '
            f'{c.get("handoffs", 0)} handoffs, '
            f'{c.get("threads", 0)} threads')


# ------------------------------------------------------- enable / disable
def enable():
    """Turn the checker on (idempotent): installs Thread start/join
    patches for fork/join happens-before edges."""
    global _ACTIVE, _CHECKER, _orig_start, _orig_join
    if _ACTIVE:
        return
    _CHECKER = _Checker()
    _orig_start = threading.Thread.start
    _orig_join = threading.Thread.join

    def start(self):
        ck = _CHECKER
        if ck is not None:
            parent = ck.thread_state()
            ck.tick(parent)
            self._race_parent_vc = dict(parent.vc)
            orig_run = self.run

            def run():
                st = ck.thread_state()
                try:
                    orig_run()
                finally:
                    st2 = ck.thread_state()
                    ck.tick(st2)
                    ck.publish_exit(self, st2)

            self.run = run
        return _orig_start(self)

    def join(self, timeout=None):
        _orig_join(self, timeout)
        ck = _CHECKER
        if ck is not None and not self.is_alive():
            ck.absorb_join(self)

    threading.Thread.start = start
    threading.Thread.join = join
    _ACTIVE = True


def disable():
    """Turn the checker off and restore Thread patches. Structures
    wrapped while enabled keep their (now inert wrt findings) proxies."""
    global _ACTIVE, _CHECKER
    if not _ACTIVE:
        return
    threading.Thread.start = _orig_start
    threading.Thread.join = _orig_join
    _ACTIVE = False
    _CHECKER = None


if os.environ.get('MXNET_RACE_CHECK', '') == '1':
    enable()
