"""Lock-discipline registry + static AST lint for the threaded host runtime.

The framework's host side is deliberately thin on locks (XLA owns device
scheduling), but the locks it does have guard hot paths: per-thread bulk
segments with cross-thread settle (``_bulk.py``), the ``_CachedGraph``
trace/compile lock racing lock-free inference (``gluon/block.py``), and the
dist_async parameter-server store/barrier (``kvstore/dist_async.py``).
This module is the single source of truth for the *intended* discipline:

* :data:`LOCK_HIERARCHY` — the declared lock ordering, outermost first.
  A thread holding a lock may only acquire locks at strictly later
  (inner) levels. Acquiring an earlier level while holding a later one
  is a lock-order inversion (potential deadlock).
* :data:`LOCK_SITES` — maps (module glob, attribute/name) to a level, so
  both the static lint below and the dynamic checker
  (:mod:`mxnet_tpu_torch.analysis.race`) resolve a lock expression to a level.

The static lint (Eraser's static cousin) walks ``mxnet_tpu_torch/**`` ASTs and
flags:

* ``lock-order-inversion`` — nested ``with`` acquiring a level ≤ the
  outermost held level (error).
* ``blocking-call-under-lock`` — socket send/recv, ``Condition.wait``
  / ``Event.wait`` / ``Thread.join`` without a timeout, ``Barrier.wait``,
  ``time.sleep``, or a device sync (``wait_to_read`` / ``asnumpy`` /
  ``block_until_ready``) lexically inside a ``with <lock>`` body
  (warning). Levels in :data:`ALLOW_BLOCKING` are exempt — e.g. the
  per-socket RPC lock exists precisely to serialize socket I/O.
* ``unguarded-shared-state`` — a module-level mutable container mutated
  outside any lock when either (a) the same name is mutated under a lock
  elsewhere in the module (inconsistent locking), or (b) the module
  spawns threads (warning).
* ``thread-local-escape`` — a value read off a ``threading.local``
  captured by a nested function or handed to ``threading.Thread``; the
  value is only meaningful on the thread that read it (warning).

Suppressions are per-line comments and MUST carry a justification::

    risky_call()   # lock-lint: disable=<rule> -- why this is safe

A ``disable=`` comment without a ``--`` justification is itself an error
(``bad-suppression``). ``MXNET_LOCK_LINT_STRICT=1`` (or ``--strict``)
promotes warnings to errors for CI.

This module is import-light on purpose (stdlib only, no jax, no package
imports) so ``tools/lock_lint.py`` can load it standalone by path.
"""

import ast
import fnmatch
import os


# --------------------------------------------------------------- registry
# Declared lock ordering, OUTERMOST level first. ``A`` before ``B`` means
# a thread holding an ``A``-level lock may acquire a ``B``-level lock,
# never the reverse. See docs/threading.md for the prose contract.
LOCK_HIERARCHY = (
    ('serve.router', 'Router._lock: the routing/health table, request '
                     'seq and counters; outermost of the serving tier '
                     'and NEVER held across an RPC — selection snapshots '
                     'under it, network I/O happens outside '
                     '(serve/router.py)'),
    ('serve.replica', 'Replica._lock + its RPC endpoint transport lock: '
                      'current-version pointer, swap flag, dedup window; '
                      'released before any DecodeServer call, so it sits '
                      'above the queue lock '
                      '(serve/replica.py)'),
    ('serve.queue', 'DynamicBatcher._cv / DecodeServer._cv (Condition): '
                    'the bounded admission queue, batching window and '
                    'drain/close flags; outermost — the scheduler thread '
                    'releases it before any model dispatch '
                    '(serve/batcher.py, serve/decode.py)'),
    ('serve.pages', 'PageAllocator._lock: the paged-KV free list, page '
                    'refcounts and prefix cache; taken inside the queue '
                    'lock while admitting and NEVER while holding the '
                    'slot lock — page release on retire happens after '
                    'the slot is freed (serve/pages.py)'),
    ('serve.slots', 'DecodeServer._slot_lock: the KV-cache slot pool '
                    'table and per-slot sequence state; taken after the '
                    'queue lock when admitting, never across a compiled '
                    'step (serve/decode.py)'),
    ('train.ckpt', '_CheckpointDaemon._cv (Condition): the pending-'
                   'snapshot slot, busy flag and stop flag of the async '
                   'checkpoint thread; the daemon releases it before the '
                   'orbax serialize, so a slow save never blocks the '
                   'step loop handing off the next snapshot '
                   '(train/elastic.py)'),
    ('bulk.segment', '_Segment.lock (RLock): per-thread bulked-eager '
                     'segment; foreign threads take it only to settle '
                     '(_bulk.py)'),
    ('block.graph', '_CachedGraph._lock (RLock): serializes tracing, '
                    'recorded calls and aux rebinds; also TapeNode.'
                    'vjp_lock (gluon/block.py, _tape.py)'),
    ('kvstore.sock', 'per-socket RPC lock: one in-flight RPC per server '
                     'connection, heartbeat vs caller '
                     '(kvstore/dist_async.py)'),
    ('kvstore.store', '_AsyncServer._lock: the k/v store, dedup window, '
                      'heartbeat table (kvstore/dist_async.py)'),
    ('kvstore.barrier', '_AsyncServer._barrier_cv: barrier arrivals and '
                        'generation counter (kvstore/dist_async.py)'),
    ('misc.leaf', 'leaf locks (stats/seq/registry/compile-once): nothing '
                  'may be acquired while holding one'),
    ('telemetry.buffer', 'the flight recorder ring + clock-offset table '
                         '(telemetry/trace.py): spans may be recorded '
                         'while holding ANY runtime lock, so it sits '
                         'below them all; nothing is acquired under it'),
    ('telemetry.metrics', 'metrics registry + instrument values '
                          '(telemetry/metrics.py): counter/histogram '
                          'updates nest under any runtime lock; '
                          'collector callables run OUTSIDE it (they '
                          'take their owners\' locks at scrape time)'),
    ('race.internal', 'the dynamic race checker\'s own metadata lock; '
                      'innermost by construction (analysis/race.py)'),
)

LOCK_LEVELS = {name: i for i, (name, _) in enumerate(LOCK_HIERARCHY)}

# (module glob, with-expression key) -> hierarchy level. The "key" of a
# lock expression is its rightmost attribute/name: ``self._lock`` ->
# ``_lock``, ``seg.lock`` -> ``lock``, ``self._sock_locks[sid]`` ->
# ``_sock_locks``.
LOCK_SITES = {
    '*/_bulk.py': {'lock': 'bulk.segment'},
    '*/gluon/block.py': {'_lock': 'block.graph'},
    '*/_tape.py': {'vjp_lock': 'block.graph'},
    '*/kvstore/dist_async.py': {
        '_sock_locks': 'kvstore.sock',
        '_lock': 'kvstore.store',
        '_barrier_cv': 'kvstore.barrier',
        '_elastic_cv': 'kvstore.barrier',
        '_seq_lock': 'misc.leaf',
        '_SERVERS_LOCK': 'misc.leaf',
    },
    '*/train/elastic.py': {
        '_cv': 'train.ckpt',
        '_stats_lock': 'misc.leaf',
    },
    '*/kvstore/rpc.py': {
        '_sock_lock': 'kvstore.sock',
        '_lock': 'kvstore.store',
        '_conns_lock': 'misc.leaf',
    },
    '*/kvstore/faults.py': {'_lock': 'misc.leaf'},
    '*/serve/batcher.py': {'_cv': 'serve.queue'},
    '*/serve/decode.py': {'_cv': 'serve.queue', '_slot_lock': 'serve.slots'},
    '*/serve/pages.py': {'_lock': 'serve.pages'},
    '*/serve/metrics.py': {'_lock': 'misc.leaf'},
    '*/serve/faults.py': {'_lock': 'misc.leaf'},
    '*/serve/router.py': {'_lock': 'serve.router'},
    '*/serve/replica.py': {'_lock': 'serve.replica'},
    '*/profiler.py': {'_stats_lock': 'misc.leaf'},
    '*/symbol/symbol.py': {'_name_lock': 'misc.leaf'},
    '*/operator.py': {'_lock': 'misc.leaf'},
    '*/_native/__init__.py': {
        '_lock': 'misc.leaf',
        '_ip_lock': 'misc.leaf',
        '_tp_lock': 'misc.leaf',
    },
    '*/analysis/race.py': {'_meta': 'race.internal'},
    '*/telemetry/trace.py': {'_lock': 'telemetry.buffer'},
    '*/telemetry/metrics.py': {'_LOCK': 'telemetry.metrics'},
}

# Levels whose entire purpose is serializing blocking work: the
# blocking-call rule does not fire while ONLY these are held.
ALLOW_BLOCKING = frozenset({'kvstore.sock'})


def level_of(name):
    """Hierarchy index of a level name, or None if unregistered."""
    return LOCK_LEVELS.get(name)


def site_level(path, key):
    """Resolve a lock key in a module path to its declared level name."""
    norm = path.replace(os.sep, '/')
    for glob, table in LOCK_SITES.items():
        if fnmatch.fnmatch(norm, glob) and key in table:
            return table[key]
    return None


# ------------------------------------------------------------- lint model
RULES = ('lock-order-inversion', 'blocking-call-under-lock',
         'unguarded-shared-state', 'thread-local-escape', 'bad-suppression')

_SOCKET_ATTRS = frozenset({'sendall', 'recv', 'recv_into', 'connect',
                           'accept'})
_SOCKET_HELPERS = frozenset({'_send_msg', '_recv_msg'})
_SYNC_ATTRS = frozenset({'wait_to_read', 'asnumpy', 'block_until_ready'})
_MUTATING_METHODS = frozenset({'append', 'extend', 'insert', 'add',
                               'update', 'clear', 'pop', 'popitem',
                               'remove', 'discard', 'setdefault'})


class LintFinding:
    __slots__ = ('rule', 'severity', 'path', 'line', 'message')

    def __init__(self, rule, severity, path, line, message):
        self.rule = rule
        self.severity = severity
        self.path = path
        self.line = line
        self.message = message

    def __repr__(self):
        return (f'{self.path}:{self.line}: [{self.severity}] '
                f'{self.rule}: {self.message}')


def _expr_key(node):
    """Rightmost attribute/name of a lock expression, or None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _lockish(key):
    if key is None:
        return False
    low = key.lower()
    return 'lock' in low or 'mutex' in low or low.endswith('_cv')


def _call_name(func):
    """Dotted name of a call target: ``threading.Lock`` -> that string."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
        return '.'.join(reversed(parts))
    return None


def _is_lock_ctor(value):
    name = _call_name(value.func) if isinstance(value, ast.Call) else None
    if name is None:
        return False
    last = name.split('.')[-1]
    return last in ('Lock', 'RLock', 'Condition')


def _no_timeout(call, min_pos):
    """True if a wait/join call has no timeout (kwarg or positional)."""
    if len(call.args) >= min_pos:
        return False
    return not any(kw.arg == 'timeout' for kw in call.keywords)


class _Suppressions:
    """Per-line ``# lock-lint: disable=rule[,rule] -- why`` comments."""

    # split so the scanner never matches its own marker definition
    MARK = 'lock-lint: ' + 'disable='

    def __init__(self, lines, path):
        self.by_line = {}
        self.bad = []
        for i, text in enumerate(lines, start=1):
            pos = text.find(self.MARK)
            if pos < 0:
                continue
            rest = text[pos + len(self.MARK):]
            if '--' in rest:
                rules_part, _, why = rest.partition('--')
                why = why.strip()
            else:
                rules_part, why = rest, ''
            rules = {r.strip() for r in rules_part.split(',') if r.strip()}
            if not why:
                self.bad.append(LintFinding(
                    'bad-suppression', 'error', path, i,
                    'suppression without a "-- <justification>" clause'))
                continue
            self.by_line[i] = rules

    def covers(self, line, rule):
        for cand in (line, line - 1):
            rules = self.by_line.get(cand)
            if rules and (rule in rules or 'all' in rules):
                return True
        return False


class _ModuleFacts(ast.NodeVisitor):
    """First pass: module-level locks, containers, threading.locals,
    thread spawning, and local-subclass names."""

    def __init__(self):
        self.containers = {}      # name -> lineno of module-level def
        self.locals_ = set()      # names bound to threading.local()s
        self.local_classes = set()
        self.spawns_threads = False

    def scan(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for base in node.bases:
                    name = _call_name(base) if isinstance(base, ast.Call) \
                        else _expr_key(base)
                    if name and name.split('.')[-1] == 'local':
                        self.local_classes.add(node.name)
            elif isinstance(node, ast.Call):
                cname = _call_name(node.func)
                if cname and cname.split('.')[-1] == 'Thread':
                    self.spawns_threads = True
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name, val = node.targets[0].id, node.value
                if isinstance(val, (ast.Dict, ast.List, ast.Set,
                                    ast.DictComp, ast.ListComp,
                                    ast.SetComp)):
                    self.containers[name] = node.lineno
                elif isinstance(val, ast.Call):
                    cname = _call_name(val.func) or ''
                    short = cname.split('.')[-1]
                    if short in ('dict', 'list', 'set', 'defaultdict',
                                 'OrderedDict', 'deque'):
                        self.containers[name] = node.lineno
                    elif short == 'local' or short in self.local_classes:
                        self.locals_.add(name)


class _FileLinter:
    def __init__(self, path, tree, lines):
        self.path = path
        self.tree = tree
        self.sup = _Suppressions(lines, path)
        self.facts = _ModuleFacts()
        self.facts.scan(tree)
        self.findings = list(self.sup.bad)
        # container name -> [mutations under lock, mutations outside]
        self.mutations = {n: [[], []] for n in self.facts.containers}

    def add(self, rule, severity, line, message):
        if not self.sup.covers(line, rule):
            self.findings.append(
                LintFinding(rule, severity, self.path, line, message))

    # ------------------------------------------------------------- walk
    def run(self):
        self._walk_body(self.tree.body, held=[])
        self._finish_shared_state()
        return self.findings

    def _resolve(self, key):
        """(level_name, level_index, allow_blocking) for a lock key."""
        level = site_level(self.path, key)
        if level is None and _lockish(key):
            return (None, None, False)   # unregistered but lock-like
        if level is None:
            return None
        return (level, level_of(level), level in ALLOW_BLOCKING)

    def _walk_body(self, body, held):
        for node in body:
            self._walk_stmt(node, held)

    def _walk_stmt(self, node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def's body runs later, not under the current locks
            self._check_tl_escape(node)
            self._walk_body(node.body, held=[])
            return
        if isinstance(node, ast.ClassDef):
            self._walk_body(node.body, held=[])
            return
        if isinstance(node, ast.With):
            pushed = 0
            for item in node.items:
                key = _expr_key(item.context_expr)
                res = self._resolve(key) if key else None
                if res is None and not _lockish(key):
                    continue
                if res is None:
                    res = (None, None, False)
                self._check_order(held, key, res, node.lineno)
                held.append((key, res))
                pushed += 1
            self._walk_body(node.body, held)
            del held[len(held) - pushed:len(held)]
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.With)):
                self._walk_stmt(child, held)
            elif isinstance(child, (ast.stmt, ast.excepthandler)):
                self._walk_stmt(child, held)
            else:
                self._scan_expr(child, held)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete,
                             ast.Expr)):
            self._check_shared_mutation(node, held)

    def _scan_expr(self, node, held):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._check_blocking(sub, held)
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_tl_escape(sub)

    # ------------------------------------------------------------ rules
    def _check_order(self, held, key, res, line):
        level, idx, _allow = res
        if idx is None:
            return
        for outer_key, (outer_level, outer_idx, _a) in held:
            if outer_key == key:
                return              # re-entrant same lock: not an order
            if outer_idx is None:
                continue
            if idx <= outer_idx:
                self.add(
                    'lock-order-inversion', 'error', line,
                    f'acquiring {level!r} (level {idx}) while holding '
                    f'{outer_level!r} (level {outer_idx}); declared '
                    f'order is outermost-first in '
                    f'analysis/locks.py:LOCK_HIERARCHY')

    def _blocking_locks(self, held):
        """Held locks that forbid blocking (i.e. not ALLOW_BLOCKING)."""
        return [k for k, (lvl, _i, allow) in held if not allow]

    def _check_blocking(self, call, held):
        strict_holders = self._blocking_locks(held)
        if not strict_holders:
            return
        func = call.func
        line = call.lineno
        holders = ', '.join(repr(h) for h in strict_holders)
        if isinstance(func, ast.Attribute):
            attr = func.attr
            if attr in _SOCKET_ATTRS:
                self.add('blocking-call-under-lock', 'warning', line,
                         f'socket .{attr}() while holding {holders}')
            elif attr in _SYNC_ATTRS:
                self.add('blocking-call-under-lock', 'warning', line,
                         f'device sync .{attr}() while holding {holders}'
                         f' — the flush may itself need the lock')
            elif attr == 'sleep' and _expr_key(func.value) in (
                    'time', '_time'):
                self.add('blocking-call-under-lock', 'warning', line,
                         f'time.sleep() while holding {holders}')
            elif attr == 'wait' and _no_timeout(call, 1):
                self.add('blocking-call-under-lock', 'warning', line,
                         f'.wait() without timeout while holding '
                         f'{holders}')
            elif attr == 'wait_for' and _no_timeout(call, 2):
                self.add('blocking-call-under-lock', 'warning', line,
                         f'.wait_for() without timeout while holding '
                         f'{holders}')
            elif attr == 'join' and _no_timeout(call, 1) \
                    and not call.args:
                self.add('blocking-call-under-lock', 'warning', line,
                         f'.join() without timeout while holding '
                         f'{holders}')
        elif isinstance(func, ast.Name):
            if func.id in _SOCKET_HELPERS:
                self.add('blocking-call-under-lock', 'warning', line,
                         f'socket helper {func.id}() while holding '
                         f'{holders}')
            elif func.id == 'sleep':
                self.add('blocking-call-under-lock', 'warning', line,
                         f'sleep() while holding {holders}')

    def _check_shared_mutation(self, node, held):
        target = None
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            func = node.value.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in _MUTATING_METHODS \
                    and isinstance(func.value, ast.Name):
                target = func.value.id
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name):
                    target = t.value.id
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name):
                    target = t.value.id
        if target in self.mutations:
            bucket = 0 if held else 1
            self.mutations[target][bucket].append(node.lineno)

    def _finish_shared_state(self):
        for name, (locked, unlocked) in self.mutations.items():
            if not unlocked:
                continue
            if locked:
                reason = (f'module global {name!r} is mutated under a '
                          f'lock at line(s) {locked} but without one '
                          f'here — inconsistent locking')
            elif self.facts.spawns_threads:
                reason = (f'module global {name!r} mutated without a '
                          f'lock in a module that spawns threads')
            else:
                continue
            for line in unlocked:
                self.add('unguarded-shared-state', 'warning', line, reason)

    def _check_tl_escape(self, fndef):
        """Values read off a threading.local captured by a nested def."""
        if not self.facts.locals_:
            return
        tl_values = {}
        for node in fndef.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Attribute) \
                    and isinstance(node.value.value, ast.Name) \
                    and node.value.value.id in self.facts.locals_:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tl_values[t.id] = node.lineno
        if not tl_values:
            return
        for node in ast.walk(fndef):
            if node is fndef:
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name) and sub.id in tl_values:
                        self.add(
                            'thread-local-escape', 'warning', sub.lineno,
                            f'{sub.id!r} (read off a threading.local at '
                            f'line {tl_values[sub.id]}) captured by a '
                            f'nested function — the value is only '
                            f'meaningful on the reading thread')
            elif isinstance(node, ast.Call):
                cname = _call_name(node.func)
                if cname and cname.split('.')[-1] == 'Thread':
                    for arg in ast.walk(node):
                        if isinstance(arg, ast.Name) \
                                and arg.id in tl_values:
                            self.add(
                                'thread-local-escape', 'warning',
                                arg.lineno,
                                f'{arg.id!r} (read off a threading.local '
                                f'at line {tl_values[arg.id]}) passed '
                                f'into a Thread')


# ------------------------------------------------------------- public API
def lint_file(path, text=None):
    """Lint one Python source file; returns a list of LintFinding."""
    if text is None:
        with open(path, encoding='utf-8') as f:
            text = f.read()
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [LintFinding('bad-suppression', 'error', path,
                            e.lineno or 0, f'un-parseable: {e.msg}')]
    return _FileLinter(path, tree, text.splitlines()).run()


def lint_tree(root):
    """Lint every ``*.py`` under ``root``; returns sorted findings."""
    findings = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ('__pycache__', '.git')]
        for fn in sorted(filenames):
            if fn.endswith('.py'):
                findings.extend(lint_file(os.path.join(dirpath, fn)))
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def strict_enabled():
    return os.environ.get('MXNET_LOCK_LINT_STRICT', '') == '1'
