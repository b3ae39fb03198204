"""Deterministic fault injection for the ``dist_async`` transport.

Counterpart of ``mxnet_tpu/kvstore/faults.py`` (stdlib only, copied with
its grammar, counters and hooks unchanged). The resilient RPC layer
(retry/backoff + reconnect in :class:`.rpc.RpcClient`, server-side seq
dedup in :class:`.rpc.RpcServer`) is only trustworthy if every recovery
path can be driven on demand: real network chaos is neither deterministic
nor CI-friendly. This module hooks the two wire functions
(``rpc._send_msg``/``rpc._recv_msg``) and injects faults according to a
spec, so a connection reset mid-push or a lossy link is an ordinary
in-process test case (the reference stack gets the same effect from
ps-lite's ``PS_DROP_MSG`` resender knob; here the injection is exact and
counted).

Spec grammar — ``MXNET_KVSTORE_FAULT_SPEC`` or
:func:`configure`, semicolon-separated rules::

    drop:CMD:P[:seed=N]     with probability P (seeded RNG, default
                            seed 0 — deterministic sequence), fail a
                            matching request send with
                            ConnectionResetError BEFORE any byte
                            leaves: the message is lost pre-delivery,
                            so a retry re-executes it.
    delay:CMD:DUR           sleep DUR (``50ms``, ``0.2s``, or bare
                            seconds) before a matching send.
    reset_after[:CMD]:N     the N-th matching request is DELIVERED and
                            applied, then the connection is reset
                            before its reply is read — the
                            lost-reply-after-apply case that the
                            (rank, client, seq) dedup window must
                            absorb. Fires once.
    reset_every[:CMD]:N     same, but every N-th matching request
                            (soak mode).
    die_after[:CMD]:N       the N-th matching request raises
                            :class:`InjectedWorkerDeath` BEFORE any
                            byte leaves — the worker-process-kill
                            case. Deliberately NOT a transport error,
                            so the retry loop does not absorb it: it
                            propagates to the training loop, which
                            "dies" (elastic chaos tests). Fires once.
    kill_host[:CMD]:N       the N-th matching request raises
                            :class:`InjectedHostDeath` — the whole-host
                            failure case for pod-mesh chaos tests.
                            Pair with ``rank=R`` to kill exactly one
                            emulated host; like ``die_after`` it is a
                            RuntimeError the retry loop must not
                            absorb, but mesh drivers can tell the two
                            apart (host death takes all of the host's
                            devices out of the mesh). Fires once.
    partition[:CMD]:N:M     requests N .. N+M-1 (counted over matching
                            sends) raise ConnectionResetError — a
                            transient network partition of a mesh
                            member that heals after M failed attempts.
                            Count-based, so the chaos tests need no
                            wall-clock sleeps.

``CMD`` filters on the wire command (``push``, ``pull``, ``init``,
``ping``, ``barrier``, ...); ``*`` matches any worker request. Server
replies carry no ``cmd`` field and only match the literal filter
``reply``, so a cmd-less rule can never fire on the server's side of
an in-process test. Any rule takes a ``rank=R`` option restricting it
to requests stamped with that worker rank (e.g.
``die_after:push:3:rank=1`` kills worker 1 on its 3rd push) — requests
without a rank stamp never match a ranked rule.

Counters from :func:`injected` (``{'drop': n, 'delay': n, 'reset': n,
'die': n, 'total': n}``) are folded into the server's ``stats`` RPC
reply by ``_AsyncServer``, so assertions can read injection and apply
counts through one call (``KVStoreDistAsync.server_health``).

The plan is process-global (both ends of an in-process loopback pair
see it) but rules target the worker side via the ``cmd`` filter; the
pending-reset flag is thread-local so a reset armed by one store's
send can only fire on that same thread's reply read.
"""

import os
import random
import re
import threading
import time

__all__ = ['configure', 'clear', 'active', 'injected',
           'on_send', 'on_recv', 'FaultSpecError', 'InjectedWorkerDeath',
           'InjectedHostDeath']


class FaultSpecError(ValueError):
    """Malformed ``MXNET_KVSTORE_FAULT_SPEC`` rule."""


class InjectedWorkerDeath(RuntimeError):
    """Raised by a ``die_after`` rule: simulates the worker process
    dying at this exact send. A RuntimeError (not ConnectionError /
    OSError) on purpose — the RPC retry loop must NOT catch it, the
    worker's training loop must."""


class InjectedHostDeath(InjectedWorkerDeath):
    """Raised by a ``kill_host`` rule: the whole emulated host (its
    kvstore rank AND all devices it owns) dies at this exact send.
    Subclasses :class:`InjectedWorkerDeath` so generic elastic
    handling still applies, while pod-mesh drivers can distinguish a
    host loss (mesh must re-form on fewer devices) from a lone worker
    death."""


def _parse_duration(text):
    m = re.fullmatch(r'(\d+(?:\.\d+)?)(ms|s)?', text)
    if not m:
        raise FaultSpecError(f'bad duration {text!r} (want e.g. 50ms, 0.2s)')
    val = float(m.group(1))
    return val / 1e3 if m.group(2) == 'ms' else val


class _Rule:
    def __init__(self, action, cmd, **kw):
        self.action = action
        self.cmd = cmd            # None == any worker request
        self.rank = None          # None == any rank
        self.seen = 0             # matching sends so far (reset_* counting)
        self.__dict__.update(kw)

    def matches(self, cmd, rank=None):
        if self.rank is not None and rank != self.rank:
            return False
        if self.cmd is None or self.cmd == '*':
            # wildcard: any worker REQUEST, never a server reply
            return cmd != 'reply'
        return self.cmd == cmd


def _parse_rule(text):
    parts = text.split(':')
    action = parts[0].strip()
    opts = {}
    while parts and '=' in parts[-1]:
        k, v = parts.pop().split('=', 1)
        opts[k.strip()] = v.strip()
    rule = None
    if action == 'drop':
        if len(parts) != 3:
            raise FaultSpecError(f'drop rule {text!r}: want drop:CMD:P')
        p = float(parts[2])
        if not 0.0 <= p <= 1.0:
            raise FaultSpecError(f'drop probability {p} outside [0, 1]')
        rule = _Rule('drop', parts[1], p=p,
                     rng=random.Random(int(opts.get('seed', 0))))
    elif action == 'delay':
        if len(parts) != 3:
            raise FaultSpecError(f'delay rule {text!r}: want delay:CMD:DUR')
        rule = _Rule('delay', parts[1], duration=_parse_duration(parts[2]))
    elif action in ('reset_after', 'reset_every', 'die_after',
                    'kill_host'):
        if len(parts) == 2:          # reset_after:N — any worker request
            cmd, n = None, parts[1]
        elif len(parts) == 3:        # reset_after:CMD:N
            cmd, n = parts[1], parts[2]
        else:
            raise FaultSpecError(
                f'{action} rule {text!r}: want {action}[:CMD]:N')
        n = int(n)
        if n < 1:
            raise FaultSpecError(f'{action} count must be >= 1, got {n}')
        rule = _Rule(action, cmd, n=n)
    elif action == 'partition':
        if len(parts) == 3:          # partition:N:M — any worker request
            cmd, n, m = None, parts[1], parts[2]
        elif len(parts) == 4:        # partition:CMD:N:M
            cmd, n, m = parts[1], parts[2], parts[3]
        else:
            raise FaultSpecError(
                f'partition rule {text!r}: want partition[:CMD]:N:M')
        n, m = int(n), int(m)
        if n < 1 or m < 1:
            raise FaultSpecError(
                f'partition start/width must be >= 1, got {n}:{m}')
        rule = _Rule('partition', cmd, n=n, m=m)
    else:
        raise FaultSpecError(
            f'unknown fault action {action!r} in rule {text!r} '
            "(know: drop, delay, reset_after, reset_every, die_after, "
            "kill_host, partition)")
    if 'rank' in opts:
        try:
            rule.rank = int(opts['rank'])
        except ValueError:
            raise FaultSpecError(
                f'rule {text!r}: rank= wants an integer, '
                f'got {opts["rank"]!r}')
    return rule


class FaultPlan:
    """A parsed spec plus its injection counters."""

    def __init__(self, spec):
        self.spec = spec
        self.rules = [_parse_rule(r) for r in spec.split(';')
                      if r.strip()]
        if not self.rules:
            raise FaultSpecError(f'empty fault spec {spec!r}')
        self.counts = {'drop': 0, 'delay': 0, 'reset': 0, 'die': 0,
                       'kill_host': 0, 'partition': 0}
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ------------------------------------------------------------- hooks
    def on_send(self, header):
        cmd = header.get('cmd', 'reply')
        rank = header.get('rank')
        rank = int(rank) if rank is not None else None
        delay = 0.0
        for rule in self.rules:
            if not rule.matches(cmd, rank):
                continue
            if rule.action == 'die_after':
                with self._lock:
                    rule.seen += 1
                    fire = rule.seen == rule.n
                    if fire:
                        self.counts['die'] += 1
                if fire:
                    raise InjectedWorkerDeath(
                        f'fault-injected worker death on {cmd!r} rpc'
                        + (f' (rank {rank})' if rank is not None else ''))
            elif rule.action == 'kill_host':
                with self._lock:
                    rule.seen += 1
                    fire = rule.seen == rule.n
                    if fire:
                        self.counts['kill_host'] += 1
                if fire:
                    raise InjectedHostDeath(
                        f'fault-injected host death on {cmd!r} rpc'
                        + (f' (rank {rank})' if rank is not None else ''))
            elif rule.action == 'partition':
                with self._lock:
                    rule.seen += 1
                    fire = rule.n <= rule.seen < rule.n + rule.m
                    if fire:
                        self.counts['partition'] += 1
                if fire:
                    raise ConnectionResetError(
                        f'fault-injected partition of {cmd!r} rpc '
                        '(member unreachable; heals after '
                        f'{rule.m} attempts)')
            elif rule.action == 'delay':
                with self._lock:
                    self.counts['delay'] += 1
                delay += rule.duration
            elif rule.action == 'drop':
                with self._lock:
                    hit = rule.rng.random() < rule.p
                    if hit:
                        self.counts['drop'] += 1
                if hit:
                    raise ConnectionResetError(
                        f'fault-injected drop of {cmd!r} rpc '
                        '(message lost before delivery)')
            else:                      # reset_after / reset_every
                with self._lock:
                    rule.seen += 1
                    fire = (rule.seen == rule.n
                            if rule.action == 'reset_after'
                            else rule.seen % rule.n == 0)
                    if fire:
                        self.counts['reset'] += 1
                if fire:
                    # the request itself goes out — the reply read on
                    # THIS thread is what dies (lost-reply-after-apply)
                    self._tls.reset_recv = True
        if delay:
            time.sleep(delay)

    def on_recv(self, sock):
        if getattr(self._tls, 'reset_recv', False):
            self._tls.reset_recv = False
            try:
                # the peer's reply bytes may already sit in the buffer;
                # a real RST discards them, so must we — otherwise a
                # non-reconnecting reader would resync on a stale reply
                sock.close()
            except OSError:
                pass
            raise ConnectionResetError(
                'fault-injected connection reset before reply')

    def injected(self):
        with self._lock:
            out = dict(self.counts)
        out['total'] = sum(out.values())
        return out


_PLAN = None


def configure(spec=None):
    """Install a fault plan from ``spec`` (or, when ``None``, from
    ``MXNET_KVSTORE_FAULT_SPEC``). An empty spec clears the plan.
    Returns the active :class:`FaultPlan` or ``None``."""
    global _PLAN
    if spec is None:
        spec = os.environ.get('MXNET_KVSTORE_FAULT_SPEC', '')
    _PLAN = FaultPlan(spec) if spec.strip() else None
    return _PLAN


def clear():
    """Remove any active fault plan."""
    global _PLAN
    _PLAN = None


def active():
    """The installed :class:`FaultPlan`, or ``None``."""
    return _PLAN


def injected():
    """Injection counters of the active plan ({} when no plan)."""
    return _PLAN.injected() if _PLAN is not None else {}


def on_send(header):
    """Hook point for ``dist_async._send_msg`` (may raise or sleep)."""
    if _PLAN is not None:
        _PLAN.on_send(header)


def on_recv(sock):
    """Hook point for ``dist_async._recv_msg`` (may raise and close)."""
    if _PLAN is not None:
        _PLAN.on_recv(sock)


# a spec set in the environment before process start (the launcher
# path: tools/launch.py exports it to every worker) arms itself on
# first import; tests configure()/clear() explicitly
if os.environ.get('MXNET_KVSTORE_FAULT_SPEC'):
    configure()
