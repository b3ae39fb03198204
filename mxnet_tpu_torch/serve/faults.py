"""Deterministic fault injection for the serving runtime.

Admission control is only trustworthy if its failure paths can be
driven on demand: a deadline that expires *in queue* needs the
scheduler to stall at exactly the right moment, and a model error
mid-batch must fail that batch's requests without wedging the server.
Same philosophy as the JAX package's ``kvstore/faults.py``, scoped to the
serving pipeline's stages instead of the wire.

Spec grammar — ``MXNET_SERVE_FAULT_SPEC`` or :func:`configure`,
semicolon-separated rules::

    stall:STAGE:DUR       sleep DUR (``50ms``, ``0.2s``, bare seconds)
                          when STAGE is reached. With a fake clock the
                          injected ``sleep`` advances virtual time, so
                          "the scheduler stalled 200ms mid-dispatch" is
                          a deterministic test, not a sleep-and-hope.
    error:STAGE[:N]       raise ``RuntimeError`` on the N-th hit of
                          STAGE (default 1; fires once).
    error_every:STAGE:N   same, every N-th hit (soak mode).
    crash:STAGE[:N]       raise :class:`CrashInjected` (a
                          ``ConnectionError``) on the N-th hit, once —
                          at the router↔replica boundary the replica
                          responds by killing its whole RPC endpoint,
                          so peers see a dead process, not an error
                          reply.
    partition:STAGE:N:M   raise :class:`PartitionInjected` (a
                          ``ConnectionError``) on hits N..N+M-1, then
                          heal — a transient network partition: the
                          endpoint stays alive but unreachable.
    kill_host:STAGE[:N]   raise :class:`HostDeathInjected` (a
                          ``ConnectionError``) on the N-th hit
                          (default 1) and every one after — a replica
                          host losing its devices: the condition is
                          PERSISTENT, not transient, until the plan is
                          cleared (a multi-chip replica cannot limp
                          along on a partial mesh). The ``device``
                          probe latches the replica unhealthy so the
                          router ejects it instead of timing out a
                          hung request.

``STAGE`` is one of the pipeline's hook points — ``dispatch`` (batch
handed to the model), ``prefill`` (decode-server prompt prefill),
``step`` (one continuous-batching decode step), ``device`` (the
replica's local device-health probe, checked on every load report) —
or, at the router↔replica RPC boundary, ``submit`` (request received
by a replica, BEFORE it is applied), ``reply`` (reply about to be
sent, AFTER the apply — losing it exercises the dedup window), and
``heartbeat`` (replica answering a router ping). ``*`` matches any.

A stage may carry a scope suffix ``STAGE@NAME`` targeting one named
endpoint (``crash:submit@r1:2`` kills only replica ``r1``, on its 2nd
submit); hooks pass their scope via ``on(stage, scope=...)``.
Scopeless rules match every scope.
"""

import os
import re
import threading
import time as _time

__all__ = ['configure', 'clear', 'active', 'injected', 'on',
           'FaultSpecError', 'CrashInjected', 'PartitionInjected',
           'HostDeathInjected', 'STAGES']

STAGES = ('dispatch', 'prefill', 'step', 'submit', 'reply', 'heartbeat',
          'device')


class FaultSpecError(ValueError):
    """Malformed ``MXNET_SERVE_FAULT_SPEC`` rule."""


class CrashInjected(ConnectionError):
    """A fault-plan ``crash`` rule fired: the endpoint must die
    abruptly (sever every connection, no replies) — ConnectionError so
    the generic RPC handler drops the socket instead of sending an
    ``ok: False`` reply the client would treat as an application
    error."""


class PartitionInjected(ConnectionError):
    """A fault-plan ``partition`` rule fired: this message is lost as
    if the network were cut, but the endpoint lives and later heals."""


class HostDeathInjected(ConnectionError):
    """A fault-plan ``kill_host`` rule fired: the replica's host lost
    (some of) its devices. Persistent until the plan is cleared — the
    replica must latch itself unhealthy, not retry."""


def _parse_duration(text):
    m = re.fullmatch(r'(\d+(?:\.\d+)?)(ms|s)?', text)
    if not m:
        raise FaultSpecError(f'bad duration {text!r} (want e.g. 50ms, 0.2s)')
    val = float(m.group(1))
    return val / 1e3 if m.group(2) == 'ms' else val


def _parse_stage(token, text):
    """Split a ``STAGE[@SCOPE]`` token."""
    stage, sep, scope = token.partition('@')
    if not stage or (sep and not scope):
        raise FaultSpecError(f'bad stage {token!r} in rule {text!r}')
    return stage, (scope or None)


class _Rule:
    def __init__(self, action, stage, scope=None, **kw):
        self.action = action
        self.stage = stage
        self.scope = scope
        self.seen = 0
        self.__dict__.update(kw)

    def matches(self, stage, scope=None):
        if self.stage not in ('*', stage):
            return False
        return self.scope is None or self.scope == scope


def _parse_rule(text):
    parts = [p.strip() for p in text.split(':')]
    action = parts[0]
    if action == 'stall':
        if len(parts) != 3:
            raise FaultSpecError(f'stall rule {text!r}: want stall:STAGE:DUR')
        stage, scope = _parse_stage(parts[1], text)
        return _Rule('stall', stage, scope,
                     duration=_parse_duration(parts[2]))
    if action in ('error', 'error_every', 'crash', 'kill_host'):
        if len(parts) == 2 and action in ('error', 'crash', 'kill_host'):
            token, n = parts[1], 1
        elif len(parts) == 3:
            token, n = parts[1], int(parts[2])
        else:
            raise FaultSpecError(
                f'{action} rule {text!r}: want {action}:STAGE[:N]')
        if n < 1:
            raise FaultSpecError(f'{action} count must be >= 1, got {n}')
        stage, scope = _parse_stage(token, text)
        return _Rule(action, stage, scope, n=n)
    if action == 'partition':
        if len(parts) != 4:
            raise FaultSpecError(
                f'partition rule {text!r}: want partition:STAGE:N:M')
        n, m = int(parts[2]), int(parts[3])
        if n < 1 or m < 1:
            raise FaultSpecError(
                f'partition start/length must be >= 1, got {n}/{m}')
        stage, scope = _parse_stage(parts[1], text)
        return _Rule('partition', stage, scope, n=n, m=m)
    raise FaultSpecError(
        f'unknown serve fault action {action!r} in rule {text!r} '
        "(know: stall, error, error_every, crash, partition, kill_host)")


class FaultPlan:
    """A parsed spec plus its injection counters."""

    def __init__(self, spec, sleep=None):
        self.spec = spec
        self.rules = [_parse_rule(r) for r in spec.split(';') if r.strip()]
        if not self.rules:
            raise FaultSpecError(f'empty serve fault spec {spec!r}')
        self.sleep = sleep or _time.sleep
        self.counts = {'stall': 0, 'error': 0, 'crash': 0, 'partition': 0,
                       'kill_host': 0}
        self._lock = threading.Lock()

    def on(self, stage, scope=None):
        stall = 0.0
        for rule in self.rules:
            if not rule.matches(stage, scope):
                continue
            if rule.action == 'stall':
                with self._lock:
                    self.counts['stall'] += 1
                stall += rule.duration
                continue
            with self._lock:
                rule.seen += 1
                if rule.action == 'error':
                    fire = rule.seen == rule.n
                elif rule.action == 'error_every':
                    fire = rule.seen % rule.n == 0
                elif rule.action == 'crash':
                    fire = rule.seen == rule.n
                elif rule.action == 'kill_host':
                    # persistent from the N-th hit on: dead devices
                    # stay dead until the plan is cleared (healed)
                    fire = rule.seen >= rule.n
                else:                      # partition: hits n..n+m-1
                    fire = rule.n <= rule.seen < rule.n + rule.m
                if fire:
                    self.counts['error' if rule.action == 'error_every'
                                else rule.action] += 1
            if fire:
                if stall:
                    self.sleep(stall)
                at = f'{stage!r}' if scope is None \
                    else f'{stage!r}@{scope}'
                if rule.action == 'crash':
                    raise CrashInjected(
                        f'fault-injected crash at serve stage {at}')
                if rule.action == 'kill_host':
                    raise HostDeathInjected(
                        f'fault-injected host death at serve stage {at}')
                if rule.action == 'partition':
                    raise PartitionInjected(
                        f'fault-injected partition at serve stage {at}')
                raise RuntimeError(
                    f'fault-injected error at serve stage {at}')
        if stall:
            self.sleep(stall)

    def injected(self):
        with self._lock:
            out = dict(self.counts)
        out['total'] = sum(out.values())
        return out


_PLAN = None


def configure(spec=None, sleep=None):
    """Install a fault plan from ``spec`` (or ``MXNET_SERVE_FAULT_SPEC``
    when ``None``). ``sleep`` overrides the stall sleeper — tests pass a
    fake clock's ``advance`` so stalls are virtual. An empty spec clears
    the plan. Returns the active :class:`FaultPlan` or ``None``."""
    global _PLAN
    if spec is None:
        spec = os.environ.get('MXNET_SERVE_FAULT_SPEC', '')
    _PLAN = FaultPlan(spec, sleep=sleep) if spec.strip() else None
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


def on(stage, scope=None):
    """Pipeline hook (may sleep or raise). Free when no plan is set."""
    if _PLAN is not None:
        _PLAN.on(stage, scope)


if os.environ.get('MXNET_SERVE_FAULT_SPEC'):
    configure()
