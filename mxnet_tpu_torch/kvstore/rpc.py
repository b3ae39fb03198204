"""Generic framed-RPC transport of ``dist_async``.

Counterpart of ``mxnet_tpu/kvstore/rpc.py``, with the same wire format
and state machine (the JAX package's replicated serving tier registers
its handlers on the same machinery; the port's router waits for ROADMAP
A1 rest):

* :func:`_send_msg` / :func:`_recv_msg` — the JSON-header + raw-bytes
  framing (no pickle on the generic path: a reachable port cannot
  execute code via a crafted header), with the deterministic
  fault-injection hooks from :mod:`.faults` inline.
* :class:`RpcServer` — a threaded TCP server owning the machinery every
  service needs and none of the semantics: per-connection handler loop,
  heartbeat ``_last_seen`` table with bye-tombstones, the ``(client,
  seq)`` exactly-once dedup window (``MXNET_KVSTORE_DEDUP_WINDOW``; a
  retry that arrives while its first attempt is still being applied
  waits for that attempt's reply, where the JAX package applies it
  again: ROADMAP C13),
  and a ``crash()`` switch for chaos tests. Services subclass and
  implement :meth:`RpcServer._handle_app`; built-in commands ``ping`` /
  ``bye`` / ``dead_nodes`` are answered here (``ping`` merges
  :meth:`RpcServer._ping_extra`, which is how replicas piggyback load
  onto heartbeats).
* :class:`RpcClient` — one retrying channel to one server address:
  per-call deadline, exponential backoff + jitter, redial on any
  transport failure, shared ``retries``/``redials``/``giveups``
  counters. Identity stamping (rank, ``(client, seq)``) stays with the
  caller — the router must reuse one identity across failover attempts,
  so the channel never invents one.

Env knobs (same names as the kvstore transport — one set of semantics):
``MXNET_KVSTORE_RPC_RETRIES`` / ``MXNET_KVSTORE_RPC_DEADLINE_S`` /
``MXNET_KVSTORE_RPC_BACKOFF_S`` / ``MXNET_KVSTORE_DEDUP_WINDOW``.
"""

import collections
import json
import os
import socket
import socketserver
import struct
import threading
import time as _time

from . import faults
from ..telemetry import trace as _trace
from ..telemetry import metrics as _tmetrics

# fleet-wide transport counters (registry instruments, mergeable over
# the 'metrics' verb); each channel's per-instance stats dict remains
# the local thin view
_C_RETRIES = _tmetrics.counter('mx_rpc_retries_total')
_C_REDIALS = _tmetrics.counter('mx_rpc_redials_total')
_C_GIVEUPS = _tmetrics.counter('mx_rpc_giveups_total')
_C_REPLAYS = _tmetrics.counter('mx_rpc_dedup_replays_total')
# pod-scale mesh membership (docs/fault-tolerance.md "Pod-scale
# elasticity"): generation gauge follows every join/leave/epoch bump,
# the reject counter every fenced-off stale-generation request
_G_MESH_GEN = _tmetrics.gauge('mx_mesh_generation')
_C_STALE_GEN = _tmetrics.counter('mx_mesh_stale_generation_rejects_total')


class StaleGeneration(RuntimeError):
    """A generation-stamped request (push/pull/put of a mesh member)
    carried a mesh generation older than the server's: the sender
    missed a re-formation — typically a host that was ejected but is
    still running. The request is REJECTED with this typed error, never
    silently applied: a zombie's gradients must not leak into a mesh
    that already rolled back past them. The client refreshes its
    generation via ``mesh_epoch``/``mesh_table`` and rejoins."""


def _recv_exact(sock, n):
    """``n`` bytes from ``sock``, received into one preallocated (so
    writable) buffer: a gradient of 100 MB arrives in one pass, where
    joining the chunks would copy it again for every one."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError('kvstore async peer closed')
        got += k
    return buf


def _send_msg(sock, header, payload=b''):
    faults.on_send(header)          # no-op unless a fault plan is armed
    head = json.dumps(header).encode('utf-8')
    sock.sendall(struct.pack('!II', len(head), len(payload)))
    sock.sendall(head)
    if payload:
        sock.sendall(payload)


def _recv_msg(sock):
    faults.on_recv(sock)            # no-op unless a fault plan is armed
    hlen, plen = struct.unpack('!II', _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen).decode('utf-8'))
    payload = _recv_exact(sock, plen) if plen else b''
    return header, payload


class RpcServer(threading.Thread):
    """Threaded TCP server speaking the framed protocol.

    Owns the transport-level state machine; application semantics live
    in subclasses via :meth:`_handle_app`. Request flow per message::

        _recv_msg -> _dispatch (heartbeat refresh, dedup window)
                  -> _handle (ping/bye/dead_nodes) -> _handle_app
                  -> _pre_reply hook -> _send_msg

    Any exception out of the handler becomes an ``ok: False`` reply and
    the connection stays alive; transport errors drop the connection
    (the peer's retrying client redials and the dedup window makes the
    resend exactly-once).
    """

    #: race-checker level for ``self._lock`` (subclasses override)
    LOCK_LEVEL = 'kvstore.store'
    # data-plane commands prove a live store: they lift a tombstone (a
    # NEW incarnation of a departed rank revives it); ping/bye/queries
    # do not (the ADVICE r5 heartbeat race)
    _REVIVING_CMDS = frozenset()

    def __init__(self, port, bind_host='127.0.0.1', sid=0):
        super().__init__(daemon=True)
        self._sid = sid
        self._lock = threading.Lock()
        # injectable clock: every liveness decision (heartbeat stamps,
        # dead_nodes cutoff, elastic ejection) reads THIS, so chaos
        # tests advance a fake clock deterministically instead of
        # sleeping past real deadlines
        self._clock = _time.monotonic
        self._last_seen = {}        # peer rank -> monotonic last beat
        self._tombstones = set()    # ranks that sent 'bye'
        # (client, seq) -> (reply, rpayload) replay window for retried
        # mutating RPCs whose reply was lost after the server applied
        # them: exactly-once under retry (≙ ps-lite resender dedup)
        self._dedup = {}
        self._dedup_order = collections.deque()
        # (client, seq) -> Event of a request being applied now: a retry
        # that arrives before the first attempt's reply is cached (the
        # reply read died while the apply still ran) waits for it and
        # replays it, instead of applying a second time
        self._inflight = {}
        self._dedup_window = int(os.environ.get(
            'MXNET_KVSTORE_DEDUP_WINDOW', '512'))
        self._counters = {'dedup_replays': 0, 'stale_gen_rejects': 0}
        # mesh membership table (mesh_join/mesh_leave/mesh_epoch): the
        # process-topology side of a MeshGroup. Guarded by self._lock
        # (kvstore.store) — no new lock level. The generation bumps on
        # every membership change; generation-stamped data-plane
        # requests older than it are rejected with StaleGeneration.
        self._mesh_members = {}     # rank -> {'joined': clock, 'meta': {}}
        self._mesh_gen = 0
        # live handler sockets: crash() force-closes them so an
        # injected replica death severs in-flight requests the way a
        # real process kill would (socketserver itself never tracks
        # accepted connections)
        self._conns = set()
        self._conns_lock = threading.Lock()
        from ..analysis import race as _race
        if _race.enabled():
            self._lock = _race.tracked(self._lock, self.LOCK_LEVEL)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # the reply goes out in three writes (lengths, header,
                # payload): without TCP_NODELAY, Nagle holds the later
                # ones until the peer's delayed ACK, 40 ms a round trip
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                with outer._conns_lock:
                    outer._conns.add(self.request)
                try:
                    self._serve_loop()
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(self.request)

            def _serve_loop(self):
                while True:
                    try:
                        header, payload = _recv_msg(self.request)
                    except (ConnectionError, OSError, ValueError):
                        return
                    try:
                        reply, rpayload = outer._dispatch(
                            header, payload, self.client_address[0])
                    except ConnectionError:
                        # injected crash/partition (serve.faults raises
                        # ConnectionError subclasses): sever with no
                        # reply — the peer sees a dead endpoint, not an
                        # application error
                        return
                    except Exception as e:    # keep the connection alive
                        reply, rpayload = {'ok': False,
                                           'error': repr(e)}, b''
                    try:
                        # chaos hook: an injected reply-loss fault makes
                        # this raise AFTER the handler applied — the
                        # retry then exercises the dedup window
                        outer._pre_reply(header)
                    except Exception:
                        return            # reply lost: drop the socket
                    try:
                        _send_msg(self.request, reply, rpayload)
                    except (ConnectionError, OSError):
                        # the peer reset/closed mid-reply (e.g. its
                        # retrying RPC layer already gave up on this
                        # socket): it will resend on a fresh connection
                        # and the dedup window answers
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        # bind the advertised interface (not 0.0.0.0): peers reach us
        # at this address anyway, and nothing else should
        try:
            self._server = Server((bind_host, port), Handler)
        except OSError:
            # the hostname may not be a local interface name
            # (NAT/containers): fall back to all interfaces like ps-lite
            self._server = Server(('0.0.0.0', port), Handler)

    @property
    def port(self):
        """The actually-bound port (useful with ``port=0`` ephemerals)."""
        return self._server.server_address[1]

    def set_clock(self, fn):
        """Swap the liveness clock (tests: a fake monotonic source).
        Returns the previous clock."""
        prev, self._clock = self._clock, fn
        return prev

    def run(self):
        self._server.serve_forever(poll_interval=0.05)

    def stop(self):
        if self.is_alive():
            self._server.shutdown()
        self._server.server_close()

    def release_port(self):
        """Drop the post-crash port hold so a successor may bind the
        advertised port (no-op unless :meth:`crash` ran)."""
        hold = getattr(self, '_port_hold', None)
        if hold is not None:
            self._port_hold = None
            try:
                hold.close()
            except OSError:
                pass

    def crash(self):
        """Abrupt death for chaos tests: stop accepting, force-close
        every live connection mid-flight — no replies, no farewells —
        exactly what a killed replica process looks like to its peers.
        The instance is dead afterwards; recovery is a NEW server on
        the same port (the JAX package's ``serve.replica.Replica.restart``)."""
        addr = self._server.server_address
        if self.is_alive():
            self._server.shutdown()
        self._server.server_close()
        # Hold the freed port with a bound, non-listening socket:
        # peers still get connection-refused (dead-process semantics),
        # but the OS cannot hand the port out as an ephemeral source
        # port to some unrelated connection, which would make the
        # same-port restart fail EADDRINUSE. release_port() drops it.
        try:
            hold = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            hold.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            hold.bind(addr)
            self._port_hold = hold
        except OSError:
            pass                        # already stolen; restart retries
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # -------------------------------------------------------------- hooks
    def _ping_extra(self):
        """Extra fields merged into every ``ping`` reply — replicas
        piggyback their load snapshot here so heartbeats double as the
        router's least-loaded routing feed. Must not block."""
        return None

    def _pre_reply(self, header):
        """Called after the handler ran, before the reply is sent; a
        raise here LOSES the reply (connection dropped) while the
        apply stands — the chaos hook for dedup-window tests."""

    # ----------------------------------------------------------- dispatch
    def _dispatch(self, header, payload, peer='127.0.0.1'):
        """Trace adoption around :meth:`_dispatch_inner`: when the
        envelope carries a ``tc`` context (injected by a tracing
        :class:`RpcClient`; old peers simply never send one) the whole
        server-side handling becomes a ``rpc.handle:<cmd>`` span in the
        caller's trace — including an injected crash, which lands as
        the span's ``error`` attr before the connection severs."""
        tc = header.get('tc')
        if not tc or not _trace.enabled():
            return self._dispatch_inner(header, payload, peer)
        with _trace.attach(tc):
            with _trace.span('rpc.handle:%s' % header['cmd'],
                             sid=self._sid):
                return self._dispatch_inner(header, payload, peer)

    def _dispatch_inner(self, header, payload, peer):
        """Bookkeeping envelope around :meth:`_handle`: heartbeat
        refresh (tombstone-gated), then the (client, seq) dedup window
        — a retried mutating RPC the server already applied gets its
        cached reply replayed instead of a second apply, and one that
        arrives while its first attempt is still being applied waits for
        that attempt's reply."""
        cmd = header['cmd']
        rank = header.get('rank')
        client, seq = header.get('client'), header.get('seq')
        key = (client, int(seq)) \
            if client is not None and seq is not None else None
        while True:
            got = self._admit(header, cmd, rank, key)
            if got is None:
                break
            if not isinstance(got, threading.Event):
                return got
            # the same (client, seq) is being applied by another handler:
            # once it ends, its cached reply is replayed (or, where it
            # failed, this attempt applies)
            got.wait()
        try:
            reply, rpayload = self._handle(header, payload, peer)
            if key is not None and reply.get('ok'):
                # only successful applies enter the window: a failed
                # attempt must re-execute, not replay its error
                with self._lock:
                    if key not in self._dedup:
                        self._dedup[key] = (reply, rpayload)
                        self._dedup_order.append(key)
                        while len(self._dedup_order) > self._dedup_window:
                            self._dedup.pop(self._dedup_order.popleft(),
                                            None)
        finally:
            if key is not None:
                with self._lock:
                    self._inflight.pop(key).set()
        return reply, rpayload

    def _admit(self, header, cmd, rank, key):
        """The envelope's bookkeeping under the lock: the heartbeat, the
        generation fence and the dedup window. Returns a reply to send
        at once, the Event of an attempt of ``key`` still being applied
        (to wait for), or None, with ``key`` now marked in flight, for
        this attempt to apply."""
        gen = header.get('gen')
        with self._lock:
            if rank is not None:
                r = int(rank)
                if r not in self._tombstones:
                    # every RPC doubles as a heartbeat (plus any
                    # dedicated ping thread on the peer)
                    self._last_seen[r] = self._clock()
                elif cmd in self._REVIVING_CMDS:
                    self._tombstones.discard(r)
                    self._last_seen[r] = self._clock()
            if gen is not None and int(gen) < self._mesh_gen:
                # generation fence — checked BEFORE the dedup window so
                # a stale sender always gets the typed rejection, even
                # for a retry whose pre-reformation apply was cached
                # (the mesh rolled back past it either way)
                self._counters['stale_gen_rejects'] += 1
                _C_STALE_GEN.inc()
                return ({'ok': False, 'kind': 'StaleGeneration',
                         'error': f'{cmd!r} rejected: stale mesh '
                                  f'generation {int(gen)} < '
                                  f'{self._mesh_gen} — the mesh '
                                  're-formed; refresh via mesh_epoch '
                                  'and rejoin',
                         'mesh_gen': self._mesh_gen}, b'')
            if key is not None:
                cached = self._dedup.get(key)
                if cached is not None:
                    self._counters['dedup_replays'] += 1
                    _C_REPLAYS.inc()
                    return cached
                ev = self._inflight.get(key)
                if ev is not None:
                    return ev
                self._inflight[key] = threading.Event()
        return None

    def _handle(self, header, payload, peer='127.0.0.1'):
        cmd = header['cmd']
        if cmd == 'ping':
            # ts/proc: the peer's wall clock + process identity, read by
            # telemetry.note_clock on the caller for cross-process trace
            # alignment (NTP-midpoint offset off this one round trip)
            reply = {'ok': True, 'sid': self._sid,
                     'ts': _time.time(), 'proc': _trace.proc_name()}
            with self._lock:
                if self._mesh_members or self._mesh_gen:
                    # membership table piggybacked on every heartbeat:
                    # followers learn re-formations (new generation,
                    # shrunk member set) without a dedicated poll verb
                    reply['mesh'] = {'gen': self._mesh_gen,
                                     'members': sorted(self._mesh_members)}
            extra = self._ping_extra()
            if extra:
                reply.update(extra)
            return reply, b''
        if cmd == 'bye':
            # clean departure: drop the rank from the last-seen table
            # so dead_nodes does not report a finished peer as dead
            # forever (ADVICE r4), and tombstone it so a delayed
            # in-flight ping cannot re-add it afterwards (ADVICE r5)
            with self._lock:
                self._last_seen.pop(int(header['rank']), None)
                self._tombstones.add(int(header['rank']))
            return {'ok': True}, b''
        if cmd == 'dead_nodes':
            cutoff = self._clock() - float(header['timeout'])
            with self._lock:
                dead = sum(1 for t in self._last_seen.values()
                           if t < cutoff)
                departed = len(self._tombstones)
            # tombstoned ranks left CLEANLY: reported separately, never
            # counted dead
            return {'ok': True, 'dead': dead, 'departed': departed}, b''
        if cmd == 'metrics':
            # fleet aggregation: the whole process registry snapshot —
            # the caller merges snapshots rid-deduped (in-process peers
            # share one registry and must not be double-counted)
            return {'ok': True,
                    'metrics': _tmetrics.default_registry().snapshot()}, \
                b''
        if cmd == 'telemetry':
            # flight-recorder sweep for the cross-process trace export
            return {'ok': True,
                    'telemetry': _trace.snapshot_buffer()}, b''
        if cmd == 'mesh_join':
            with self._lock:
                self._mesh_members[int(header['rank'])] = {
                    'joined': self._clock(),
                    'meta': header.get('meta') or {}}
                self._mesh_gen += 1
                _G_MESH_GEN.set(self._mesh_gen)
                return {'ok': True, 'gen': self._mesh_gen,
                        'members': sorted(self._mesh_members)}, b''
        if cmd == 'mesh_leave':
            with self._lock:
                if self._mesh_members.pop(int(header['rank']),
                                          None) is not None:
                    self._mesh_gen += 1
                    _G_MESH_GEN.set(self._mesh_gen)
                return {'ok': True, 'gen': self._mesh_gen,
                        'members': sorted(self._mesh_members)}, b''
        if cmd == 'mesh_epoch':
            # leader-driven re-formation: eject dead members and bump
            # the generation ONCE. Ejecting an already-gone rank is a
            # no-op (idempotent — a retried epoch does not double-bump),
            # so the fence moves exactly one step per real reformation.
            with self._lock:
                changed = False
                for r in header.get('eject') or []:
                    if self._mesh_members.pop(int(r), None) is not None:
                        changed = True
                if changed or header.get('bump'):
                    self._mesh_gen += 1
                    _G_MESH_GEN.set(self._mesh_gen)
                return {'ok': True, 'gen': self._mesh_gen,
                        'members': sorted(self._mesh_members)}, b''
        return self._handle_app(header, payload, peer)

    def _handle_app(self, header, payload, peer):
        """Application commands — subclasses implement; reached only
        for commands the base protocol does not answer."""
        return {'ok': False,
                'error': f'unknown cmd {header["cmd"]!r}'}, b''


class RpcClient:
    """One retrying channel to one :class:`RpcServer` address.

    Extracted from ``KVStoreDistAsync._rpc_to``: transport failures
    (``ConnectionError``/``OSError``/timeouts, fault-injected ones
    included) close and re-dial the socket, then resend with
    exponential backoff + jitter until the attempt budget or per-call
    deadline runs out. A half-written request or half-read reply can
    never desync the stream because the socket is dropped on EVERY
    failure. Application-level errors (``ok: False`` replies) are NOT
    retried — they raise ``RuntimeError``.

    The channel stamps nothing into headers: (rank, client, seq)
    identity belongs to the caller, which may need to keep it stable
    across channels (router failover re-sends the SAME identity to a
    different replica).
    """

    def __init__(self, host, port, label=None, what='dist_async',
                 retries=None, deadline_s=None, backoff_s=None,
                 stats=None):
        self._host, self._port = host, int(port)
        self._label = label if label is not None \
            else f'server at {host}:{port}'
        self._what = what
        self._sock = None
        self._sock_lock = threading.Lock()
        env = os.environ.get
        self._retries = int(env('MXNET_KVSTORE_RPC_RETRIES', '4')) \
            if retries is None else int(retries)
        self._deadline = float(env('MXNET_KVSTORE_RPC_DEADLINE_S', '60')) \
            if deadline_s is None else float(deadline_s)
        self._backoff = float(env('MXNET_KVSTORE_RPC_BACKOFF_S', '0.05')) \
            if backoff_s is None else float(backoff_s)
        self._stats = stats if stats is not None \
            else {'retries': 0, 'redials': 0, 'giveups': 0}

    @property
    def addr(self):
        return (self._host, self._port)

    @property
    def stats(self):
        return self._stats

    def _dial(self, deadline=None):
        """Connect with bounded patience: the startup path keeps the
        historical ~10s budget; reconnects inside a retrying RPC pass
        the caller's remaining ``deadline`` (monotonic timestamp)."""
        import time
        last = None
        for _ in range(100):
            if deadline is not None and time.monotonic() >= deadline:
                break
            try:
                s = socket.create_connection(
                    (self._host, self._port), timeout=5)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # per-call timeouts are managed by call() from its
                # deadline; an unset timeout here would otherwise cap
                # every recv (barriers included) at connect's 5s
                s.settimeout(None)
                return s
            except OSError as e:
                last = e
                time.sleep(0.1)
        raise ConnectionError(
            f'cannot reach {self._what} {self._label} at '
            f'{self._host}:{self._port}: {last}')

    def connect(self):
        """Eagerly establish the connection (startup-time fail-fast)."""
        with self._sock_lock:
            if self._sock is None:
                self._sock = self._dial()
        return self

    def sock(self):
        """The live socket (diagnostics, e.g. getsockname), or None."""
        return self._sock

    def close(self):
        with self._sock_lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def call(self, header, payload=b'', attempts=None, deadline_s=None):
        """One RPC with retry/backoff + reconnect (see class docs).

        When the calling thread has a live trace context the whole
        call (retries and backoff included) becomes an ``rpc:<cmd>``
        span and the envelope grows an optional ``tc`` field carrying
        that span's context — old peers ignore the extra key, tracing
        peers adopt it, so one user request stitches into ONE trace
        across every hop. No context → the envelope is byte-identical
        to the pre-telemetry wire format."""
        if _trace.current_tc() is None:
            return self._call(header, payload, attempts, deadline_s)
        with _trace.span('rpc:%s' % header['cmd'], peer=self._label):
            header = dict(header)
            header['tc'] = _trace.current_tc()
            return self._call(header, payload, attempts, deadline_s)

    def _call(self, header, payload=b'', attempts=None, deadline_s=None):
        import random
        import time
        deadline = time.monotonic() + (
            self._deadline if deadline_s is None else deadline_s)
        if attempts is None:
            attempts = max(1, self._retries + 1)
        with self._sock_lock:
            for attempt in range(attempts):
                try:
                    sock = self._sock
                    if sock is None:
                        sock = self._dial(deadline=deadline)
                        self._sock = sock
                        self._stats['redials'] += 1
                        _C_REDIALS.inc()
                    sock.settimeout(
                        max(0.05, deadline - time.monotonic()))
                    _send_msg(sock, header, payload)
                    reply, rpayload = _recv_msg(sock)
                    sock.settimeout(None)
                    break
                except (ConnectionError, TimeoutError, OSError) as e:
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                    self._sock = None
                    now = time.monotonic()
                    if attempt + 1 >= attempts or now >= deadline:
                        self._stats['giveups'] += 1
                        _C_GIVEUPS.inc()
                        raise ConnectionError(
                            f'{self._what} rpc {header["cmd"]!r} to '
                            f'{self._label} at '
                            f'{self._host}:{self._port} failed '
                            f'after {attempt + 1} attempt(s) '
                            f'({type(e).__name__}: {e}); raise '
                            'MXNET_KVSTORE_RPC_RETRIES / '
                            'MXNET_KVSTORE_RPC_DEADLINE_S to wait '
                            'longer') from e
                    self._stats['retries'] += 1
                    _C_RETRIES.inc()
                    step = self._backoff * (2 ** attempt)
                    step *= 0.5 + random.random() / 2   # jitter
                    time.sleep(min(step, max(0.0, deadline - now)))
        if not reply.get('ok'):
            err = RuntimeError(reply.get('error', 'rpc failed'))
            # the full reply rides along so callers can rehydrate typed
            # errors (the serve router maps reply['kind'] back to the
            # ServeError subclass the replica raised)
            err.reply = reply
            raise err
        return reply, rpayload
