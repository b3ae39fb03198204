"""``dist_async``: the asynchronous parameter-server KVStore.

Counterpart of ``mxnet_tpu/kvstore/dist_async.py`` (reference
``src/kvstore/kvstore_dist_server.h:325-349``): in async mode the server
applies each worker's push to its weights at once (no merge buffer, no
wait for the other workers), and a worker pulls whatever the server holds
at that instant, so gradients may be stale in exchange for never waiting
on a straggler. The topology is the reference's: a server thread in rank 0
(and, with several servers, in ranks 1..S-1) owns the store and the
updater, and every worker reaches it over plain TCP.

**The server's update runs on the card.** The reference wraps the stored
weight in an NDArray on the default device and runs the updater there
(``mxnet_tpu/kvstore/dist_async.py:217-235``). Here the server keeps each
key's weight as a tensor on its device (``cuda:0``, or the host when the
store is made with ``device='cpu'`` or under ``with mx.cpu():``; with no
card and neither, making the store raises), beside the updater's slots.
A push is one host-to-device copy of the gradient and the optimizer's
update, which for Adam is the fused kernel (B5) and for SGD with momentum
B6, as the port's optimizers choose; a pull is one device-to-host copy.
Both run under the store lock on a CUDA stream of the server's own, so a
pull never reads a half-applied weight and the server's work never waits
on, or joins, a graph that a training thread of the same process is
capturing. Every tensor the server makes is made on that stream, so it is
freed back to it. CUDA events before and after each update on the
server stream give its span there (``server_health()[sid]['device']``),
which the host paces as it launches the update's few kernels.

Wire format (unchanged): a JSON header (cmd, key, dtype, shape) and raw
bytes, never pickle, so a reachable port cannot execute code through a
crafted header. The one pickled payload (``set_optimizer``) is gated
behind a shared-secret token (``MXNET_KVSTORE_SECRET``); without a
configured secret it is only accepted from loopback peers. The optimizer
travels without its parameters and without any tensor
(``Optimizer.__getstate__``): the server makes the slots and the
hyperparameter rows on its device. Server 0 binds the coordinator
interface from ``MX_COORDINATOR`` (``host:port``, as ``tools/launch.py``
sets it) rather than 0.0.0.0, at ``MXNET_KVSTORE_ASYNC_PORT`` (default
the coordinator's port + 29); a ``file://`` coordinator
(``parallel.launch.spawn``) means this host, and ``spawn`` then sets
``MXNET_KVSTORE_ASYNC_PORT`` to free loopback ports.

The transport (framing, handler loop, heartbeat table, tombstones, the
``(client, seq)`` dedup window, the retrying client channel) is
:mod:`.rpc`; fault injection is :mod:`.faults`. The host-side machinery is
the reference's:

* **multi-server key sharding**: ``MXNET_KVSTORE_NUM_SERVERS=S`` starts a
  server in each of ranks 0..S-1 (server s at port base + s); keys go to
  server CRC32(key) % S;
* **big-array splitting**: an array of at least
  ``MXNET_KVSTORE_BIGARRAY_BOUND`` bytes (1 MB) with at least S rows is
  split into S row ranges, chunk k (key ``'{key}#c{k}'``) on server k;
* **failure detection**: each worker pings server 0 every
  ``MXNET_KVSTORE_HEARTBEAT_S`` (2 s); ``get_num_dead_node`` counts
  unreachable servers and workers whose last beat is older than its
  ``timeout``;
* **fault tolerance**: retries with backoff under a deadline, the dedup
  window (exactly-once pushes under retry), tombstones for ranks that
  said ``bye``;
* the elastic membership verbs that :class:`..train.ElasticGroup` drives,
  and the mesh membership verbs with their generation fence.

A pull into a CUDA tensor goes through the pinned buffers of
:mod:`..parallel._staging`, as the ``dist_sync`` kvstore's transport does.
"""

import os
import pickle
import socket
import threading

import numpy as _onp
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..telemetry import trace as _trace
from . import faults
from .base import KVStoreBase, register
from .kvstore import _reduce
# the framing helpers, under the names the reference's callers use
from .rpc import (RpcClient, RpcServer, StaleGeneration,  # noqa: F401
                  _recv_exact, _recv_msg, _send_msg)

__all__ = ['KVStoreDistAsync']

# RPCs that change server state: they carry a per-store (client, seq)
# identity so a retry of an applied-but-reply-lost request is answered
# from the server's dedup window instead of re-applied (pull/ping/stats
# are idempotent and need no window)
_MUTATING_CMDS = frozenset(
    {'init', 'push', 'set_optimizer', 'register_server', 'barrier',
     'put', 'elastic_join', 'elastic_leave', 'elastic_commit',
     'elastic_barrier', 'mesh_join', 'mesh_leave', 'mesh_epoch'})

# data-plane commands stamped with the client's cached mesh generation
# (once set_mesh_gen/mesh_join ran): the server's generation fence
# rejects them typed after a re-formation instead of silently applying
# a stale world's update. Mesh verbs themselves are never stamped:
# they are how a client learns the current generation.
_MESH_STAMPED_CMDS = frozenset({'init', 'push', 'pull', 'put'})

#: wire dtype names (numpy's, as the reference writes them) of the tensor
#: dtypes a store carries
_WIRE = {torch.float32: 'float32', torch.float64: 'float64',
         torch.float16: 'float16', torch.bfloat16: 'bfloat16',
         torch.int8: 'int8', torch.uint8: 'uint8', torch.int32: 'int32',
         torch.int64: 'int64', torch.bool: 'bool'}
_FROM_WIRE = {v: k for k, v in _WIRE.items()}


def _as_bytes(t):
    """The bytes of host tensor ``t`` (made contiguous), without a copy
    when it already is: a payload for :func:`.rpc._send_msg`."""
    t = t.contiguous()
    if t.numel() == 0:
        return b''
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _from_bytes(payload, dtype, shape):
    """A host tensor of ``dtype`` (a wire name) and ``shape`` over the
    bytes of ``payload`` (a view of a writable buffer; read-only bytes are
    copied first)."""
    dt = _FROM_WIRE[str(dtype)]
    shape = tuple(int(s) for s in shape)
    if not len(payload):
        return torch.empty(shape, dtype=dt)
    if isinstance(payload, bytes):
        payload = bytearray(payload)
    return torch.frombuffer(payload, dtype=torch.uint8).view(dt).reshape(
        shape)


def _meta(t):
    return {'dtype': _WIRE[t.dtype], 'shape': list(t.shape)}


class _AsyncServer(RpcServer):
    """The parameter server: one instance in rank 0 (reference
    KVStoreDistServer::Run), and one in each of ranks 1..S-1 with several
    servers. Every request handler applies at once under the store lock:
    the async branch of DataHandleDefault. The transport machinery
    (handler loop, heartbeat table, dedup window) comes from
    :class:`.rpc.RpcServer`."""

    LOCK_LEVEL = 'kvstore.store'
    # data-plane commands prove a live store: they lift a tombstone (a
    # NEW store of a departed rank revives it); ping/bye/queries do not
    _REVIVING_CMDS = frozenset(
        {'init', 'push', 'pull', 'barrier', 'set_optimizer', 'put',
         'elastic_join', 'elastic_barrier', 'elastic_commit',
         'mesh_join'})

    def __init__(self, port, bind_host='127.0.0.1', sid=0, device='cpu'):
        super().__init__(port, bind_host=bind_host, sid=sid)
        self._device = torch.device(device)
        # the server's own stream: its copies and updates never join the
        # stream of a graph a training thread of this process captures
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == 'cuda' else None
        self._store = {}
        self._updater = None
        self._server_table = {}     # sid -> 'host:port' (server 0 only)
        self._counters.update({'init_applied': 0, 'push_applied': 0})
        self._timed = []            # (start, end) events of each update
        self._device_ms = {'update_ms': 0.0, 'updates': 0}
        self._secret = os.environ.get('MXNET_KVSTORE_SECRET', '')
        # addresses that count as "same host" for the no-secret
        # set_optimizer gate: loopback plus the bind interface itself
        # (rank 0 dialing hostA:port arrives with hostA's own source IP)
        self._local_peers = {'127.0.0.1', '::1'}
        try:
            self._local_peers.add(socket.gethostbyname(bind_host))
        except OSError:
            pass
        self._barrier_count = 0
        self._barrier_gen = 0
        self._barrier_arrivals = set()   # (client, seq) this generation
        self._barrier_cv = threading.Condition()
        # ------- elastic membership (train.elastic worker-loss recovery)
        # rank -> {'joined': clock time, 'start': first step this member
        # participates in}: a late joiner must not be counted at a
        # barrier for a step already in flight (its gradient would be
        # scaled for a world it was never part of)
        self._elastic_members = {}
        self._elastic_gen = 0            # bumps on every join/ejection
        self._elastic_committed = -1     # last checkpoint-committed step
        self._elastic_step = -1          # max step whose barrier released
        self._elastic_arrivals = {}      # (phase, step) -> set of ranks
        self._elastic_rel = {}           # (phase, step) -> release count
        self._elastic_reply = {}         # (phase, step) -> last release reply
        self._elastic_released = {}      # rank -> clock at its last release
        self._elastic_cv = threading.Condition()
        self._race = None
        from ..analysis import race as _race
        if _race.enabled():
            # self._lock is already tracked at 'kvstore.store' by the
            # RpcServer base; every _store mutation must hold it:
            # handler threads race each other and the heartbeat reaper
            self._barrier_cv = _race.tracked_condition(
                self._barrier_cv, 'kvstore.barrier')
            self._elastic_cv = _race.tracked_condition(
                self._elastic_cv, 'kvstore.barrier')
            self._race = _race.shared_state('kvstore._AsyncServer._store',
                                            guard=self._lock)

    # ------------------------------------------------------------- device
    def _on_device(self):
        """The server's device and stream as the current ones (nothing
        on the host)."""
        import contextlib
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _to_device(self, header, payload):
        """The payload as a new tensor on the server's device: one
        host-to-device copy on the server stream."""
        host = _from_bytes(payload, header['dtype'], header['shape'])
        with self._on_device():
            return host.to(self._device, copy=True)

    def _apply(self, key, grad, weight):
        """The updater on ``weight`` in place, between CUDA events on the
        server stream when it has one (caller holds the store lock)."""
        with self._on_device():
            if self._stream is None:
                self._updater(key, grad, weight)
                return
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self._updater(key, grad, weight)
            b.record()
            self._timed.append((a, b))

    def _device_stats(self):
        """The update device ms so far (caller holds the store lock)."""
        for a, b in self._timed:
            b.synchronize()
            self._device_ms['update_ms'] += a.elapsed_time(b)
            self._device_ms['updates'] += 1
        self._timed = []
        return dict(self._device_ms, device=str(self._device))

    # ----------------------------------------------------------- handlers
    def _handle_app(self, header, payload, peer='127.0.0.1'):
        cmd = header['cmd']
        rank = header.get('rank')
        if cmd == 'register_server':
            with self._lock:
                self._server_table[int(header['sid'])] = header['addr']
            return {'ok': True}, b''
        if cmd == 'server_table':
            with self._lock:
                return {'ok': True,
                        'table': {str(k): v for k, v
                                  in self._server_table.items()}}, b''
        if cmd == 'stats':
            with self._lock:
                reply = {'ok': True, 'sid': self._sid,
                         'keys': sorted(map(str, self._store)),
                         'counters': dict(self._counters),
                         'tombstones': sorted(self._tombstones),
                         'faults': faults.injected(),
                         'device': self._device_stats()}
            with self._elastic_cv:
                reply['elastic'] = {
                    'gen': self._elastic_gen,
                    'live': sorted(self._elastic_members),
                    'committed': self._elastic_committed,
                    'step': self._elastic_step}
            with self._lock:
                reply['mesh'] = {'gen': self._mesh_gen,
                                 'members': sorted(self._mesh_members)}
            return reply, b''
        if cmd == 'init':
            arr = self._to_device(header, payload)
            with self._lock:
                if self._race is not None:
                    self._race.write()
                # first init wins (reference: rank 0 authoritative)
                self._store.setdefault(header['key'], arr)
                self._counters['init_applied'] += 1
            return {'ok': True}, b''
        if cmd == 'put':
            # unconditional overwrite, the rollback/recovery primitive:
            # init's first-write-wins would keep the value being rolled
            # back, and push routes through the updater
            arr = self._to_device(header, payload)
            with self._lock:
                if self._race is not None:
                    self._race.write()
                self._store[header['key']] = arr
            return {'ok': True}, b''
        if cmd == 'push':
            grad = self._to_device(header, payload)
            with self._lock:
                if self._race is not None:
                    self._race.write()
                w = self._store.get(header['key'])
                if w is None:
                    self._store[header['key']] = grad
                elif self._updater is not None:
                    # immediate apply, the async DataHandleDefault branch,
                    # in place on the stored weight; a pull reads it under
                    # this lock on the same stream, so never half-applied
                    self._apply(header['key'], grad, w)
                else:
                    with self._on_device():
                        self._store[header['key']] = w + grad
                self._counters['push_applied'] += 1
            return {'ok': True}, b''
        if cmd == 'pull':
            with self._lock:
                if self._race is not None:
                    self._race.read()
                w = self._store.get(header['key'])
                if w is None:
                    # a clean error keeps the connection alive (a raise
                    # would kill this handler thread and drop the socket)
                    return {'ok': False,
                            'error': f'no such key {header["key"]!r} on '
                                     f'server {self._sid}'}, b''
                # the device-to-host copy is the read: it stays under the
                # store lock so that no push lands in the middle of it
                with self._on_device():
                    data = w.to('cpu', copy=True)  # lock-lint: disable=blocking-call-under-lock -- the copy is the snapshot a pull returns; outside the lock a push could tear it
            return {'ok': True, **_meta(data)}, _as_bytes(data)
        if cmd == 'set_optimizer':
            # the only pickled payload on the wire: gate it.  With a
            # configured shared secret, require the token; without one,
            # only trust loopback peers (same-host job).
            import hmac
            if self._secret:
                if not hmac.compare_digest(header.get('token', ''),
                                           self._secret):
                    return {'ok': False,
                            'error': 'set_optimizer rejected: bad or '
                                     'missing MXNET_KVSTORE_SECRET '
                                     'token'}, b''
            elif not peer.startswith('127.') \
                    and peer not in self._local_peers:
                return {'ok': False,
                        'error': 'set_optimizer rejected from non-'
                                 'local peer: set '
                                 'MXNET_KVSTORE_SECRET on all ranks '
                                 'to enable remote optimizer setup'}, b''
            from ..optimizer import get_updater
            opt = pickle.loads(payload)
            with self._lock:
                self._updater = get_updater(opt)
            return {'ok': True}, b''
        if cmd == 'barrier':
            n = header['nproc']
            # retry identity: a worker whose connection died while its
            # original barrier handler is still blocked in wait_for
            # re-sends the SAME (client, seq) on a fresh socket; that
            # duplicate must wait for the release, not arrive twice
            ident = (header.get('client'), header.get('seq'))
            with self._barrier_cv:
                gen = self._barrier_gen
                if ident == (None, None) \
                        or ident not in self._barrier_arrivals:
                    self._barrier_arrivals.add(ident)
                    self._barrier_count += 1
                if self._barrier_count >= n:
                    self._barrier_count = 0
                    self._barrier_arrivals = set()
                    self._barrier_gen += 1
                    self._barrier_cv.notify_all()
                else:
                    deadline = _kv_deadline_s()
                    released = self._barrier_cv.wait_for(
                        lambda: self._barrier_gen != gen,
                        timeout=deadline)
                    if not released:
                        # undo our arrival so later barriers don't
                        # release one worker early, and surface the
                        # failure to the caller instead of silently
                        # proceeding unsynchronized
                        self._barrier_count -= 1
                        self._barrier_arrivals.discard(ident)
                        return {'ok': False,
                                'error': f'barrier timeout after '
                                         f'{deadline:g}s '
                                         f'(MXNET_KVSTORE_DEADLINE_S): '
                                         f'not all workers arrived'}, b''
            return {'ok': True}, b''
        if cmd == 'elastic_join':
            r = int(rank)
            with self._elastic_cv:
                # a (re)joining worker participates from the first step
                # whose barrier has not released yet: the in-flight step
                # keeps the world it started with
                start = max(self._elastic_step,
                            self._elastic_committed) + 1
                if r not in self._elastic_members:
                    self._elastic_members[r] = {'joined': self._clock(),
                                                'start': start}
                    self._elastic_gen += 1
                    self._elastic_cv.notify_all()
                return {'ok': True, 'gen': self._elastic_gen,
                        'live': sorted(self._elastic_members),
                        'committed': self._elastic_committed,
                        'resume': self._elastic_members[r]['start']}, b''
        if cmd == 'elastic_leave':
            r = int(rank)
            with self._elastic_cv:
                if self._elastic_members.pop(r, None) is not None:
                    self._elastic_gen += 1
                    self._elastic_cv.notify_all()
                return {'ok': True, 'gen': self._elastic_gen,
                        'live': sorted(self._elastic_members)}, b''
        if cmd == 'elastic_commit':
            step = int(header['step'])
            with self._elastic_cv:
                self._elastic_committed = max(self._elastic_committed,
                                              step)
                # prune barrier bookkeeping for steps that can never be
                # revisited (rollback never goes behind the commit)
                for k in [k for k in self._elastic_arrivals
                          if k[1] < self._elastic_committed - 2]:
                    self._elastic_arrivals.pop(k, None)
                    self._elastic_rel.pop(k, None)
                    self._elastic_reply.pop(k, None)
                self._elastic_cv.notify_all()
                return {'ok': True,
                        'committed': self._elastic_committed}, b''
        if cmd == 'elastic_barrier':
            return self._elastic_barrier(header)
        return {'ok': False, 'error': f'unknown cmd {cmd!r}'}, b''

    def _elastic_barrier(self, header):
        """Membership-aware barrier for the elastic step protocol.

        Release condition: every *expected* member (live, and whose
        ``start`` step is <= this barrier's step) has arrived. While
        waiting, each waiter re-evaluates liveness from the heartbeat
        table against the injectable clock and EJECTS silent members,
        only non-arrived ones: an arrived member is a live handler
        thread by construction, no matter how stale its fake-clock
        heartbeat looks. Barriers are re-runnable: a release clears the
        arrivals set and caches the reply, so a rollback-redo of the
        same (phase, step) forms a fresh barrier instead of releasing
        instantly off stale arrivals.

        Lock order: the heartbeat snapshot is taken under ``self._lock``
        (kvstore.store) and RELEASED before ``_elastic_cv``
        (kvstore.barrier) is acquired: store before barrier, matching
        the declared hierarchy.
        """
        import time as _time
        rank = int(header['rank'])
        phase = header['phase']
        step = int(header['step'])
        key = (phase, step)
        deadline = _kv_deadline_s()
        wall_deadline = _time.monotonic() + deadline
        entry_gen = None
        entry_rel = None
        while True:
            with self._lock:
                seen = {r: t for r, t in self._last_seen.items()}
                tombs = set(self._tombstones)
            now = self._clock()
            with self._elastic_cv:
                if rank not in self._elastic_members:
                    return {'ok': False,
                            'error': f'rank {rank} is not an elastic '
                                     'member (call elastic_join '
                                     'first)'}, b''
                if entry_gen is None:
                    entry_gen = self._elastic_gen
                    entry_rel = self._elastic_rel.get(key, 0)
                elif self._elastic_rel.get(key, 0) > entry_rel:
                    # another waiter released this barrier round: join
                    # its verdict so the whole group acts uniformly.
                    # Checked BEFORE registering arrival: a woken
                    # waiter must not seed the next run of this
                    # (phase, step) barrier with its stale rank
                    return dict(self._elastic_reply[key]), b''
                arr = self._elastic_arrivals.setdefault(key, set())
                arr.add(rank)
                dead = []
                for r, m in self._elastic_members.items():
                    if r in arr:
                        continue
                    # a member released from a barrier was alive then,
                    # though its heartbeats waited behind its barrier
                    # call on the one socket
                    last = max(seen.get(r, m['joined']),
                               self._elastic_released.get(r, m['joined']))
                    if r in tombs or now - last > deadline:
                        dead.append(r)
                for r in dead:
                    del self._elastic_members[r]
                if dead:
                    self._elastic_gen += 1
                    self._elastic_cv.notify_all()
                expected = {r for r, m in self._elastic_members.items()
                            if m['start'] <= step}
                if expected and expected <= arr:
                    self._elastic_step = max(self._elastic_step, step)
                    reply = {'ok': True, 'gen': self._elastic_gen,
                             'live': sorted(self._elastic_members),
                             'count': len(expected),
                             'committed': self._elastic_committed,
                             'changed': self._elastic_gen != entry_gen}
                    self._elastic_rel[key] = \
                        self._elastic_rel.get(key, 0) + 1
                    for r in arr:
                        self._elastic_released[r] = now
                    self._elastic_reply[key] = reply
                    self._elastic_arrivals[key] = set()
                    self._elastic_cv.notify_all()
                    return dict(reply), b''
                if _time.monotonic() >= wall_deadline:
                    arr.discard(rank)
                    return {'ok': False,
                            'error': f'elastic barrier ({phase}, {step}) '
                                     f'timeout after {deadline:g}s '
                                     '(MXNET_KVSTORE_DEADLINE_S)'}, b''
                # short slices, not one long wait: fake-clock liveness
                # (self._clock) can advance without any notify, and the
                # per-iteration re-snapshot is what turns that into a
                # deterministic ejection
                self._elastic_cv.wait(timeout=0.05)


_SERVERS = {}
# guards _SERVERS: two stores connecting concurrently in one process
# must not double-create (and double-bind) the per-port server
_SERVERS_LOCK = threading.Lock()


def _kv_deadline_s():
    """Liveness deadline for control-plane waits (barrier wait_for,
    heartbeat join): ``MXNET_KVSTORE_DEADLINE_S`` (default 120), so a
    dead peer can no longer hang a barrier forever. Distinct from
    ``MXNET_KVSTORE_RPC_DEADLINE_S``, the per-RPC transport budget."""
    try:
        return max(1e-3, float(os.environ.get(
            'MXNET_KVSTORE_DEADLINE_S', '120')))
    except ValueError:
        return 120.0


def _coordinator():
    """(host, server port) from ``MX_COORDINATOR`` and
    ``MXNET_KVSTORE_ASYNC_PORT``: ``host:port`` gives the host and, by
    default, port + 29 (``tools/launch.py``); a ``scheme://`` URL
    (``file://``, as ``parallel.launch.spawn`` sets it) means this host,
    and the port must be given."""
    coord = os.environ.get('MX_COORDINATOR', '127.0.0.1:49800')
    port = os.environ.get('MXNET_KVSTORE_ASYNC_PORT')
    if '://' in coord:
        scheme, rest = coord.split('://', 1)
        if scheme == 'tcp':
            coord = rest
        elif port is None:
            raise MXNetError(
                f'dist_async: MX_COORDINATOR={coord!r} names no host and '
                f'port; set MXNET_KVSTORE_ASYNC_PORT (parallel.launch.'
                f'spawn sets it for its ranks)')
        else:
            return '127.0.0.1', int(port)
    host, cport = coord.rsplit(':', 1)
    return host, int(port) if port is not None else int(cport) + 29


@register
class KVStoreDistAsync(KVStoreBase):
    """Asynchronous parameter-server kvstore (reference ``dist_async``).
    ``device`` is where this process's server keeps the weights and runs
    the updater: by default the current context's (``gpu(0)`` unless a
    ``with mx.cpu():`` block says otherwise); a card that is not there
    raises."""

    NAME = 'dist_async'

    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._rank = int(os.environ.get('MX_PROC_ID', '0'))
        self._nproc = int(os.environ.get('MX_NPROC', '1'))
        self._chans = {}            # sid -> RpcClient channel
        self._addrs = {}            # sid -> (host, port) diagnostics
        self._server = None
        self._port = None
        self._host = ' '
        self._closed = False
        self._nserv = min(max(1, int(os.environ.get(
            'MXNET_KVSTORE_NUM_SERVERS', '1'))), self._nproc)
        self._big = int(float(os.environ.get(
            'MXNET_KVSTORE_BIGARRAY_BOUND', str(1 << 20))))
        self._hb_thread = None
        self._stage = None          # pinned buffers, made at first use
        # resilient-transport knobs: a transient server restart or TCP
        # reset is absorbed by redial + retry instead of killing the
        # job (ps-lite Resender/PS_RESEND, Van reconnect)
        self._rpc_retries = int(os.environ.get(
            'MXNET_KVSTORE_RPC_RETRIES', '4'))
        self._rpc_deadline = float(os.environ.get(
            'MXNET_KVSTORE_RPC_DEADLINE_S', '60'))
        self._rpc_backoff = float(os.environ.get(
            'MXNET_KVSTORE_RPC_BACKOFF_S', '0.05'))
        # per-store identity + monotonic sequence for mutating RPCs:
        # the server's dedup window keys on (client, seq) so a retried
        # already-applied push replays its reply (exactly-once). The
        # client id disambiguates several stores of the same rank in
        # one process (each runs its own seq counter from 0).
        import uuid
        self._client = uuid.uuid4().hex
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._transport_stats = {'retries': 0, 'redials': 0,
                                 'giveups': 0}
        # cached mesh generation: None until this store joined the mesh
        # (or set_mesh_gen ran); only then are data-plane RPCs stamped
        # and subject to the server's generation fence
        self._mesh_gen = None

    # ------------------------------------------------------------ plumbing
    def _channel(self, sid, host, port):
        """Create + eagerly connect the retrying channel to server
        ``sid`` (all channels share one transport-stats dict)."""
        chan = RpcClient(host, int(port), label=f'server {sid}',
                         what='dist_async', retries=self._rpc_retries,
                         deadline_s=self._rpc_deadline,
                         backoff_s=self._rpc_backoff,
                         stats=self._transport_stats)
        chan.connect()
        self._addrs[sid] = (host, int(port))
        self._chans[sid] = chan
        return chan

    def _serve(self, port, bind, sid):
        """This process's server at ``port`` (one per port and process,
        whatever number of stores the process makes), started if new."""
        with _SERVERS_LOCK:
            server = _SERVERS.get(port)
            if server is None:
                server = _AsyncServer(port, bind_host=bind, sid=sid,
                                      device=self._device)
                server.start()
                _SERVERS[port] = server
        return server

    def _ensure_connected(self):
        if self._chans:
            return
        host, self._port = _coordinator()
        self._host = host
        self._closed = False
        local = host in ('127.0.0.1', 'localhost')
        if self._rank == 0 and self._server is None:
            # rank 0 hosts server 0 (reference: the server node group)
            # and must start it before dialing itself below
            self._server = self._serve(self._port,
                                       '127.0.0.1' if local else host, 0)
        # every rank (rank 0 included) connects to the advertised
        # coordinator host: the server may be bound to that interface
        # only, so rank 0 dialing loopback would be refused
        target = '127.0.0.1' if local else host
        self._channel(0, target, self._port)
        if self._nserv > 1:
            # server sid>0 starts only AFTER dialing server 0 and binds
            # the exact interface that dial used (getsockname), the same
            # address it advertises in register_server: binding 0.0.0.0
            # would expose the unauthenticated data plane on every NIC
            if 0 < self._rank < self._nserv:
                my_port = self._port + self._rank
                myif = self._chans[0].sock().getsockname()[0]
                self._server = self._serve(
                    my_port, '127.0.0.1' if local else myif, self._rank)
                myaddr = f'{myif}:{my_port}'
                self._rpc_to(0, {'cmd': 'register_server',
                                 'sid': self._rank, 'addr': myaddr})
            table = {}
            import time
            for _ in range(200):
                reply, _p = self._rpc_to(0, {'cmd': 'server_table'})
                table = reply['table']
                if len(table) >= self._nserv - 1:
                    break
                time.sleep(0.1)
            else:
                raise ConnectionError(
                    f'only {len(table) + 1}/{self._nserv} dist_async '
                    'servers registered')
            for sid_s, addr in table.items():
                h, p = addr.rsplit(':', 1)
                self._channel(int(sid_s), h, int(p))
        if self._hb_thread is None:
            interval = float(os.environ.get('MXNET_KVSTORE_HEARTBEAT_S',
                                            '2'))
            self._hb_stop = threading.Event()
            # weakref: a strong self in the closure would keep the store
            # alive forever (thread references closure references store),
            # so __del__->close could never run for abandoned stores
            import weakref
            wself = weakref.ref(self)
            stop = self._hb_stop

            def beat():
                while not stop.wait(interval):
                    st = wself()
                    if st is None:
                        return        # store collected
                    try:
                        # single attempt, short deadline: a lost beat
                        # is harmless (the next one retries, and every
                        # real RPC piggybacks a heartbeat); retrying
                        # here would pin the socket lock for seconds
                        st._rpc_to(0, {'cmd': 'ping'}, attempts=1,
                                   deadline_s=5)
                    except Exception:
                        # a beat lost behind a long call on the socket
                        # (a barrier) is no reason to stop beating
                        if stop.is_set():
                            return    # job shutting down
                    finally:
                        del st

            self._hb_thread = threading.Thread(target=beat, daemon=True)
            self._hb_thread.start()

    def close(self):
        """Stop the heartbeat thread and close this store's server
        connections (the server threads themselves are shared per port
        and stay up for other stores in the process).

        Idempotent and shutdown-safe: a second call (or a __del__ at
        interpreter teardown racing an already-dead heartbeat thread,
        or one that runs before _ensure_connected ever did) returns
        without raising."""
        if getattr(self, '_closed', False):
            return
        self._closed = True
        hb = getattr(self, '_hb_thread', None)
        if hb is not None:
            try:
                self._hb_stop.set()
                # join BEFORE the bye RPC: an in-flight ping landing
                # after the bye would re-add this rank to the server's
                # last-seen table. Deadline-bounded: a pinger stuck in a
                # dying RPC must not hang close() (the thread is a
                # daemon; leaking it past the deadline is safe).
                hb.join(timeout=min(10.0, _kv_deadline_s()))
            except Exception:
                pass              # interpreter shutting down mid-close
            self._hb_thread = None
        chans = getattr(self, '_chans', None)
        if not chans:
            return
        if 0 in chans:
            try:
                # clean departure: deregister from the heartbeat table
                # so this rank is not counted dead forever; a single
                # short attempt: shutdown must not hang on a server that
                # is already gone
                self._rpc_to(0, {'cmd': 'bye'}, attempts=1, deadline_s=5)
            except Exception:
                pass              # server already gone: nothing to tell
        for chan in list(chans.values()):
            try:
                chan.close()
            except Exception:
                pass
        chans.clear()
        self._addrs.clear()

    def __del__(self):                  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def _rpc_to(self, sid, header, payload=b'', attempts=None,
                deadline_s=None):
        """One RPC with retry/backoff + reconnect (the channel's
        :meth:`.rpc.RpcClient.call` contract).

        This wrapper owns identity: it stamps ``rank`` plus, for
        mutating RPCs, the per-store ``(client, seq)``, exactly once,
        so the identity survives the channel's resends and the server
        dedup window sees a stable key. Application-level errors
        (``ok: False`` replies) are NOT retried: they surface as
        ``RuntimeError``."""
        header['rank'] = self._rank
        if header['cmd'] in _MUTATING_CMDS and 'seq' not in header:
            with self._seq_lock:
                self._seq += 1
                header['seq'] = self._seq
            header['client'] = self._client
        if self._mesh_gen is not None and 'gen' not in header \
                and header['cmd'] in _MESH_STAMPED_CMDS:
            header['gen'] = self._mesh_gen
        try:
            return self._chans[sid].call(header, payload,
                                         attempts=attempts,
                                         deadline_s=deadline_s)
        except RuntimeError as e:
            reply = getattr(e, 'reply', None) or {}
            if reply.get('kind') == 'StaleGeneration':
                err = StaleGeneration(str(e))
                err.reply = reply
                raise err from None
            raise

    def _rpc(self, header, payload=b''):
        self._ensure_connected()
        return self._rpc_to(0, header, payload)

    # ------------------------------------------------------------- routing
    def _key_server(self, key):
        import zlib
        return zlib.crc32(str(key).encode()) % self._nserv

    def _plan(self, key, shape, nbytes):
        """Reference EncodeDefaultKey (kvstore_dist.h:621): small keys
        hash to one server; arrays >= bigarray_bound with enough rows
        split into contiguous row ranges, chunk k on server k. Every
        worker computes the identical plan from (key, shape)."""
        self._ensure_connected()
        if self._nserv == 1:
            return [(0, key, None)]
        if nbytes >= self._big and len(shape) >= 1 \
                and shape[0] >= self._nserv:
            rows, S = shape[0], self._nserv
            return [(k, f'{key}#c{k}',
                     (rows * k // S, rows * (k + 1) // S))
                    for k in range(S)]
        return [(self._key_server(key), key, None)]

    def _staging(self):
        if self._stage is None:
            from ..parallel._staging import HostStage
            self._stage = HostStage()
        return self._stage

    def _to_host(self, v, key):
        """``v`` (an NDArray, a tensor, or array-like) as a contiguous host
        tensor; a CUDA tensor is copied into this key's pinned buffer."""
        t = v._data if isinstance(v, NDArray) else v
        if not torch.is_tensor(t):
            t = torch.as_tensor(_onp.ascontiguousarray(_onp.asarray(t)))
        t = t.detach()
        if t.device.type == 'cuda':
            return self._staging().to_host(('push', key), t)
        return t.contiguous()

    def _send_value(self, cmd, key, value):
        """``value`` to the server(s) of ``key`` as ``cmd`` (init, push,
        put), split as :meth:`_plan` says."""
        a = self._to_host(value, key)
        for sid, sub, rng in self._plan(key, tuple(a.shape),
                                        a.numel() * a.element_size()):
            part = a if rng is None else a[rng[0]:rng[1]]
            self._rpc_to(sid, {'cmd': cmd, 'key': sub, **_meta(part)},
                         _as_bytes(part))

    # ------------------------------------------------------------- surface
    def init(self, key, value):
        keys = key if isinstance(key, (list, tuple)) else [key]
        vals = value if isinstance(value, (list, tuple)) else [value]
        for k, v in zip(keys, vals):
            self._send_value('init', k, v)

    def push(self, key, value, priority=0):
        # child-only span: a traced caller (telemetry.span around the
        # training step) sees its push/pull legs (and, through the tc
        # injected on each RPC, the server-side apply) as one trace;
        # untraced callers pay one context check
        with _trace.child_span('kvstore.push'):
            self._push(key, value, priority)

    def _push(self, key, value, priority=0):
        keys = key if isinstance(key, (list, tuple)) else [key]
        vals = value if isinstance(value, (list, tuple)) else [value]
        for k, v in zip(keys, vals):
            if isinstance(v, (list, tuple)):   # local replicas: sum first
                v = _reduce([x._data if isinstance(x, NDArray) else x
                             for x in v])
            # no merge buffer, no worker barrier: the server applies this
            # push before replying (async semantics)
            self._send_value('push', k, v)

    def _pull_one(self, sid, sub):
        reply, payload = self._rpc_to(sid, {'cmd': 'pull', 'key': sub})
        return _from_bytes(payload, reply['dtype'], reply['shape'])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        with _trace.child_span('kvstore.pull'):
            return self._pull(key, out, priority, ignore_sparse)

    def _fetch(self, k, tpl):
        """Key ``k``'s value from its server(s) as a host tensor; ``tpl``
        (the out template, or None) decides the split plan."""
        if tpl is not None:
            # split routing is decided from the out template's shape
            # (identical on every worker: the same plan as init/push)
            raw = tpl._data if isinstance(tpl, NDArray) else tpl
            shape = tuple(raw.shape)
            nbytes = raw.element_size() * max(1, int(_onp.prod(shape)))
            plan = self._plan(k, shape, nbytes)
        else:
            plan = self._plan(k, (), 0)
        if len(plan) == 1:
            try:
                return self._pull_one(plan[0][0], plan[0][1])
            except RuntimeError as e:
                # no out template and the key was init'd as a split big
                # array: the unsplit name doesn't exist; fetch the chunks
                # (chunk c lives on server c by plan)
                if 'no such key' not in str(e) or self._nserv == 1:
                    raise
                return torch.cat([self._pull_one(c, f'{k}#c{c}')
                                  for c in range(self._nserv)])
        try:
            return torch.cat([self._pull_one(sid, sub)
                              for sid, sub, _ in plan])
        except RuntimeError as e:
            # the out template's shape/dtype planned a split the pushed
            # array never had (e.g. a wider template dtype crossing
            # bigarray_bound): fall back to the unsplit key on its hash
            # server, mirroring the single-plan fallback above
            if 'no such key' not in str(e):
                raise
            return self._pull_one(self._key_server(k), k)

    def _write(self, k, target, host):
        """The pulled ``host`` value into ``target``: a tensor in place (a
        CUDA one through this key's pinned buffer, without waiting for the
        card), an NDArray rebound to a new tensor on its device."""
        if isinstance(target, NDArray):
            target._rebind(host.to(target._data.device, copy=True))
            return
        with torch.no_grad():
            if target.device.type != 'cuda':
                target.copy_(host.reshape(target.shape))
                return
            stage = self._staging()
            stage.to_host(('pull', k), host.reshape(target.shape))
            stage.to_device(('pull', k), target.device, out=target)

    def _pull(self, key, out=None, priority=0, ignore_sparse=True,
              result=True):
        keys = key if isinstance(key, (list, tuple)) else [key]
        outs = out if isinstance(out, (list, tuple)) else [out]
        results = []
        for k, o in zip(keys, outs):
            tpl = o[0] if isinstance(o, (list, tuple)) else o
            host = self._fetch(k, tpl)
            targets = o if isinstance(o, (list, tuple)) else [o]
            for t in targets:
                if t is not None:
                    self._write(k, t, host)
            if result:
                results.append(NDArray(host.to(self._device, copy=True)))
        if not result:
            return None
        return results if isinstance(key, (list, tuple)) else results[0]

    def pushpull(self, key, value, out=None, priority=0):
        """Async pushpull = push, then pull whatever the server holds:
        other workers' concurrent pushes may or may not be included
        (exactly the reference's dist_async staleness contract)."""
        self.push(key, value, priority)
        with _trace.child_span('kvstore.pull'):
            self._pull(key, out=out if out is not None else value,
                       priority=priority, result=False)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.barrier()
        with _trace.child_span('kvstore.pull'):
            self._pull(key, out=out, priority=priority, result=False)

    def set_optimizer(self, optimizer):
        """Pickle the optimizer to the server(s) (reference
        _send_command_to_servers + kSetMultiPrecision path). Only rank 0
        sends it (the reference likewise issues the server command from
        rank 0 alone, and the Trainer calls this on every rank). Ordering
        is safe: workers cannot push before the broadcast barrier in the
        Trainer's ``_init_params``, which rank 0 only reaches after this
        RPC completes. The request carries the shared-secret token so the
        server will unpickle it."""
        if self._rank != 0:
            return
        self._ensure_connected()
        blob = pickle.dumps(optimizer)
        token = os.environ.get('MXNET_KVSTORE_SECRET', '')
        for sid in sorted(self._chans):
            # every server runs the updater for the keys/chunks it owns
            self._rpc_to(sid, {'cmd': 'set_optimizer', 'token': token},
                         blob)

    def set_updater(self, updater):
        raise NotImplementedError(
            'dist_async runs the updater on the server; use '
            'set_optimizer (reference kvstore_dist.h same restriction)')

    def set_gradient_compression(self, compression_params):
        raise ValueError('gradient compression is not supported on '
                         'dist_async (reference supports it on the sync '
                         'PS path only)')

    def server_stats(self):
        """Per-server key inventory {sid: [keys]}: the sharded layout
        (split chunks appear as 'key#cN')."""
        self._ensure_connected()
        out = {}
        for sid in sorted(self._chans):
            reply, _ = self._rpc_to(sid, {'cmd': 'stats'})
            out[sid] = reply['keys']
        return out

    def server_health(self):
        """Full per-server ``stats`` reply {sid: {...}}: key inventory,
        apply/dedup counters, tombstoned ranks, the fault plan's
        ``faults.injected()`` counters (when one is armed in the server's
        process), the elastic and mesh state, and ``device``: the
        server's device and its update device ms so far."""
        self._ensure_connected()
        out = {}
        for sid in sorted(self._chans):
            reply, _ = self._rpc_to(sid, {'cmd': 'stats'})
            out[sid] = {k: v for k, v in reply.items() if k != 'ok'}
        return out

    def transport_stats(self):
        """Worker-side resilience counters: ``retries`` (resends after
        a transport failure), ``redials`` (socket reconnects),
        ``giveups`` (RPCs that exhausted retries/deadline)."""
        return dict(self._transport_stats)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nproc

    def barrier(self):
        """Explicit rendezvous (reference ps::Postoffice::Barrier), NOT
        implied by push/pull, which never wait for other workers."""
        self._rpc({'cmd': 'barrier', 'nproc': self._nproc})

    # ------------------------------------------------- elastic membership
    def put(self, key, value):
        """Unconditionally overwrite ``key`` on its server(s): the
        rollback/recovery primitive (``init`` is first-write-wins and
        would keep exactly the value being rolled back)."""
        keys = key if isinstance(key, (list, tuple)) else [key]
        vals = value if isinstance(value, (list, tuple)) else [value]
        for k, v in zip(keys, vals):
            self._send_value('put', k, v)

    def elastic_join(self):
        """Enter (or re-enter after a restart) the elastic membership
        group on server 0. Returns the join reply: ``live`` ranks,
        membership ``gen``, last ``committed`` step and the ``resume``
        step this worker participates from (a late joiner sits out any
        in-flight step)."""
        reply, _ = self._rpc({'cmd': 'elastic_join'})
        return {k: v for k, v in reply.items() if k != 'ok'}

    def elastic_leave(self):
        """Cleanly exit the elastic group (planned scale-down)."""
        reply, _ = self._rpc({'cmd': 'elastic_leave'})
        return {k: v for k, v in reply.items() if k != 'ok'}

    def elastic_commit(self, step):
        """Record that the checkpoint for ``step`` is durably committed:
        the step the group re-forms at after a failure."""
        reply, _ = self._rpc({'cmd': 'elastic_commit', 'step': int(step)})
        return int(reply['committed'])

    def elastic_barrier(self, phase, step):
        """Membership-aware rendezvous of the live elastic members for
        ``(phase, step)``. Blocks until every live member expected at
        this step arrives; silently dead members are ejected from the
        group within ``MXNET_KVSTORE_DEADLINE_S`` instead of hanging
        the barrier. Returns the release verdict: ``count`` (the world
        size this step runs at), ``live``, ``gen``, ``committed`` and
        ``changed`` (membership changed since this barrier formed: the
        caller's cue to roll back to the committed step)."""
        self._ensure_connected()
        # the handler legitimately blocks up to the liveness deadline;
        # give the transport room on top of it so a full barrier wait is
        # not misread as a dead server
        budget = _kv_deadline_s() + max(5.0, self._rpc_deadline)
        reply, _ = self._rpc_to(0, {'cmd': 'elastic_barrier',
                                    'phase': str(phase),
                                    'step': int(step)},
                                deadline_s=budget)
        return {k: v for k, v in reply.items() if k != 'ok'}

    # --------------------------------------------------- mesh membership
    def set_mesh_gen(self, gen):
        """Adopt ``gen`` as this store's mesh generation: every
        subsequent data-plane RPC (init/push/pull/put) is stamped with
        it and the server's generation fence rejects it typed
        (:class:`.rpc.StaleGeneration`) once the mesh re-formed past it.
        ``None`` un-stamps (pre-mesh behaviour)."""
        self._mesh_gen = None if gen is None else int(gen)

    def mesh_join(self, meta=None):
        """Join the pod mesh on server 0 (bumps the generation) and
        adopt the new generation. ``meta`` rides along into the
        membership table: mesh config, address, device inventory."""
        header = {'cmd': 'mesh_join'}
        if meta:
            header['meta'] = dict(meta)
        reply, _ = self._rpc(header)
        self.set_mesh_gen(reply['gen'])
        return {k: v for k, v in reply.items() if k != 'ok'}

    def mesh_leave(self):
        """Cleanly exit the mesh (planned scale-down; bumps the
        generation when this rank was actually a member)."""
        reply, _ = self._rpc({'cmd': 'mesh_leave'})
        return {k: v for k, v in reply.items() if k != 'ok'}

    def mesh_epoch(self, eject=(), bump=False):
        """Leader-driven re-formation: eject dead ``ranks`` and bump
        the generation once (idempotent: re-ejecting an already-gone
        rank is a no-op unless ``bump`` forces it). Adopts the new
        generation locally and returns it with the surviving members."""
        reply, _ = self._rpc({'cmd': 'mesh_epoch',
                              'eject': [int(r) for r in eject],
                              'bump': bool(bump)})
        self.set_mesh_gen(reply['gen'])
        return {k: v for k, v in reply.items() if k != 'ok'}

    def mesh_table(self):
        """Current membership as piggybacked on a heartbeat: ``gen`` +
        ``members``, the follower's way to learn a re-formation it did
        not drive."""
        reply, _ = self._rpc({'cmd': 'ping'})
        return reply.get('mesh', {'gen': 0, 'members': []})

    def get_num_dead_node(self, node_id=0, timeout=60):
        """A real failure-detection answer (reference ps-lite
        Postoffice::GetDeadNodes via scheduler heartbeats): unreachable
        servers are pinged NOW; workers count as dead when their
        heartbeat (piggybacked on every RPC + the dedicated ping
        thread) is older than ``timeout`` seconds in server 0's
        last-seen table."""
        self._ensure_connected()
        dead = 0
        for sid in sorted(self._chans):
            try:
                self._rpc_to(sid, {'cmd': 'ping'})
            except Exception:
                dead += 1
        try:
            reply, _ = self._rpc_to(0, {'cmd': 'dead_nodes',
                                        'timeout': timeout})
            dead += int(reply['dead'])
        except Exception:
            pass
        return dead

    @property
    def type(self):
        return 'dist_async'

    @staticmethod
    def is_capable(capability):
        return capability.lower() in ('optimizer', 'init')
