"""The port's ``dist_async`` parameter server in one process, against the
JAX package.

Every case of ``tests/test_kvstore_faults.py`` (the resilient transport:
retries, the ``(client, seq)`` dedup window, tombstones, the fault-spec
grammar, barriers, the soak) and of ``tests/test_kvstore_elastic.py``
(elastic membership on the server and through ``train.ElasticGroup``,
with the chaos run on a fake clock), and the two ``dist_async`` units of
``tests/test_kvstore.py``, run against the port's store, whose server
keeps its weights on the host here (``device='cpu'``). Where an outcome
can be compared, the same sequence runs through both packages, each on
private ports of its own, and the port must give the JAX package's
result: the store's contents after the same init/push/pull script under
SGD and Adam (rtol 1e-6, the JAX tests' bound for an optimizer), the
parse of the same fault specs, the bytes ``_send_msg`` puts on the wire,
the layout and values of a two-server store with a split big array, the
mesh verbs and their generation fence, the dead-node counts of the
heartbeat table and of a crashed server, and the final weights of the chaos run (exactly equal:
sums of the same fp32 values in the same order).

The JAX soak helper (``benchmark/opperf.py``) imports the JAX package, so
the port's soak is the loop it runs, written out here; its long variant
runs its 200 rounds here in about a second, so it is not marked slow.
"""

import socket
import threading
import time
from contextlib import closing

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu.kvstore import dist_async as jda, faults as jfaults
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkv, optimizer as topt
from mxnet_tpu_torch.kvstore import dist_async, faults, rpc
from mxnet_tpu_torch.kvstore.dist_async import _AsyncServer
from mxnet_tpu_torch.train import ElasticGroup, ElasticHalted

RTOL = 1e-6


def _free_port():
    with closing(socket.socket()) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _ones(n, v=1.0):
    return torch.full((n,), float(v))


def _np(x):
    return x.asnumpy() if hasattr(x, 'asnumpy') else onp.asarray(x)


def _env(monkeypatch, port, rank=0, nproc=1, **env):
    monkeypatch.setenv('MX_COORDINATOR', f'127.0.0.1:{_free_port()}')
    monkeypatch.setenv('MXNET_KVSTORE_ASYNC_PORT', str(port))
    monkeypatch.setenv('MXNET_KVSTORE_HEARTBEAT_S', '3600')
    monkeypatch.setenv('MX_PROC_ID', str(rank))
    monkeypatch.setenv('MX_NPROC', str(nproc))
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def _stop(module, created):
    for kv, _ in created:
        try:
            kv.close()
        except Exception:
            pass
    for _, port in created:
        srv = module._SERVERS.pop(port, None)
        if srv is not None:
            srv.stop()


@pytest.fixture
def async_store(monkeypatch):
    """A port dist_async store on private ports with its server on the
    host and the heartbeat pinger parked (it would race the deterministic
    fault counters), plus guaranteed fault-plan/server cleanup."""
    created = []

    def make(rank=0, **env):
        port = int(env.pop('_port', 0)) or _free_port()
        _env(monkeypatch, port, rank=rank, **env)
        kv = tkv.create('dist_async', device='cpu')
        created.append((kv, port))
        return kv

    yield make
    faults.clear()
    _stop(dist_async, created)


@pytest.fixture
def jax_store(monkeypatch):
    """The JAX package's store, made the same way on ports of its own."""
    created = []

    def make(rank=0, **env):
        port = int(env.pop('_port', 0)) or _free_port()
        _env(monkeypatch, port, rank=rank, **env)
        kv = jkv.create('dist_async')
        created.append((kv, port))
        return kv

    yield make
    jfaults.clear()
    _stop(jda, created)


# ------------------------------------------------- the resilient transport

def test_push_retried_across_reset_applies_exactly_once(async_store):
    """The push is delivered, the reply is lost to an injected connection
    reset, the retry redials and resends, and the server's dedup window
    replays the cached reply instead of applying the gradient twice."""
    kv = async_store()
    kv.init('w', torch.zeros(8))
    faults.configure('reset_after:push:1')
    kv.push('w', _ones(8))
    onp.testing.assert_allclose(_np(kv.pull('w')), onp.ones((8,)))
    health = kv.server_health()[0]
    assert health['counters']['push_applied'] == 1
    assert health['counters']['dedup_replays'] == 1
    assert health['faults']['reset'] == 1
    ts = kv.transport_stats()
    assert ts['retries'] >= 1 and ts['redials'] >= 1
    assert ts['giveups'] == 0


def test_lossy_link_drops_are_retried_to_success(async_store):
    kv = async_store(MXNET_KVSTORE_RPC_BACKOFF_S='0.01')
    kv.init('w', torch.zeros(4))
    faults.configure('drop:push:0.5:seed=1')
    for _ in range(5):
        kv.push('w', _ones(4))
    faults.clear()
    onp.testing.assert_allclose(_np(kv.pull('w')), 5.0)
    assert kv.server_health()[0]['counters']['push_applied'] == 5
    assert kv.transport_stats()['retries'] >= 1


def test_deadline_exceeded_raises_connectionerror_naming_target(
        async_store):
    kv = async_store(MXNET_KVSTORE_RPC_RETRIES='2',
                     MXNET_KVSTORE_RPC_BACKOFF_S='0.01',
                     MXNET_KVSTORE_RPC_DEADLINE_S='20')
    kv.init('w', torch.zeros(2))
    faults.configure('drop:push:1.0')        # every attempt dies
    with pytest.raises(ConnectionError) as ei:
        kv.push('w', _ones(2))
    faults.clear()
    msg = str(ei.value)
    host, port = kv._addrs[0]
    assert f'{host}:{port}' in msg
    assert '3 attempt' in msg                # retries=2 -> 3 attempts
    assert kv.transport_stats()['giveups'] == 1
    # the store is not poisoned: the next call redials and succeeds
    onp.testing.assert_allclose(_np(kv.pull('w')), 0.0)


def test_application_errors_are_not_retried(async_store):
    kv = async_store()
    kv.init('w', torch.zeros(2))
    with pytest.raises(RuntimeError, match='no such key'):
        kv._rpc_to(0, {'cmd': 'pull', 'key': 'missing'})
    assert kv.transport_stats()['retries'] == 0


def test_delay_fault_injects_latency_and_counts(async_store):
    kv = async_store()
    kv.init('w', torch.zeros(2))
    faults.configure('delay:pull:30ms')
    t0 = time.perf_counter()
    kv.pull('w')
    assert time.perf_counter() - t0 >= 0.03
    assert faults.injected()['delay'] >= 1
    faults.clear()


def test_close_tombstones_rank_on_server(async_store):
    kv = async_store()
    kv.init('w', torch.zeros(2))
    srv = kv._server
    kv.close()
    reply, _ = srv._dispatch({'cmd': 'dead_nodes', 'timeout': -1.0}, b'')
    assert reply['dead'] == 0 and reply['departed'] == 1
    reply, _ = srv._dispatch({'cmd': 'stats'}, b'')
    assert reply['tombstones'] == [0]


@pytest.fixture
def bare_server():
    srv = _AsyncServer(0, bind_host='127.0.0.1', sid=0)  # never start()ed
    yield srv
    srv._server.server_close()


def test_tombstoned_rank_ignores_delayed_ping(bare_server):
    srv = bare_server
    srv._dispatch({'cmd': 'ping', 'rank': 5}, b'')
    reply, _ = srv._dispatch({'cmd': 'dead_nodes', 'timeout': -1.0}, b'')
    assert reply['dead'] == 1
    srv._dispatch({'cmd': 'bye', 'rank': 5}, b'')
    srv._dispatch({'cmd': 'ping', 'rank': 5}, b'')   # lands after the bye
    reply, _ = srv._dispatch({'cmd': 'dead_nodes', 'timeout': -1.0}, b'')
    assert reply['dead'] == 0 and reply['departed'] == 1
    assert 5 not in srv._last_seen


def test_tombstone_lifted_by_new_store_data_rpc(bare_server):
    srv = bare_server
    srv._dispatch({'cmd': 'bye', 'rank': 3}, b'')
    srv._dispatch({'cmd': 'ping', 'rank': 3}, b'')
    assert 3 in srv._tombstones and 3 not in srv._last_seen
    srv._dispatch({'cmd': 'push', 'rank': 3, 'key': 'w',
                   'dtype': 'float32', 'shape': [2]},
                  onp.ones(2, 'f').tobytes())
    assert 3 not in srv._tombstones and 3 in srv._last_seen


def _push(srv, seq, val, client='c1', key='w'):
    arr = onp.full((2,), float(val), 'f')
    return srv._dispatch({'cmd': 'push', 'rank': 0, 'key': key,
                          'client': client, 'seq': seq,
                          'dtype': 'float32', 'shape': [2]},
                         arr.tobytes())


def test_dedup_replays_cached_reply_without_reapply(bare_server):
    srv = bare_server
    srv._dispatch({'cmd': 'init', 'rank': 0, 'key': 'w', 'client': 'c1',
                   'seq': 1, 'dtype': 'float32', 'shape': [2]},
                  onp.zeros(2, 'f').tobytes())
    _push(srv, 2, 1.0)
    _push(srv, 2, 1.0)                       # retry of the same seq
    assert srv._counters['push_applied'] == 1
    assert srv._counters['dedup_replays'] == 1
    onp.testing.assert_allclose(srv._store['w'].numpy(), 1.0)
    _push(srv, 3, 1.0)                       # a new seq applies
    onp.testing.assert_allclose(srv._store['w'].numpy(), 2.0)


def _retry_while_applying(srv):
    """A push whose retry arrives while its first attempt is still being
    applied (the client's reply read died at once, as under
    ``reset_every:push``): returns how often the server applied it and
    how often it replayed the reply."""
    gate, inside = threading.Event(), threading.Event()
    handle = srv._handle

    def slow(header, payload, peer='127.0.0.1'):
        if header['cmd'] == 'push' and not inside.is_set():
            inside.set()
            gate.wait(10)
        return handle(header, payload, peer)
    srv._handle = slow
    srv._dispatch({'cmd': 'init', 'rank': 0, 'key': 'w', 'client': 'c1',
                   'seq': 1, 'dtype': 'float32', 'shape': [2]},
                  onp.zeros(2, 'f').tobytes())
    first = threading.Thread(target=_push, args=(srv, 2, 1.0), daemon=True)
    first.start()
    assert inside.wait(5)
    retry = threading.Thread(target=_push, args=(srv, 2, 1.0), daemon=True)
    retry.start()
    retry.join(0.5)         # done at once, or waiting for the first
    gate.set()
    first.join(5)
    retry.join(5)
    assert not first.is_alive() and not retry.is_alive()
    return srv._counters['push_applied'], srv._counters['dedup_replays']


def test_dedup_replays_a_retry_that_arrives_while_applying(bare_server):
    """Exactly once also for a retry of a push still being applied: it
    waits for the first attempt and replays its reply (the JAX package
    applies it twice, ROADMAP C13)."""
    assert _retry_while_applying(bare_server) == (1, 1)
    onp.testing.assert_allclose(bare_server._store['w'].numpy(), 1.0)


def test_C13_jax_dedup_applies_an_in_flight_retry_twice():
    """ROADMAP C13: the JAX package's dedup window holds a reply only
    once its apply has finished, so a retry that arrives meanwhile is
    applied a second time."""
    srv = jda._AsyncServer(0, bind_host='127.0.0.1', sid=0)
    try:
        assert _retry_while_applying(srv) == (2, 0)
        onp.testing.assert_allclose(_np(srv._store['w']), 2.0)
    finally:
        srv._server.server_close()


def test_dedup_window_prunes_oldest_entries(monkeypatch):
    monkeypatch.setenv('MXNET_KVSTORE_DEDUP_WINDOW', '4')
    srv = _AsyncServer(0, bind_host='127.0.0.1', sid=0)
    try:
        for seq in range(1, 8):              # 7 pushes, window of 4
            _push(srv, seq, 1.0)
        assert len(srv._dedup) == 4
        assert ('c1', 7) in srv._dedup and ('c1', 2) not in srv._dedup
        _push(srv, 7, 1.0)
        assert srv._counters['dedup_replays'] == 1
        applied = srv._counters['push_applied']
        _push(srv, 2, 1.0)                   # pruned: applies again
        assert srv._counters['push_applied'] == applied + 1
    finally:
        srv._server.server_close()


def test_dedup_does_not_cache_failed_replies(bare_server):
    srv = bare_server
    reply, _ = srv._dispatch({'cmd': 'nonsense', 'rank': 0,
                              'client': 'c9', 'seq': 1}, b'')
    assert not reply['ok']
    assert ('c9', 1) not in srv._dedup


def test_barrier_duplicate_arrival_is_idempotent(bare_server):
    srv = bare_server
    replies = []

    def arrive(client, seq):
        r, _ = srv._dispatch({'cmd': 'barrier', 'nproc': 2, 'rank': 0,
                              'client': client, 'seq': seq}, b'')
        replies.append(r)

    t1 = threading.Thread(target=arrive, args=('a', 1), daemon=True)
    t1.start()
    time.sleep(0.1)
    t2 = threading.Thread(target=arrive, args=('a', 1), daemon=True)
    t2.start()                               # the duplicate
    time.sleep(0.2)
    with srv._barrier_cv:
        assert srv._barrier_count == 1
    assert t1.is_alive() and t2.is_alive()
    arrive('b', 1)                           # the real second worker
    t1.join(5)
    t2.join(5)
    assert not t1.is_alive() and not t2.is_alive()
    assert all(r['ok'] for r in replies)


# ------------------------------------------------------- the spec grammar

SPECS = ['drop:push:0.3:seed=7;delay:pull:50ms;reset_after:5;'
         'reset_every:push:3;delay:init:0.2s',
         'die_after:push:2:rank=1',
         'kill_host:pull:4:rank=0;partition:push:2:3',
         'partition:1:2;reset_every:4;drop:*:1.0',
         'delay:ping:1ms;delay:barrier:0.25']


def _parse(plan):
    keys = ('n', 'm', 'p', 'duration')
    return [(r.action, r.cmd, r.rank,
             {k: getattr(r, k) for k in keys if hasattr(r, k)})
            for r in plan.rules]


def test_fault_spec_grammar():
    plan = faults.FaultPlan(SPECS[0])
    kinds = [(r.action, r.cmd) for r in plan.rules]
    assert kinds == [('drop', 'push'), ('delay', 'pull'),
                     ('reset_after', None), ('reset_every', 'push'),
                     ('delay', 'init')]
    assert plan.rules[1].duration == pytest.approx(0.05)
    assert plan.rules[4].duration == pytest.approx(0.2)
    assert plan.rules[2].n == 5


@pytest.mark.parametrize('spec', SPECS)
def test_fault_spec_parse_equals_jax(spec):
    """The same spec parses to the same rules in both packages, and the
    seeded drop sequence of the same rule is the same."""
    got, want = faults.FaultPlan(spec), jfaults.FaultPlan(spec)
    assert _parse(got) == _parse(want)
    for r, w in zip(got.rules, want.rules):
        if r.action == 'drop':
            assert [r.rng.random() for _ in range(20)] == \
                [w.rng.random() for _ in range(20)]


@pytest.mark.parametrize('bad', [
    'explode:push:1', 'drop:push:1.5', 'drop:push', 'delay:pull:fast',
    'reset_after:push:0', 'reset_after:a:b:c',
])
def test_fault_spec_rejects_malformed_rules(bad):
    with pytest.raises(faults.FaultSpecError):
        faults.FaultPlan(bad)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultPlan(bad)


def test_fault_spec_from_environment(monkeypatch):
    monkeypatch.setenv('MXNET_KVSTORE_FAULT_SPEC', 'delay:ping:1ms')
    try:
        plan = faults.configure()
        assert plan is not None and plan.rules[0].cmd == 'ping'
        faults.on_send({'cmd': 'ping'})
        assert faults.injected() == {'drop': 0, 'delay': 1, 'reset': 0,
                                     'die': 0, 'kill_host': 0,
                                     'partition': 0, 'total': 1}
    finally:
        faults.clear()
    assert faults.injected() == {}


def test_cmdless_rules_never_match_server_replies():
    plan = faults.FaultPlan('reset_after:1;drop:*:1.0')
    plan.on_send({'ok': True})
    assert plan.injected()['total'] == 0
    with pytest.raises(ConnectionResetError):
        plan.on_send({'cmd': 'push'})


# ----------------------------------------------------------------- framing

@pytest.mark.parametrize('header,payload', [
    ({'cmd': 'push', 'key': 'w', 'dtype': 'float32', 'shape': [2, 3],
      'rank': 1, 'seq': 7, 'client': 'abc'},
     onp.arange(6, dtype='f').tobytes()),
    ({'ok': True, 'dtype': 'float32', 'shape': [0]}, b''),
    ({'cmd': 'ping', 'rank': 0}, b''),
])
def test_send_msg_frames_bytes_as_jax(header, payload):
    """``_send_msg`` writes the JAX package's bytes for the same header
    and payload, and ``_recv_msg`` reads them back."""
    wires = []
    for send in (rpc._send_msg, jda._send_msg):
        a, b = socket.socketpair()
        with a, b:
            send(a, dict(header), payload)
            a.shutdown(socket.SHUT_WR)
            buf = b''
            while True:
                chunk = b.recv(65536)
                if not chunk:
                    break
                buf += chunk
        wires.append(buf)
    assert wires[0] == wires[1]
    a, b = socket.socketpair()
    with a, b:
        a.sendall(wires[0])
        got, body = rpc._recv_msg(b)
    assert got == header and bytes(body) == payload


def test_tensor_payloads_are_the_numpy_bytes():
    """A tensor goes on the wire as numpy's ``tobytes`` of the same
    values, with numpy's dtype name, and comes back as it went."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) * 0.5
    assert bytes(dist_async._as_bytes(x)) == x.numpy().tobytes()
    assert dist_async._meta(x) == {'dtype': 'float32', 'shape': [3, 4]}
    back = dist_async._from_bytes(x.numpy().tobytes(), 'float32', [3, 4])
    assert torch.equal(back, x)
    bf = x.to(torch.bfloat16)
    assert torch.equal(dist_async._from_bytes(
        bytes(dist_async._as_bytes(bf)), 'bfloat16', [3, 4]), bf)


# ------------------------------------------------------------- soak mode

def _soak(async_store, rounds, spec, size, keys):
    kv = async_store(MXNET_KVSTORE_RPC_BACKOFF_S='0.005')
    names = [f'soak{k}' for k in range(keys)]
    for n in names:
        kv.init(n, torch.zeros(size))
    if spec:
        faults.configure(spec)
    one = torch.ones(size)
    for _ in range(rounds):
        for n in names:
            kv.push(n, one)
            kv.pull(n)
    ok = all(onp.allclose(_np(kv.pull(n)), float(rounds)) for n in names)
    counters = kv.server_health()[0]['counters']
    res = dict(verified_exactly_once=ok and counters['push_applied']
               == rounds * keys, server_counters=counters,
               faults=faults.injected(), transport=kv.transport_stats())
    faults.clear()
    return res


def test_kvstore_soak_smoke(async_store):
    res = _soak(async_store, 6, 'reset_every:push:3', size=64, keys=2)
    assert res['verified_exactly_once']
    assert res['server_counters']['push_applied'] == 12
    assert res['faults']['reset'] >= 1
    assert res['transport']['retries'] >= 1


def test_kvstore_soak_long(async_store):
    res = _soak(async_store, 200,
                'reset_every:push:7;drop:push:0.1:seed=5;delay:pull:1ms',
                size=256, keys=3)
    assert res['verified_exactly_once']
    assert res['server_counters']['push_applied'] == 600
    assert res['faults']['reset'] >= 10


def test_barrier_deadline_bounds_missing_peer(async_store):
    kv = async_store(MX_NPROC=2, MXNET_KVSTORE_DEADLINE_S='0.3')
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='barrier timeout'):
        kv.barrier()
    assert time.monotonic() - t0 < 10
    with pytest.raises(RuntimeError, match='barrier timeout'):
        kv.barrier()


def test_close_idempotent_and_gc_safe(async_store):
    kv = async_store()
    kv.init('w', torch.zeros(2))
    hb = kv._hb_thread
    if hb is not None:
        kv._hb_stop.set()
        hb.join(timeout=10)
        assert not hb.is_alive()
    kv.close()
    assert kv._closed
    kv.close()
    kv.__del__()
    kv2 = async_store()
    kv2.close()
    kv2.close()


# ------------------------------------------------------ dist_async units

def test_dist_async_server_bye_removes_rank_from_heartbeats(bare_server):
    srv = bare_server
    srv._dispatch({'cmd': 'ping', 'rank': 5}, b'')
    reply, _ = srv._dispatch({'cmd': 'dead_nodes', 'timeout': -1.0}, b'')
    assert reply['dead'] == 1
    reply, _ = srv._dispatch({'cmd': 'bye', 'rank': 5}, b'')
    assert reply['ok']
    reply, _ = srv._dispatch({'cmd': 'dead_nodes', 'timeout': -1.0}, b'')
    assert reply['dead'] == 0


def test_dist_async_pull_split_plan_falls_back_to_unsplit_key(monkeypatch):
    kv = tkv.KVStoreDistAsync.__new__(tkv.KVStoreDistAsync)
    kv._rank, kv._nproc = 0, 4
    kv._nserv = 2
    kv._big = 8                       # tiny bound: (4,2) f32 = 32 B splits
    kv._device = torch.device('cpu')
    monkeypatch.setattr(kv, '_ensure_connected', lambda: None)
    stored = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    pulls = []

    def fake_pull_one(sid, sub):
        pulls.append((sid, sub))
        if '#c' in str(sub):
            raise RuntimeError(f'no such key {sub!r} on server {sid}')
        return stored

    monkeypatch.setattr(kv, '_pull_one', fake_pull_one)
    out = torch.zeros(4, 2)
    got = kv.pull('w', out=out)
    onp.testing.assert_allclose(_np(got), stored.numpy())
    onp.testing.assert_allclose(out.numpy(), stored.numpy())
    assert any('#c' in str(s) for _, s in pulls)
    assert pulls[-1][1] == 'w'


def test_no_card_and_no_cpu_means_an_error(monkeypatch):
    """The server runs its updates on the card: with none and no
    ``device='cpu'`` (or ``with mx.cpu():``), making the store raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(tmx.MXNetError):
        tkv.create('dist_async')
    assert tkv.create('dist_async', device='cpu')._device.type == 'cpu'
    with tmx.cpu():
        assert tkv.create('dist_async')._device.type == 'cpu'


# --------------------------------------------- the same script, two packages

def _script(kv, mx, opt, arr):
    """init two keys, set the optimizer, three pushes and pulls each."""
    rng = onp.random.default_rng(3)
    w = rng.standard_normal((8,)).astype('f')
    m = rng.standard_normal((4, 3)).astype('f')
    kv.init('w', arr(w))
    kv.init(7, arr(m))
    kv.set_optimizer(opt)
    outs = []
    for _ in range(3):
        gw = rng.standard_normal((8,)).astype('f')
        gm = rng.standard_normal((4, 3)).astype('f')
        kv.push('w', arr(gw))
        kv.push(7, arr(gm))
        outs += [_np(kv.pull('w')), _np(kv.pull(7))]
    return outs


@pytest.mark.parametrize('name,hyper', [
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 0.01}),
    ('adam', {'learning_rate': 0.01, 'wd': 0.001}),
])
def test_store_contents_equal_jax(async_store, jax_store, name, hyper):
    """The same init/push/pull script under the same optimizer leaves the
    same weights on both servers (rtol 1e-6)."""
    got = _script(async_store(), tmx, topt.create(name, **hyper),
                  torch.from_numpy)
    want = _script(jax_store(), jmx, jmx.optimizer.create(name, **hyper),
                   jmx.np.array)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)


def _two_ranks(make, mx, arr):
    """Ranks 0 and 1 of one job in this process, two servers (server 1 in
    rank 1), a 2 KB bound: the big key splits by rows, small keys hash."""
    port = _free_port()
    env = dict(_port=port, MX_NPROC=2, MXNET_KVSTORE_NUM_SERVERS=2,
               MXNET_KVSTORE_BIGARRAY_BOUND=2048)
    kv0 = make(rank=0, **env)
    box = {}
    t = threading.Thread(target=lambda: box.setdefault(
        0, kv0._ensure_connected()), daemon=True)
    t.start()
    time.sleep(0.2)
    kv1 = make(rank=1, **env)
    kv1._ensure_connected()
    t.join(30)
    big = onp.arange(64 * 9, dtype='f').reshape(64, 9)
    kv0.init('emb', arr(big))
    for k in ('a', 'b', 'c', 3):
        kv0.init(k, arr(onp.full((5,), 2.0, 'f')))
    kv1.push('emb', arr(onp.ones((64, 9), 'f')))
    kv0.push('b', arr(onp.ones((5,), 'f')))
    stats = kv0.server_stats()
    vals = [_np(kv1.pull('emb', out=arr(onp.zeros((64, 9), 'f')))),
            _np(kv1.pull('emb')), _np(kv0.pull('b'))]
    return stats, vals


def test_sharding_and_split_equal_jax(async_store, jax_store):
    """Two servers: every key on the server its CRC32 names, the big
    array's row chunks one a server, pulls reassembling them: the same
    layout and values as the JAX package's."""
    got = _two_ranks(async_store, tmx, torch.from_numpy)
    want = _two_ranks(jax_store, jmx, jmx.np.array)
    assert got[0] == want[0]
    assert sorted(got[0][0] + got[0][1]) == sorted(
        ['3', 'a', 'b', 'c', 'emb#c0', 'emb#c1'])
    for g, w in zip(got[1], want[1]):
        onp.testing.assert_array_equal(g, w)


def _mesh(kv):
    out = [kv.mesh_join(meta={'devices': 2}), kv.mesh_table()]
    kv.init('w', _arr_for(kv)(onp.zeros((2,), 'f')))
    out.append(kv.mesh_epoch(bump=True))
    kv.set_mesh_gen(out[0]['gen'])          # a zombie's stale generation
    try:
        kv.push('w', _arr_for(kv)(onp.ones((2,), 'f')))
        out.append('applied')
    except RuntimeError as e:
        out.append(type(e).__name__)
    kv.set_mesh_gen(out[2]['gen'])
    kv.push('w', _arr_for(kv)(onp.ones((2,), 'f')))
    out += [kv.mesh_epoch(eject=[0]), kv.mesh_leave(),
            kv.server_health()[0]['counters']['stale_gen_rejects']]
    return out


def _arr_for(kv):
    return torch.from_numpy if isinstance(kv, tkv.KVStoreDistAsync) \
        else jmx.np.array


def test_mesh_verbs_and_generation_fence_equal_jax(async_store, jax_store):
    """mesh_join/table/epoch/leave replies and the fence that rejects a
    push stamped with a generation older than the server's (typed
    ``StaleGeneration``) are the JAX package's."""
    got, want = _mesh(async_store()), _mesh(jax_store())
    assert got == want
    assert got[3] == 'StaleGeneration' and got[-1] == 1


def _dead_counts(make, arr):
    env = dict(_port=_free_port(), MX_NPROC=2)
    kv0 = make(rank=0, **env)
    kv1 = make(rank=1, **env)
    kv0.init('w', arr(onp.zeros((2,), 'f')))
    kv1.pull('w')
    counts = [kv0.get_num_dead_node(timeout=3600),
              kv0.get_num_dead_node(timeout=-1)]
    kv1.close()                      # bye: departed, never dead
    counts.append(kv0.get_num_dead_node(timeout=-1))
    srv = kv0._server
    reply, _ = srv._dispatch({'cmd': 'dead_nodes', 'timeout': -1.0}, b'')
    return counts + [reply['departed']]


def test_dead_node_counts_equal_jax(async_store, jax_store):
    """Heartbeats: every RPC stamps the rank's last beat, a beat older
    than ``timeout`` counts dead, a closed store departs: the same counts
    in both packages over the same sequence."""
    got = _dead_counts(async_store, torch.from_numpy)
    want = _dead_counts(jax_store, jmx.np.array)
    assert got == want == [0, 2, 1, 1]


def _dead_server(make, module, arr):
    port = _free_port()
    env = dict(_port=port, MX_NPROC=2, MXNET_KVSTORE_NUM_SERVERS=2,
               MXNET_KVSTORE_RPC_RETRIES=0, MXNET_KVSTORE_RPC_DEADLINE_S=2)
    kv0 = make(rank=0, **env)
    t = threading.Thread(target=kv0._ensure_connected, daemon=True)
    t.start()
    time.sleep(0.2)
    kv1 = make(rank=1, **env)
    kv1._ensure_connected()
    t.join(30)
    kv0.init('w', arr(onp.zeros((2,), 'f')))
    counts = [kv0.get_num_dead_node(timeout=3600)]
    module._SERVERS[port + 1].crash()     # server 1 dies with its rank
    counts.append(kv0.get_num_dead_node(timeout=3600))
    module._SERVERS.pop(port + 1).release_port()
    return counts


def test_dead_server_counts_equal_jax(async_store, jax_store):
    """An unreachable server counts as dead at once (its ping fails),
    beside the workers' heartbeats: the same counts as the JAX package's
    in-process store (its multi-process dead-server script fails in the
    driver's runs, ROADMAP C3)."""
    got = _dead_server(async_store, dist_async, torch.from_numpy)
    want = _dead_server(jax_store, jda, jmx.np.array)
    assert got == want == [0, 1]


# ------------------------------------------------------------ elastic units

@pytest.fixture
def elastic_server(monkeypatch):
    """A bare server (never start()ed) on a fake clock with a short
    liveness deadline: every 'second' in these tests is a fake one."""
    monkeypatch.setenv('MXNET_KVSTORE_DEADLINE_S', '5')
    srv = _AsyncServer(0, bind_host='127.0.0.1', sid=0)
    clk = [1000.0]
    srv.set_clock(lambda: clk[0])
    yield srv, clk
    srv._server.server_close()


def _join(srv, rank):
    reply, _ = srv._dispatch({'cmd': 'elastic_join', 'rank': rank}, b'')
    return reply


def _barrier_async(srv, rank, phase, step, out):
    def run():
        reply, _ = srv._dispatch({'cmd': 'elastic_barrier', 'rank': rank,
                                  'phase': phase, 'step': step}, b'')
        out.append(reply)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_join_gen_and_resume_step(elastic_server):
    srv, _clk = elastic_server
    r0 = _join(srv, 0)
    assert r0['ok'] and r0['gen'] == 1 and r0['live'] == [0]
    assert r0['committed'] == -1 and r0['resume'] == 0
    r1 = _join(srv, 1)
    assert r1['gen'] == 2 and r1['live'] == [0, 1]
    again = _join(srv, 0)
    assert again['gen'] == 2 and again['resume'] == 0


def test_leave_pops_member_and_bumps_gen(elastic_server):
    srv, _clk = elastic_server
    _join(srv, 0)
    _join(srv, 1)
    reply, _ = srv._dispatch({'cmd': 'elastic_leave', 'rank': 1}, b'')
    assert reply['live'] == [0] and reply['gen'] == 3
    reply, _ = srv._dispatch({'cmd': 'elastic_leave', 'rank': 1}, b'')
    assert reply['gen'] == 3


def test_commit_is_monotonic(elastic_server):
    srv, _clk = elastic_server
    reply, _ = srv._dispatch({'cmd': 'elastic_commit', 'step': 5}, b'')
    assert reply['committed'] == 5
    reply, _ = srv._dispatch({'cmd': 'elastic_commit', 'step': 3}, b'')
    assert reply['committed'] == 5


def test_barrier_releases_when_all_expected_arrive(elastic_server):
    srv, _clk = elastic_server
    _join(srv, 0)
    _join(srv, 1)
    out = []
    t0 = _barrier_async(srv, 0, 'pre', 0, out)
    time.sleep(0.15)
    assert t0.is_alive() and not out
    t1 = _barrier_async(srv, 1, 'pre', 0, out)
    t0.join(10)
    t1.join(10)
    assert len(out) == 2
    for v in out:
        assert v['ok'] and v['count'] == 2 and v['live'] == [0, 1]
        assert v['changed'] is False


def test_barrier_ejects_silent_member_within_deadline(elastic_server):
    srv, clk = elastic_server
    _join(srv, 0)
    _join(srv, 1)
    out = []
    t = _barrier_async(srv, 0, 'pre', 0, out)
    time.sleep(0.15)
    assert t.is_alive()
    clk[0] += 5.1                           # past the 5 s fake deadline
    t.join(10)
    assert not t.is_alive()
    v = out[0]
    assert v['ok'] and v['live'] == [0] and v['count'] == 1
    assert v['changed'] is True
    assert _join(srv, 0)['gen'] == 3


def test_barrier_is_rerunnable_after_release(elastic_server):
    srv, _clk = elastic_server
    _join(srv, 0)
    _join(srv, 1)
    out = []
    t0 = _barrier_async(srv, 0, 'pre', 7, out)
    t1 = _barrier_async(srv, 1, 'pre', 7, out)
    t0.join(10)
    t1.join(10)
    assert len(out) == 2
    redo = []
    r0 = _barrier_async(srv, 0, 'pre', 7, redo)
    time.sleep(0.15)
    assert r0.is_alive() and not redo
    r1 = _barrier_async(srv, 1, 'pre', 7, redo)
    r0.join(10)
    r1.join(10)
    assert len(redo) == 2 and all(v['ok'] for v in redo)


def test_release_leaves_no_stale_arrivals(elastic_server):
    srv, _clk = elastic_server
    _join(srv, 0)
    _join(srv, 1)
    out = []
    t0 = _barrier_async(srv, 0, 'pre', 7, out)
    time.sleep(0.15)
    t1 = _barrier_async(srv, 1, 'pre', 7, out)
    t0.join(10)
    t1.join(10)
    assert len(out) == 2 and all(v['ok'] for v in out)
    with srv._elastic_cv:
        assert srv._elastic_arrivals.get(('pre', 7), set()) == set()


def test_late_joiner_sits_out_inflight_steps(elastic_server):
    srv, _clk = elastic_server
    _join(srv, 0)
    out = []
    _barrier_async(srv, 0, 'pre', 3, out).join(10)
    assert out[0]['count'] == 1
    r1 = _join(srv, 1)
    assert r1['resume'] == 4
    post = []
    _barrier_async(srv, 0, 'post', 3, post).join(10)
    assert post[0]['ok'] and post[0]['count'] == 1
    assert post[0]['live'] == [0, 1]
    pre4 = []
    t0 = _barrier_async(srv, 0, 'pre', 4, pre4)
    time.sleep(0.15)
    assert t0.is_alive()
    t1 = _barrier_async(srv, 1, 'pre', 4, pre4)
    t0.join(10)
    t1.join(10)
    assert [v['count'] for v in pre4] == [2, 2]


def test_barrier_rejects_nonmember(elastic_server):
    srv, _clk = elastic_server
    reply, _ = srv._dispatch({'cmd': 'elastic_barrier', 'rank': 9,
                              'phase': 'pre', 'step': 0}, b'')
    assert not reply['ok'] and 'not an elastic member' in reply['error']


def test_barrier_wall_timeout_rolls_back_arrival(monkeypatch):
    monkeypatch.setenv('MXNET_KVSTORE_DEADLINE_S', '0.3')
    srv = _AsyncServer(0, bind_host='127.0.0.1', sid=0)
    try:
        _join(srv, 0)
        _join(srv, 1)
        stop = threading.Event()

        def keep_fresh():               # rank 1 beats but never arrives
            while not stop.wait(0.05):
                srv._dispatch({'cmd': 'ping', 'rank': 1}, b'')

        hb = threading.Thread(target=keep_fresh, daemon=True)
        hb.start()
        try:
            reply, _ = srv._dispatch({'cmd': 'elastic_barrier', 'rank': 0,
                                      'phase': 'pre', 'step': 0}, b'')
        finally:
            stop.set()
            hb.join(5)
        assert not reply['ok'] and 'timeout' in reply['error']
        with srv._elastic_cv:
            assert 0 not in srv._elastic_arrivals.get(('pre', 0), set())
    finally:
        srv._server.server_close()


def test_put_overwrites_unlike_init_and_push(async_store):
    kv = async_store()
    kv.init('w', torch.ones(4))
    kv.init('w', _ones(4, 9.0))               # first write wins
    onp.testing.assert_allclose(_np(kv.pull('w')), 1.0)
    kv.push('w', torch.ones(4))               # additive
    onp.testing.assert_allclose(_np(kv.pull('w')), 2.0)
    kv.put('w', _ones(4, 7.0))                # overwrite
    onp.testing.assert_allclose(_np(kv.pull('w')), 7.0)


def test_elastic_group_single_worker_cycle(async_store):
    kv = async_store()
    group = ElasticGroup(kv)
    assert group.rank == 0 and group.resume_step == 0
    assert group.committed == -1
    pre = group.pre_step(0)
    assert pre['count'] == 1 and pre['live'] == [0]
    assert group.is_leader(pre)
    post = group.post_step(0)
    assert post['changed'] is False
    assert group.commit(0) == 0 and group.committed == 0
    group.leave()


def test_elastic_group_halts_below_min_workers(async_store):
    kv = async_store()
    group = ElasticGroup(kv, min_workers=2)
    with pytest.raises(ElasticHalted, match='MXNET_ELASTIC_MIN_WORKERS'):
        group.pre_step(0)


def test_server_stats_report_elastic_state(async_store):
    kv = async_store()
    group = ElasticGroup(kv)
    group.pre_step(0)
    group.post_step(0)
    group.commit(0)
    health = kv.server_health()[0]['elastic']
    assert health['live'] == [0] and health['committed'] == 0
    assert health['step'] == 0 and health['gen'] >= 1


# ------------------------------------------------------------ chaos smoke

DIM = 8
LR = 0.1
N_STEPS = 8
DIE_ON_PUSH = 2       # worker 1's 2nd push == its step-1 gradient


def _grad(step):
    return onp.full((DIM,), 0.01 * (step + 1), 'f')


def _reference_weights():
    w = onp.zeros((DIM,), 'f')
    for s in range(N_STEPS):
        w = w - LR * _grad(s)
    return w


def _worker_loop(kv, group, log, ckpt, arr, stop_at=N_STEPS, gate=None):
    """The elastic step protocol from the ElasticGroup docstring. With
    ``gate`` ``(step, event)`` the worker waits for ``event`` before that
    step (ROADMAP C17: the port runs a step in about a millisecond, so the
    chaos schedule must not hang on how soon a thread is scheduled)."""
    step = max(group.resume_step, group.committed + 1)
    while step < stop_at:
        if gate is not None and step == gate[0]:
            assert gate[1].wait(60), 'the restarted worker never joined'
        pre = group.pre_step(step)
        kv.pull('w')
        kv.push('w', arr(-LR * _grad(step) / pre['count']))
        post = group.post_step(step)
        log.append({'step': step, 'count': post['count'],
                    'live': list(post['live']),
                    'changed': post['changed']})
        if post['changed']:
            if group.is_leader(post):
                kv.put('w', arr(ckpt[group.committed]))
            step = group.committed + 1
            continue
        if group.is_leader(post):
            ckpt[step] = _np(kv.pull('w')).copy()
            group.commit(step)
        step += 1


def _chaos(monkeypatch, create, da, flt, group_cls, arr, late_s=0.0):
    """Worker 1 killed mid-push (``die_after``, no bye), ejected once the
    fake clock passes the deadline, the step rolled back, worker 1's new
    incarnation re-admitted. Returns the final weights, the logs and the
    committed steps.

    The schedule is held by two gates, not by how soon threads run
    (ROADMAP C17): both workers join the group before either steps (the
    port runs all N_STEPS of a lone worker in about 10 ms, so a worker
    thread started late under load joined after the other had finished,
    and its fault never fired), and the survivor waits before step
    ``N_STEPS - 2`` until the restarted incarnation has joined (else it
    finished solo first and re-admitted no one). ``late_s`` starts each
    worker-1 thread that much later, which showed both faults without
    load."""
    port = _free_port()
    _env(monkeypatch, port, nproc=2, MXNET_KVSTORE_DEADLINE_S='30')
    stores, errors = [], []

    def make_store(rank):
        monkeypatch.setenv('MX_PROC_ID', str(rank))
        kv = create()
        stores.append(kv)
        return kv

    try:
        kv0 = make_store(0)
        kv0.init('w', arr(onp.zeros((DIM,), 'f')))
        srv = da._SERVERS[port]
        clk = [time.monotonic()]
        srv.set_clock(lambda: clk[0])
        flt.configure(f'die_after:push:{DIE_ON_PUSH}:rank=1')
        ckpt = {}
        log0, log1a, log1b = [], [], []
        died, rejoined = threading.Event(), threading.Event()
        kv1 = make_store(1)
        group0, group1 = group_cls(kv0), group_cls(kv1)    # the start gate

        def run0():
            try:
                _worker_loop(kv0, group0, log0, ckpt, arr,
                             gate=(N_STEPS - 2, rejoined))
            except BaseException as e:   # noqa: BLE001 - surfaced below
                errors.append(('w0', e))

        def run1_doomed():
            time.sleep(late_s)
            try:
                _worker_loop(kv1, group1, log1a, ckpt, arr)
            except flt.InjectedWorkerDeath:
                died.set()             # dirty death: no bye, no leave
            except BaseException as e:
                errors.append(('w1', e))

        t0 = threading.Thread(target=run0, daemon=True)
        t1 = threading.Thread(target=run1_doomed, daemon=True)
        t0.start()
        t1.start()
        assert died.wait(60), 'fault never fired'
        t1.join(30)
        with srv._elastic_cv:
            assert 1 in srv._elastic_members
        clk[0] += 31                   # past MXNET_KVSTORE_DEADLINE_S
        with srv._elastic_cv:
            assert srv._elastic_cv.wait_for(
                lambda: srv._elastic_committed >= 2, timeout=60)

        def run1_restarted():
            time.sleep(late_s)
            kv1b = make_store(1)
            try:
                group = group_cls(kv1b)
                rejoined.set()
                assert group.committed >= 2
                _worker_loop(kv1b, group, log1b, ckpt, arr)
            except BaseException as e:
                errors.append(('w1b', e))

        t1b = threading.Thread(target=run1_restarted, daemon=True)
        t1b.start()
        t0.join(120)
        t1b.join(120)
        assert not t0.is_alive() and not t1b.is_alive()
        assert errors == []
        return dict(final=_np(kv0.pull('w')).copy(), log0=log0,
                    log1a=log1a, log1b=log1b, ckpt=sorted(ckpt),
                    die=flt.injected()['die'],
                    health=kv0.server_health()[0]['elastic'])
    finally:
        flt.clear()
        for kv in stores:
            try:
                kv.close()
            except Exception:
                pass
        srv = da._SERVERS.pop(port, None)
        if srv is not None:
            srv.stop()


def test_chaos_two_worker_training(monkeypatch):
    """The chaos training run through the port, and through the JAX
    package: worker 1 dies mid-push, the survivor ejects it only once the
    fake clock passes the deadline, rolls back, continues solo and
    re-admits the restarted worker; every step is committed and the final
    weights equal the unfaulted reference's and the JAX run's."""
    import mxnet_tpu.train as jtrain
    got = _chaos(monkeypatch, lambda: tkv.create('dist_async', device='cpu'),
                 dist_async, faults, ElasticGroup, torch.from_numpy)
    want = _chaos(monkeypatch, lambda: jkv.create('dist_async'), jda,
                  jfaults, jtrain.ElasticGroup, jmx.np.array)
    assert got['die'] == 1
    solo = [e for e in got['log0'] if e['live'] == [0]]
    assert solo, 'worker 1 was never ejected'
    readmitted = [e for e in got['log0']
                  if e['live'] == [0, 1] and e['count'] == 2
                  and e['step'] > solo[0]['step']]
    assert readmitted, 'restarted worker 1 was never re-admitted'
    assert [e for e in got['log0'] if e['changed']]
    assert got['ckpt'] == list(range(N_STEPS))
    assert got['health']['committed'] == N_STEPS - 1
    assert got['health']['live'] == [0, 1]
    onp.testing.assert_allclose(got['final'], _reference_weights(),
                                rtol=1e-6, atol=1e-7)
    if got['log1b']:
        assert got['log1b'][0]['step'] > got['log1a'][-1]['step']
    assert want['ckpt'] == got['ckpt']
    onp.testing.assert_array_equal(got['final'], want['final'])


def test_chaos_schedule_holds_when_worker_threads_start_late(monkeypatch):
    """ROADMAP C17 without load: worker 1's threads start 0.3 s late, as a
    loaded machine schedules them. Without the start gate worker 0 ran all
    its steps alone before worker 1 joined ('fault never fired'); without
    the restart gate it finished solo before the restarted worker joined
    ('never re-admitted'). With both, the chaos run is the same run."""
    got = _chaos(monkeypatch, lambda: tkv.create('dist_async', device='cpu'),
                 dist_async, faults, ElasticGroup, torch.from_numpy,
                 late_s=0.3)
    assert got['die'] == 1
    solo = [e for e in got['log0'] if e['live'] == [0]]
    assert solo and solo[0]['step'] == DIE_ON_PUSH - 1
    assert [e for e in got['log0'] if e['live'] == [0, 1]
            and e['count'] == 2 and e['step'] > solo[0]['step']]
    assert got['log1b'] and got['log1b'][0]['step'] == N_STEPS - 2
    assert got['ckpt'] == list(range(N_STEPS))
    onp.testing.assert_allclose(got['final'], _reference_weights(),
                                rtol=1e-6, atol=1e-7)
