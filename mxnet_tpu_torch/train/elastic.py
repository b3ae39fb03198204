"""Elastic, preemption-tolerant training supervision (``mx.train``).

Counterpart of ``mxnet_tpu/train/elastic.py``, with its three legs:

1. **Async crash-consistent checkpoints**: :class:`ElasticTrainer`
   snapshots the training state ON-step (the cheap phase) and hands the
   serialization to a background :class:`_CheckpointDaemon` thread running
   :class:`~mxnet_tpu_torch.parallel.checkpoint.SharedCheckpointManager`
   saves OFF-step (CheckFreq, FAST '21). The manager's commit protocol
   (staging directory, atomic rename, fsynced manifest) leaves
   ``latest_step()`` on the previous complete checkpoint after a kill at
   any point. Knobs: ``MXNET_CKPT_ASYNC=1`` (default off: synchronous
   saves) and ``MXNET_CKPT_EVERY_S`` (the least seconds between accepted
   saves).

2. **Bit-exact resume**: the checkpoint carries, besides the parameters,
   the ``Trainer``'s state (optimizer slots, update counters,
   lr-scheduler), every random stream (``mx.random.get_state()``: each
   device's generator, the one a captured graph registered included) and
   the data iterator's position (``DataLoader.resumable()``). A run killed
   at step k and resumed trains on the same batches, dropout masks and
   schedule as one that never died. On a card, bit for bit only under
   ``torch.use_deterministic_algorithms(True)`` (with
   ``CUBLAS_WORKSPACE_CONFIG`` set): an embedding's backward adds with
   atomics otherwise, in an order that changes from run to run. A
   hybridized net's graphs are compiled before the restore (a replay
   draws its Dropout masks otherwise than an eager call from one state):
   run a step or two on a placeholder batch first, as a resumed job
   compiles before it loads.

3. **Worker-loss recovery**: :class:`ElasticGroup` drives the
   ``dist_async`` elastic membership protocol, and
   :class:`MeshElasticTrainer` re-forms a sharded run's mesh on the
   surviving hosts.

Where the port differs from the reference, by design:

* **A snapshot copies.** The port updates weights, slots and gradient
  buffers in place (``gluon/parameter.py``), so a snapshot holding a
  reference would be overwritten by the next step while the daemon writes
  it. A whole parameter is copied to the host; a sharded one keeps this
  rank's shard as a device copy (``blocked_ms`` measures the copies).
* **The daemon has a process group of its own.** With sharded parameters
  every rank writes its shards and the commit barriers; run by the daemon
  thread over the training group, that barrier would interleave with the
  main thread's collectives. :class:`ElasticTrainer` gives its manager a
  group made once, at construction, over the manager's ranks.
* **Every live rank runs its shard** under :class:`MeshElasticTrainer`
  (the reference's leader runs the global program under GSPMD and the
  followers only the protocol): each formation of live hosts gets a
  process group of its own (``sharding.context.local_group``) and a
  sharding context inside it, and its lowest rank commits the checkpoint
  once every rank wrote its shards.

Concurrency: the daemon's ``_cv`` is level ``train.ckpt`` in the declared
hierarchy (``analysis/locks.py``) and is tracked under
``MXNET_RACE_CHECK=1``; the serialization runs outside it.
"""

import os
import pickle
import threading
import time

import numpy as _np
from .. import _rng
from .. import profiler as _profiler
from ..telemetry import metrics as _tmetrics
from ..telemetry import trace as _trace
from ..telemetry.metrics import Reservoir

__all__ = ['ElasticHalted', 'ElasticGroup', 'ElasticTrainer',
           'MeshElasticTrainer']


class ElasticHalted(RuntimeError):
    """The live worker count fell below ``MXNET_ELASTIC_MIN_WORKERS``:
    the caller should checkpoint and exit cleanly (the run resumes when
    capacity returns)."""


def _env_flag(name, default='0'):
    return os.environ.get(name, default).strip().lower() in (
        '1', 'true', 'yes', 'on')


class _CheckpointDaemon(threading.Thread):
    """Background serializer: a single-slot mailbox of the newest pending
    snapshot (latest wins: an overwritten pending snapshot is counted
    ``coalesced``, CheckFreq's bounded-lag contract: at most one
    checkpoint behind, never a growing queue)."""

    def __init__(self, manager, stats, stats_lock, name='ckpt-daemon',
                 observe=None):
        super().__init__(daemon=True, name=name)
        self._manager = manager
        self._stats = stats
        self._stats_lock = stats_lock
        self._observe = observe     # serialize-time sink (histogram)
        self._cv = threading.Condition()
        self._pending = None        # (step, tree) | None
        self._busy = False
        self._stopping = False
        self._race = None
        from ..analysis import race as _race
        if _race.enabled():
            self._cv = _race.tracked_condition(self._cv, 'train.ckpt')
            self._race = _race.shared_state(
                'train._CheckpointDaemon._pending', guard=self._cv)

    def submit(self, step, tree):
        with self._cv:
            if self._race is not None:
                self._race.write()
            if self._pending is not None:
                with self._stats_lock:
                    self._stats['coalesced'] += 1
            self._pending = (step, tree)
            self._cv.notify_all()

    def flush(self, timeout=None):
        """Block until the mailbox is empty and no save is in flight.
        Returns False on timeout."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._pending is None and not self._busy,
                timeout=timeout)

    def close(self, timeout=30.0):
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self.join(timeout=timeout)

    def run(self):
        while True:
            with self._cv:
                while self._pending is None and not self._stopping:
                    # bounded slices: close() can race the notify
                    self._cv.wait(timeout=0.5)
                if self._pending is None:
                    return            # stopping and drained
                if self._race is not None:
                    self._race.write()
                step, tree = self._pending
                self._pending = None
                self._busy = True
            t0 = time.perf_counter()
            err = None
            try:
                # outside the cv: the serialization overlaps the training
                # step that is already running
                self._manager.save(step, tree)
            except BaseException as e:      # must keep draining
                err = e
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                if err is None:
                    self._stats['saves'] += 1
                    self._stats['async_saves'] += 1
                    self._stats['last_step'] = step
                else:
                    self._stats['errors'] += 1
                    self._stats['last_error'] = repr(err)
                self._stats['serialize_ms'].add(dt_ms)
            if self._observe is not None:
                self._observe(dt_ms)
            with self._cv:
                self._busy = False
                self._cv.notify_all()


def _sharded(nd):
    return getattr(nd, '_layout', None) is not None


def _own_group(manager):
    """``manager`` with a process group of its own over its ranks (its
    group's; else the active sharding context's; else the world's), made
    here, by those ranks together; the manager itself where there is one
    process."""
    import torch.distributed as dist
    from ..parallel.checkpoint import SharedCheckpointManager
    from ..sharding.context import current
    if not isinstance(manager, SharedCheckpointManager) or \
            not (dist.is_available() and dist.is_initialized()):
        return manager
    g, ctx = manager.group, current()
    if g is not None:
        ranks = dist.get_process_group_ranks(g)
    elif ctx is not None:
        ranks = list(ctx.ranks)
    else:
        ranks = list(range(dist.get_world_size()))
    if len(ranks) == 1:
        return manager
    from ..sharding.context import local_group
    return manager.for_group(local_group(ranks))


class ElasticTrainer:
    """Checkpoint/resume supervisor of one training process (or of one
    rank of a sharded run).

    Wraps a parameter dict, a ``gluon.Trainer`` and a
    :class:`~mxnet_tpu_torch.parallel.checkpoint.SharedCheckpointManager`
    and owns what goes into a checkpoint (the module docstring's leg 2)
    and when it is written (synchronously, or off the step loop).

    ``params`` is a ``{name: Parameter}`` dict (``dict(net.
    collect_params())``); ``data_iter`` is optional and must have
    ``state_dict()`` / ``load_state_dict()`` (``DataLoader.resumable()``'s
    iterator has). Under a process group the ranks make it together: the
    manager gets a group of its own here (see the module docstring).
    """

    def __init__(self, params, trainer, manager, data_iter=None,
                 name='elastic0', async_save=None, every_s=None,
                 clock=time.monotonic):
        self._params = dict(params)
        self._trainer = trainer
        self._manager = _own_group(manager)
        self._data_iter = data_iter
        self._name = name
        self._clock = clock
        self._async = _env_flag('MXNET_CKPT_ASYNC') \
            if async_save is None else bool(async_save)
        if every_s is None:
            try:
                every_s = float(os.environ.get('MXNET_CKPT_EVERY_S', '0'))
            except ValueError:
                every_s = 0.0
        self._every_s = float(every_s)
        self._last_accept = None      # clock time of the last accepted save
        self._stats_lock = threading.Lock()
        # bounded reservoirs: exact count/sum/min/max and a uniform sample
        self._stats = {'saves': 0, 'async_saves': 0, 'coalesced': 0,
                       'throttled': 0, 'errors': 0, 'last_step': -1,
                       'last_error': None,
                       'blocked_ms': Reservoir(512),
                       'serialize_ms': Reservoir(512)}
        self._h_blocked = _tmetrics.histogram('mx_ckpt_blocked_ms',
                                              trainer=name)
        self._h_serialize = _tmetrics.histogram('mx_ckpt_serialize_ms',
                                                trainer=name)
        self._collector_key = _tmetrics.register_collector(
            f'elastic:{name}', self._collect)
        self._daemon = None
        if self._async:
            self._daemon = _CheckpointDaemon(
                self._manager, self._stats, self._stats_lock,
                name=f'ckpt-{name}', observe=self._h_serialize.observe)
            self._daemon.start()
        self._closed = False
        _profiler.attach_checkpoint(name, self.stats)

    @property
    def manager(self):
        """The manager the saves go through (with its own group)."""
        return self._manager

    def _collect(self):
        """Registry collector: the checkpoint counters as Prometheus
        samples (``stats()`` stays the local view)."""
        with self._stats_lock:
            counters = {k: self._stats[k] for k in
                        ('saves', 'async_saves', 'coalesced',
                         'throttled', 'errors')}
        labels = {'trainer': self._name}
        for k, v in counters.items():
            yield ('counter', f'mx_ckpt_{k}_total', labels, v)

    # ---------------------------------------------------------- snapshot
    @staticmethod
    def _snap_param(p):
        """One parameter's snapshot leaf, a copy: the port's updates write
        in place. A whole parameter goes to the host as numpy; a sharded
        one stays a sharded NDArray of a device copy of this rank's shard
        (gathering it to one host on-step would serialize the model
        through one process; every rank writes its own shard)."""
        from ..sharding.dispatch import shard
        nd = p.data()
        if _sharded(nd):
            return shard(nd._data.detach().clone(), nd._layout)
        return nd._data.detach().to('cpu', copy=True).numpy()

    def snapshot(self, step):
        """The checkpoint tree: copies of the parameters (see
        :meth:`_snap_param`), the Trainer's optimizer slots as leaves
        (``slots``, by ``Trainer.sharded_states()``'s keys: host copies,
        or device copies of this rank's pieces where sharded, which
        restore re-cuts for any mesh), and a pickled ``meta`` blob (the
        Trainer's counters and lr-scheduler, the random streams, the
        iterator position, the step), so that no slot is pickled on-step.
        This is the on-step cost of an asynchronous save."""
        from ..sharding.dispatch import shard
        tree = {'params': {n: self._snap_param(p)
                           for n, p in self._params.items()}}
        trainer_state = None
        if self._trainer is not None:
            trainer_state = self._trainer.state_dict(states=False)
            tree['slots'] = {
                k.replace('/', '|'): shard(v._data.detach().clone(),
                                           v._layout)
                if _sharded(v) else
                v._data.detach().to('cpu', copy=True).numpy()
                for k, v in self._trainer.sharded_states().items()}
        meta = {
            'step': int(step),
            'trainer': trainer_state,
            'rng': _rng.get_state(),
            'data_iter': self._data_iter.state_dict()
            if self._data_iter is not None else None,
        }
        tree['meta'] = _np.frombuffer(bytearray(pickle.dumps(meta)),
                                      dtype=_np.uint8)
        return tree

    # -------------------------------------------------------------- save
    def save(self, step, block=False):
        """Checkpoint ``step``. Returns True if a save was accepted.

        Asynchronously: builds the snapshot (the bounded on-step cost,
        recorded as ``blocked_ms``) and mails it to the daemon, whose
        serialization overlaps the next steps. Synchronously: the whole
        save runs here. ``MXNET_CKPT_EVERY_S`` throttles accepted saves;
        ``block=True`` bypasses the throttle and, asynchronously, waits
        for this snapshot to be durable before returning."""
        if self._every_s > 0 and not block \
                and self._last_accept is not None \
                and self._clock() - self._last_accept < self._every_s:
            with self._stats_lock:
                self._stats['throttled'] += 1
            return False
        with _trace.span('ckpt.save', trainer=self._name,
                         step=int(step), sync=self._daemon is None):
            return self._save(step, block)

    def _save(self, step, block):
        t0 = time.perf_counter()
        tree = self.snapshot(step)
        if self._daemon is not None:
            self._daemon.submit(int(step), tree)
            blocked_ms = (time.perf_counter() - t0) * 1e3
            if block:
                self._daemon.flush()
        else:
            err = None
            try:
                self._manager.save(int(step), tree)
            except BaseException as e:
                err = e
            blocked_ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                if err is None:
                    self._stats['saves'] += 1
                    self._stats['last_step'] = int(step)
                else:
                    self._stats['errors'] += 1
                    self._stats['last_error'] = repr(err)
                self._stats['serialize_ms'].add(blocked_ms)
            self._h_serialize.observe(blocked_ms)
            if err is not None:
                raise err
        with self._stats_lock:
            self._stats['blocked_ms'].add(blocked_ms)
        self._h_blocked.observe(blocked_ms)
        self._last_accept = self._clock()
        return True

    def flush(self, timeout=None):
        """Drain any save in flight (a no-op when synchronous). Returns
        False on timeout."""
        if self._daemon is not None:
            return self._daemon.flush(timeout=timeout)
        return True

    # ----------------------------------------------------------- restore
    def restore(self, step=None):
        """Restore the latest (or the given) committed checkpoint into the
        live objects: parameters (each sharded one cut to this rank's shard
        on its current mesh, which may not be the mesh that wrote it),
        Trainer, random streams, iterator position. Returns the restored
        step, or -1 when there is no checkpoint (a cold start: the caller
        trains from its own initialization)."""
        if step is None:
            step = self._manager.latest_step()
        if step is None:
            return -1
        tree = self._manager.restore(int(step))
        params = tree['params']
        for n, p in self._params.items():
            if n not in params:
                raise KeyError(
                    f'checkpoint step {step} has no parameter {n!r}')
            p.set_data(_np.asarray(params[n]))
        meta = pickle.loads(_np.asarray(tree['meta'],
                                        dtype=_np.uint8).tobytes())
        if self._trainer is not None and meta.get('trainer') is not None:
            self._trainer.load_state_dict(meta['trainer'])
            if 'slots' in tree:
                self._trainer.load_sharded_states(
                    {k.replace('|', '/'): v
                     for k, v in tree['slots'].items()})
        if meta.get('rng') is not None:
            _rng.set_state(meta['rng'])
        if self._data_iter is not None \
                and meta.get('data_iter') is not None:
            self._data_iter.load_state_dict(meta['data_iter'])
        with self._stats_lock:
            self._stats['last_step'] = int(meta['step'])
        return int(meta['step'])

    # ------------------------------------------------------------- stats
    def stats(self):
        """A snapshot of the counters and the blocked/serialize times."""
        with self._stats_lock:
            s = dict(self._stats)
            blocked = s.pop('blocked_ms')
            ser = s.pop('serialize_ms')
            s['blocked_ms_avg'] = blocked.mean
            s['blocked_ms_max'] = blocked.max if len(blocked) else 0.0
            s['serialize_ms_avg'] = ser.mean
            s['serialize_ms_max'] = ser.max if len(ser) else 0.0
        return s

    def close(self, timeout=30.0):
        if self._closed:
            return
        self._closed = True
        _tmetrics.unregister_collector(self._collector_key)
        _profiler.detach_checkpoint(self._name)
        if self._daemon is not None:
            self._daemon.close(timeout=timeout)
            self._daemon = None

    def __del__(self):                  # pragma: no cover - GC timing
        try:
            self.close(timeout=1.0)
        except Exception:
            pass


class ElasticGroup:
    """Membership/step-protocol driver over a ``dist_async`` store.

    One instance per worker. The per-step protocol the chaos tests (and
    a real elastic loop) follow::

        group = ElasticGroup(store)           # elastic_join
        step = max(group.resume_step, restored + 1)
        while training:
            pre = group.pre_step(step)        # fixes count for scaling
            ... pull weights, compute grad ...
            store.push(key, -lr * grad / pre['count'])
            post = group.post_step(step)
            if post['changed']:               # membership changed
                step = group.committed + 1    #   mid-step: roll back
                if group.is_leader(post):
                    ... put() checkpointed weights back ...
                continue
            if group.is_leader(post):
                ... save checkpoint, group.commit(step) ...
            step += 1

    A worker that dies silently is ejected inside the barrier wait
    within ``MXNET_KVSTORE_DEADLINE_S``; the release then reports
    ``changed=True`` and the shrunken ``count``. A restarted worker
    re-joins and is scheduled in from the first not-yet-released step
    (it sits out any step already in flight — its gradient would be
    scaled for a world it was not part of).
    """

    def __init__(self, store, min_workers=None):
        if min_workers is None:
            try:
                min_workers = int(os.environ.get(
                    'MXNET_ELASTIC_MIN_WORKERS', '1'))
            except ValueError:
                min_workers = 1
        self._min = max(1, int(min_workers))
        self._store = store
        self._rank = store.rank
        info = store.elastic_join()
        self._gen = info['gen']
        self._committed = int(info['committed'])
        self._resume = int(info['resume'])

    @property
    def rank(self):
        return self._rank

    @property
    def resume_step(self):
        """First step this member participates in (join reply)."""
        return self._resume

    @property
    def committed(self):
        """Last step known checkpoint-committed (join reply / barriers)."""
        return self._committed

    def is_leader(self, verdict):
        """Leader = lowest live rank of the given barrier verdict; the
        leader saves the group checkpoint and performs rollback puts."""
        return self._rank == min(verdict['live'])

    def _barrier(self, phase, step):
        v = self._store.elastic_barrier(phase, step)
        self._gen = v['gen']
        self._committed = int(v['committed'])
        if len(v['live']) < self._min:
            raise ElasticHalted(
                f'{len(v["live"])} live worker(s) < '
                f'MXNET_ELASTIC_MIN_WORKERS={self._min} at '
                f'({phase}, {step}): checkpoint and halt')
        return v

    def barrier(self, phase, step):
        """Named rendezvous of the live members outside the pre/post
        step protocol — mesh re-formation drains ('reform') and rejoins
        ('rejoin') on these. Same ejection/halt semantics as the step
        barriers."""
        return self._barrier(str(phase), int(step))

    def pre_step(self, step):
        """Entry barrier: fixes the gradient-scaling ``count``."""
        return self._barrier('pre', step)

    def post_step(self, step):
        """Exit barrier: ``changed=True`` means the membership moved
        mid-step — roll back to ``committed`` and redo."""
        return self._barrier('post', step)

    def commit(self, step):
        """Record the checkpoint for ``step`` as durable (leader calls
        after the save)."""
        self._committed = self._store.elastic_commit(step)
        return self._committed

    def leave(self):
        """Clean exit (planned scale-down): no ejection wait for peers."""
        self._store.elastic_leave()


def _lost_peer(err):
    """True when ``err`` says a peer of a collective is gone: the watched
    wait gave up, or gloo lost a connection."""
    from ..kvstore.fusion import FormationLost
    if isinstance(err, FormationLost):
        return True
    import torch.distributed as dist
    if isinstance(err, getattr(dist, 'DistError', ())):
        return True
    return isinstance(err, RuntimeError) and 'gloo' in str(err)


class MeshElasticTrainer:
    """One rank of a pod-scale elastic FSDP run.

    Composes the pod layers end to end: a ``dist_async`` store (this
    process's kvstore rank and mesh membership), a
    :class:`~mxnet_tpu_torch.sharding.MeshGroup` (which host owns which
    ranks), an :class:`ElasticGroup` (the per-step membership protocol)
    and an :class:`ElasticTrainer` (crash-consistent sharded checkpoints).
    One process is one rank (``store.rank`` its world rank, a device of
    ``group``); a host is ``group``'s block of ranks, and it is live while
    all of its ranks are.

    ``build(ctx)`` is the model factory, called in every live rank under
    each formation's sharding context; it returns ``{'params': {name:
    Parameter}, 'trainer': gluon.Trainer | None, 'step': fn(step)}`` with
    the parameters already placed on ``ctx``'s mesh (run a warm-up step
    inside) and a Trainer that has not stepped. Each formation of live
    hosts gets a process group of its own and a context inside it
    (``MeshGroup.context(group=...)``), and a second group for its
    checkpoints; nothing after the start reaches the default world, which
    holds the dead ranks.

    After a host death the mesh re-forms through the span tree
    ``mesh.reform`` -> ``detect`` / ``drain`` / ``restore`` and the
    ``rejoin`` barrier: the leader (the lowest live rank) ejects the dead
    ranks with ``mesh_epoch`` (bumping the generation, so the dead host's
    stale pushes reject typed), every survivor drains its checkpoint
    daemon, makes the new formation's groups, rebuilds and restores the
    last committed step (re-sharded onto the smaller mesh), and training
    resumes at ``committed + 1``: bit-exact with a run that never faulted
    at the reduced size, because the restored state and the programs are
    the same.

    A death inside a step's collective fails the collective on the ranks
    connected to the dead ones; each such rank bumps the mesh generation,
    and a rank waiting on a live peer sees that move between the slices
    of its watched wait (:func:`..kvstore.fusion.watching`) and gives up
    too. Every survivor then goes to the step's exit barrier, where the
    dead are ejected within ``MXNET_KVSTORE_DEADLINE_S``: no wait on the
    collective's own timeout. A second death during re-formation re-enters
    the loop (membership strictly shrinks, each barrier is deadline
    bounded: convergence or :class:`ElasticHalted`, never a hang).
    ``MXNET_MESH_REFORM_S`` bounds one re-formation;
    ``MXNET_ELASTIC_MIN_WORKERS`` counts ranks. ``rules`` and ``mode``
    go to each formation's context (BERT: ``bert_partition_rules``). Every
    rank constructs its
    trainer before any calls :meth:`run` (a barrier between the two), so
    that the first step's barrier sees every member.
    """

    def __init__(self, store, group, build, ckpt_dir, tp=None,
                 min_workers=None, name='mesh', rules=None, mode=None):
        self._store = store
        self._rank = store.rank
        self._build = build
        self._dir = ckpt_dir
        self._tp = tp
        self._rules = (rules, mode)
        self._name = name
        self._formed = group
        self._host = group.host_of(self._rank)
        self._groups = None      # (training group, checkpoint group)
        self._gen = None         # the mesh generation the formation saw
        self._broken = False     # a collective of this formation failed
        self._ctx = None
        self._state = None       # build(ctx) result
        self._et = None          # this formation's ElasticTrainer
        from ..parallel.checkpoint import SharedCheckpointManager
        self._manager = SharedCheckpointManager(ckpt_dir)
        self._h_reform = _tmetrics.histogram('mx_mesh_reform_duration_ms',
                                             host=str(self._rank))
        self._reform_s = float(os.environ.get('MXNET_MESH_REFORM_S',
                                              '300'))
        #: per re-formation, seconds of: ``detect`` (the barrier that saw
        #: the change, and a failed step before it), ``drain``,
        #: ``restore`` and ``rejoin``
        self.timings = []
        store.mesh_join(meta={'host': self._host, 'devices': 1})
        self._elastic = ElasticGroup(store, min_workers=min_workers)

    # ------------------------------------------------------------- state
    @property
    def group(self):
        """The current formation (live hosts and generation)."""
        return self._formed

    @property
    def committed(self):
        return self._elastic.committed

    @property
    def state(self):
        """This rank's ``build(ctx)`` result for the current formation."""
        return self._state

    def _live_ranks(self, verdict):
        """The ranks of the hosts all of whose ranks are in ``verdict``."""
        live = set(verdict['live'])
        hosts = [h for h in range(self._formed.n_procs)
                 if set(self._formed.devices_for(h)) <= live]
        return [d for h in hosts for d in self._formed.devices_for(h)], \
            hosts

    def _form(self, hosts):
        """Formation for the live ``hosts``, generation mirrored from the
        kvstore's membership table."""
        from ..sharding.context import MeshGroup
        gen = self._store.mesh_table()['gen']
        return MeshGroup(self._formed.n_procs, self._formed._devices,
                         generation=gen, live=hosts)

    def _context(self):
        if self._ctx is None:
            self._ctx = self._formed.context(
                tp=self._tp, rules=self._rules[0], mode=self._rules[1],
                group=self._groups[0])
        return self._ctx

    def _drop_formation(self):
        """Give up the current formation's groups and objects."""
        from ..sharding.context import abandon
        if self._et is not None:
            self._et.close()
            self._et = None
        if self._groups is not None:
            for g in self._groups:
                abandon(g)
        self._groups = None
        self._ctx = None
        self._state = None

    def _restore_state(self):
        """Make the formation's groups, build the model under its context
        and restore the last committed checkpoint onto it (the
        re-shard-on-restore path when the mesh shrank). Every live rank,
        together."""
        from ..sharding.context import local_group, use as _use
        self._drop_formation()
        train = local_group(self._formed.live_devices())
        self._groups = (train,)
        self._gen = self._store.mesh_table()['gen']
        self._broken = False
        ctx = self._context()
        with _use(ctx):
            st = self._build(ctx)
        self._state = st
        # a name a formation: collectors and histograms key on it; the
        # trainer's manager gets a group of its own beside ``train``
        self._et = ElasticTrainer(
            st['params'], st.get('trainer'),
            self._manager.for_group(train),
            name=f'{self._name}-r{self._rank}-g{self._formed.generation}')
        self._groups = (train, self._et.manager.group)
        return self._et.restore()

    def _watch(self):
        """Between the slices of a watched collective: give it up once the
        mesh generation moved (a peer reported a failed collective, or the
        leader ejected ranks)."""
        from ..kvstore.fusion import FormationLost
        if self._store.mesh_table()['gen'] != self._gen:
            raise FormationLost('the mesh generation moved during a '
                                'collective: a peer is gone')

    def _lost(self):
        """This rank saw a collective fail: tell the others (a generation
        bump they see in their watched waits) and give the formation up."""
        if not self._broken:
            self._broken = True
            self._store.mesh_epoch(bump=True)

    # ------------------------------------------------------------ reform
    def _reform(self, verdict, step, waited=0.0):
        """Mesh re-formation after a membership change (or a failed
        collective). Loops until a formation survives both its barriers
        unchanged. Returns the step training resumes at. ``waited`` is
        how long the barrier (and the failed step before it) that gave
        ``verdict`` took: the detection, counted in :attr:`timings`."""
        t0 = time.perf_counter()
        times = {'detect': float(waited), 'drain': 0.0, 'restore': 0.0,
                 'rejoin': 0.0}
        with _trace.span('mesh.reform', rank=self._rank, step=int(step)):
            while True:
                if time.perf_counter() - t0 > self._reform_s:
                    raise ElasticHalted(
                        'mesh re-formation did not converge within '
                        f'MXNET_MESH_REFORM_S={self._reform_s:g}s')
                live = sorted(verdict['live'])
                t = time.perf_counter()
                with _trace.child_span('mesh.reform.detect',
                                       live=list(live)):
                    ranks, hosts = self._live_ranks(verdict)
                    if self._rank not in ranks:
                        # this rank's host lost another rank: leave
                        self._drop_formation()
                        self._elastic.leave()
                        raise ElasticHalted(
                            f'host {self._host} lost a rank; rank '
                            f'{self._rank} leaves the mesh')
                    dead = [r for r in self._formed.live_devices()
                            if r not in live]
                    if self._elastic.is_leader(verdict):
                        self._store.mesh_epoch(eject=dead)
                times['detect'] += time.perf_counter() - t
                t = time.perf_counter()
                with _trace.child_span('mesh.reform.drain'):
                    if self._et is not None:
                        self._et.flush()
                    v = self._elastic.barrier('reform', step)
                    if sorted(v['live']) != live:
                        verdict = v      # a second death mid-reformation
                        times['drain'] += time.perf_counter() - t
                        continue
                times['drain'] += time.perf_counter() - t
                t = time.perf_counter()
                with _trace.child_span('mesh.reform.restore'):
                    self._store.set_mesh_gen(
                        self._store.mesh_table()['gen'])
                    self._formed = self._form(hosts)
                    self._restore_state()
                times['restore'] += time.perf_counter() - t
                t = time.perf_counter()
                v2 = self._elastic.barrier('rejoin', step)
                times['rejoin'] += time.perf_counter() - t
                if sorted(v2['live']) != live:
                    verdict = v2
                    continue
                break
        self._gen = self._store.mesh_table()['gen']
        self.timings.append(times)
        self._h_reform.observe((time.perf_counter() - t0) * 1e3)
        return self._elastic.committed + 1

    def _changed(self, verdict):
        return verdict.get('changed') or self._broken or \
            sorted(verdict['live']) != self._formed.live_devices()

    # --------------------------------------------------------------- run
    def run(self, num_steps):
        """Drive steps ``resume .. num_steps-1`` through the elastic
        protocol, re-forming the mesh on every membership change. Raises
        :class:`ElasticHalted` when the live rank count falls below
        ``MXNET_ELASTIC_MIN_WORKERS``. Returns the first step not run
        (``num_steps`` on normal completion)."""
        from ..kvstore.fusion import watching
        from ..sharding.context import use as _use
        # staggered mesh_joins left peers on different cached generations:
        # adopt the authoritative one before stepping
        self._store.set_mesh_gen(self._store.mesh_table()['gen'])
        step = max(self._elastic.resume_step,
                   self._elastic.committed + 1)
        num_steps = int(num_steps)
        while step < num_steps:
            t0 = time.perf_counter()
            pre = self._elastic.pre_step(step)
            if sorted(pre['live']) != self._formed.live_devices():
                step = self._reform(pre, step, time.perf_counter() - t0)
                continue
            t0 = time.perf_counter()
            try:
                if self._state is None:
                    self._restore_state()
                with _use(self._context()), watching(self._watch):
                    self._state['step'](step)
            except Exception as e:      # a peer died inside the step
                if not _lost_peer(e):
                    raise
                self._lost()
            t1 = time.perf_counter()
            post = self._elastic.post_step(step)
            if not self._broken and \
                    self._store.mesh_table()['gen'] != self._gen:
                self._broken = True      # a peer's collective failed
            if self._changed(post):
                # a failed step's time counts from its failure's start
                step = self._reform(post, step, time.perf_counter() - (
                    t0 if self._broken else t1))
                continue
            try:
                with watching(self._watch):
                    self._et.save(step, block=True)
            except Exception as e:      # a peer died inside the save
                if not _lost_peer(e):
                    raise
                self._lost()
                step = self._reform(self._elastic.barrier('saved', step),
                                    step)
                continue
            if self._elastic.is_leader(post):
                self._elastic.commit(step)
            step += 1
        return step

    def close(self):
        if self._et is not None:
            self._et.close()
            self._et = None
