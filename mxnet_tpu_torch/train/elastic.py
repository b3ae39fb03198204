"""Worker-loss recovery over ``dist_async`` (``mx.train``).

Counterpart of ``mxnet_tpu/train/elastic.py``'s third leg:
:class:`ElasticGroup` drives the ``dist_async`` elastic membership
protocol (``elastic_join`` / ``elastic_barrier`` / ``elastic_commit`` on
server 0): surviving workers detect a silently dead peer within
``MXNET_KVSTORE_DEADLINE_S`` (heartbeat table + ejection inside the
barrier wait), re-form at the last committed step, rescale gradient
aggregation to the live count, and re-admit a restarted worker from the
latest checkpoint. Below ``MXNET_ELASTIC_MIN_WORKERS`` live workers the
group checkpoint-and-halts (:class:`ElasticHalted`).

The reference's other two legs wait for modules the port does not have
yet (ROADMAP A10 rest): :class:`ElasticTrainer` (asynchronous
crash-consistent checkpoints and bit-exact resume) for
``parallel/checkpoint.py``, and :class:`MeshElasticTrainer` (one host of a
pod-scale elastic FSDP run) for ``sharding/``. Making either raises.
"""

import os

__all__ = ['ElasticHalted', 'ElasticGroup', 'ElasticTrainer',
           'MeshElasticTrainer']


class ElasticHalted(RuntimeError):
    """The live worker count fell below ``MXNET_ELASTIC_MIN_WORKERS``:
    the caller should checkpoint and exit cleanly (the run resumes when
    capacity returns)."""


class _Pending:
    """A class of the reference whose modules are not ported yet."""

    _needs = ''

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f'{type(self).__name__} needs {self._needs}, which is not '
            f'ported yet (ROADMAP A10 rest)')


class ElasticTrainer(_Pending):
    """Checkpoint/resume supervisor of one training process (reference
    ``mxnet_tpu/train/elastic.py:152``): waits for
    ``parallel/checkpoint.py``."""

    _needs = 'parallel/checkpoint.py (SharedCheckpointManager)'


class MeshElasticTrainer(_Pending):
    """One host of a pod-scale elastic FSDP run (reference
    ``mxnet_tpu/train/elastic.py:522``): waits for ``sharding/``."""

    _needs = 'sharding/ (MeshGroup, the FSDP mesh)'


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
