"""Gluon-surface pipeline parallelism: train a ``HybridSequential`` (or a
list of stages) with the 1F1B or GPipe schedule over the ``'pp'`` axis.

Counterpart of ``mxnet_tpu/parallel/gluon_pipeline.py``. The reference
stacks structurally identical stages on a stage axis and runs them as one
SPMD program; the port runs one process a stage (:mod:`.pipeline`), so
each rank keeps and updates only its own stage: every rank builds the whole
net the same way (from one seed, or from given weights), and
:class:`PipelineTrainer` takes its stage's forward as a function of its
parameters (``HybridBlock.pure_function``), drives the schedule, writes
the per-stage gradients (summed over microbatches) into the stage's
``Parameter`` grad buffers and lets a ``gluon.Trainer`` over that stage's
parameters finish the step (Adam: the fused kernel). Stages need not be
structurally identical here, but each must map a microbatch to the same
shape and dtype (the hops carry one shape).
"""

import torch

from .pipeline import (_context, _local, gpipe_local, onef1b_local)

__all__ = ['split_sequential', 'PipelineTrainer']


def split_sequential(net, n_stages):
    """Split a ``HybridSequential``'s children into ``n_stages`` equal
    consecutive groups, each wrapped as its own ``HybridSequential``
    stage. The children count must divide evenly."""
    from ..gluon import nn
    children = list(net._children.values())
    if not children or len(children) % n_stages:
        raise ValueError(
            f'cannot split {len(children)} child blocks into '
            f'{n_stages} equal stages')
    per = len(children) // n_stages
    stages = []
    for s in range(n_stages):
        stage = nn.HybridSequential()
        for c in children[s * per:(s + 1) * per]:
            stage.add(c)
        stages.append(stage)
    return stages


def _sq_err_loss_grad(y, t):
    """Default ``loss_grad_fn``: summed squared error and its gradient."""
    d = (y - t).to(torch.float32)
    return (d * d).sum(), (2.0 * d).to(y.dtype)


class PipelineTrainer:
    """Train Gluon stages as a 1F1B (default) or GPipe pipeline, this rank
    as the stage at its coordinate along ``axis_name`` of ``mesh`` (a
    ``ShardingContext`` or a named ``DeviceMesh``).

    ``stages``: the ``mesh``'s stage count of initialized, shape-preserving
    blocks, or a ``HybridSequential`` to split with
    :func:`split_sequential`; every rank passes the same net. ``example``:
    one microbatch ``(mb, ...)``. ``loss_grad_fn(y, target) -> (loss,
    dL/dy)`` runs at the last stage (default: summed squared error); the
    gradients are the sum over microbatches, and ``step(batch_size)``
    rescales them as ``gluon.Trainer`` does. ``schedule``: ``'1f1b'`` or
    ``'gpipe'``. Stages must not hold mutable aux state (BatchNorm's running
    statistics): the stage forward is pure over (params, x).
    """

    def __init__(self, stages, mesh, example, loss_grad_fn=None,
                 optimizer='sgd', optimizer_params=None, axis_name='pp',
                 schedule='1f1b'):
        from .. import gluon
        from ..ndarray.ndarray import NDArray, array
        ctx = _context(mesh)
        n_stages = ctx.size(axis_name)
        if not isinstance(stages, (list, tuple)):
            stages = split_sequential(stages, n_stages)
        if len(stages) != n_stages:
            raise ValueError(
                f'{len(stages)} stages for a {n_stages}-way '
                f'{axis_name!r} mesh axis')
        if schedule not in ('1f1b', 'gpipe'):
            raise ValueError(f'unknown schedule {schedule!r}')
        for i, st in enumerate(stages):
            if any(p.grad_req == 'null'
                   for p in st.collect_params().values()):
                raise ValueError(
                    f'pipeline stage {i} must not hold mutable aux state '
                    '(e.g. BatchNorm running stats): the stage forward is '
                    'pure over (params, x); use LayerNorm')
        self._ctx = ctx
        self._axis = axis_name
        self._schedule = schedule
        self._loss_grad_fn = loss_grad_fn or _sq_err_loss_grad
        self._stages = list(stages)
        self.stage = ctx.coord(axis_name)
        block = self._stages[self.stage]
        example = example if isinstance(example, NDArray) else array(example)
        pure, _ins, main, _aux = block.pure_function(example, train=True)
        self._pure = pure
        self._params = [p for p in block._cached_graph._params()[0]
                        if p.grad_req != 'null']
        if [tuple(t.shape) for t in main] != \
                [tuple(p.shape) for p in self._params]:
            raise ValueError('stage parameters do not match its forward')
        self._trainer = gluon.Trainer(
            {f'stage{self.stage}.{j}.{p.name}': p
             for j, p in enumerate(self._params)},
            optimizer, optimizer_params)

    @property
    def trainer(self):
        """The ``gluon.Trainer`` over this rank's stage."""
        return self._trainer

    def _stage_fn(self, params, x):
        outs, _ = self._pure(None, (x,), params, ())
        return outs[0]

    def _weights(self):
        return [p.data()._data for p in self._params]

    def _feed(self, xs):
        from ..sharding.rules import PartitionSpec as P
        xs = xs._data if hasattr(xs, '_data') else torch.as_tensor(xs)
        n = int(xs.shape[0])
        if n % self._ctx.size(self._axis):
            raise ValueError(
                f'n_micro ({n}) must be divisible by the stage count '
                f'({self._ctx.size(self._axis)})')
        return _local(xs, self._ctx, P(self._axis),
                      blocks={0: n // self._ctx.size(self._axis)}), n

    def step(self, xs, ys, batch_size=None):
        """One pipelined training step over ``xs`` ``(n_micro, mb, ...)``
        and the matching targets ``ys``: the gradients land in this stage's
        ``Parameter`` grad buffers, then its Trainer updates them
        (``batch_size`` defaults to ``n_micro * mb``). Returns the total
        loss as a float (on every rank)."""
        from ..kvstore.fusion import CrossProcess
        feed, n_micro = self._feed(xs)
        tgt = ys._data if hasattr(ys, '_data') else torch.as_tensor(ys)
        if int(tgt.shape[0]) != n_micro:
            raise ValueError(
                f'ys has {tgt.shape[0]} microbatch targets but xs has '
                f'{n_micro} microbatches')
        weights = self._weights()
        if self._schedule == '1f1b':
            grads, loss = onef1b_local(
                self._stage_fn, self._loss_grad_fn, weights, feed, tgt,
                self._ctx, self._axis, n_micro)
        else:
            leaves = [w.detach().requires_grad_(True) for w in weights]
            outs = gpipe_local(self._stage_fn, leaves, feed, self._ctx,
                               self._axis, n_micro)
            S, k = self._ctx.size(self._axis), self.stage
            local = sum(self._loss_grad_fn(outs[q], tgt[q * S + k])[0]
                        for q in range(outs.shape[0]))
            grads = torch.autograd.grad(local, leaves)
            loss = local.detach().to(torch.float32)
            if S > 1:
                loss = CrossProcess.get(self._ctx.group(self._axis)).psum(
                    loss.reshape(1).clone()).reshape(())
        with torch.no_grad():
            for p, g in zip(self._params, grads):
                p._grad_buffer().copy_(g)
        if batch_size is None:
            batch_size = n_micro * int(feed.shape[1])
        self._trainer.step(batch_size)
        return float(loss)

    def forward(self, xs):
        """Pipelined inference over microbatches (the GPipe schedule):
        ``(n_micro, mb, ...)`` in, the same out, as the port's sharded
        value over the stage axis (``asnumpy()`` gathers it)."""
        from ..sharding.dispatch import Layout, shard
        from ..sharding.rules import PartitionSpec as P
        feed, n_micro = self._feed(xs)
        with torch.no_grad():
            outs = gpipe_local(self._stage_fn, self._weights(), feed,
                               self._ctx, self._axis, n_micro)
        lay = Layout(self._ctx, P(self._axis),
                     (n_micro,) + tuple(feed.shape[1:]),
                     blocks={0: feed.shape[0]})
        return shard(outs, lay)
