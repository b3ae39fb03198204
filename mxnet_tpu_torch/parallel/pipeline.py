"""Pipeline parallelism: the GPipe and 1F1B schedules over a ``'pp'`` axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``, with its public
functions, arguments and statistics. The JAX package runs every stage as
one SPMD program (a ``lax.scan`` over ticks inside a ``shard_map``) whose
activations move between neighbours by ``lax.ppermute``; the port runs one
process a stage, each rank at its coordinate ``k`` along the stage axis of
a sharding context (``mesh``: a ``ShardingContext`` or a named
``DeviceMesh``), and moves each activation, cotangent, input and output by
a point-to-point send and receive over that axis's process group
(``kvstore.fusion.CrossProcess.send``/``recv``: under gloo a CUDA tensor
is staged through pinned host buffers, as the kvstore and the ring stage
theirs). Sends are asynchronous and each stream (a tag a direction) is
received in microbatch order, so a stage starts microbatch ``t + 1`` while
its neighbour still works on ``t``.

The layout is the reference's: stage parameters are stacked on a leading
stage axis (:func:`stack_stage_params`), and stage ``k`` holds the
interleaved microbatches ``{t : t % S == k}`` of the feed and of the
outputs. The stage that owns microbatch ``t`` sends it to stage 0, and the
last stage sends its output to its owner.

Where the port differs, by design:

* **No bubble work.** The single SPMD program runs ``stage_fn`` on every
  tick, fill and drain included; here a stage computes only its
  ``n_micro`` microbatches. Outputs, per-stage gradients and the total
  loss are the reference's; :func:`pipeline_stats` and
  :func:`onef1b_stats` keep the reference's formulas (of its ticks).
* **Residuals.** The GPipe backward (:func:`pipeline_apply` under
  autograd: one ``torch.autograd.Function`` a stage whose backward runs
  the reverse schedule, cotangents hopping stage to stage) keeps each
  microbatch's forward graph, as the reference's scan transpose keeps its
  residuals; the 1F1B backward uses the graph of the microbatch it
  retires, kept for at most ``S - k`` microbatches in flight, where the
  reference rematerializes from the stored input.
* **Outputs.** :func:`pipeline_apply` returns the port's sharded value: an
  NDArray of this stage's ``(n_micro / S, mb, ...)`` interleaved slots,
  laid out over the stage axis in ``n_micro / S`` blocks, whose
  ``asnumpy()`` gathers the reference's ``(n_micro, mb, ...)`` array.
"""

import collections

import numpy as _np
import torch

__all__ = ['pipeline_apply', 'pipeline_train_1f1b', 'stack_stage_params',
           'pipeline_stats', 'onef1b_stats', 'gpipe_local', 'onef1b_local']

# the streams between two stages, one tag each
_FEED, _ACT, _OUT, _COT, _DFEED, _DOUT = 1, 2, 3, 4, 5, 6


def pipeline_stats(n_micro, n_stages):
    """The reference's schedule figures (of its SPMD kernel's ticks: every
    stage runs every tick, the output circulation's drain included), the
    classic GPipe bubble and the per-stage buffers in microbatches."""
    ticks = max(n_micro, n_micro + 2 * n_stages - 3)
    return {
        'ticks': ticks,
        'bubble_fraction': (ticks - n_micro) / ticks,
        'gpipe_bubble_fraction':
            (n_stages - 1) / (n_micro + n_stages - 1),
        'feed_microbatches_per_stage': n_micro // n_stages,
        'out_microbatches_per_stage': n_micro // n_stages,
        'carrier_microbatches': 3,
    }


def onef1b_stats(n_micro, n_stages):
    """The reference's 1F1B figures: its ticks and bubble, and the per-stage
    residual window (O(S) microbatches, against GPipe's O(n_micro))."""
    ticks = n_micro + 2 * (n_stages - 1)
    return {
        'ticks': ticks,
        'bubble_fraction': (ticks - n_micro) / ticks,
        'residual_microbatches_per_stage': 2 * n_stages - 1,
        'gpipe_residual_microbatches_per_stage': n_micro,
    }


# ------------------------------------------------------------------ trees
def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in tree for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return next(it)


def _tensor(x):
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(_np.ascontiguousarray(x))


def stack_stage_params(param_list):
    """Stack a list of per-stage parameter trees along a new leading axis
    (the stage axis)."""
    leaves = [_leaves(p) for p in param_list]
    stacked = [torch.stack([_tensor(ls[j]) for ls in leaves])
               for j in range(len(leaves[0]))]
    return _rebuild(param_list[0], iter(stacked))


# ------------------------------------------------------------- placement
def _context(mesh):
    from .sharded import _context as ctx_of
    return ctx_of(mesh)


def _local(x, ctx, spec, blocks=None):
    """This rank's piece of ``x`` at ``spec`` (a differentiable cut of a
    whole tensor; a sharded NDArray's own shard, which must be laid out
    so)."""
    from ..ndarray.ndarray import NDArray
    from ..sharding.dispatch import Layout, cut
    if isinstance(x, NDArray) and x._layout is not None:
        return x._data
    t = _tensor(x)
    return cut(t, Layout(ctx, spec, t.shape, blocks=blocks))


def _spec_axes(spec):
    used = set()
    for s in spec or ():
        if s is None:
            continue
        used.update(s if isinstance(s, (tuple, list)) else (s,))
    return used


def _prepare(stage_params, xs, ctx, axis, param_specs, data_spec):
    """``(S, k, n_micro, n_loc, local params tree, specs, local feed)``."""
    from ..sharding.rules import PartitionSpec as P
    S = ctx.size(axis)
    n_micro = int(xs.shape[0])
    if n_micro % S:
        raise ValueError(
            f'n_micro ({n_micro}) must be divisible by the stage count '
            f'({S})')
    leaves = _leaves(stage_params)
    if param_specs is None:
        specs = [P(axis)] * len(leaves)
    else:
        specs = _leaves_specs(param_specs)
        for s in specs:
            if not s or s[0] != axis:
                raise ValueError(
                    f'param_specs leaves must lead with {axis!r} (the '
                    f'stacked stage axis); got {s}')
    local = [_local(p, ctx, s).squeeze(0) for p, s in zip(leaves, specs)]
    n_loc = n_micro // S
    feed = _local(xs, ctx, P(axis) if data_spec is None else data_spec,
                  blocks={0: n_loc})
    return (S, ctx.coord(axis), n_micro, n_loc,
            _rebuild(stage_params, iter(local)), specs, feed)


def _leaves_specs(tree):
    from ..sharding.rules import PartitionSpec as P
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in tree for v in _leaves_specs(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves_specs(x)]
    return [tree]


class _Hops:
    """The point-to-point streams of one schedule run over the stage
    axis's group (its rank j is stage j)."""

    def __init__(self, ctx, axis):
        self._where = (ctx, axis)
        self._comm = None
        self.sent = []

    @property
    def comm(self):
        if self._comm is None:        # one stage never hops
            from ..kvstore.fusion import CrossProcess
            ctx, axis = self._where
            self._comm = CrossProcess.get(ctx.group(axis))
        return self._comm

    def send(self, t, to, tag, t_idx):
        self.sent.append(self.comm.send(t.detach(), to, tag=tag,
                                        key=(tag, t_idx)))

    def recv(self, like, frm, tag):
        return self.comm.recv(like, frm, tag=tag, key=tag)

    def finish(self):
        """Wait for every send of this run (their buffers are free after)."""
        from ..kvstore.fusion import wait
        for w in self.sent:
            wait(w)
        self.sent = []


def _run_stage(stage_fn, params, x):
    """``stage_fn`` on leaves made fresh autograd leaves: returns the
    leaves of the input and the parameters, and the output with its graph
    (for this stage's backward of this microbatch)."""
    with torch.enable_grad():
        x_ = x.detach().requires_grad_(True)
        leaves = [p.detach().requires_grad_(p.is_floating_point())
                  for p in _leaves(params)]
        y = stage_fn(_rebuild(params, iter(leaves)), x_)
    return x_, leaves, y


def _backward_stage(x_, leaves, y, dy):
    ins = [x_] + [p for p in leaves if p.requires_grad]
    grads = torch.autograd.grad(y, ins, dy, allow_unused=True)
    gx = grads[0] if grads[0] is not None else torch.zeros_like(x_)
    gp, it = [], iter(grads[1:])
    for p in leaves:
        g = next(it) if p.requires_grad else None
        gp.append(torch.zeros_like(p) if g is None else g)
    return gx, gp


# ------------------------------------------------------------------ GPipe
class _GPipe(torch.autograd.Function):
    """One stage's GPipe schedule; its backward is the reverse schedule
    (every stage of the axis runs it together, as autograd reaches it)."""

    @staticmethod
    def forward(fctx, run, feed, *params):
        stage_fn, tree, hops_of, S, k, n_micro = run
        local_params = _rebuild(tree, iter(params))
        n_loc = feed.shape[0]
        hops = hops_of()
        like = feed[0]
        if k != 0:                      # the feed this stage owns -> 0
            for q in range(n_loc):
                hops.send(feed[q], 0, _FEED, q * S + k)
        kept, outs = [], [None] * n_loc
        train = any(fctx.needs_input_grad)
        for t in range(n_micro):
            if k == 0:
                x = feed[t // S] if t % S == 0 else \
                    hops.recv(like, t % S, _FEED)
            else:
                x = hops.recv(like, k - 1, _ACT)
            if train:
                x_, leaves, y = _run_stage(stage_fn, local_params, x)
                kept.append((x_, leaves, y))
            else:
                y = stage_fn(local_params, x)
            if k < S - 1:
                hops.send(y, k + 1, _ACT, t)
            elif t % S == k:
                outs[t // S] = y.detach()
            else:
                hops.send(y, t % S, _OUT, t)
        for q in range(n_loc):
            if k != S - 1:
                outs[q] = hops.recv(like, S - 1, _OUT)
        hops.finish()
        fctx.run = run
        fctx.kept = kept
        fctx.n_params = len(params)
        return torch.stack(outs)

    @staticmethod
    def backward(fctx, d_outs):
        stage_fn, tree, hops_of, S, k, n_micro = fctx.run
        del stage_fn, tree
        hops = hops_of()
        n_loc = d_outs.shape[0]
        like = d_outs[0]
        if k != S - 1:                  # owned output gradients -> last
            for q in range(n_loc):
                hops.send(d_outs[q], S - 1, _DOUT, q * S + k)
        gsum = None
        d_feed = [None] * n_loc
        for t in range(n_micro):
            if k == S - 1:
                dy = d_outs[t // S] if t % S == k else \
                    hops.recv(like, t % S, _DOUT)
            else:
                dy = hops.recv(like, k + 1, _COT)
            x_, leaves, y = fctx.kept[t]
            gx, gp = _backward_stage(x_, leaves, y, dy)
            fctx.kept[t] = None
            gsum = gp if gsum is None else [a + b for a, b in zip(gsum, gp)]
            if k > 0:
                hops.send(gx, k - 1, _COT, t)
            elif t % S == 0:
                d_feed[t // S] = gx
            else:
                hops.send(gx, t % S, _DFEED, t)
        for q in range(n_loc):
            if k != 0:
                d_feed[q] = hops.recv(like, 0, _DFEED)
        hops.finish()
        return (None, torch.stack(d_feed)) + tuple(gsum)


def gpipe_local(stage_fn, params, feed, ctx, axis_name, n_micro):
    """The GPipe schedule of this stage: ``params`` its own (a tree of
    tensors), ``feed`` its ``(n_micro / S, mb, ...)`` interleaved inputs;
    returns its interleaved outputs, differentiable (see
    :func:`pipeline_apply`)."""
    leaves = _leaves(params)

    def hops_of():
        return _Hops(ctx, axis_name)
    run = (stage_fn, params, hops_of, ctx.size(axis_name),
           ctx.coord(axis_name), int(n_micro))
    return _GPipe.apply(run, feed, *leaves)


def pipeline_apply(stage_fn, stage_params, xs, mesh, axis_name='pp',
                   param_specs=None, data_spec=None):
    """Run the stages as a GPipe pipeline, this rank as stage ``k``.

    ``stage_fn(params, x) -> y``: one stage, shape-preserving.
    ``stage_params``: a tree whose leaves lead with the stage axis (stage
    i's weights at index i), whole tensors (this rank takes its piece) or
    NDArrays sharded over the axis. ``xs``: ``(n_micro, microbatch, ...)``
    inputs, whole (this rank keeps its interleaved shard) or sharded so.
    ``param_specs``/``data_spec``: as the reference (leaves lead with
    ``axis_name``; other axes cut the stage's pieces further).

    Returns the outputs as a sharded NDArray (see the module docstring).
    Differentiable: a backward through it (every stage calls it) runs the
    reverse schedule and fills the gradients of ``stage_params`` and
    ``xs``."""
    from ..sharding.dispatch import Layout, shard
    from ..sharding.rules import PartitionSpec as P
    ctx = _context(mesh)
    _S, _k, n_micro, n_loc, params, _specs, feed = _prepare(
        stage_params, xs, ctx, axis_name, param_specs, data_spec)
    outs = gpipe_local(stage_fn, params, feed, ctx, axis_name, n_micro)
    gshape = (n_micro,) + tuple(_tensor(xs).shape[1:]) \
        if not hasattr(xs, '_layout') or xs._layout is None \
        else tuple(xs._layout.gshape)
    lay = Layout(ctx, P(axis_name) if data_spec is None else data_spec,
                 gshape, blocks={0: n_loc})
    return shard(outs, lay)


# ------------------------------------------------------------------- 1F1B
def pipeline_train_1f1b(stage_fn, loss_grad_fn, stage_params, xs, ys,
                        mesh, axis_name='pp', param_specs=None,
                        data_spec=None, target_spec=None, loss_axes=None):
    """One 1F1B (PipeDream-flush) training step, this rank as stage ``k``:
    ``S - k - 1`` warm-up forwards, then one forward and one backward in
    turn, then the cool-down backwards; the last stage backwards each
    microbatch right after its forward, seeded by
    ``loss_grad_fn(y, target) -> (loss, dL/dy)``.

    ``ys``: ``(n_micro, ...)`` targets (whole, replicated; or cut by
    ``target_spec``). Returns ``(grads, loss)``: this stage's parameter
    gradients summed over microbatches, as sharded NDArrays laid out as
    ``stage_params`` (``asnumpy()`` gathers the stacked
    ``(n_stages, ...)`` gradients), and the total loss (a 0-dim tensor on
    every rank), summed over ``loss_axes`` (default: the stage axis). An
    extra loss axis (a data axis such as ``'sp'``) also sums each
    parameter's gradient where its spec does not split that axis."""
    from ..kvstore.fusion import CrossProcess
    from ..sharding.dispatch import Layout, shard
    from ..sharding.rules import PartitionSpec as P
    n_micro = int(xs.shape[0])
    if int(ys.shape[0]) != n_micro:
        raise ValueError(
            f'ys has {ys.shape[0]} microbatch targets but xs has '
            f'{n_micro} microbatches')
    ctx = _context(mesh)
    _S, _k, n_micro, _n_loc, params, specs, feed = _prepare(
        stage_params, xs, ctx, axis_name, param_specs, data_spec)
    tgt = _local(ys, ctx, P() if target_spec is None else target_spec)
    gsum, loss = onef1b_local(stage_fn, loss_grad_fn, params, feed, tgt,
                              ctx, axis_name, n_micro)
    for a in (loss_axes or (axis_name,)):
        if ctx.size(a) > 1 and a != axis_name:
            loss = CrossProcess.get(ctx.group(a)).psum(
                loss.reshape(1).clone()).reshape(())
    extra = [a for a in (loss_axes or ()) if a != axis_name]
    out = []
    for p, g, spec in zip(_leaves(stage_params), gsum, specs):
        for a in extra:
            if a not in _spec_axes(spec) and ctx.size(a) > 1:
                g = CrossProcess.get(ctx.group(a)).psum(
                    g.contiguous().clone())
        gshape = tuple(p._layout.gshape) if getattr(p, '_layout', None) \
            is not None else tuple(_tensor(p).shape)
        out.append(shard(g.unsqueeze(0), Layout(ctx, spec, gshape)))
    return _rebuild(stage_params, iter(out)), loss


def onef1b_local(stage_fn, loss_grad_fn, params, feed, tgt, ctx,
                 axis_name, n_micro):
    """The 1F1B schedule of this stage: ``params`` its own tree of
    tensors, ``feed`` its interleaved inputs, ``tgt`` the targets (indexed
    by microbatch). Returns ``(gradients, loss)``: the gradients of
    ``params``' leaves summed over microbatches, and the total loss summed
    over the stage axis (on every stage)."""
    from ..kvstore.fusion import CrossProcess
    S, k = ctx.size(axis_name), ctx.coord(axis_name)
    n_loc = feed.shape[0]
    hops = _Hops(ctx, axis_name)
    like = feed[0]
    if k != 0:
        for q in range(n_loc):
            hops.send(feed[q], 0, _FEED, q * S + k)
    inflight = collections.deque()
    seeds = {}
    gsum = None
    loss = torch.zeros((), dtype=torch.float32, device=like.device)

    def forward(t):
        nonlocal loss
        if k == 0:
            x = feed[t // S] if t % S == 0 else hops.recv(like, t % S, _FEED)
        else:
            x = hops.recv(like, k - 1, _ACT)
        x_, leaves, y = _run_stage(stage_fn, params, x)
        inflight.append((t, x_, leaves, y))
        if k < S - 1:
            hops.send(y, k + 1, _ACT, t)
        else:
            with torch.no_grad():
                mb_loss, seed = loss_grad_fn(y.detach(), tgt[t])
            loss = loss + mb_loss.to(loss.dtype)
            seeds[t] = seed

    def backward(t):
        nonlocal gsum
        t0, x_, leaves, y = inflight.popleft()
        assert t0 == t
        dy = seeds.pop(t) if k == S - 1 else hops.recv(like, k + 1, _COT)
        gx, gp = _backward_stage(x_, leaves, y, dy)
        gsum = gp if gsum is None else [a + b for a, b in zip(gsum, gp)]
        if k > 0:
            hops.send(gx, k - 1, _COT, t)

    warm = min(S - k - 1, n_micro)
    for t in range(warm):
        forward(t)
    for i in range(n_micro - warm):
        forward(warm + i)
        backward(i)
    for t in range(n_micro - warm, n_micro):
        backward(t)
    hops.finish()
    # the total loss lives on the last stage: share it over the axis
    if S > 1:
        loss = CrossProcess.get(ctx.group(axis_name)).psum(
            loss.reshape(1).clone()).reshape(())
    return gsum, loss
