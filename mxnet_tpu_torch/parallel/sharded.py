"""Sharded placement and training steps over a mesh of ranks.

Counterpart of ``mxnet_tpu/parallel/sharded.py``. The JAX package places
values on a device mesh (``jax.device_put`` with a ``NamedSharding``) and
compiles one SPMD step with ``jax.jit``; the port runs one process a rank,
so a placed value is this rank's shard (a sharded NDArray, ``mx.sharding``)
and a step runs in every rank, with its gradients summed over ``dp``
through the axis's process group.
"""

import torch

__all__ = ['replicate', 'shard_params', 'make_sharded_train_step',
           'cross_replica_mean']


def _context(mesh):
    from ..sharding.context import ShardingContext
    return mesh if isinstance(mesh, ShardingContext) \
        else ShardingContext.from_mesh(mesh)


def _value(value):
    from ..gluon.parameter import Parameter
    from ..ndarray.ndarray import NDArray, array
    if isinstance(value, Parameter):       # collect_params() dicts
        return NDArray(value._full())
    if isinstance(value, NDArray):
        return value
    if torch.is_tensor(value):
        return NDArray(value)
    return array(value)


def replicate(tree, mesh):
    """Every leaf of a dict or list whole on every rank (NDArrays; a
    sharded leaf is gathered)."""
    from ..sharding.dispatch import gather_value
    del mesh
    if isinstance(tree, dict):
        return {k: gather_value(_value(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_value(_value(v)) for v in tree)
    return gather_value(_value(tree))


def shard_params(params, mesh, rules=None, on_unmatched='replicate'):
    """This rank's shard of each parameter (``{name: NDArray}``), placed by
    ``rules`` (an ``mx.sharding`` table: first match wins) on ``mesh`` (a
    ``ShardingContext`` or a ``DeviceMesh`` with named dims). A thin
    wrapper over ``mx.sharding.match_spec`` and ``resolve_spec``, so that
    this, the hybridize cache and the serving pool agree; an uncovered
    parameter is replicated (``on_unmatched='error'`` raises
    ``UnmatchedParamError``, the registry's contract)."""
    from ..sharding import dispatch
    from ..sharding.rules import match_spec, resolve_spec
    ctx = _context(mesh)
    out = {}
    for name, value in params.items():
        value = _value(value)
        spec = match_spec(name, value.shape, rules,
                          on_unmatched=on_unmatched)
        spec = resolve_spec(spec, value.shape, ctx, name=name)
        out[name] = dispatch.redistribute(value, ctx, spec)
    return out


def make_sharded_train_step(loss_fn, optimizer_step, mesh,
                            donate_params=True):
    """A data-parallel train step over a dict of tensors:
    ``step(params, opt_state, batch, lr) -> (params, opt_state, loss)``.

    ``loss_fn(params, batch)`` is a scalar over this rank's shard of the
    batch (a mean over its rows), and ``optimizer_step(params, grads,
    opt_state, lr) -> (params, opt_state)``; the gradients are the mean
    over ``dp`` of the ranks' (the gradient of the mean over the whole
    batch, as the JAX step's psum gives it), and the loss returned is the
    mean over ``dp``. ``donate_params`` is the JAX step's donation, which
    in-place updates here make moot."""
    ctx = _context(mesh)
    del donate_params

    def step(params, opt_state, batch, lr):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in grads.items()}
        grads = {k: cross_replica_mean(g, 'dp', ctx)
                 for k, g in grads.items()}
        with torch.no_grad():
            params, opt_state = optimizer_step(
                {k: v.detach() for k, v in leaves.items()}, grads,
                opt_state, lr)
        return params, opt_state, cross_replica_mean(loss.detach(), 'dp',
                                                     ctx)

    return step


def cross_replica_mean(x, axis_name='dp', mesh=None):
    """The mean of ``x`` (a tensor) over the ranks of ``axis_name`` of
    ``mesh`` (default: the active ``mx.sharding`` context); ``x`` itself
    where the axis has one rank."""
    from ..sharding import _collectives as C
    from ..sharding.context import current
    ctx = _context(mesh) if mesh is not None else current()
    if ctx is None or ctx.size(axis_name) == 1:
        return x
    return C.all_reduce(x, ctx.group(axis_name)) / ctx.size(axis_name)
