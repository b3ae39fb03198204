"""Mixture-of-Experts with expert parallelism over an ``'ep'`` axis.

Counterpart of ``mxnet_tpu/parallel/moe.py`` (Switch/GShard lineage):
tokens are routed by a learned gate to their top two experts, dispatched
into fixed-capacity expert slots (``C = int(cf * T * 2 / E) + 1`` a rank's
``T`` tokens), exchanged so that each rank holds its experts' slots from
every rank, run through the local experts as batched matrix products, sent
back and combined with the gate weights. The router's load-balancing loss
(Shazeer et al.) comes back beside the output, averaged over ``'ep'``.

The JAX package runs the body inside a ``shard_map`` with
``lax.all_to_all``; the port runs it in every rank, one process a rank of
the axis, with the exchange an ``all_to_all_single`` over the axis's
process group (``kvstore.fusion.CrossProcess.all_to_all``: gloo takes it
for host tensors, so a CUDA tensor goes through pinned buffers) inside a
``torch.autograd.Function`` whose backward is the reverse exchange. The
dispatch, the combine and the expert products are ``torch.matmul``/``bmm``
(the reference's are XLA einsums, outside any Pallas kernel). Everything is
differentiable.
"""

import torch

__all__ = ['top2_gating', 'moe_ffn_kernel', 'moe_ffn', 'capacity']


def _gelu(x):
    # jax.nn.gelu's default: the tanh approximation
    return torch.nn.functional.gelu(x, approximate='tanh')


def capacity(n_tokens, n_experts, capacity_factor=1.25):
    """Slots an expert has for ``n_tokens`` routed tokens (top-2: two
    slots a token)."""
    return int(capacity_factor * n_tokens * 2 / n_experts) + 1


def top2_gating(logits, capacity):
    """Top-2 token routing with a fixed expert capacity.

    ``logits``: ``(T, E)``. Returns ``(dispatch (T, E, C) one-hot, combine
    (T, E, C) weights, aux_loss scalar)``; first come, first served."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate1 = torch.argmax(probs, dim=-1)
    mask1 = torch.nn.functional.one_hot(gate1, E).to(probs.dtype)
    probs2 = probs * (1.0 - mask1)
    gate2 = torch.argmax(probs2, dim=-1)
    mask2 = torch.nn.functional.one_hot(gate2, E).to(probs.dtype)

    # load balancing: E * sum_e (share of tokens to e) * (mean prob of e)
    density = mask1.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux_loss = E * torch.sum(density * density_proxy)

    # positions within each expert's buffer
    pos1 = torch.cumsum(mask1, dim=0) - mask1
    mask1 = mask1 * (pos1 < capacity).to(mask1.dtype)
    pos2 = torch.cumsum(mask2, dim=0) - mask2 + mask1.sum(0, keepdim=True)
    mask2 = mask2 * (pos2 < capacity).to(mask2.dtype)

    w1 = (probs * mask1).sum(-1)
    w2 = (probs * mask2).sum(-1)
    denom = torch.clamp(w1 + w2, min=1e-9)
    w1, w2 = w1 / denom, w2 / denom

    def slot(pos, mask):
        return torch.nn.functional.one_hot(
            (pos * mask).sum(-1).to(torch.int64), capacity).to(probs.dtype)
    cap1, cap2 = slot(pos1, mask1), slot(pos2, mask2)
    dispatch = (mask1[..., None] * cap1[:, None, :] +
                mask2[..., None] * cap2[:, None, :])
    combine = (w1[:, None, None] * mask1[..., None] * cap1[:, None, :] +
               w2[:, None, None] * mask2[..., None] * cap2[:, None, :])
    return dispatch, combine, aux_loss


class _AllToAll(torch.autograd.Function):
    """Chunk ``j`` of dim 0 to rank ``j`` of the group; the backward sends
    the gradients back the same way (the exchange is its own adjoint)."""

    @staticmethod
    def forward(fctx, x, comm):
        fctx.comm = comm
        return comm.all_to_all(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.comm.all_to_all(g.contiguous()), None


class _Mean(torch.autograd.Function):
    """The mean over the group's ranks (``lax.pmean``); its adjoint is the
    mean of the gradients."""

    @staticmethod
    def forward(fctx, x, comm):
        fctx.comm = comm
        return comm.psum(x.reshape(1).clone()).reshape(x.shape) / comm._nproc

    @staticmethod
    def backward(fctx, g):
        comm = fctx.comm
        return comm.psum(g.reshape(1).clone()).reshape(g.shape) / \
            comm._nproc, None


def moe_ffn_kernel(x, wg, w_in, w_out, comm, n_experts,
                   capacity_factor=1.25, activation=_gelu):
    """One rank's MoE feed-forward (the reference's ``shard_map`` body).

    ``x``: ``(T_local, D)`` this rank's tokens; ``wg``: ``(D, E)`` the
    router (whole on every rank); ``w_in``: ``(E_local, D, F)`` and
    ``w_out``: ``(E_local, F, D)`` this rank's experts; ``comm``: the
    ``CrossProcess`` of the expert axis, or None for one rank. Returns
    ``(y (T_local, D), aux_loss)``."""
    ep = 1 if comm is None else comm._nproc
    T, D = x.shape
    E = n_experts
    el = E // ep
    C = capacity(T, E, capacity_factor)
    logits = x @ wg
    dispatch, combine, aux = top2_gating(logits, C)
    # (T, E*C)^T (T, D) -> (E, C, D): tokens into their expert slots
    slots = (dispatch.reshape(T, E * C).t() @ x).reshape(E, C, D)
    if comm is not None and ep > 1:
        # (ep, E_local, C, D): rank j's experts' slots go to rank j
        slots = _AllToAll.apply(slots.reshape(ep, el, C, D).contiguous(),
                                comm)
    slots = slots.reshape(ep, el, C, D).transpose(0, 1).reshape(
        el, ep * C, D)
    h = activation(torch.bmm(slots, w_in))
    y = torch.bmm(h, w_out)                          # (E_local, ep*C, D)
    y = y.reshape(el, ep, C, D).transpose(0, 1).contiguous()
    if comm is not None and ep > 1:
        y = _AllToAll.apply(y, comm)                 # back to the owners
    y = y.reshape(E * C, D)
    out = combine.reshape(T, E * C) @ y
    if comm is not None and ep > 1:
        aux = _Mean.apply(aux, comm)
    return out, aux


def moe_ffn(x, wg, w_in, w_out, mesh, axis_name='ep',
            capacity_factor=1.25, activation=_gelu):
    """Expert-parallel MoE feed-forward over a token-sharded batch, this
    rank at its coordinate along ``axis_name`` of ``mesh`` (a
    ``ShardingContext`` or a named ``DeviceMesh``; None runs one rank).

    ``x``: ``(T, D)`` tokens and ``w_in``/``w_out``: ``(E, D, F)`` /
    ``(E, F, D)`` experts, each whole (this rank keeps its tokens and its
    experts, dim 0 split over the axis) or an NDArray sharded so. Returns
    ``(y, aux)``: ``y`` the output laid out as ``x`` (a sharded NDArray of
    this rank's tokens, whose ``asnumpy()`` gathers), ``aux`` the
    load-balancing loss averaged over the axis (a 0-dim tensor)."""
    from ..kvstore.fusion import CrossProcess
    from ..sharding.dispatch import Layout, shard
    from ..sharding.rules import PartitionSpec as P
    from .pipeline import _context, _local, _tensor
    if mesh is None or _context(mesh).size(axis_name) == 1:
        ctx, comm = None, None
    else:
        ctx = _context(mesh)
        comm = CrossProcess.get(ctx.group(axis_name))

    def mine(t):
        return _tensor(t) if ctx is None else _local(t, ctx, P(axis_name))
    xl, wi, wo = mine(x), mine(w_in), mine(w_out)
    n_experts = wi.shape[0] * (1 if comm is None else comm._nproc)
    y, aux = moe_ffn_kernel(xl, _tensor(wg), wi, wo, comm, n_experts,
                            capacity_factor, activation)
    if ctx is None:
        from ..ndarray.ndarray import NDArray
        return NDArray(y), aux
    gshape = (xl.shape[0] * comm._nproc, xl.shape[1])
    return shard(y, Layout(ctx, P(axis_name), gshape)), aux
