"""The collectives of a sharded computation, over one mesh axis's process
group, and their ``autograd.Function`` forms.

Each rank holds its shard; where GSPMD would insert a collective into the
one program, the port calls one here. The transport is the kvstore's,
:class:`..kvstore.fusion.CrossProcess` over the axis's process group:
under gloo a CUDA tensor passes through its pinned host buffers, under
NCCL it goes to the collective as it is, none runs inside a CUDA graph
capture, each is bounded by the process group's timeout
(``parallel.DEFAULT_TIMEOUT_S``) and each adds to its counters. This
module lays the tensors out for it (the pieces of a dim, in blocks).

The autograd forms are Megatron's four operators, named by what the
forward does:

* :class:`AllReduce` sums over the axis, and passes the gradient through
  (a row-parallel product's output, a vocab-parallel lookup, a loss
  reduced over the data axis);
* :class:`Broadcast` passes the value through, and sums the gradient over
  the axis (the input of a column-parallel product, which every rank of
  ``tp`` reads);
* :class:`Gather` concatenates the ranks' pieces along a dim; its backward
  takes this rank's piece of the gradient (``'slice'``: what comes after
  is the same on every rank of the axis) or sums the pieces first
  (``'sum'``: a parameter gathered on the data axis, whose ranks each see
  other rows of the batch);
* :class:`Scatter` keeps this rank's piece; its backward gathers;

and :class:`SumToAll`, a sum whose every rank goes on with computations
of its own (its backward sums the parts those send back).
"""

import torch
import torch.distributed as dist

from ..kvstore.fusion import CrossProcess, counters, reset_counters

__all__ = ['all_reduce', 'all_gather', 'reduce_scatter', 'take',
           'AllReduce', 'Broadcast', 'Gather', 'Scatter', 'SumToAll',
           'counters', 'reset_counters']


def all_reduce(t, group):
    """The sum of ``t`` over the group (a new tensor)."""
    flat = t.clone(memory_format=torch.contiguous_format).view(-1)
    return CrossProcess.get(group).psum(flat).view(t.shape)


def _join(parts, dim, blocks):
    """The pieces of the ranks, in rank order, concatenated along ``dim``:
    with ``blocks`` > 1 each piece holds one part of each of ``blocks``
    equal blocks, and the result is the blocks in order."""
    if blocks == 1:
        return torch.cat(parts, dim)
    chunks = [p.chunk(blocks, dim) for p in parts]
    return torch.cat([c[j] for j in range(blocks) for c in chunks], dim)


def take(t, dim, n, i, blocks=1):
    """Piece ``i`` of ``n`` of ``t`` along ``dim``: with ``blocks`` > 1, the
    ``i``-th part of each of ``blocks`` equal blocks, concatenated."""
    if blocks == 1:
        return t.chunk(n, dim)[i] if t.shape[dim] % n == 0 else \
            t.narrow(dim, i * (t.shape[dim] // n), t.shape[dim] // n)
    return torch.cat([b.chunk(n, dim)[i] for b in t.chunk(blocks, dim)],
                     dim)


def all_gather(t, group, dim, blocks=1):
    """The ranks' pieces of ``t`` concatenated along ``dim``."""
    comm = CrossProcess.get(group)
    full = comm.all_gather(t.contiguous().view(-1))
    return _join(list(full.view(comm._nproc, *t.shape).unbind(0)), dim,
                 blocks)


def reduce_scatter(t, group, dim, index, blocks=1):
    """This rank's piece (``index`` of the group's size) along ``dim`` of
    the sum of ``t`` over the group: one reduce-scatter of the pieces laid
    out rank-major (``index`` is this rank's place in the group)."""
    n = dist.get_world_size(group)
    parts = torch.cat([take(t, dim, n, r, blocks).reshape(-1)
                       for r in range(n)])
    out = CrossProcess.get(group).reduce_scatter(parts)
    return out.view(take(t, dim, n, index, blocks).shape)


def _recording(t):
    return torch.is_grad_enabled() and t.requires_grad


class AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, blocks, index, mode):
        ctx.args = (group, dim, blocks, index, mode)
        return all_gather(t, group, dim, blocks)

    @staticmethod
    def backward(ctx, g):
        group, dim, blocks, index, mode = ctx.args
        n = dist.get_world_size(group)
        if mode == 'sum':
            g = reduce_scatter(g, group, dim, index, blocks)
        else:
            g = take(g, dim, n, index, blocks).contiguous()
        return g, None, None, None, None, None


class Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, blocks, index, n):
        ctx.args = (group, dim, blocks)
        return take(t, dim, n, index, blocks).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim, blocks = ctx.args
        return all_gather(g.contiguous(), group, dim, blocks), None, None, \
            None, None, None


class SumToAll(torch.autograd.Function):
    """A sum over the axis that each rank then uses in a computation of
    its own (BatchNorm's statistics over a split batch): the gradients
    each rank sends back are parts, so the backward sums them too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def sum_to_all(t, group):
    """:class:`SumToAll` where autograd records, else the plain sum."""
    return SumToAll.apply(t, group) if _recording(t) \
        else all_reduce(t, group)


def sum_over(t, group):
    """:class:`AllReduce` where autograd records, else the plain sum."""
    return AllReduce.apply(t, group) if _recording(t) \
        else all_reduce(t, group)


def read_by_all(t, group):
    """:class:`Broadcast` where autograd records, else ``t``."""
    return Broadcast.apply(t, group) if _recording(t) else t


def gather(t, group, dim, blocks, index, mode='slice'):
    """:class:`Gather` where autograd records, else the plain gather."""
    if _recording(t):
        return Gather.apply(t, group, dim, blocks, index, mode)
    return all_gather(t, group, dim, blocks)


def scatter(t, group, dim, blocks, index, n):
    """:class:`Scatter` where autograd records, else the plain piece."""
    if _recording(t):
        return Scatter.apply(t, group, dim, blocks, index, n)
    return take(t, dim, n, index, blocks)
