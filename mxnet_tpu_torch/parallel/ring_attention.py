"""Ring attention: sequence parallelism over a ring of ranks.

Counterpart of the JAX package's ``parallel/ring_attention.py``. The
sequence axis is sharded over the mesh dim ``sp``: each rank holds the
Q/K/V blocks of its shard, the K/V blocks travel round the ring (rank r
sends to r + 1 and receives from r - 1), and each rank folds every block
that reaches it into its running online-softmax state (m, l, o). On a
CUDA tensor each block goes through the flash-attention stats kernel
(``csrc/flash_attention.cu``, :func:`..ops.kernels.flash_attention_stats`),
so the (S_local, S_local) score matrix never reaches device memory. The
receive and send of the next block are posted before the current block is
computed and waited for after it, so the transfer overlaps the compute.

The JAX function takes global arrays sharded by ``shard_map``; here SPMD
is one process per rank, so :func:`ring_attention` takes and returns this
rank's shards. Its gradient is the JAX function's (``jax.grad`` through
the stats form's recomputing vjp and the transposed ``ppermute``): under
autograd the ring is one node whose backward sends the K/V blocks round
the ring the other way, each carrying its dK/dV, and recomputes every
block's share in plain PyTorch.
"""

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..ops.kernels import needs_grad
from ..ops.kernels.flash_attention import flash_attention_stats
from ._staging import HostStage, refuse_capture, staged

__all__ = ['ring_attention', 'ring_attention_kernel']


def _online_block(q, k, v, m_prev, l_prev, o_prev, scale, mask=None):
    """One blockwise-softmax accumulation step.

    q: (B, H, Sq, D); k/v: (B, H, Sk, D); running max m, denom l, out o.
    """
    s = torch.einsum('bhqd,bhkd->bhqk', q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, -torch.inf)
    m_cur = s.amax(-1)
    m_new = torch.maximum(m_prev, m_cur)
    # guard fully-masked rows (all -inf)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l_cur = p.sum(-1)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe),
                        0.0)
    l_new = l_prev * alpha + l_cur
    o_new = o_prev * alpha[..., None] + torch.einsum('bhqk,bhkd->bhqd', p, v)
    return m_new, l_new, o_new


def _merge_stats(m, l, o, acc_b, m_b, l_b):
    """Fold one block's (unnormalized out, max, denom) into the running
    accumulator: the cross-rank half of the online softmax."""
    m_new = torch.maximum(m, m_b)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    a = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    b = torch.where(torch.isfinite(m_b), torch.exp(m_b - m_safe), 0.0)
    l_new = a * l + b * l_b
    o_new = a[..., None] * o + b[..., None] * acc_b
    return m_new, l_new, o_new


class _Ring:
    """The rotation of one packed block, ``(n, B, H, S_local, D)``, round
    the ranks of ``group``: :meth:`start` posts the receive from the
    neighbour on one side and the send of the block held now to the other,
    :meth:`finish` waits for both and returns the block that arrived. The
    forward's K/V travel to rank + 1; ``reverse`` sends them to rank - 1,
    as the backward does.

    The transport follows the group's backend (``_staging.staged``): NCCL
    takes the CUDA tensors as they are, gloo host tensors, and CUDA tensors
    under gloo pass through two pinned host buffers (one send, one
    receive; they swap after each step), with the arrived block copied to
    the card without blocking the host."""

    def __init__(self, parts, group, reverse=False):
        self.group = group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        step = -1 if reverse else 1
        self.send_to = dist.get_global_rank(group, (rank + step) % world)
        self.recv_from = dist.get_global_rank(group, (rank - step) % world)
        self.device = parts[0].device
        self.staged = staged(group, self.device)
        self.spec = ((len(parts),) + tuple(parts[0].shape), parts[0].dtype)
        if self.staged:
            self.stage = HostStage()
            self.stage.to_host(0, self.spec, parts)     # sent next
        else:
            self.bufs = [torch.stack(parts), torch.empty(
                *self.spec[0], dtype=self.spec[1], device=self.device)]
        self.cur = 0            # index of the buffer holding this block
        self.reqs = None

    def start(self, held=None):
        """Post the rotation of the block held now; ``held``, a block on
        the device that was written since it arrived, replaces it."""
        refuse_capture('ring_attention')
        nxt = 1 - self.cur
        if self.staged:
            # the receive waits until the card has read the buffer; the
            # send may go while the card still copies from its buffer
            send = self.stage.to_host(self.cur, held) if held is not None \
                else self.stage.held(self.cur)
            recv = self.stage.buffer(nxt, *self.spec)
        else:
            if held is not None:
                self.bufs[self.cur] = held
            send, recv = self.bufs[self.cur], self.bufs[nxt]
        self.reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.irecv, recv, self.recv_from, self.group),
            dist.P2POp(dist.isend, send, self.send_to, self.group)])

    def finish(self):
        for r in self.reqs:
            r.wait()
        self.reqs = None
        self.cur = 1 - self.cur
        if not self.staged:
            return self.bufs[self.cur]
        return self.stage.to_device(self.cur, self.device)


def _flash_block(q, k, v, scale, diag, m, l, o):
    b, h, sl, d = q.shape
    acc, mb, lb = flash_attention_stats(
        q.reshape(b * h, sl, d), k.reshape(b * h, sl, d),
        v.reshape(b * h, sl, d), scale, causal=diag)
    return _merge_stats(m, l, o, acc.view(b, h, sl, d), mb.view(b, h, sl),
                        lb.view(b, h, sl))


def _check(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(f'ring_attention: want q, k, v (B, H, S_local, D) '
                         f'of one shape, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')


def _ring_forward(q, k, v, group, causal, use_flash):
    """The forward ring; returns the fp32 output and the final row
    statistics (m, l) that the backward reads."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    b, h, sl, d = q.shape
    scale = d ** -0.5
    qf = q.float().contiguous()
    m = torch.full((b, h, sl), -torch.inf, device=q.device)
    l = torch.zeros((b, h, sl), device=q.device)
    o = torch.zeros((b, h, sl, d), device=q.device)
    ring = _Ring([k, v], group) if world > 1 else None
    kb, vb = k, v
    for i in range(world):
        if i < world - 1:       # the last block's successor is never read
            ring.start()
        src = (rank - i) % world            # whose K/V this rank holds now
        if not (causal and src > rank):
            diag = causal and src == rank
            kf, vf = kb.float().contiguous(), vb.float().contiguous()
            if use_flash:
                m, l, o = _flash_block(qf, kf, vf, scale, diag, m, l, o)
            else:
                mask = _diag_mask(sl, q.device) if diag else None
                m, l, o = _online_block(qf, kf, vf, m, l, o, scale, mask)
        if i < world - 1:
            kb, vb = ring.finish()
    return o / l.clamp_min(1e-30)[..., None], m, l


def _diag_mask(sl, device):
    return torch.ones(sl, sl, dtype=torch.bool, device=device).tril()


def _block_grads(qf, g, lse, delta, kf, vf, scale, mask):
    """One block's share of the gradient: the cotangents the merges pass
    to the block's stats ``(acc_b, m_b, l_b)`` -- ``a_b g``, ``a_b
    (<g, acc_b> - l_b delta)`` and ``-a_b delta``, with ``a_b = exp(m_b -
    m) / l`` -- pushed back through the stats form. The terms of ``m_b``
    cancel, which leaves the softmax's own vjp over the block's keys:
    ``P = exp(s - lse)``, ``dS = P * (g v^T - delta)``. Returns (dq, dk,
    dv) of the block, fp32."""
    s = torch.einsum('bhqd,bhkd->bhqk', qf, kf) * scale
    if mask is not None:
        s = s.masked_fill(~mask, -torch.inf)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum('bhqk,bhqd->bhkd', p, g)
    ds = p * (torch.einsum('bhqd,bhkd->bhqk', g, vf) - delta[..., None])
    dq = torch.einsum('bhqk,bhkd->bhqd', ds, kf) * scale
    dk = torch.einsum('bhqk,bhqd->bhkd', ds, qf) * scale
    return dq, dk, dv


def _ring_backward(q, k, v, out, m, l, g, group, causal):
    """The backward ring. The K/V blocks go round the other way
    (rank r sends to r - 1), each carrying its dK/dV accumulator: a rank
    adds its queries' share to the block it holds, so that after ``world``
    rotations every block is home with the gradient of every query. dQ
    accumulates where it is. The blocks the causal forward skipped are
    skipped again. Recomputed in plain PyTorch from the final statistics,
    as the JAX package's ``_stats_bwd`` recomputes through its XLA twin:
    no kernel runs here."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    sl, d = q.shape[2], q.shape[3]
    scale = d ** -0.5
    qf, gf = q.float(), g.float()
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), torch.inf)
    delta = (gf * out).sum(-1)
    mask = _diag_mask(sl, q.device) if causal else None
    dq = torch.zeros_like(qf)
    blk = torch.stack([k.float(), v.float(), torch.zeros_like(qf),
                       torch.zeros_like(qf)])
    ring = _Ring(list(blk), group, reverse=True) if world > 1 else None
    for i in range(world):
        src = (rank + i) % world            # whose K/V this rank holds now
        if not (causal and src > rank):
            bq, bk, bv = _block_grads(qf, gf, lse, delta, blk[0], blk[1],
                                      scale, mask if src == rank else None)
            dq += bq
            blk[2] += bk
            blk[3] += bv
        if ring is not None:    # world rotations bring every block home
            ring.start(held=blk)
            blk = ring.finish()
    return dq.to(q.dtype), blk[2].to(k.dtype), blk[3].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring as one autograd node: the forward ring, and the backward
    ring of :func:`_ring_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, use_flash):
        out, m, l = _ring_forward(q, k, v, group, causal, use_flash)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.group, ctx.causal = group, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, m, l, g, ctx.group,
                                    ctx.causal)
        return dq, dk, dv, None, None, None


def ring_attention_kernel(q, k, v, group, causal=False, use_flash=None):
    """The per-rank body: attention of this rank's queries over the whole
    ring's keys. q, k, v: (B, H, S_local, D), this rank's shards, equal
    shapes; ``group`` the ring's process group (ranks in sequence order).

    ``use_flash`` (default: on CUDA tensors) computes each block with the
    flash-attention stats kernel; ``False`` takes the blockwise plain path.
    Under ``causal`` the block of rank ``src`` is full below this rank,
    diagonal at it and skipped above it, a choice made on the host: rank r
    computes r + 1 blocks, and ``world`` without ``causal``.

    Under autograd the ring is one node whose backward runs the ring the
    other way (:func:`_ring_backward`): every rank must call the backward,
    as every rank called the forward."""
    _check(q, k, v)
    if use_flash is None:
        use_flash = q.device.type == 'cuda'
    if needs_grad(q, k, v):
        return _RingAttention.apply(q, k, v, group, causal, use_flash)
    out, _, _ = _ring_forward(q, k, v, group, causal, use_flash)
    return out.to(q.dtype)


def _axes(entry):       # spec entries may be tuples of axis names
    return entry if isinstance(entry, tuple) else (entry,)


def ring_attention(q, k, v, mesh, axis_name='sp', causal=False, spec=None,
                   use_flash=None):
    """Attention over a sequence sharded over ``axis_name`` of ``mesh``
    (a ``DeviceMesh`` from :func:`.mesh.make_mesh`): q, k, v and the
    result are this rank's shards, (B, H, S_local, D).

    ``spec`` (a tuple of mesh axis names or ``None`` per dim, as a JAX
    ``PartitionSpec``) may name other mesh axes on the batch and head dims,
    e.g. ``('dp', None, 'sp', None)``, so that sequence parallelism
    composes with data parallelism in one mesh; those axes are plain local
    blocks here, and only ``axis_name`` takes part in the ring. A spec
    that does not shard dim 2 over ``axis_name`` alone, or that shards the
    head dim, raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names or ())
    if spec is None:
        spec = (None, None, axis_name, None)
    else:
        full = tuple(spec) + (None,) * (4 - len(tuple(spec)))
        if len(full) != 4 or _axes(full[2]) != (axis_name,) \
                or full[3] is not None \
                or axis_name in _axes(full[0]) + _axes(full[1]):
            raise ValueError(
                f'spec must shard the sequence dim (dim 2) over '
                f'{axis_name!r} and leave head_dim unsharded, got {spec}')
        unknown = {a for e in full for a in _axes(e)
                   if a is not None and a not in names}
        if unknown:
            raise ValueError(f'spec names axes {sorted(unknown)} that the '
                             f'mesh {names} does not have')
    if axis_name not in names:
        raise ValueError(f'mesh {names} has no axis {axis_name!r}')
    return ring_attention_kernel(q, k, v, mesh.get_group(axis_name),
                                 causal=causal, use_flash=use_flash)
