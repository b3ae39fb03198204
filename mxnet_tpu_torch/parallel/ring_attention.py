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
rank's shards. There is no gradient yet (the backward would rotate dK/dV
the other way round the ring): under autograd the functions raise.
"""

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..ops.kernels import needs_grad
from ..ops.kernels.flash_attention import flash_attention_stats

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
    """The rotation of one packed K/V block, ``(2, B, H, S_local, D)``,
    round the ranks of ``group``: :meth:`start` posts the receive from
    rank - 1 and the send of the block held now to rank + 1, :meth:`finish`
    waits for both and returns the block that arrived.

    The transport follows the group's backend. NCCL takes the CUDA tensors
    as they are. Gloo takes host tensors: CPU tensors go as they are, and
    CUDA tensors pass through two pinned host buffers allocated here, once
    per call (one send, one receive; they swap after each step), with the
    arrived block copied to the card without blocking the host. Any other
    pairing raises."""

    def __init__(self, k, v, group):
        self.backend = dist.get_backend(group)
        self.group = group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        self.send_to = dist.get_global_rank(group, (rank + 1) % world)
        self.recv_from = dist.get_global_rank(group, (rank - 1) % world)
        self.device = k.device
        if self.backend == 'nccl' and k.device.type == 'cuda':
            self.staged = False
        elif self.backend == 'gloo':
            self.staged = k.device.type == 'cuda'
        else:
            raise MXNetError(f'ring_attention: backend {self.backend!r} '
                             f'with {k.device.type} tensors is not taken '
                             f'(NCCL moves CUDA tensors, gloo host ones)')
        shape = (2,) + tuple(k.shape)
        if self.staged:
            self.bufs = [torch.empty(shape, dtype=k.dtype, pin_memory=True)
                         for _ in range(2)]
            self.bufs[0][0].copy_(k)        # synchronous: sent next
            self.bufs[0][1].copy_(v)
            # the copies to the card that last read each buffer
            self.copied = [None, None]
        else:
            self.bufs = [torch.stack([k, v]), torch.empty(
                shape, dtype=k.dtype, device=k.device)]
        self.cur = 0            # index of the buffer holding this block
        self.reqs = None

    def start(self):
        nxt = 1 - self.cur
        if self.staged and self.copied[nxt] is not None:
            self.copied[nxt].synchronize()   # its last copy to the card
        self.reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.irecv, self.bufs[nxt], self.recv_from,
                       self.group),
            dist.P2POp(dist.isend, self.bufs[self.cur], self.send_to,
                       self.group)])

    def finish(self):
        for r in self.reqs:
            r.wait()
        self.reqs = None
        self.cur = 1 - self.cur
        buf = self.bufs[self.cur]
        if not self.staged:
            return buf[0], buf[1]
        blk = buf.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.copied[self.cur] = ev
        return blk[0], blk[1]


def _flash_block(q, k, v, scale, diag, m, l, o):
    b, h, sl, d = q.shape
    acc, mb, lb = flash_attention_stats(
        q.reshape(b * h, sl, d), k.reshape(b * h, sl, d),
        v.reshape(b * h, sl, d), scale, causal=diag)
    return _merge_stats(m, l, o, acc.view(b, h, sl, d), mb.view(b, h, sl),
                        lb.view(b, h, sl))


def ring_attention_kernel(q, k, v, group, causal=False, use_flash=None):
    """The per-rank body: attention of this rank's queries over the whole
    ring's keys. q, k, v: (B, H, S_local, D), this rank's shards, equal
    shapes; ``group`` the ring's process group (ranks in sequence order).

    ``use_flash`` (default: on CUDA tensors) computes each block with the
    flash-attention stats kernel; ``False`` takes the blockwise plain path.
    Under ``causal`` the block of rank ``src`` is full below this rank,
    diagonal at it and skipped above it, a choice made on the host: rank r
    computes r + 1 blocks, and ``world`` without ``causal``."""
    if needs_grad(q, k, v):
        raise MXNetError('ring_attention has no gradient yet (its backward '
                         'would rotate dK/dV back round the ring); call it '
                         'under torch.no_grad() or on tensors that do not '
                         'require grad')
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(f'ring_attention: want q, k, v (B, H, S_local, D) '
                         f'of one shape, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    b, h, sl, d = q.shape
    scale = d ** -0.5
    if use_flash is None:
        use_flash = q.device.type == 'cuda'

    qf = q.float().contiguous()
    m = torch.full((b, h, sl), -torch.inf, device=q.device)
    l = torch.zeros((b, h, sl), device=q.device)
    o = torch.zeros((b, h, sl, d), device=q.device)
    ring = _Ring(k, v, group) if world > 1 else None
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
                mask = None
                if diag:
                    mask = torch.ones(sl, sl, dtype=torch.bool,
                                      device=q.device).tril()
                m, l, o = _online_block(qf, kf, vf, m, l, o, scale, mask)
        if i < world - 1:
            kb, vb = ring.finish()
    out = o / l.clamp_min(1e-30)[..., None]
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
