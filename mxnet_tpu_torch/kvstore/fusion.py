"""Gradient fusion buffers and the cross-process collectives.

Counterpart of ``mxnet_tpu/kvstore/fusion.py``, the transport under
``dist_tpu_sync``'s fused pushpull:

* **Fusion buffers**: consecutive keys of one dtype share a flat buffer
  up to ``MXNET_KVSTORE_FUSION_BUFFER_MB`` (default 64), so the wire sees
  a few large collectives instead of one a key; each buffer is
  zero-padded to a multiple of 65536 elements. :func:`plan_buckets`,
  :func:`zero1_layout` and :func:`assign_owners` are the JAX package's
  plans, value for value.
* **Collectives over the default process group** (:class:`CrossProcess`):
  the JAX package's ``psum``, ``psum_scatter`` and ``all_gather`` over a
  one-device-per-process mesh become ``all_reduce``,
  ``reduce_scatter_tensor`` and an all-gather. Under NCCL (one card a
  rank) device tensors go to the collective as they are; under gloo CUDA
  tensors pass through pinned host buffers, one for each buffer size,
  allocated once (``parallel._staging``, which the ring shares), and a
  reduce-scatter is gloo's all-reduce of the whole buffer, of which only
  this rank's tile goes back to the card (gloo's own reduce-scatter is
  the slower of the two).
* **ZeRO-1**: :func:`zero1_layout` packs the keys rank-major by owner, so
  that a reduce-scatter delivers each owner the summed gradients of the
  keys it owns and an all-gather returns the weights it updated;
  :func:`zero1_exchange` is that exchange, shared by
  :func:`zero1_update_in_axis` and the sharded Gluon Trainer (which packs
  a tile of every tensor instead of whole keys).
* **Counters**: every collective of :class:`CrossProcess` adds to
  :func:`counters` (calls, bytes, host seconds with the staging), whoever
  calls it: the kvstore, ``SyncBatchNorm``, ``mx.sharding``, the
  pipeline's hops or the MoE exchange.
* **Watched waits** (:func:`watching`): a gloo collective whose peer died
  fails only on the ranks connected to that peer; a rank waiting on a
  live peer that already gave up would wait out the group's timeout.
  Inside ``watching(check)`` every collective is issued asynchronously
  and waited for in slices, and ``check()`` runs between slices (the
  elastic trainer's: has the formation's generation moved?), so such a
  rank raises :class:`FormationLost` instead. Each collective also passes
  the ``dist_async`` fault hook as command ``collective`` (so a
  ``kill_host:collective:N`` rule kills a rank inside a step's
  collective).

The in-axis forms of the JAX module (:func:`zero1_update_in_axis`,
:func:`bucketed_allreduce_in_axis`), which run inside a ``shard_map`` there,
run in every rank here over the process group of one axis of the active
``mx.sharding`` mesh (:class:`CrossProcess` over that group). The concat,
split and decode here are plain PyTorch, as the JAX package leaves them
to XLA.
"""

import contextlib
import datetime
import functools
import math
import os
import time

import numpy as _np
import torch
import torch.distributed as dist

from ..base import MXNetError
from ..parallel._staging import HostStage, refuse_capture, staged
from . import faults as _faults

__all__ = ['fusion_buffer_bytes', 'make_buckets', 'plan_buckets',
           'zero1_layout', 'assign_owners', 'CrossProcess',
           'zero1_exchange', 'zero1_update_in_axis',
           'bucketed_allreduce_in_axis', 'counters', 'reset_counters',
           'FormationLost', 'watching', 'issue', 'wait']

_PAD_QUANTUM = 65536  # elements
#: collectives run, bytes sent and host seconds spent (staging included),
#: by kind, in this process
_COUNT = {}


#: the active watch's check, or None
_WATCH = [None]
#: how long a watched collective waits between two checks
_WATCH_SLICE_S = 0.2


class FormationLost(MXNetError):
    """A collective was given up: a peer of its group is gone (raised by
    a :func:`watching` check while the collective waited)."""


@contextlib.contextmanager
def watching(check):
    """Inside the block, every collective waits in slices of
    ``_WATCH_SLICE_S`` seconds and calls ``check()`` between them;
    ``check`` raises (a :class:`FormationLost`) to give the collective
    up."""
    prev, _WATCH[0] = _WATCH[0], check
    try:
        yield
    finally:
        _WATCH[0] = prev


def wait(work):
    """Wait for an asynchronous op's ``work``: in slices under
    :func:`watching`, calling its check between them."""
    check = _WATCH[0]
    if check is None:
        work.wait()
        return
    while True:
        try:
            work.wait(timeout=datetime.timedelta(seconds=_WATCH_SLICE_S))
            return
        except RuntimeError as e:
            if 'timed out' not in str(e).lower():
                raise
        check()


def issue(fn, *args, **kwargs):
    """Run the ``torch.distributed`` call ``fn(*args, **kwargs)`` through
    the fault hook and, under :func:`watching`, as an asynchronous op
    waited for in slices (:func:`wait`); returns when it completed."""
    if _faults._PLAN is not None:
        _faults.on_send({'cmd': 'collective', 'rank': dist.get_rank()})
    if _WATCH[0] is None:
        return fn(*args, **kwargs)
    return wait(fn(*args, async_op=True, **kwargs))


def counters():
    """``{kind: [calls, bytes, seconds]}`` of the :class:`CrossProcess`
    collectives this process ran (host time from the call to its result
    on the device, staging included)."""
    return {k: list(v) for k, v in _COUNT.items()}


def reset_counters():
    _COUNT.clear()


def _counted(kind):
    def wrap(fn):
        @functools.wraps(fn)
        def run(self, t, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(self, t, *args, **kwargs)
            c = _COUNT.setdefault(kind, [0, 0, 0.0])
            c[0] += 1
            c[1] += t.numel() * t.element_size()
            c[2] += time.perf_counter() - t0
            return out
        return run
    return wrap


def fusion_buffer_bytes():
    """The bucket cap in bytes."""
    return int(float(os.environ.get('MXNET_KVSTORE_FUSION_BUFFER_MB', '64'))
               * 1e6)


def make_buckets(nbytes, limit):
    """Greedy in-order bucketing: consecutive keys share a bucket until
    ``limit`` bytes; the order (the caller's priority order) is kept."""
    buckets, cur, acc = [], [], 0
    for i, b in enumerate(nbytes):
        if cur and acc + b > limit:
            buckets.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += b
    if cur:
        buckets.append(cur)
    return buckets


def _padded_len(n):
    return -(-n // _PAD_QUANTUM) * _PAD_QUANTUM


def _numel(shape):
    return math.prod(int(d) for d in shape) or 1


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size() \
        if isinstance(dtype, torch.dtype) else _np.dtype(dtype).itemsize


def plan_buckets(arrs, order, limit):
    """The store's bucket plan: dtype-grouped, in ``order``, greedy by
    bytes up to ``limit``. Yields ``(sel, shapes, offsets, pad_to)`` per
    bucket. ``arrs`` are tensors or anything with ``shape`` and
    ``dtype``."""
    by_dtype = {}
    for i in order:
        by_dtype.setdefault(str(arrs[i].dtype), []).append(i)
    for idxs in by_dtype.values():
        itemsize = _itemsize(arrs[idxs[0]].dtype)
        sizes = [_numel(arrs[i].shape) for i in idxs]
        for bucket in make_buckets([s * itemsize for s in sizes], limit):
            sel = [idxs[j] for j in bucket]
            szs = [sizes[j] for j in bucket]
            shapes = tuple(tuple(int(d) for d in arrs[i].shape)
                           for i in sel)
            offs = tuple(int(o) for o in _np.cumsum([0] + szs[:-1]))
            yield sel, shapes, offs, _padded_len(sum(szs))


def zero1_layout(sizes, nproc, owner=None, order=None):
    """The ZeRO-1 flat-tile layout: per-key owners, per-rank key segments
    (in ``order`` when given), the padded tile length and the
    :func:`_pack_segments` layout. Returns ``(owner, seg_keys, lmax,
    layout)``."""
    owner = assign_owners(sizes, nproc) if owner is None else owner
    order = range(len(sizes)) if order is None else order
    seg_keys = [[i for i in order if owner[i] == r] for r in range(nproc)]
    seg_len = [sum(sizes[i] for i in s) for s in seg_keys]
    lmax = _padded_len(max(seg_len + [1]))
    layout = tuple((tuple(s), lmax - seg_len[r])
                   for r, s in enumerate(seg_keys))
    return owner, seg_keys, lmax, layout


def assign_owners(sizes, nproc, load=None):
    """Deterministic balanced owners for the ZeRO-1 update: largest key
    first onto the least-loaded rank (seeded with ``load``). Every rank
    computes the same."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    load = list(load) if load is not None else [0] * nproc
    owner = [0] * len(sizes)
    for i in order:
        r = min(range(nproc), key=lambda j: load[j])
        owner[i] = r
        load[r] += sizes[i]
    return owner


def _concat_flat(raws, pad_to):
    """The tensors flattened into one new buffer of ``pad_to`` elements,
    zero-padded."""
    flat = torch.empty(pad_to, dtype=raws[0].dtype, device=raws[0].device)
    off = 0
    with torch.no_grad():
        for r in raws:
            n = r.numel()
            flat[off:off + n].copy_(r.reshape(-1))
            off += n
        flat[off:].zero_()
    return flat


def _split_flat(flat, shapes, offsets):
    """Views of ``flat``, one per shape at its offset."""
    return [flat[off:off + _numel(shape)].view(shape)
            for shape, off in zip(shapes, offsets)]


def _pack_segments(raws, layout):
    """Rank-major packing for the ZeRO-1 update: ``layout`` is, for each
    rank, (the key indices it owns, zero padding), so that tile r of the
    reduce-scatter is exactly rank r's keys."""
    parts = []
    for idxs, pad in layout:
        parts.extend(raws[i] for i in idxs)
        if pad:
            parts.append(raws[0].new_zeros(pad))
    dt, dev = raws[0].dtype, raws[0].device
    total = sum(p.numel() for p in parts)
    flat = torch.empty(total, dtype=dt, device=dev)
    off = 0
    with torch.no_grad():
        for p in parts:
            flat[off:off + p.numel()].copy_(p.reshape(-1))
            off += p.numel()
    return flat


class CrossProcess:
    """The collectives over a process group (default: the world), one
    rank a process: what this process contributes goes in, this process's
    share of the result comes out (a new tensor, or ``flat`` itself for
    :meth:`psum`)."""

    _instances = {}

    @classmethod
    def get(cls, group=None):
        world = dist.get_world_size(group)
        inst = cls._instances.get(group)
        if inst is None or inst._nproc != world:
            inst = cls._instances[group] = cls(group)
        return inst

    def __init__(self, group=None):
        self._group = group
        self._nproc = dist.get_world_size(group)
        self._stage = HostStage()

    def _host(self, tag, t):
        """``t`` as the collective takes it: itself, or a pinned host copy
        (keyed by ``tag`` and its size) under gloo. Every collective starts
        here, and none runs inside a CUDA graph capture."""
        refuse_capture(f'collective {tag}')
        if not staged(self._group, t.device):
            return t, None
        key = (tag, t.numel(), t.dtype)
        return self._stage.to_host(key, t), key

    def _result(self, tag, n, like):
        """A tensor of ``n`` elements for a collective's result: on the
        device, or a pinned host buffer under gloo (with its key)."""
        if not staged(self._group, like.device):
            return like.new_empty(n), None
        key = (tag, n, like.dtype)
        return self._stage.buffer(key, (n,), like.dtype), key

    @_counted('all_reduce')
    def psum(self, flat):
        """All-reduce (sum) of ``flat`` in place: every process gets the
        sum over processes."""
        buf, key = self._host('psum', flat)
        issue(dist.all_reduce, buf, group=self._group)
        if key is not None:
            self._stage.to_device(key, flat.device, out=flat)
        return flat

    @_counted('reduce_scatter')
    def reduce_scatter(self, flat):
        """This process's 1/nproc tile of the sum over processes (the
        gradient half of the ZeRO-1 update); ``flat``'s length must be a
        multiple of nproc."""
        n = flat.numel()
        assert n % self._nproc == 0
        m = n // self._nproc
        buf, key = self._host('rs', flat)
        if dist.get_backend(self._group) == 'gloo':
            # gloo's reduce-scatter is slower than its all-reduce, which
            # sends twice the bytes: sum the whole (staged) buffer, and
            # take this rank's tile back to the card
            if key is None:
                buf = buf.clone()
            issue(dist.all_reduce, buf, group=self._group)
            mine = slice(dist.get_rank(self._group) * m,
                         (dist.get_rank(self._group) + 1) * m)
            return buf[mine].clone() if key is None else \
                self._stage.to_device(key, flat.device, part=mine)
        tile = flat.new_empty(m)
        issue(dist.reduce_scatter_tensor, tile, buf, group=self._group)
        return tile

    @_counted('all_gather')
    def all_gather(self, tile):
        """Every process's tile, concatenated in rank order (the weight
        half of the ZeRO-1 update)."""
        buf, _ = self._host('ag', tile)
        full, key = self._result('ag_full', tile.numel() * self._nproc, tile)
        if dist.get_backend(self._group) == 'nccl':
            issue(dist.all_gather_into_tensor, full, buf, group=self._group)
        else:
            issue(dist.all_gather, list(full.chunk(self._nproc)), buf,
                  group=self._group)
        return full if key is None else \
            self._stage.to_device(key, tile.device)

    def compressed_sum(self, words, threshold, n_values):
        """The 2-bit path: all-gather every process's packed words (16x
        fewer bytes than the values), then decode and sum them; returns
        the first ``n_values`` sums."""
        from .gradient_compression import dequantize_2bit
        gathered = self.all_gather(words).view(self._nproc, -1)
        vals = dequantize_2bit(gathered, threshold,
                               gathered.numel() * 16)
        return vals.view(self._nproc, -1).sum(0)[:n_values]

    @_counted('broadcast')
    def broadcast(self, t):
        """Rank 0's ``t`` into every process's ``t``, in place."""
        buf, key = self._host('bcast', t.reshape(-1))
        src = 0 if self._group is None else \
            dist.get_global_rank(self._group, 0)
        issue(dist.broadcast, buf, src=src, group=self._group)
        if key is not None:
            self._stage.to_device(key, t.device, out=t.view(-1))
        return t

    @_counted('all_to_all')
    def all_to_all(self, t):
        """``t`` cut into nproc equal chunks along dim 0, chunk j sent to
        process j; returns the chunks received, process i's at position i
        (``all_to_all_single``, which gloo implements for host tensors:
        a CUDA tensor goes through pinned buffers)."""
        flat = t.contiguous().view(-1)
        buf, _ = self._host('a2a', flat)
        out, key = self._result('a2a_out', flat.numel(), flat)
        issue(dist.all_to_all_single, out, buf, group=self._group)
        if key is not None:
            out = self._stage.to_device(key, t.device)
        return out.view(t.shape)

    def peer(self, i):
        """The world rank of this group's rank ``i``."""
        return i if self._group is None else \
            dist.get_global_rank(self._group, i)

    @_counted('send')
    def send(self, t, i, tag=0, key=None):
        """Start sending ``t`` to this group's rank ``i``; returns the
        work to wait for. Under gloo a CUDA tensor is copied into the
        pinned buffer named ``key``, which must not be sent from again
        before that work completed."""
        if _faults._PLAN is not None:
            _faults.on_send({'cmd': 'collective', 'rank': dist.get_rank()})
        refuse_capture('send')
        buf = t.contiguous()
        if staged(self._group, t.device):
            buf = self._stage.to_host(('send', key, t.numel(), t.dtype), buf)
        return dist.isend(buf, dst=self.peer(i), group=self._group, tag=tag)

    @_counted('recv')
    def recv(self, t, i, tag=0, key=None):
        """Receive into a tensor like ``t`` (shape, dtype, device) from
        this group's rank ``i``; returns it. ``key`` names a pinned buffer
        to receive into under gloo."""
        if staged(self._group, t.device):
            k = ('recv', key, t.numel(), t.dtype)
            buf = self._stage.buffer(k, t.shape, t.dtype)
            issue(dist.recv, buf, src=self.peer(i), group=self._group,
                  tag=tag)
            return self._stage.to_device(k, t.device)
        out = torch.empty_like(t)
        issue(dist.recv, out, src=self.peer(i), group=self._group, tag=tag)
        return out


def _axis(axis_name):
    """The :class:`CrossProcess` of ``axis_name`` of the active
    ``mx.sharding`` mesh and this rank's index along it."""
    from ..sharding.context import current
    ctx = current()
    if ctx is None or axis_name not in ctx.axis_sizes:
        raise ValueError(f'no active mx.sharding mesh with an axis '
                         f'{axis_name!r}')
    return CrossProcess.get(ctx.group(axis_name)), ctx.coord(axis_name)


def zero1_exchange(comm, packed, update, reduce=True):
    """One ZeRO-1 exchange over the ranks of ``comm`` (a
    :class:`CrossProcess`): ``packed`` holds every rank's gradient
    segment, rank-major and of one length, and one reduce-scatter gives
    this rank its summed segment (with ``reduce=False``, ``packed`` is
    that segment already); ``update(g_segment)`` updates this rank's
    weights and returns their new segment, flat; one all-gather returns
    every rank's new segment, as the rows of an ``(nproc, length)``
    tensor."""
    g = comm.reduce_scatter(packed) if reduce else packed
    new = update(g).contiguous()
    return comm.all_gather(new).view(comm._nproc, -1)


def zero1_update_in_axis(grads, weights, mom_tile, axis_name, nproc,
                         update_fn, owner=None):
    """The ZeRO-1 sharded update over the ranks of ``axis_name`` (JAX
    ``fusion.py:162``, there inside a ``shard_map``): the
    :func:`assign_owners`/:func:`_pack_segments` layout, one
    reduce-scatter delivering each owner its summed gradient tile, the
    update on the owned tile only (``update_fn(w_tile, g_tile, mom_tile)
    -> (new_w_tile, new_mom_tile)``, state split ``nproc`` ways), and one
    all-gather returning every key's new weights. Returns
    ``(new_weights_per_key, new_mom_tile)``."""
    comm, r = _axis(axis_name)
    if comm._nproc != nproc:
        raise ValueError(f'axis {axis_name!r} has {comm._nproc} ranks, '
                         f'not {nproc}')
    sizes = [_numel(w.shape) for w in weights]
    owner, seg_keys, lmax, layout = zero1_layout(sizes, nproc, owner)
    w_tile = _pack_segments(list(weights), layout)[r * lmax:(r + 1) * lmax]
    new_m = []

    def update(g_tile):
        new_w, m = update_fn(w_tile, g_tile, mom_tile)
        new_m.append(m)
        return new_w
    full = zero1_exchange(comm, _pack_segments(list(grads), layout),
                          update).reshape(-1)
    outs = []
    for i in range(len(weights)):
        ro = owner[i]
        off = ro * lmax + sum(sizes[j] for j in
                              seg_keys[ro][:seg_keys[ro].index(i)])
        outs.append(full[off:off + sizes[i]].reshape(weights[i].shape))
    return outs, new_m[0]


def bucketed_allreduce_in_axis(raws, axis_name, limit=None, order=None):
    """The fused pushpull's bucketed all-reduce over the ranks of
    ``axis_name`` (JAX ``fusion.py:125``): :func:`plan_buckets`, one flat
    buffer and one all-reduce a bucket, split back; returns the summed
    tensors in the order given."""
    comm, _ = _axis(axis_name)
    limit = fusion_buffer_bytes() if limit is None else limit
    out = list(raws)
    order = list(range(len(out))) if order is None else order
    for sel, shapes, offs, pad_to in plan_buckets(out, order, limit):
        flat = comm.psum(_concat_flat([out[i] for i in sel], pad_to))
        for i, p in zip(sel, _split_flat(flat, shapes, offs)):
            out[i] = p
    return out
