"""``dist_tpu_sync``: the synchronous multi-process KVStore.

Counterpart of ``mxnet_tpu/kvstore/tpu.py`` (reference kvstore_dist.h:44
and its servers, replaced by collectives). One process a rank, joined in
the default ``torch.distributed`` process group
(``parallel.init_distributed``, ``parallel.launch.spawn``):

* ``push``/``pushpull`` all-reduce the local replica sum over the ranks.
  They **sum**, they do not average: a rank's ``Trainer.step(batch_size)``
  with its local batch size gives the JAX package's numbers, not
  ``DistributedDataParallel``'s mean;
* ``init``/``broadcast``: rank 0's value wins (reference KVStoreDist::Init);
* ``fused_pushpull`` coalesces the keys into fusion buffers in priority
  order, one all-reduce a buffer (2-bit compressed buffers all-gather
  their words instead); with an updater and more than one process it runs
  the ZeRO-1 update (each key updated once, on its owner; disable with
  ``MXNET_KVSTORE_ZERO1=0``).

With one process it is exactly ``local``, as the reference documents.
The transport is :class:`.fusion.CrossProcess`: NCCL takes device tensors,
gloo host tensors, with CUDA tensors staged through pinned host buffers.
"""

import os

import numpy as _np
import torch.distributed as dist

from ..ndarray.ndarray import NDArray
from . import fusion
from .base import register
from .kvstore import KVStoreLocal, _group, _write

__all__ = ['KVStoreTPUSync']


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@register
class KVStoreTPUSync(KVStoreLocal):
    """``dist_tpu_sync`` / ``dist_sync``: cross-process synchronous
    all-reduce."""

    NAME = 'dist_tpu_sync'

    def __init__(self):
        super().__init__()
        self._nproc, _ = _world()
        self._update_mode = {}
        self._z1_owner, self._z1_load = {}, [0] * self._nproc

    def _allreduce(self, local_sum, key=None):
        """The sum over processes of this process's ``local_sum`` (a new
        tensor). Under 2-bit compression the local sum is quantized first
        (its error kept in this worker's residual) and the gathered words
        are decoded and summed."""
        gc = self.gradient_compression
        if gc.active and key is not None:
            words = gc.quantize(key, local_sum)
            if self._nproc == 1:
                return gc.dequantize(words, local_sum.shape, local_sum.dtype)
            vals = fusion.CrossProcess.get().compressed_sum(
                words, gc.threshold, local_sum.numel())
            return vals.reshape(local_sum.shape).to(local_sum.dtype)
        if self._nproc == 1:
            return local_sum
        out = local_sum.reshape(-1).clone()
        return fusion.CrossProcess.get().psum(out).view(local_sum.shape)

    def _hop(self, k, merged):
        raw, fresh = merged
        out = self._allreduce(raw, key=k)
        return out, fresh or out is not raw

    # ------------------------------------------------------------ fused path
    def fused_pushpull(self, keys, values, outs=None, priorities=None):
        """The bucketed fused pushpull (reference PushPullDefault and the
        P3 priority slicing): every key's replicas summed, the keys
        coalesced into fusion buffers in priority order, one collective a
        buffer, and the results split and written to the targets. With an
        updater and more than one process the ZeRO-1 update runs instead
        (see the module docstring); like the reference's server-side
        states, ``save_optimizer_states`` is then rank-local."""
        n = len(keys)
        if n == 0:
            return
        vals_lists = [v if isinstance(v, (list, tuple)) else [v]
                      for v in values]
        targets = [(outs[i] if isinstance(outs[i], (list, tuple))
                    else [outs[i]]) if outs is not None else vals_lists[i]
                   for i in range(n)]
        merged = self._merge_local(vals_lists, targets)
        order = list(range(n))
        if priorities is not None:
            order.sort(key=lambda i: -priorities[i])
        gc = self.gradient_compression
        if (self._updater is not None and self._nproc > 1
                and not gc.active
                and os.environ.get('MXNET_KVSTORE_ZERO1', '1') == '1'
                and self._zero1_update(keys, [m for m, _ in merged],
                                       targets, order)):
            return
        if self._updater is not None and self._nproc > 1:
            # a key whose state was made under ZeRO-1 lives on its owner
            # only: replicated updates from here on would diverge from it
            self._guard_update_mode(keys, 'replicated')
        if self._nproc > 1 or gc.active:
            merged = self._bucketed_allreduce(keys, merged, order, gc)
        self._apply_merged(keys, merged, targets)

    def _guard_update_mode(self, keys, mode):
        """Pin each key's updater-state layout ('zero1' or 'replicated')
        at its first update; raise on a switch mid-run."""
        for k in keys:
            prev = self._update_mode.setdefault(k, mode)
            if prev != mode:
                raise RuntimeError(
                    f'kvstore key {k!r}: optimizer state was created '
                    f'under {prev!r} updates but this pushpull selected '
                    f'{mode!r} (MXNET_KVSTORE_ZERO1 toggled or gradient '
                    'compression enabled mid-run?). Switching layouts '
                    'mid-run silently abandons sharded state; restart '
                    'training with a consistent configuration.')

    def _bucketed_allreduce(self, keys, merged, order, gc):
        raws = [m for m, _ in merged]
        out = list(merged)
        cp = fusion.CrossProcess.get() if self._nproc > 1 else None
        limit = fusion.fusion_buffer_bytes()
        if gc.active:
            # per-key quantization first: the residuals are per key
            words = [gc.quantize(keys[i], raws[i]) for i in range(len(keys))]
            if cp is None:
                for i in order:
                    out[i] = (gc.dequantize(words[i], raws[i].shape,
                                            raws[i].dtype), True)
                return out
            # the decode blows words up 16x: keep the buffers small
            wbytes = [4 * words[i].numel() for i in order]
            for bucket in fusion.make_buckets(wbytes,
                                              max(limit // 16, 1 << 20)):
                sel = [order[j] for j in bucket]
                wtot = sum(words[i].numel() for i in sel)
                pad_to = fusion._padded_len(wtot)
                flat_w = fusion._concat_flat([words[i] for i in sel], pad_to)
                vals = cp.compressed_sum(flat_w, gc.threshold, pad_to * 16)
                offs, woff = [], 0
                for i in sel:
                    offs.append(woff * 16)
                    woff += words[i].numel()
                parts = fusion._split_flat(
                    vals, [tuple(raws[i].shape) for i in sel], offs)
                for i, p in zip(sel, parts):
                    out[i] = (p.to(raws[i].dtype), True)
            return out
        for sel, shapes, offs, pad_to in fusion.plan_buckets(
                raws, order, limit):
            flat = cp.psum(fusion._concat_flat([raws[i] for i in sel],
                                               pad_to))
            for i, p in zip(sel, fusion._split_flat(flat, shapes, offs)):
                out[i] = (p, True)
        return out

    def _zero1_update(self, keys, merged, targets, order):
        """The ZeRO-1 optimizer-on-store (reference server-side
        ApplyUpdates): a reduce-scatter gives each rank the summed
        gradients of the keys it owns, the updater runs on those only, and
        an all-gather brings every key's new weight to every rank. Returns
        False (replicated updates) for mixed dtypes."""
        dt = merged[0].dtype
        if any(m.dtype != dt for m in merged):
            return False
        self._guard_update_mode(keys, 'zero1')
        for k in keys:
            if k not in self._store:
                raise ValueError(
                    f'pushpull with an updater requires key {k!r} to be '
                    'initialized first (init/broadcast)')
        cp = fusion.CrossProcess.get()
        nproc, me = self._nproc, self.rank
        sizes = [m.numel() or 1 for m in merged]
        # owners are pinned per key at first sight: recomputing them from
        # each call's key list would move keys (and orphan their state)
        # when the key set changes; every rank sees the same calls
        new = [i for i in range(len(keys)) if keys[i] not in self._z1_owner]
        for j, r in zip(new, fusion.assign_owners(
                [sizes[i] for i in new], nproc, load=self._z1_load)):
            self._z1_owner[keys[j]] = r
            self._z1_load[r] += sizes[j]
        owner = [self._z1_owner[k] for k in keys]
        _, seg_keys, lmax, layout = fusion.zero1_layout(
            sizes, nproc, owner=owner, order=order)
        my_tile = cp.reduce_scatter(fusion._pack_segments(merged, layout))
        mine = seg_keys[me]
        if mine:
            offs = _np.cumsum([0] + [sizes[i] for i in mine[:-1]])
            grads = fusion._split_flat(
                my_tile, [tuple(merged[i].shape) for i in mine],
                [int(o) for o in offs])
            for i, g in zip(mine, grads):
                self._updater(keys[i], NDArray(g), self._store[keys[i]])
            w_tile = fusion._concat_flat(
                [self._store[keys[i]]._data for i in mine], lmax)
        else:
            w_tile = merged[0].new_zeros(lmax)
        full = cp.all_gather(w_tile)
        offs = []
        for i in range(len(keys)):
            r = owner[i]
            offs.append(r * lmax + sum(
                sizes[j] for j in seg_keys[r][:seg_keys[r].index(i)]))
        parts = fusion._split_flat(
            full, [tuple(m.shape) for m in merged], offs)
        for i, k in enumerate(keys):
            _write(self._store[k]._data, parts[i])
            for t in targets[i]:
                _write(t, parts[i])
        return True

    # ------------------------------------------------------------ init, bcast
    def init(self, key, value):
        """Rank 0's value is authoritative (reference KVStoreDist::Init)."""
        super().init(key, value)
        if self._nproc > 1:
            for k, _ in _group(key, value):
                fusion.CrossProcess.get().broadcast(self._store[k]._data)

    def broadcast(self, key, value, out, priority=0):
        """Rank 0's value to every rank's ``out`` (reference
        KVStoreDist::Init semantics)."""
        self.init(key, [v[0] if isinstance(v, (list, tuple)) else v
                        for v in value] if isinstance(key, (list, tuple))
                  else (value[0] if isinstance(value, (list, tuple))
                        else value))
        self.pull(key, out=out, priority=priority)

    # ------------------------------------------------------------- topology
    @property
    def rank(self):
        return _world()[1]

    @property
    def num_workers(self):
        return _world()[0]

    def barrier(self):
        if self._nproc > 1:
            dist.barrier()

    def get_num_dead_node(self, node_id=0, timeout=60):
        """Reference include/mxnet/kvstore.h:408: a collective's timeout
        fails every rank of the group, so a reachable store has none
        dead."""
        return 0

    @property
    def type(self):
        return 'dist_tpu_sync'
