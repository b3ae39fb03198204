"""In-process KVStore types: ``local`` and ``device``.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py`` (reference
src/kvstore/kvstore_local.h:70 and comm.h: CommCPU :104, CommDevice
:452). Values are NDArrays or ``torch`` tensors, one per device replica of
a key; a key's replicas are summed, in plain PyTorch that reads each
replica once and writes one output (the JAX package's one fused XLA
reduction; no ``torch.stack`` of the replicas is made).

How a result reaches its target follows what the target is. A tensor is
written in place: it keeps its address, as the grad buffers and weights
that a Trainer's captured update graph reads do (``gluon/trainer.py``
passes its buffers as tensors). An NDArray is rebound, as the JAX package
rebinds its immutable arrays: NDArray payloads are never written in place
(``ndarray/ndarray.py``), so a view taken from the old value keeps it.
The store holds its own copy of each key's value, which the updater
writes in place. A row-sparse or CSR value (``ndarray.sparse``) is kept in
its storage; a push into it adds to its dense equivalent and compresses the
sum again, as the reference does, and ``row_sparse_pull`` returns the rows
asked for as a ``RowSparseNDArray`` of those rows only, from a sparse or a
dense stored value, never a table-sized array.
"""

import warnings

import torch

from ..ndarray.ndarray import NDArray
from .base import KVStoreBase, register

__all__ = ['KVStore', 'KVStoreLocal', 'KVStoreDevice']


def _group(keys, values):
    """Group possibly flat (key, value) lists by key (reference
    kvstore_local.h GroupKVPairs)."""
    if not isinstance(keys, (list, tuple)):
        return [(keys, list(values) if isinstance(values, (list, tuple))
                 else [values])]
    if len(keys) == len(values) and not any(
            isinstance(v, (list, tuple)) for v in values):
        merged, order = {}, []
        for k, v in zip(keys, values):
            if k not in merged:
                merged[k] = []
                order.append(k)
            merged[k].append(v)
        return [(k, merged[k]) for k in order]
    return [(k, list(v) if isinstance(v, (list, tuple)) else [v])
            for k, v in zip(keys, values)]


def _raw(x):
    """The tensor of an NDArray or a tensor, detached."""
    return (x._data if isinstance(x, NDArray) else x).detach()


def _write(target, value, fresh=False):
    """Write ``value`` into ``target``: a tensor in place, an NDArray by
    rebinding it (to ``value`` itself when ``fresh``, a tensor no one else
    writes, else to a copy)."""
    if isinstance(target, NDArray):
        target._rebind(value if fresh else value.clone())
        return
    if target.data_ptr() == value.data_ptr() and \
            target.shape == value.shape and target.dtype == value.dtype:
        return
    with torch.no_grad():
        target.copy_(value.reshape(target.shape))


def _reduce(raws, into=None):
    """The sum of a key's replicas, reading each once: into ``into`` (a
    tensor of the sum's shape and dtype, which may be one of the
    replicas) when given, else into a new tensor (CommDevice::Reduce,
    comm.h:452). One replica is returned as it is."""
    if len(raws) == 1:
        return raws[0]
    with torch.no_grad():
        out = torch.add(raws[0], raws[1], out=into) if into is not None \
            else torch.add(raws[0], raws[1])
        for r in raws[2:]:
            out.add_(r)
    return out


def _into(raws, targets):
    """A target the replica sum may be written into in place: the first
    target, when it is a contiguous tensor of the sum's shape and dtype on
    the replicas' device; else None."""
    if len(raws) < 2 or not targets:
        return None
    t = targets[0]
    r = raws[0]
    if torch.is_tensor(t) and t.shape == r.shape and t.dtype == r.dtype \
            and t.device == r.device and t.is_contiguous():
        return t
    return None


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


@register
class KVStoreLocal(KVStoreBase):
    """Reference kvstore_local.h:70: aggregation in one process."""

    NAME = 'local'

    def __init__(self):
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._gc = None

    # ------------------------------------------------------ classic surface
    def init(self, key, value):
        from ..ndarray.sparse import BaseSparseNDArray
        for k, vals in _group(key, value):
            v = vals[0]
            self._store[k] = v.copy() if isinstance(v, BaseSparseNDArray) \
                else NDArray(_raw(v).clone())

    def push(self, key, value, priority=0):
        """Sum the replicas into the stored value (accumulate), or hand
        the sum to the updater."""
        for k, vals in _group(key, value):
            merged, _ = self._hop(k, (_reduce([_raw(v) for v in vals]),
                                      False))
            self._push_merged(k, merged)

    def _push_merged(self, k, merged):
        if self._updater is not None and k in self._store:
            self._updater(k, NDArray(merged), self._store[k])
        elif k in self._store:
            stored = self._store[k]
            if stored.stype != 'default':   # re-compressed, as rebinding
                stored._rebind(stored._data + merged.to(stored._data.dtype))
                return
            with torch.no_grad():
                stored._data.add_(merged.to(stored._data.dtype))
        else:
            self._store[k] = NDArray(merged.clone())

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        for k, outs in _group(key, out):
            src = self._store[k]._data
            for o in outs:
                _write(o, src)

    def pushpull(self, key, value, out=None, priority=0):
        """Fused push + pull (reference PushPullDefault,
        kvstore_dist.h:578). Without an updater it is an allreduce: the
        targets get the sum of the values."""
        outs = dict(_group(key, out)) if out is not None else None
        for k, vals in _group(key, value):
            targets = outs[k] if outs is not None else vals
            merged = self._merge_local([vals], [targets])[0]
            self._finish(k, self._hop(k, merged), targets)

    def _hop(self, k, merged):
        """The cross-process hop of one key's local sum, ``(tensor,
        fresh)``; none here."""
        return merged

    def _finish(self, k, merged, targets):
        """Run the updater on a merged value (or not) and write the result
        to the targets. ``merged`` is ``(tensor, fresh)``: fresh when the
        tensor was made here, so that one NDArray target may take it as
        its payload."""
        merged, fresh = merged
        if self._updater is not None:
            if k not in self._store:
                raise ValueError(
                    f'pushpull with an updater requires key {k!r} to be '
                    'initialized first (init/broadcast), matching the '
                    'reference KVStore contract')
            self._updater(k, NDArray(merged), self._store[k])
            result, fresh = self._store[k]._data, False
        else:
            result = merged
            fresh = fresh and len(targets) == 1
        for t in targets:
            _write(t, result, fresh)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    # ---------------------------------------------------------- fused path
    def fused_pushpull(self, keys, values, outs=None, priorities=None):
        """Multi-key pushpull: ``values[i]`` is the replica list of
        ``keys[i]`` (a single value is one replica), ``outs[i]`` its
        targets (default: the replicas). ``priorities`` order the
        distributed hop (the Trainer's ``priority=-i``); here every key's
        replicas are summed in turn."""
        vals_lists = [_as_list(v) for v in values]
        targets = [_as_list(outs[i]) if outs is not None else vals_lists[i]
                   for i in range(len(keys))]
        merged = self._merge_local(vals_lists, targets)
        self._apply_merged(keys, merged, targets)

    def _merge_local(self, vals_lists, targets):
        """Each key's replica sum, as ``(tensor, fresh)``: written into
        its first target when that may take it (no updater), else into a
        new tensor; one replica is passed on as it is."""
        merged = []
        for vals, tgt in zip(vals_lists, targets):
            raws = [_raw(v) for v in vals]
            into = None if self._updater is not None else _into(raws, tgt)
            merged.append((_reduce(raws, into),
                           len(raws) > 1 and into is None))
        return merged

    def _apply_merged(self, keys, merged, targets):
        for k, m, t in zip(keys, merged, targets):
            self._finish(k, m, t)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull the rows ``row_ids`` of a stored table (reference
        PullRowSparse, include/mxnet/kvstore.h:221). A row-sparse stored
        value gives its retained rows; a dense one gathers the rows.
        Without ``out`` they come back as a ``RowSparseNDArray`` of those
        rows only; a row-sparse ``out`` takes them as its components, and
        a dense ``out`` in the same rows."""
        from ..ndarray.sparse import RowSparseNDArray, retain
        if isinstance(key, (list, tuple)):
            rids = row_ids if isinstance(row_ids, (list, tuple)) else \
                [row_ids] * len(key)
            outs = out if isinstance(out, (list, tuple)) else \
                [None] * len(key)
            return [self.row_sparse_pull(k, out=o, priority=priority,
                                         row_ids=r)
                    for k, o, r in zip(key, outs, rids)]
        stored = self._store[key]
        if row_ids is None:
            self.pull(key, out=out, priority=priority)
            return out
        if isinstance(stored, RowSparseNDArray):
            res = retain(stored, row_ids)
        else:
            value = stored._data
            rows = torch.as_tensor(_raw(row_ids) if isinstance(
                row_ids, NDArray) else row_ids, device=value.device).long()
            with torch.no_grad():
                res = RowSparseNDArray(value.index_select(0, rows), rows,
                                       value.shape)
        if out is None:
            return res
        for o in _as_list(out):
            if isinstance(o, RowSparseNDArray):
                o.data, o.indices = res.data, res.indices
                o._invalidate()
                continue
            cur = _raw(o).clone()
            cur[res.indices._data.to(cur.device)] = res.data._data.to(
                cur.device, cur.dtype)
            _write(o, cur, fresh=True)
        return out

    # ------------------------------------------------------ optimizer hooks
    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        from ..optimizer import get_updater
        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """Enable 2-bit compression (reference SetGradientCompression). On
        the in-process stores it only validates and records the
        parameters, and warns: compression applies on the distributed hop
        (``dist_tpu_sync``), as in the JAX package."""
        from .gradient_compression import GradientCompression
        gc = GradientCompression()
        gc.set_params(compression_params)
        if gc.active and type(self) in (KVStoreLocal, KVStoreDevice):
            warnings.warn(
                f'gradient compression is a no-op on the {self.NAME!r} '
                'kvstore: it applies only on the distributed hop '
                '(dist_tpu_sync)', UserWarning, stacklevel=2)
        self._gc = gc

    @property
    def gradient_compression(self):
        if self._gc is None:
            from .gradient_compression import GradientCompression
            self._gc = GradientCompression()
        return self._gc

    # ------------------------------------------------------------- topology
    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    @property
    def type(self):
        return self.NAME

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, 'updater is not initialized'
        with open(fname, 'wb') as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, 'updater is not initialized'
        with open(fname, 'rb') as f:
            self._updater.set_states(f.read())

    @staticmethod
    def is_capable(capability):
        return capability.lower() in ('optimizer', 'init')


@register
class KVStoreDevice(KVStoreLocal):
    """Reference ``device`` type (CommDevice): the same here, the replicas
    are summed on their device."""

    NAME = 'device'


KVStore = KVStoreLocal  # the classic class name
