"""Horovod / BytePS kvstore plugins: the reference's delegation
structure over an injectable backend.

Counterpart of ``mxnet_tpu/kvstore/plugins.py`` (reference
python/mxnet/kvstore/horovod.py:25-160: broadcast is ``hvd.broadcast``,
pushpull ``hvd.allreduce``/``allreduce_``, rank, local_rank and size come
from the hvd module; python/mxnet/kvstore/byteps.py:26-224:
byteps_declare_tensor and byteps_push_pull, broadcast zeroes non-root
ranks and then push_pulls).

The backend is duck-typed: anything exposing the hvd (or bps) call
surface is injected with ``Horovod.set_backend(module)`` /
``BytePS.set_backend(module)``, and the tests drive the delegation with a
mock. Without a backend, and without the real package, both classes are
COMPAT ALIASES of :class:`.tpu.KVStoreTPUSync`: the same sum over ranks,
through ``torch.distributed``.
"""

from ..ndarray.ndarray import NDArray
from .base import register
from .kvstore import _raw, _reduce
from .tpu import KVStoreTPUSync, _world


def _reduce_replicas(vals):
    """Sum a list of local replicas into one value (the base store's local
    reduction before its collective), so that one collective carries the
    whole contribution."""
    if len(vals) == 1:
        return vals[0]
    total = _reduce([_raw(v) for v in vals])
    return NDArray(total) if isinstance(vals[0], NDArray) else total


def _resolve_backend(injected, module_name):
    if injected is not None:
        return injected
    try:
        import importlib
        return importlib.import_module(module_name)
    except ImportError:
        return None


@register
class Horovod(KVStoreTPUSync):
    """COMPAT ALIAS and delegation shell for the Horovod plugin.

    With a backend (injected with :meth:`set_backend`, or a real
    ``horovod.mxnet`` if one is installed) every collective delegates as
    the reference ``KVStoreHorovod`` does; without one the class is a
    COMPAT ALIAS of the ``dist_tpu_sync`` store."""

    NAME = 'horovod'
    _backend = None                  # class-level injection point

    @classmethod
    def set_backend(cls, hvd):
        """Inject an hvd-like module (``init/rank/local_rank/size/
        broadcast/allreduce/allreduce_``); ``None`` restores the alias."""
        cls._backend = hvd

    def __init__(self):
        super().__init__()
        self._hvd = _resolve_backend(type(self)._backend, 'horovod.mxnet')
        if self._hvd is not None:
            self._hvd.init()         # reference horovod.py:30

    # ------------------------------------------------------- delegation
    def broadcast(self, key, value, out, priority=0):
        """Reference horovod.py:42: rank-0's value to every rank's out
        via ``hvd.broadcast``."""
        if self._hvd is None:
            return super().broadcast(key, value, out, priority)
        if isinstance(value, (list, tuple)):
            # first replica wins: broadcast ships a value (rank 0's
            # weights), so k identical replicas must not be summed
            value = value[0]
        outs = out if isinstance(out, (list, tuple)) else [out]
        res = self._hvd.broadcast(tensor=value, root_rank=0,
                                  name=str(key), priority=priority)
        for o in outs:
            o[:] = res

    def pushpull(self, key, value, out=None, priority=0):
        """Reference horovod.py:78: allreduce_ in place when no out,
        else allreduce into out (sum, never average). A replica list is
        summed locally first, so that one allreduce carries the whole
        contribution and every out target receives the result."""
        if self._hvd is None:
            return super().pushpull(key, value, out, priority)
        if out is None:
            vals = value if isinstance(value, (list, tuple)) else [value]
            for v in vals:
                self._hvd.allreduce_(v, average=False, name=str(key),
                                     priority=priority)
        else:
            outs = out if isinstance(out, (list, tuple)) else [out]
            v = _reduce_replicas(value) \
                if isinstance(value, (list, tuple)) else value
            res = self._hvd.allreduce(v, average=False, name=str(key),
                                      priority=priority)
            for o in outs:
                o[:] = res

    def set_optimizer(self, optimizer):
        """Reference horovod.py:135: the plugin never runs the optimizer
        on a server; the Trainer keeps updates local."""
        if self._hvd is None:
            return super().set_optimizer(optimizer)

    @property
    def rank(self):
        return self._hvd.rank() if self._hvd is not None else super().rank

    @property
    def local_rank(self):
        if self._hvd is not None:
            return self._hvd.local_rank()
        return _world()[1]

    @property
    def num_workers(self):
        return self._hvd.size() if self._hvd is not None \
            else super().num_workers

    @property
    def type(self):
        return 'horovod' if self._hvd is not None else super().type


@register
class BytePS(KVStoreTPUSync):
    """COMPAT ALIAS and delegation shell for the BytePS plugin (reference
    python/mxnet/kvstore/byteps.py:26), as :class:`Horovod`.

    Every tensor is announced with ``byteps_declare_tensor`` and summed in
    place with ``byteps_push_pull``; broadcast zeroes the value on non-root
    ranks first, so that the push_pull sum is rank 0's value."""

    NAME = 'byteps'
    _backend = None

    @classmethod
    def set_backend(cls, bps):
        cls._backend = bps

    def __init__(self):
        super().__init__()
        self._bps = _resolve_backend(type(self)._backend, 'byteps.mxnet')
        if self._bps is not None:
            self._bps.init()         # reference byteps.py:43

    def _push_pull_inplace(self, key, tensor, priority):
        self._bps.byteps_declare_tensor(str(key))
        self._bps.byteps_push_pull(tensor, version=0, priority=priority,
                                   name=str(key), is_average=False)

    def broadcast(self, key, value, out, priority=0):
        """Reference byteps.py:46-102: non-root ranks zero their copy,
        then the push_pull sum carries rank-0's value to everyone."""
        if self._bps is None:
            return super().broadcast(key, value, out, priority)
        if isinstance(value, (list, tuple)):
            if len(value) != 1:
                # reference byteps.py asserts a single tensor
                raise ValueError(
                    'byteps broadcast takes a single tensor per key, '
                    f'got a {len(value)}-element replica list for key '
                    f'{key!r} (reference byteps.py asserts '
                    'a single NDArray)')
            value = value[0]
        outs = out if isinstance(out, (list, tuple)) else [out]
        inplace = len(outs) == 1 and value is outs[0]
        bval = value if inplace else value.copy()
        if self.rank != 0:
            bval[:] = bval * 0       # reference: __imul__(0) on non-root
        self._push_pull_inplace(key, bval, priority)
        bval.wait_to_read()          # reference: sync before training
        for o in outs:
            if o is not bval:
                o[:] = bval

    def pushpull(self, key, value, out=None, priority=0):
        """Reference byteps.py:105-160: declare and push_pull, in place
        when no out, else through a scratch copy into out. A replica list
        is summed locally first, so that no replica's gradient is
        dropped."""
        if self._bps is None:
            return super().pushpull(key, value, out, priority)
        vals = value if isinstance(value, (list, tuple)) else [value]
        if out is None:
            for v in vals:
                self._push_pull_inplace(key, v, priority)
            return
        outs = out if isinstance(out, (list, tuple)) else [out]
        scratch = _reduce_replicas(vals)
        if scratch is vals[0]:
            scratch = vals[0].copy()
        self._push_pull_inplace(key, scratch, priority)
        for o in outs:
            o[:] = scratch

    @property
    def rank(self):
        return self._bps.rank() if self._bps is not None else super().rank

    @property
    def local_rank(self):
        if self._bps is not None:
            return self._bps.local_rank()
        return _world()[1]

    @property
    def num_workers(self):
        return self._bps.size() if self._bps is not None \
            else super().num_workers

    @property
    def type(self):
        return 'byteps' if self._bps is not None else super().type
