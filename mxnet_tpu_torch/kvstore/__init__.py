"""``mx.kvstore`` of the port: key-value parameter synchronization.

Counterpart of ``mxnet_tpu/kvstore/`` (reference include/mxnet/kvstore.h:59
and src/kvstore/). ``local`` and ``device`` sum the replicas of a key in
one process; ``dist_tpu_sync`` (``dist``, ``dist_sync``,
``dist_sync_device``, ``dist_device_sync``) all-reduces across processes
over ``torch.distributed``, one process a rank; ``horovod`` and ``byteps``
delegate to an injected backend. The KVStore surface (init, push, pull,
pushpull, broadcast, rank, num_workers, barrier and the optimizer and
updater hooks) is the reference's, so the Trainer and the reference's
scripts run unchanged. The parameter server (``dist_async`` with
``rpc.py`` and ``faults.py``) is not ported yet (ROADMAP A10 rest).
"""

from .base import KVStoreBase
from .kvstore import KVStore, KVStoreLocal, KVStoreDevice
from .tpu import KVStoreTPUSync
from .plugins import Horovod, BytePS

__all__ = ['create', 'KVStoreBase', 'KVStore', 'KVStoreLocal',
           'KVStoreDevice', 'KVStoreTPUSync', 'Horovod', 'BytePS']


def create(name='local'):
    """The KVStore of type ``name`` (reference src/kvstore/kvstore.cc:42
    KVStore::Create), with the reference's aliases."""
    if not isinstance(name, str):
        raise TypeError('name must be a string')
    return KVStoreBase.get_kvstore(name)
