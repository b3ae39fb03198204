"""KVStore registry (counterpart of ``mxnet_tpu/kvstore/base.py``,
reference python/mxnet/kvstore/base.py:249,432).

Backends register by name; ``create('horovod')`` and the others resolve
here, with the reference's type-string aliases.
"""

KVSTORE_REGISTRY = {}

#: the reference's type-string aliases (src/kvstore/kvstore.cc:42-85)
ALIASES = {
    'local_allreduce_cpu': 'local',
    'local_allreduce_device': 'device',
    'nccl': 'device',
    'dist': 'dist_tpu_sync',
    'dist_sync': 'dist_tpu_sync',
    'dist_sync_device': 'dist_tpu_sync',
    'dist_device_sync': 'dist_tpu_sync',
}


def register(klass):
    """Register a KVStoreBase subclass under its ``NAME`` (reference
    kvstore/base.py:432)."""
    name = getattr(klass, 'NAME', klass.__name__).lower()
    KVSTORE_REGISTRY[name] = klass
    return klass


class KVStoreBase:
    """Abstract KVStore (reference kvstore/base.py:249): ``broadcast`` is
    Init + Pull, ``pushpull`` is PushPull, beside the classic push/pull."""

    OPTIMIZER = 'optimizer'

    @staticmethod
    def register(klass):
        return register(klass)

    @staticmethod
    def get_kvstore(name):
        name = ALIASES.get(name.lower(), name.lower())
        if name not in KVSTORE_REGISTRY:
            raise ValueError(f'Unknown KVStore type {name!r}; registered: '
                             f'{sorted(KVSTORE_REGISTRY)}')
        return KVSTORE_REGISTRY[name]()

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    @staticmethod
    def is_capable(capability):
        raise NotImplementedError

    @property
    def rank(self):
        raise NotImplementedError

    @property
    def num_workers(self):
        raise NotImplementedError
