"""Core shared definitions of the PyTorch port: the error hierarchy and the
class registries (counterpart of ``mxnet_tpu/base.py``)."""


class MXNetError(RuntimeError):
    """Base error type for the framework (reference: python/mxnet/error.py)."""


_registries = {}


def register(klass):
    """Class-registry decorator factory, mirroring dmlc registry semantics
    (reference: python/mxnet/registry.py). Used by LRScheduler.
    """
    registry = _registries.setdefault(klass, {})

    def do_register(subclass_or_name):
        def _reg(subclass, name=None):
            if name is None:
                name = subclass.__name__
            registry[name.lower()] = subclass
            return subclass

        if isinstance(subclass_or_name, str):
            return lambda subclass: _reg(subclass, subclass_or_name)
        return _reg(subclass_or_name)

    return do_register


def registry_create(klass, name, *args, **kwargs):
    registry = _registries.get(klass, {})
    if isinstance(name, klass):
        return name
    key = name.lower()
    if key not in registry:
        raise ValueError(
            f'Cannot find registered {klass.__name__} with name {name}. '
            f'Registered: {sorted(registry)}')
    return registry[key](*args, **kwargs)
