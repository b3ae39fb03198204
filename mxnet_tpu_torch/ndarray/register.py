"""Namespace code generation from the op registry.

Counterpart of ``mxnet_tpu/ndarray/register.py`` (reference
python/mxnet/base.py:600, python/mxnet/ndarray/register.py:265-277): every
registered op gets a frontend function in the namespace module(s) its
``namespaces`` name, so ``mx.nd``, ``mx.np`` and ``mx.npx`` are populated
from the registry.
"""

from ..ops import registry as _reg


def populate(module_dict, namespace, extra_aliases=True):
    """Inject frontend functions for all ops tagged with ``namespace``."""
    seen = set()
    for name, op in _reg.list_ops().items():
        if namespace not in op.namespaces:
            continue
        if id(op) in seen and name == op.name:
            continue
        fn = _reg.make_frontend(op.name)
        module_dict.setdefault(name, fn)
        if extra_aliases and name == op.name:
            for a in op.aliases:
                module_dict.setdefault(a, fn)
        seen.add(id(op))
    return module_dict
