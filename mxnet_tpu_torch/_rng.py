"""Context-scoped random generators.

Counterpart of ``mxnet_tpu/_rng.py``. The reference gives every op a
per-device random resource so that user code never touches generator
state; the JAX package hides explicit keys behind ``next_key()``. Here
the resource is one ``torch.Generator`` per device: a stochastic op draws
from :func:`generator` of its device, which ``mx.random.seed`` reseeds.
A CUDA generator is made with ``torch.Generator(device=...)``, the kind
that a CUDA graph can register (:func:`graph_generators`): a hybridized
block's captured call draws from it, and each replay draws anew, so a
replay's numbers differ from an eager call's from the same seed (by design:
ROADMAP). :func:`drawing_from` makes every stochastic op draw from a given
generator instead, as the JAX package's trace provider hands out keys
from the ``rng_key`` a pure function is given.
"""

import contextlib

import threading

import numpy as _np
import torch

__all__ = ['seed', 'generator', 'current_numpy_rng', 'get_state',
           'set_state', 'graph_generators', 'drawing_from']

_lock = threading.Lock()
_gens = {}          # torch.device -> torch.Generator
_seed = [None]      # the last mx.random.seed, or None for a random one


def _key(device):
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


_override = threading.local()


def generator(device):
    """The generator of ``device``, made and seeded on first use: from the
    last :func:`seed`, else from numpy's global stream, as the reference
    draws its first key. Inside :func:`drawing_from`, that block's
    generator."""
    forced = getattr(_override, 'gen', None)
    if forced is not None:
        return forced
    dev = _key(device)
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            s = _seed[0]
            gen.manual_seed(int(_np.random.randint(0, 2**31 - 1))
                            if s is None else s)
            _gens[dev] = gen
    return gen


@contextlib.contextmanager
def drawing_from(gen):
    """Every stochastic op of this thread draws from ``gen`` inside the
    block (a pure function's generator, the counterpart of its JAX
    ``rng_key``)."""
    prev = getattr(_override, 'gen', None)
    _override.gen = gen
    try:
        yield gen
    finally:
        _override.gen = prev


def graph_generators(device):
    """The generators a CUDA graph captured on ``device`` registers, so
    that its stochastic ops draw new numbers on every replay: the device's
    generator, on a torch whose graphs take generators; else none, and a
    replay repeats its capture's draws."""
    from ._graphs import captures_generators
    dev = torch.device(device)
    if dev.type != 'cuda' or not captures_generators():
        return ()
    return (generator(dev),)


def seed(seed_state, ctx='all'):
    """Seed the generator of every device (``ctx='all'``) or of one
    context's device (reference python/mxnet/random.py:seed)."""
    s = int(seed_state)
    with _lock:
        if ctx == 'all' or ctx is None:
            _seed[0] = s
            devs = list(_gens)
        else:
            from .context import resolve_device
            devs = [_key(resolve_device(ctx))]
    for dev in devs:
        generator(dev).manual_seed(s)


_state = threading.local()


def current_numpy_rng():
    """Host-side numpy Generator for initializers and data augmentation."""
    if not hasattr(_state, 'np_rng'):
        _state.np_rng = _np.random.default_rng()
    return _state.np_rng


def get_state():
    """Snapshot every random stream a step consumes, as host data: each
    device generator's state, the host numpy Generator and numpy's legacy
    global stream. :func:`set_state` restores it, so that a resumed run
    draws what the uninterrupted one would."""
    with _lock:
        gens = {str(d): g.get_state().clone() for d, g in _gens.items()}
    return {'generators': gens, 'seed': _seed[0],
            'np_rng': current_numpy_rng().bit_generator.state,
            'np_global': _np.random.get_state()}


def set_state(state):
    """Restore a snapshot taken by :func:`get_state`."""
    _seed[0] = state['seed']
    for dev, st in state['generators'].items():
        generator(dev).set_state(st)
    current_numpy_rng().bit_generator.state = state['np_rng']
    _np.random.set_state(state['np_global'])
