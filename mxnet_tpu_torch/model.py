"""NDArray-map files and checkpoints.

Counterpart of ``mxnet_tpu/model.py`` in the same format: an ``.npz`` of
named arrays with the magic key ``__mxnet_tpu_format__`` holding the
format version, so that a file either package saves loads in the other.
Gluon's ``save_parameters``/``load_parameters`` and ``npx.save``/
``npx.load`` go through :func:`save_ndarray_map`/:func:`load_ndarray_map`.
:func:`save_checkpoint`/:func:`load_checkpoint` are the reference's
symbol-and-parameters pair (``{prefix}-symbol.json`` and
``{prefix}-{epoch:04d}.params.npz`` with ``arg:``/``aux:`` keys).

``load_checkpoint`` returns the loaded symbol when ``{prefix}-symbol.json``
exists, as MXNet's does; the JAX package returns ``None`` in its place
(ROADMAP C16).
"""

import os

import numpy as _np

from .ndarray.ndarray import NDArray, array

__all__ = ['save_ndarray_map', 'load_ndarray_map', 'save_checkpoint',
           'load_checkpoint']

_MAGIC_KEY = '__mxnet_tpu_format__'


def save_ndarray_map(fname, data):
    """``mx.nd.save`` (reference ndarray.cc:1697 NDArray::Save): an
    NDArray, a list of them or a dict of named ones (numpy arrays too)."""
    if isinstance(data, NDArray):
        data = {'0': data}
    elif isinstance(data, (list, tuple)):
        data = {str(i): v for i, v in enumerate(data)}
    arrays = {k: v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v)
              for k, v in data.items()}
    arrays[_MAGIC_KEY] = _np.array([2, 0])  # format version
    # through a handle: np.savez given a path appends '.npz' to it
    with open(fname, 'wb') as f:
        _np.savez(f, **arrays)


def load_ndarray_map(fname, ctx=None):
    """``mx.nd.load`` (reference ndarray.cc:1820 NDArray::Load): a dict of
    NDArrays on ``ctx`` (default: the current context), or a list when
    every key is an index."""
    with _np.load(fname, allow_pickle=False) as z:
        out = {k: array(z[k], ctx=ctx) for k in z.files if k != _MAGIC_KEY}
    keys = list(out)
    if keys and all(k.isdigit() for k in keys):
        return [out[str(i)] for i in range(len(keys))]
    return out


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Reference model.py save_checkpoint: ``{prefix}-symbol.json`` (when
    ``symbol`` is given) and ``{prefix}-{epoch:04d}.params.npz``, the
    parameters keyed ``arg:<name>`` and ``aux:<name>``."""
    data = {}
    for k, v in (arg_params or {}).items():
        data[f'arg:{k}'] = v
    for k, v in (aux_params or {}).items():
        data[f'aux:{k}'] = v
    save_ndarray_map(f'{prefix}-{epoch:04d}.params.npz', data)
    if symbol is not None:
        symbol.save(f'{prefix}-symbol.json', remove_amp_cast)


def load_checkpoint(prefix, epoch):
    """Reference model.py load_checkpoint: ``(symbol, arg_params,
    aux_params)``, the arrays on the current context; ``symbol`` is None
    when the prefix has no symbol file."""
    from .symbol import load as sym_load
    data = load_ndarray_map(f'{prefix}-{epoch:04d}.params.npz')
    arg_params, aux_params = {}, {}
    for k, v in data.items():
        if k.startswith('arg:'):
            arg_params[k[4:]] = v
        elif k.startswith('aux:'):
            aux_params[k[4:]] = v
    sym_file = f'{prefix}-symbol.json'
    sym = sym_load(sym_file) if os.path.exists(sym_file) else None
    return sym, arg_params, aux_params
