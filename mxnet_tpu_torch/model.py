"""NDArray-map files: ``save_ndarray_map`` and ``load_ndarray_map``.

Counterpart of ``mxnet_tpu/model.py:18-41`` in the same format: an
``.npz`` of named arrays with the magic key ``__mxnet_tpu_format__``
holding the format version, so that a file either package saves loads in
the other. Gluon's ``save_parameters``/``load_parameters`` and
``npx.save``/``npx.load`` go through these. The checkpoint pair
(``save_checkpoint``/``load_checkpoint``) serves symbols, which the port
does not have yet.
"""

import numpy as _np

from .ndarray.ndarray import NDArray, array

__all__ = ['save_ndarray_map', 'load_ndarray_map']

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
