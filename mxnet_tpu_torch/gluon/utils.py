"""``gluon.utils`` (counterpart of ``mxnet_tpu/gluon/utils.py``, reference
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``shape_is_known``. ``download``
waits (ROADMAP A11): nothing in the port reaches a network.
"""

import hashlib
import warnings

import torch

from ..ndarray.ndarray import NDArray, array

__all__ = ['split_data', 'split_and_load', 'clip_global_norm', 'check_sha1',
           'shape_is_known']


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (reference
    utils.py:split_data); the last takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f'data with shape {data.shape} cannot be evenly split into '
            f'{num_slice} slices along axis {batch_axis}.')
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(begin, end)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` over ``ctx_list`` and copy each slice there
    (reference utils.py:split_and_load); one context gives the whole
    batch."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` so that their joint 2-norm is at most ``max_norm``
    (reference utils.py:clip_global_norm); returns the norm before. The
    scaled arrays are rebound (NDArray value semantics)."""
    if not arrays:
        raise ValueError('clip_global_norm needs at least one array')
    total = torch.sqrt(sum(torch.sum(a._data.detach().float() ** 2)
                           for a in arrays))
    total_norm = float(total)
    if check_isfinite and not torch.isfinite(total):
        warnings.warn('nan or inf is detected. Clipping results will be '
                      'undefined.', stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr._rebind(arr._data * scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, 'rb') as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def shape_is_known(shape):
    if shape is None:
        return False
    return all(s is not None and s > 0 for s in shape)
