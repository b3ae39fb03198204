"""Sparse NDArrays: row-sparse and CSR storage (``mx.nd.sparse``).

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference
``python/mxnet/ndarray/sparse.py`` over the storage types of
``include/mxnet/ndarray.h:61-66``). The component arrays are plain
tensors on the array's device: a row-sparse array holds ``indices`` (row
ids, int64) and ``data`` (those rows), a CSR array ``data``, ``indices``
(column ids) and ``indptr`` (row offsets). Nothing becomes dense unless
the reference converts it too: the dedicated paths (CSR and CSR-transposed
``dot`` by segment sum and scatter-add, their matvec forms, ``add`` of two
CSR or two row-sparse arrays, ``retain``, CSR row slicing and scalar math)
read and write the components only. Every other op takes the dense
equivalent (the reference's storage fallback, ``src/common/
exec_utils.h``), which ``_data`` makes once and keeps in the ``_dense``
slot.

A row-sparse array made by a backward (``Embedding(sparse_grad=True)``)
holds one entry a token occurrence: its ``indices`` may repeat
(``_may_have_duplicates``), and its dense value sums the repeats.
"""

import numpy as _np
import torch

from .ndarray import NDArray, array, context_of
from ..context import current_context, resolve_device

__all__ = ['BaseSparseNDArray', 'RowSparseNDArray', 'CSRNDArray',
           'row_sparse_array', 'csr_matrix', 'zeros', 'empty', 'dot',
           'retain', 'cast_storage', 'add', 'elemwise_add']


def _ids(x, device):
    """Row or column ids (an NDArray, a tensor, numpy data or a list) as
    int64 on ``device``."""
    if isinstance(x, NDArray):
        x = x._data.detach()
    if not torch.is_tensor(x):
        x = torch.as_tensor(_np.asarray(x, dtype=_np.int64))
    return x.to(device=device, dtype=torch.int64)


def _values(x, device=None):
    """Stored values as a tensor: an NDArray's or a tensor's on their own
    device unless ``device`` is given; host data through ``array`` (its
    dtype rules), on ``device`` or the current context."""
    if isinstance(x, NDArray):
        x = x._data.detach()
    if torch.is_tensor(x):
        return x.detach() if device is None else x.detach().to(device)
    ctx = None if device is None else context_of(device)
    return array(_np.asarray(x), ctx=ctx)._data


class BaseSparseNDArray(NDArray):
    """What the two storage types share. ``_data`` is the dense equivalent,
    made on first use and kept in ``_dense`` (the storage fallback); the
    shape, dtype and context come from the components."""

    def __init__(self, shape, dtype):
        self.__dict__['_dense'] = None
        super().__init__(None)
        self._shape = tuple(int(s) for s in shape)
        self._dtype = dtype

    @property
    def _data(self):
        d = self.__dict__.get('_dense')
        if d is None:
            d = self._to_dense_raw()
            self.__dict__['_dense'] = d
        return d

    @_data.setter
    def _data(self, value):
        self.__dict__['_dense'] = value

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        from .. import _dtypes
        return _dtypes.to_numpy(self._dtype)

    @property
    def size(self):
        return int(_np.prod(self._shape))

    @property
    def context(self):
        return context_of(self.data._data.device)

    ctx = context
    device = context

    def _invalidate(self):
        self.__dict__['_dense'] = None

    def _rebind(self, raw):
        """A write: the new dense value is compressed into the components
        again, which stay what every sparse path reads (the reference
        rewrites its aux arrays, ``ndarray.h:308``)."""
        fresh = cast_storage(NDArray(raw.detach()), self.stype)
        self._refresh_from(fresh)
        self.__dict__['_dense'] = raw.detach()
        if self._ag is not None and not self._ag.variable:
            self._ag = None

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == 'default':
            return self.todense()
        return cast_storage(self.todense(), stype)

    def todense(self):
        return NDArray(self._to_dense_raw())

    def asnumpy(self):
        return self._to_dense_raw().cpu().numpy()

    def copy(self):
        return self.copyto(self.context)

    def __repr__(self):
        return f'<{type(self).__name__} {self.shape} {self.dtype}>'


class RowSparseNDArray(BaseSparseNDArray):
    """The rows present (reference ``RowSparseNDArray``,
    ``kRowSparseStorage``): ``indices`` (n,) int64 row ids and ``data``
    (n,) + shape[1:]."""

    #: True for an array a backward made: one entry a token occurrence,
    #: so ``indices`` may repeat; consumers sum the repeats
    _may_have_duplicates = False

    def __init__(self, data, indices, shape, ctx=None):
        dev = None if ctx is None else resolve_device(ctx)
        vals = _values(data, dev)
        data = NDArray(vals)
        super().__init__(shape, vals.dtype)
        self.data = data
        self.indices = NDArray(_ids(indices, vals.device))

    @property
    def stype(self):
        return 'row_sparse'

    def _to_dense_raw(self):
        vals = self.data._data.detach()
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        idx = self.indices._data.long()
        if self._may_have_duplicates:
            return dense.index_add_(0, idx, vals)
        dense[idx] = vals
        return dense

    def copyto(self, other):
        if isinstance(other, NDArray) and not isinstance(other, type(self)):
            return super().copyto(other)
        dev = other.to_torch() if other is not None else None
        out = RowSparseNDArray(self.data._data.clone().to(dev),
                               self.indices._data.clone().to(dev),
                               self._shape)
        out._may_have_duplicates = self._may_have_duplicates
        return out

    def _refresh_from(self, fresh):
        self.data = fresh.data
        self.indices = fresh.indices
        self._may_have_duplicates = False

    def retain(self, rsp_indices):
        return retain(self, rsp_indices)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows (reference ``CSRNDArray``,
    ``kCSRStorage``): ``data`` (nnz,), ``indices`` (nnz,) int64 column ids,
    ``indptr`` (rows + 1,) int64 offsets."""

    def __init__(self, data, indptr, indices, shape, ctx=None):
        dev = None if ctx is None else resolve_device(ctx)
        vals = _values(data, dev)
        super().__init__(shape, vals.dtype)
        self.data = NDArray(vals)
        self.indptr = NDArray(_ids(indptr, vals.device))
        self.indices = NDArray(_ids(indices, vals.device))

    @property
    def stype(self):
        return 'csr'

    def _row_ids(self):
        """The row of each stored value: a search of ``indptr`` on the
        device, O(nnz log rows)."""
        ptr = self.indptr._data
        pos = torch.arange(self.data._data.shape[0], device=ptr.device)
        return torch.searchsorted(ptr, pos, right=True) - 1

    def _to_dense_raw(self):
        vals = self.data._data.detach()
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        dense[self._row_ids(), self.indices._data] = vals
        return dense

    def copyto(self, other):
        if isinstance(other, NDArray) and not isinstance(other, type(self)):
            return super().copyto(other)
        dev = other.to_torch() if other is not None else None
        return CSRNDArray(self.data._data.clone().to(dev),
                          self.indptr._data.clone().to(dev),
                          self.indices._data.clone().to(dev), self._shape)

    def _refresh_from(self, fresh):
        self.data = fresh.data
        self.indptr = fresh.indptr
        self.indices = fresh.indices

    def __getitem__(self, key):
        """Row slicing stays CSR, O(selected nnz) (the reference's
        ``CSRNDArray.__getitem__``); any other key takes the dense
        value."""
        if isinstance(key, int):
            key = slice(key, key + 1)
        if not isinstance(key, slice) or key.step not in (None, 1):
            return NDArray(self._to_dense_raw())[key]
        start, stop, _ = key.indices(self._shape[0])
        ptr = self.indptr._data
        lo, hi = (int(v) for v in ptr[[start, stop]].tolist())
        return CSRNDArray(self.data._data[lo:hi], ptr[start:stop + 1] - lo,
                          self.indices._data[lo:hi],
                          (stop - start, self._shape[1]))

    def _same_structure(self, vals):
        return CSRNDArray(vals, self.indptr._data, self.indices._data,
                          self._shape)

    def __mul__(self, other):
        if _np.isscalar(other):
            return self._same_structure(self.data._data * other)
        if isinstance(other, NDArray) and not isinstance(
                other, BaseSparseNDArray) and other.shape == self._shape:
            # csr * dense: the dense values at the stored coordinates
            at = other._data[self._row_ids(), self.indices._data]
            return self._same_structure(self.data._data * at)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if _np.isscalar(other):
            return self._same_structure(self.data._data / other)
        return NotImplemented

    def __neg__(self):
        return self._same_structure(-self.data._data)


# ------------------------------------------------------------ constructors
def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` and ``shape``, or the
    compression of a dense array (reference ``row_sparse_array``)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape, ctx)
    dense = arg1 if isinstance(arg1, NDArray) else array(arg1, ctx=ctx,
                                                         dtype=dtype)
    return cast_storage(dense, 'row_sparse')


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from scipy's ``(data, indices, indptr)`` and
    ``shape``, or the compression of a dense array (reference
    ``csr_matrix``)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indptr, indices, shape, ctx)
    dense = arg1 if isinstance(arg1, NDArray) else array(arg1, ctx=ctx,
                                                         dtype=dtype)
    return cast_storage(dense, 'csr')


def zeros(stype, shape, ctx=None, dtype='float32'):
    """An all-zero array of storage ``stype``: no stored value."""
    from .. import _dtypes
    dev = resolve_device(ctx if ctx is not None else current_context())
    dt = _dtypes.to_torch(dtype)
    shape = tuple(shape)
    if stype == 'row_sparse':
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int64, device=dev), shape)
    if stype == 'csr':
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                      device=dev),
                          torch.zeros((0,), dtype=torch.int64, device=dev),
                          shape)
    return NDArray(torch.zeros(shape, dtype=dt, device=dev))


empty = zeros


# ------------------------------------------------------------------- ops
def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` (reference ``cast_storage.cc``). The
    compression finds the nonzero rows or values on the array's device;
    their count is data-dependent, so it waits for the card."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == 'default':
        return arr
    dense = arr._data.detach()
    if stype == 'row_sparse':
        mask = (dense.reshape(dense.shape[0], -1) != 0).any(dim=1)
        idx = torch.nonzero(mask).flatten()
        return RowSparseNDArray(dense[idx], idx, dense.shape)
    if stype == 'csr':
        if dense.dim() != 2:
            raise ValueError('csr storage requires 2-D')
        rows, cols = torch.nonzero(dense, as_tuple=True)
        counts = torch.bincount(rows, minlength=dense.shape[0])
        indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                             device=dense.device)
        torch.cumsum(counts, 0, out=indptr[1:])
        return CSRNDArray(dense[rows, cols], indptr, cols, dense.shape)
    raise ValueError(f'unknown storage type {stype}')


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (reference ``src/operator/tensor/dot.cc``): CSR ·
    dense by a segment sum over the stored values, CSRᵀ · dense by a
    scatter-add (the embedding-gradient pattern), each with its matvec
    form; anything else through the dense equivalents."""
    if isinstance(lhs, CSRNDArray) and not isinstance(
            rhs, BaseSparseNDArray):
        vals = lhs.data._data
        cols = lhs.indices._data
        rows = lhs._row_ids()
        rd = rhs._data
        if transpose_b:
            rd = rd.t()
        vec = rd.dim() == 1          # matvec: (R, C) . (C,) -> (R,)
        scale = vals if vec else vals[:, None]
        if transpose_a:
            shape = (lhs.shape[1],) + tuple(rd.shape[1:])
            out = torch.zeros(shape, dtype=rd.dtype, device=rd.device)
            return NDArray(out.index_add_(0, cols, rd[rows] * scale))
        shape = (lhs.shape[0],) + tuple(rd.shape[1:])
        out = torch.zeros(shape, dtype=rd.dtype, device=rd.device)
        return NDArray(out.index_add_(0, rows, rd[cols] * scale))
    ld = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rd = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    a = ld._data.t() if transpose_a else ld._data
    b = rd._data.t() if transpose_b else rd._data
    from ..ops.linalg import dot as _dense_dot
    return NDArray(_dense_dot(a, b))


def retain(rsp, indices):
    """The rows of ``rsp`` whose ids are in ``indices`` (reference
    ``_retain``, what the kvstore's ``row_sparse_pull`` reads)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError('retain expects a RowSparseNDArray')
    have = rsp.indices._data
    want = _ids(indices, have.device)
    sel = torch.nonzero(torch.isin(have, want)).flatten()
    return RowSparseNDArray(rsp.data._data[sel], have[sel], rsp.shape)


def add(lhs, rhs):
    """``elemwise_add`` with the sparse forms of the reference
    (``elemwise_binary_op_basic.cc``): CSR + CSR stays CSR and row-sparse
    + row-sparse stays row-sparse, in O(nnz); anything else is dense."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray) \
            and lhs.shape == rhs.shape:
        ncol = lhs.shape[1]
        keys = torch.cat([lhs._row_ids() * ncol + lhs.indices._data,
                          rhs._row_ids() * ncol + rhs.indices._data])
        uniq, inv = torch.unique(keys, return_inverse=True)
        vals = torch.cat([lhs.data._data, rhs.data._data])
        out = torch.zeros(uniq.shape[0], dtype=vals.dtype,
                          device=vals.device).index_add_(0, inv, vals)
        rows = uniq // ncol
        counts = torch.bincount(rows, minlength=lhs.shape[0])
        indptr = torch.zeros(lhs.shape[0] + 1, dtype=torch.int64,
                             device=vals.device)
        torch.cumsum(counts, 0, out=indptr[1:])
        return CSRNDArray(out, indptr, uniq % ncol, lhs.shape)
    if isinstance(lhs, RowSparseNDArray) and isinstance(
            rhs, RowSparseNDArray) and lhs.shape == rhs.shape:
        ids = torch.cat([lhs.indices._data, rhs.indices._data])
        rows, inv = torch.unique(ids, return_inverse=True)
        vals = torch.cat([lhs.data._data, rhs.data._data])
        out = torch.zeros((rows.shape[0],) + tuple(vals.shape[1:]),
                          dtype=vals.dtype, device=vals.device)
        return RowSparseNDArray(out.index_add_(0, inv, vals), rows,
                                lhs.shape)
    ld = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rd = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return ld + rd


elemwise_add = add


# ------------------------------------------------------ row merge (static)
def merge_rows(ids, vals):
    """Sum the values of repeated row ids at a static size: ``(rows,
    merged, valid)``, each with the ``n`` entries of ``ids``. The first
    ``u`` entries are the ``u`` distinct ids in ascending order and their
    summed values; the other ``n - u`` are padding, marked False in
    ``valid``, that repeat the first row with zero values. No step waits
    for the card (the reference's ``jnp.unique(size=n, fill_value=-1)``,
    ``mxnet_tpu/optimizer/__init__.py:180-190``). The sort is stable, so
    the repeats of an id are summed in the order they came."""
    n = ids.shape[0]
    sid, order = torch.sort(ids.long(), stable=True)
    svals = vals.index_select(0, order)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    uniq = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
    uniq.scatter_(0, seg, sid)
    merged = torch.zeros_like(vals).index_add_(0, seg, svals)
    valid = uniq >= 0
    rows = torch.where(valid, uniq, uniq[:1])
    return rows, merged, valid
