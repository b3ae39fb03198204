"""Sharded values and the eager dispatch over them.

A sharded NDArray holds this rank's shard as its tensor and a
:class:`Layout` (the context, the spec of each dim, the global shape):
``.shape`` is the global shape, and ``asnumpy()`` gathers the global value,
a collective that every rank of the mesh calls. Where the JAX package
leaves the partitioning of every op to GSPMD, an op over sharded inputs
here takes one of these forms, by what it computes:

* **elementwise** (the ``elemwise`` ops, activations, dropout): inputs laid
  out alike run on their shards; an unsharded operand of the same global
  extent on a sharded dim is cut to this rank's shard first (the
  reference's ``lift_raws``), one that broadcasts over it is taken as is;
* **row-wise** (products with a weight, norms, softmax over a later axis,
  attention, lookups, reshapes and reductions that keep dim 0): a batch
  sharded on the data axis runs on its rows;
* **tensor-parallel** forms: a product whose weight is ``P('tp', None)``
  is column-parallel (its output stays a local slice of the last dim), one
  whose weight is ``P(None, 'tp')`` row-parallel (it takes the local slice
  and sums over ``tp``); an embedding on ``P('tp', None)`` looks up its own
  rows and sums over ``tp``; attention over a ``tp``-sliced embedding runs
  on its local heads; a split of a slice laid out in blocks (BERT's fused
  ``qkv``) stays local;
* a **sum or mean over the data axis** reduces the rows it has and sums
  over ``dp`` (the gradient passes through unchanged);
* **anything else** gathers its sharded inputs first (the FSDP form,
  always correct) and gives an unsharded result.

A parameter's gathered value keeps its gradient path: the gradient of a
piece gathered over the data axis is summed over it (each rank saw other
rows of the batch) and this rank's piece kept; over any other axis this
rank's piece is kept. The autograd forms are :mod:`._collectives`'. A
batch gathered whole, or reduced over ``dp``, is the same on every rank
of ``dp`` from then on, so a parameter or a batch split on ``dp``
meeting it while autograd records raises (:func:`check_whole`): the
gradients would count every rank, or miss the others'.
"""

import math

import numpy as _np
import torch

from .. import _tape
from ..ndarray.ndarray import NDArray, array, context_of
from ..ops import registry as _registry
from . import _collectives as C
from .rules import PartitionSpec as P

__all__ = ['Layout', 'shard', 'local', 'gather_value', 'gather_tensor',
           'cut', 'redistribute', 'lift', 'invoke', 'is_sharded']


def _axes(entry, ctx):
    if entry is None:
        return ()
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in axes if ctx.size(a) > 1)


class Layout:
    """How a value lies over a mesh: for each dim the mesh axes it is split
    over (major first), the block count of each split (1: contiguous
    pieces; k: each of k equal blocks split alike, BERT's fused ``qkv``),
    the global shape, and whether it is a parameter's value."""

    __slots__ = ('ctx', 'spec', 'blocks', 'gshape', 'param')

    def __init__(self, ctx, spec, gshape, blocks=None, param=False):
        self.ctx = ctx
        gshape = tuple(int(d) for d in gshape)
        entries = tuple(spec) + (None,) * (len(gshape) - len(spec))
        self.spec = tuple(_axes(e, ctx) for e in entries[:len(gshape)])
        if blocks is None:
            blocks = {}
        if isinstance(blocks, dict):
            blocks = tuple(tuple((blocks.get(d, 1) if j == 0 else 1)
                                 for j in range(len(a)))
                           for d, a in enumerate(self.spec))
        self.blocks = tuple(tuple(b) for b in blocks)
        self.gshape = gshape
        self.param = param

    @property
    def sharded(self):
        return any(self.spec)

    def pspec(self):
        """The spec as a :class:`.rules.PartitionSpec`."""
        out = [None if not a else (a[0] if len(a) == 1 else a)
               for a in self.spec]
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def factor(self, d):
        return math.prod(self.ctx.size(a) for a in self.spec[d])

    def local_shape(self):
        return tuple(g // self.factor(d) for d, g in enumerate(self.gshape))

    def same(self, other):
        return other is not None and self.ctx.same_mesh(other.ctx) and \
            self.spec == other.spec and self.blocks == other.blocks and \
            self.gshape == other.gshape

    def axes(self):
        return {a for s in self.spec for a in s}

    def replace(self, spec=None, gshape=None, blocks=None, param=False):
        """A layout like this one with the given spec (as per-dim axis
        tuples), global shape and blocks."""
        lay = Layout.__new__(Layout)
        lay.ctx = self.ctx
        lay.spec = tuple(spec) if spec is not None else self.spec
        lay.gshape = tuple(gshape) if gshape is not None else self.gshape
        lay.blocks = tuple(blocks) if blocks is not None else tuple(
            (1,) * len(a) for a in lay.spec)
        lay.param = param
        return lay

    def __repr__(self):
        return f'Layout({self.pspec()!r}, {self.gshape}, ' \
               f'blocks={self.blocks})'


def is_sharded(x):
    return getattr(x, '_layout', None) is not None


#: True once this process has made a sharded value (the registry scans
#: a call's arguments for one only then)
made = False


def shard(tensor, layout):
    """An NDArray of this rank's shard ``tensor`` laid out by ``layout``
    (an unsharded NDArray when the layout splits nothing)."""
    global made
    out = NDArray(tensor)
    out._layout = layout if layout is not None and layout.sharded else None
    made = made or out._layout is not None
    return out


def local(x):
    """The shard of ``x`` as an unsharded NDArray (the same tensor)."""
    if not is_sharded(x):
        return x
    out = NDArray(x._data)
    out._ag = x._ag
    return out


def cut(t, layout, grad=False):
    """This rank's shard of the full tensor ``t`` under ``layout``
    (``grad``: the cut's backward gathers)."""
    ctx = layout.ctx
    for d, axes in enumerate(layout.spec):
        for j, a in enumerate(axes):
            n, i, k = ctx.size(a), ctx.coord(a), layout.blocks[d][j]
            t = C.scatter(t, ctx.group(a), d, k, i, n) if grad \
                else C.take(t, d, n, i, k)
    return t.contiguous()


def gather_tensor(t, layout, param=None):
    """The full tensor of the shard ``t``: the gathers, innermost axis
    first. The backward keeps this rank's piece, summed over the data axis
    first for a parameter's value (``param``, default the layout's)."""
    ctx = layout.ctx
    param = layout.param if param is None else param
    for d in range(len(layout.spec)):
        axes = layout.spec[d]
        for j in reversed(range(len(axes))):
            a = axes[j]
            mode = 'sum' if param and a == ctx.data_axis else 'slice'
            t = C.gather(t, ctx.group(a), d, layout.blocks[d][j],
                         ctx.coord(a), mode)
    return t


def gather_value(x):
    """The global value of ``x`` as an unsharded NDArray (a collective
    where ``x`` is sharded)."""
    if not is_sharded(x):
        return x
    return NDArray(gather_tensor(x._data, x._layout))


def redistribute(x, ctx, spec, blocks=None):
    """``x`` laid out at ``spec`` on ``ctx``: gathered where it lies
    otherwise, then cut to this rank's shard (with gradients)."""
    layout = Layout(ctx, spec, x.shape, blocks=blocks)
    if is_sharded(x) and x._layout.same(layout):
        return x
    full = gather_tensor(x._data, x._layout) if is_sharded(x) else x._data
    if not layout.sharded:
        return NDArray(full)
    return shard(cut(full, layout, grad=True), layout)


# --------------------------------------------------------------- dispatch
def _nd_slots(args, kwargs):
    """``(where, NDArray)`` for every NDArray argument: ``('a', i, j)``
    (j None, or the index in a list argument) or ``('k', name, None)``."""
    out = []
    for i, a in enumerate(args):
        if isinstance(a, NDArray):
            out.append((('a', i, None), a))
        elif isinstance(a, (list, tuple)):
            for j, e in enumerate(a):
                if isinstance(e, NDArray):
                    out.append((('a', i, j), e))
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            out.append((('k', k, None), v))
    return out


def _put(args, kwargs, where, value):
    kind, i, j = where
    if kind == 'k':
        kwargs[i] = value
    elif j is None:
        args[i] = value
    else:
        seq = list(args[i])
        seq[j] = value
        args[i] = seq


def _run(op, args, kwargs):
    return _registry.invoke(op, tuple(args), kwargs)


def _wrap(res, layout_of):
    """Attach ``layout_of(i, out)`` to each output."""
    if isinstance(res, tuple):
        return tuple(shard(o._data, layout_of(i, o)) if layout_of(i, o)
                     else o for i, o in enumerate(res))
    lay = layout_of(0, res)
    return shard(res._data, lay) if lay is not None else res


def lift(arrays):
    """The reference's ``lift_raws`` for a list of NDArrays (see
    :func:`_elementwise`): unsharded arrays of a sharded peer's global
    shape are cut to this rank's shard."""
    lays = [a._layout for a in arrays if is_sharded(a)]
    if not lays:
        return list(arrays)
    lay = lays[0]
    return [shard(cut(a._data, lay, grad=True), lay)
            if not is_sharded(a) and tuple(a.shape) == lay.gshape else a
            for a in arrays]


def _gather_all(args, kwargs, slots):
    for where, nd in slots:
        if is_sharded(nd):
            _put(args, kwargs, where, gather_value(nd))


def _fallback(op, args, kwargs, slots):
    whole = _tape.is_recording() and any(
        _batch_split(nd) for _, nd in slots)
    _gather_all(args, kwargs, slots)
    if not whole:
        return _run(op, args, kwargs)
    # the gathered batch is whole here: no parameter may meet it
    check_whole([_mark_whole(nd) if _batch_split(old) else nd
                 for (_, old), (_, nd) in zip(slots,
                                              _nd_slots(args, kwargs))])
    return _mark_whole(_run(op, args, kwargs))


def _batch_split(nd):
    """True for an activation split on the data axis (not a
    parameter's value)."""
    return is_sharded(nd) and not nd._layout.param and \
        nd._layout.ctx.data_axis in nd._layout.axes()


#: True once a value gathered whole from a batch split on dp exists in
#: this process (the registry checks each recorded op only then)
seen = False


def _mark_whole(res):
    """Mark results computed whole from a batch split on ``dp``: what
    follows is the same on every rank of ``dp``, so a parameter it reaches
    would get its gradient ``dp`` times over the Trainer's sum."""
    global seen
    seen = True
    for o in (res if isinstance(res, tuple) else (res,)):
        o._dp_whole = True
    return res


def check_whole(arrays):
    """Raise where a parameter, or a batch split on ``dp``, meets a value
    computed whole from a batch split on ``dp`` (gathered, or reduced over
    it) while autograd records (see :func:`_mark_whole`): the gradients
    would count every rank, or miss the others'. Returns whether such a
    value is among ``arrays``."""
    if not any(getattr(a, '_dp_whole', False) for a in arrays):
        return False
    if any(getattr(a, '_param', False) or _batch_split(a) or (
            is_sharded(a) and a._layout.param) for a in arrays):
        from ..base import MXNetError
        raise MXNetError(
            'sharding: a parameter or a batch split on dp meets a value '
            'computed whole from that batch (gathered, or reduced over '
            'dp) while autograd records; the gradients would count every '
            'dp rank. Keep the batch split up to the parameters (row-wise '
            'ops), and reduce over dp last')
    return True


def _broadcast(shapes):
    return tuple(_np.broadcast_shapes(*shapes)) if shapes else ()


def _elementwise(op, args, kwargs, slots):
    lays = [nd._layout for _, nd in slots if is_sharded(nd)]
    lay = lays[0]
    if any(not lay.same(l) for l in lays[1:]):
        return _fallback(op, args, kwargs, slots)
    try:
        if _broadcast([nd.shape for _, nd in slots]) != lay.gshape:
            return _fallback(op, args, kwargs, slots)
    except ValueError:
        return _fallback(op, args, kwargs, slots)
    nd_all = len(lay.gshape)
    for where, nd in slots:
        if is_sharded(nd):
            _put(args, kwargs, where, local(nd))
            continue
        shp = nd.shape
        off = nd_all - len(shp)
        need = False
        for d, axes in enumerate(lay.spec):
            dd = d - off
            if not axes or dd < 0 or shp[dd] == 1:
                continue
            need = True
        if not need:
            continue
        if off or any(shp[d] not in (1, lay.gshape[d])
                      for d in range(len(shp))):
            return _fallback(op, args, kwargs, slots)
        full = nd._data.expand(lay.gshape) if shp != lay.gshape \
            else nd._data
        _put(args, kwargs, where, NDArray(cut(full, lay, grad=True)))
    # a value of parameters alone stays one: its gathers sum over dp
    out = lay.replace(blocks=lay.blocks, param=all(l.param for l in lays))
    return _wrap(_run(op, args, kwargs),
                 lambda i, o: out if tuple(o._data.shape) ==
                 lay.local_shape() else None)


def _norm_axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % ndim for a in axes) if ndim else ()


def _arg(args, kwargs, pos, name, default=None):
    if name in kwargs:
        return kwargs[name]
    if pos is not None and len(args) > pos:
        return args[pos]
    return default


def _batch_layout(nd):
    """The layout of ``nd`` when it is split on the data axis along dim 0
    and nowhere else, else None."""
    lay = nd._layout if is_sharded(nd) else None
    if lay is None or lay.ctx.data_axis is None:
        return None
    if lay.spec[0] != (lay.ctx.data_axis,) or any(lay.spec[1:]) or \
            lay.blocks[0] != (1,):
        return None
    return lay


def _rowwise(op, args, kwargs, slots, batch):
    """Run on this rank's rows: every batch argument (the slots in
    ``batch``) split on the data axis along dim 0, or unsharded with the
    global batch extent (then cut); the other arguments whole (gathered
    when sharded). The outputs of the batch extent are split alike."""
    lay = None
    for where, nd in slots:
        if where in batch and is_sharded(nd):
            lay = _batch_layout(nd)
            if lay is None:
                return None
            break
    if lay is None:
        return None
    g0 = lay.gshape[0]
    for where, nd in slots:
        if where in batch:
            if is_sharded(nd):
                bl = _batch_layout(nd)
                if bl is None or not bl.ctx.same_mesh(lay.ctx) or \
                        bl.gshape[0] != g0:
                    return None
                _put(args, kwargs, where, local(nd))
            elif nd.ndim and nd.shape[0] == g0:
                blay = Layout(lay.ctx, P(lay.ctx.data_axis), nd.shape)
                _put(args, kwargs, where,
                     NDArray(cut(nd._data, blay, grad=True)))
        elif is_sharded(nd):
            _put(args, kwargs, where, gather_value(nd))
    n0 = lay.local_shape()[0]

    def layout_of(i, o):
        s = tuple(o._data.shape)
        if s and s[0] == n0:
            return Layout(lay.ctx, P(lay.ctx.data_axis), (g0,) + s[1:])
        return None
    return layout_of


def _slot(slots, pos=None, name=None):
    for where, nd in slots:
        if where[0] == 'a' and where[1] == pos and where[2] is None:
            return where, nd
        if where[0] == 'k' and where[1] == name:
            return where, nd
    return None, None


def _rows(op, args, kwargs, slots, batch):
    got = _rowwise(op, args, kwargs, slots, batch)
    if got is None:
        return _fallback(op, args, kwargs, slots)
    return _wrap(_run(op, args, kwargs), got)


def _tp_of(lay, d):
    """The tensor-parallel axis that alone splits dim ``d``, or None."""
    if lay is None or not lay.spec[d] or len(lay.spec[d]) != 1:
        return None
    a = lay.spec[d][0]
    return None if a == lay.ctx.data_axis else a


def _only(lay, d):
    """True when dim ``d`` is the only one ``lay`` splits."""
    return all(not s for i, s in enumerate(lay.spec) if i != d)


def _rest_layout(xlay, ctx, lead, last, last_axis=None, blocks=1):
    """The layout of an output whose leading dims lie as ``xlay``'s (on
    the data axis or not) and whose last dim is ``last`` wide, split on
    ``last_axis`` in ``blocks`` blocks."""
    spec = [(ctx.data_axis,) if xlay is not None and i == 0 else ()
            for i in range(len(lead))] + [(last_axis,) if last_axis else ()]
    bl = [(1,) if s else () for s in spec]
    if last_axis:
        bl[-1] = (blocks,)
    lay = Layout.__new__(Layout)      # every field set by replace
    lay.ctx = ctx
    return lay.replace(spec=spec, gshape=tuple(lead) + (last,), blocks=bl)


def _dense(op, args, kwargs, slots):
    """``fully_connected``: column- or row-parallel by its weight's layout,
    else row-wise with the weight whole."""
    wsl, w = _slot(slots, 1, 'weight')
    xsl, x = _slot(slots, 0, 'data')
    wl = w._layout if is_sharded(w) else None
    col = wl is not None and _only(wl, 0) and _tp_of(wl, 0)
    row = wl is not None and _only(wl, 1) and _tp_of(wl, 1)
    if not (col or row) or x is None:
        return _rows(op, args, kwargs, slots, {xsl})
    ctx = wl.ctx
    axis = col or row
    group, n, i = ctx.group(axis), ctx.size(axis), ctx.coord(axis)
    flatten = _arg(args, kwargs, 5, 'flatten', True)
    bsl, b = _slot(slots, 2, 'bias')
    xl = x._layout if is_sharded(x) else None
    # the batch rows stay where they are; any other split is gathered
    xb = _batch_layout(x) if xl is not None else None
    lead_g = list(x.shape[:-1]) if not flatten else [x.shape[0]]
    if col:
        if xl is not None and xb is None:
            x = gather_value(x)
        xt = local(x)._data if xb is not None else x._data
        xt = C.read_by_all(xt, group)
        _put(args, kwargs, xsl, NDArray(xt))
        _put(args, kwargs, wsl, local(w))
        units = wl.gshape[0]
        if b is not None:
            bl = b._layout if is_sharded(b) else None
            if bl is not None and bl.spec[0] == (axis,):
                _put(args, kwargs, bsl, local(b))
            else:
                bt = gather_value(b)._data if bl is not None else b._data
                _put(args, kwargs, bsl, NDArray(C.scatter(
                    bt, group, 0, wl.blocks[0][0], i, n)))
        kwargs['num_hidden'] = units // n
        res = _run(op, args, kwargs)
        lay = _rest_layout(xb, ctx, lead_g, units, axis, wl.blocks[0][0])
        return _wrap(res, lambda j, o: lay)
    # row-parallel: the input's last dim split alike (a flattened input's
    # flattened dim), then the sum
    if xl is not None and _tp_of(xl, len(xl.spec) - 1) == axis and \
            xl.blocks[-1] == (1,) and not (flatten and x.ndim > 2) and all(
                not s or s == (ctx.data_axis,) and k == 0
                for k, s in enumerate(xl.spec[:-1])):
        xt = x._data
        xb = x._layout if xl.spec[0] == (ctx.data_axis,) else None
    else:
        if xl is not None and xb is None:
            x = gather_value(x)
        base = local(x)._data if xb is not None else x._data
        if flatten and base.dim() > 2:
            base = base.reshape(base.shape[0], -1)
        xt = C.scatter(base, group, base.dim() - 1, 1, i, n)
    _put(args, kwargs, xsl, NDArray(xt))
    _put(args, kwargs, wsl, local(w))
    if b is not None:
        _put(args, kwargs, bsl, None)
    kwargs['no_bias'] = True
    if len(args) > 2:
        args[2] = None
    res = _run(op, args, kwargs)
    out = C.sum_over(res._data, group)
    if b is not None:
        bt = gather_value(b)._data if is_sharded(b) else b._data
        out = out + bt
    lay = _rest_layout(xb, ctx, lead_g, wl.gshape[0])
    return shard(out, lay) if lay.sharded else NDArray(out)


def _embedding(op, args, kwargs, slots):
    """A lookup in a table split on its rows over a model axis: the rows
    this rank holds, zeros elsewhere, summed over the axis."""
    _, w = _slot(slots, 1, 'weight')
    isl, ids = _slot(slots, 0, 'data')
    wl = w._layout if is_sharded(w) else None
    axis = _tp_of(wl, 0) if wl is not None and _only(wl, 0) else None
    if axis is None:
        return _rows(op, args, kwargs, slots, {isl})
    ctx = wl.ctx
    group, n, i = ctx.group(axis), ctx.size(axis), ctx.coord(axis)
    il = _batch_layout(ids) if is_sharded(ids) else None
    if is_sharded(ids) and il is None:
        ids = gather_value(ids)
    it = local(ids)._data if il is not None else ids._data
    out = vocab_lookup(it, local(w)._data, group, i)
    lay = _rest_layout(il, ctx, list(ids.shape), wl.gshape[1])
    return shard(out, lay) if lay.sharded else _plain(out)


def vocab_lookup(ids, w, group, index):
    """The rows ``ids`` of a table split on its rows over the ranks of
    ``group``, of which this rank holds piece ``index``, ``w``: the rows
    held here, zeros elsewhere, summed over the group (Megatron's
    vocab-parallel embedding)."""
    lo = index * w.shape[0]
    ids = ids.long()
    mine = (ids >= lo) & (ids < lo + w.shape[0])
    part = torch.nn.functional.embedding(
        torch.where(mine, ids - lo, torch.zeros_like(ids)), w)
    return C.sum_over(part * mine.unsqueeze(-1).to(part.dtype), group)


def _plain(t):
    return NDArray(t)


def _attention(op, args, kwargs, slots):
    """``multi_head_attention`` over an embedding split on a model axis:
    the local heads; else row-wise."""
    qsl, q = _slot(slots, 0, 'q')
    ksl, k = _slot(slots, 1, 'k')
    vsl, v = _slot(slots, 2, 'v')
    msl, _ = _slot(slots, 4, 'mask')
    batch = {s for s in (qsl, ksl, vsl, msl) if s is not None}
    ql = q._layout if is_sharded(q) else None
    last = ql is not None and _tp_of(ql, len(ql.spec) - 1)
    if not last or ql.blocks[-1] != (1,) or not all(
            is_sharded(t) and t._layout.same(ql) for t in (k, v)):
        return _rows(op, args, kwargs, slots, batch)
    ctx = ql.ctx
    heads = _arg(args, kwargs, 3, 'num_heads')
    n = ctx.size(last)
    if heads % n:
        return _fallback(op, args, kwargs, slots)
    for sl, t in ((qsl, q), (ksl, k), (vsl, v)):
        _put(args, kwargs, sl, local(t))
    if len(args) > 3:
        args[3] = heads // n
    else:
        kwargs['num_heads'] = heads // n
    m = _slot(slots, 4, 'mask')[1]
    if m is not None:
        if is_sharded(m) and ql.spec[0] == (ctx.data_axis,) and \
                _batch_layout(m) is not None:
            _put(args, kwargs, msl, local(m))
        elif is_sharded(m):
            _put(args, kwargs, msl, gather_value(m))
        elif ql.spec[0] == (ctx.data_axis,) and m.shape[0] == ql.gshape[0]:
            blay = Layout(ctx, P(ctx.data_axis), m.shape)
            _put(args, kwargs, msl, _plain(cut(m._data, blay, grad=True)))
    return _wrap(_run(op, args, kwargs), lambda i, o: ql)


def _batch_norm_train(op, args, kwargs, slots):
    """Training-mode BatchNorm over a batch split on the data axis: the
    statistics of the whole batch, each per-channel sum taken over the
    rows this rank holds and summed over ``dp`` (forward and backward, as
    ``SyncBatchNorm`` does over the world); the output keeps the split."""
    xsl, x = slots[0]
    lay = _batch_layout(x)
    axis = _arg(args, kwargs, 4, 'axis', 1)
    if lay is None or axis % len(lay.gshape) == 0:
        return _fallback(op, args, kwargs, slots)
    axis %= len(lay.gshape)
    ctx = lay.ctx
    group = ctx.group(ctx.data_axis)
    gamma, beta = (gather_value(nd)._data
                   for nd in (_slot(slots, 1, 'gamma')[1],
                              _slot(slots, 2, 'beta')[1]))
    eps = _arg(args, kwargs, 3, 'eps', 1e-5)
    xt = local(x)._data
    red = tuple(i for i in range(xt.dim()) if i != axis)
    shape = [1] * xt.dim()
    shape[axis] = -1
    n = xt.numel() // xt.shape[axis] * ctx.size(ctx.data_axis)
    mean = C.sum_to_all(xt.sum(red), group) / n
    d = xt - mean.view(shape)
    var = C.sum_to_all((d * d).sum(red), group) / n
    if _arg(args, kwargs, 5, 'fix_gamma', False):
        gamma = torch.ones_like(gamma)
    out = d * torch.rsqrt(var.view(shape) + eps) * gamma.view(shape) \
        + beta.view(shape)
    return shard(out, lay), _plain(mean), _plain(var)


def _split(op, args, kwargs, slots):
    """A split along a dim laid out in as many blocks as sections: each
    section is this rank's; a split along another dim is row-wise when it
    keeps dim 0."""
    xsl, x = _slot(slots, 0, 'x')
    lay = x._layout
    axis = _arg(args, kwargs, 2, 'axis', 0) % len(lay.gshape)
    sections = _arg(args, kwargs, 1, 'indices_or_sections')
    if lay.spec[axis] and isinstance(sections, int) and \
            len(lay.spec[axis]) == 1 and lay.blocks[axis] == (sections,) \
            and all(not s or d == 0 and s == (lay.ctx.data_axis,)
                    for d, s in enumerate(lay.spec) if d != axis):
        _put(args, kwargs, xsl, local(x))
        g = list(lay.gshape)
        g[axis] //= sections
        bl = list(lay.blocks)
        bl[axis] = (1,)
        out = lay.replace(gshape=g, blocks=bl)
        return _wrap(_run(op, args, kwargs), lambda i, o: out)
    if axis == 0:
        return _fallback(op, args, kwargs, slots)
    return _rows(op, args, kwargs, slots, {xsl})


def _reduce(op, args, kwargs, slots):
    """A reduction: row-wise when it keeps dim 0; a sum or mean over all
    of a value split on the data axis along dim 0 sums the rows it has
    over ``dp``; anything else gathers."""
    xsl, x = slots[0]
    lay = _batch_layout(x)
    if lay is None:
        if is_sharded(x) and not _reduces_dim0(x, args, kwargs) and not \
                any(x._layout.spec[d] for d in _norm_axes(
                    _arg(args, kwargs, 1, 'axis'), x.ndim)):
            # keeps every split dim: runs on the shard
            lay0 = x._layout
            got = _keep_layout(lay0, x, args, kwargs)
            if got is not None:
                _put(args, kwargs, xsl, local(x))
                return _wrap(_run(op, args, kwargs), got)
        return _fallback(op, args, kwargs, slots)
    axes = _norm_axes(_arg(args, kwargs, 1, 'axis'), len(lay.gshape))
    if 0 not in axes:
        return _rows(op, args, kwargs, slots, {xsl})
    if op.name not in ('sum', 'mean'):
        return _fallback(op, args, kwargs, slots)
    ctx = lay.ctx
    _put(args, kwargs, xsl, local(x))
    if op.name == 'mean':
        # the local sum over the global count, summed over dp
        count = math.prod(lay.gshape[a] for a in axes)
        from ..ops.registry import get_op
        kw = dict(kwargs)
        res = _run(get_op('sum'), args, kw)
        t = res._data / count
        t = t.to(res._data.dtype)
    else:
        t = _run(op, args, kwargs)._data
    out = _plain(C.sum_over(t, ctx.group(ctx.data_axis)))
    return _mark_whole(out) if _tape.is_recording() else out


def _reduces_dim0(x, args, kwargs):
    return 0 in _norm_axes(_arg(args, kwargs, 1, 'axis'), x.ndim)


def _keep_layout(lay, x, args, kwargs):
    keep = bool(_arg(args, kwargs, 3, 'keepdims', False))
    axes = _norm_axes(_arg(args, kwargs, 1, 'axis'), x.ndim)
    spec = [s for d, s in enumerate(lay.spec) if keep or d not in axes]
    gsh = [1 if d in axes else g for d, g in enumerate(lay.gshape)
           if keep or d not in axes]
    bl = [b for d, b in enumerate(lay.blocks) if keep or d not in axes]
    out = lay.replace(spec=spec, gshape=gsh, blocks=bl, param=lay.param)
    return lambda i, o: out


def _reshape(op, args, kwargs, slots):
    """A reshape that keeps dim 0 of a batch split on the data axis: the
    new shape's first entry becomes this rank's rows; a reshape of the
    trailing dims of a value split on a model axis along its last dim,
    splitting it into (heads, head_dim), stays local."""
    xsl, x = slots[0]
    lay = _batch_layout(x)
    shape = kwargs.get('newshape', args[1] if len(args) > 1 else None)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if lay is None or not shape or shape[0] not in (lay.gshape[0], -1) or \
            (shape[0] == -1 and -1 in shape[1:]):
        return _fallback(op, args, kwargs, slots)
    n0 = lay.local_shape()[0]
    if shape[0] == -1:
        rest = math.prod(shape[1:])
        if rest <= 0 or math.prod(lay.gshape) // rest != lay.gshape[0]:
            return _fallback(op, args, kwargs, slots)
    new = (n0,) + shape[1:]
    if 'newshape' in kwargs:
        kwargs['newshape'] = new
    else:
        args[1] = new
    _put(args, kwargs, xsl, local(x))
    g0 = lay.gshape[0]
    return _wrap(_run(op, args, kwargs), lambda i, o: Layout(
        lay.ctx, P(lay.ctx.data_axis), (g0,) + tuple(o._data.shape[1:])))


def _getitem(op, args, kwargs, slots):
    """Indexing that keeps dim 0 whole (a key starting with ``:``) runs on
    the rows."""
    x = slots[0][1]
    key = kwargs.get('key')
    first = key[0] if isinstance(key, tuple) and key else key
    if isinstance(first, slice) and first == slice(None) and \
            _batch_layout(x) is not None and isinstance(key, tuple) and \
            all(not isinstance(k, type(x)) for k in key):
        return _rows(op, args, kwargs, slots, {slots[0][0]})
    return _fallback(op, args, kwargs, slots)


def _axis_not0(pos, name, default):
    def rule(op, args, kwargs, slots):
        x = slots[0][1]
        nd = len(x.shape)
        ax = _arg(args, kwargs, pos, name, default)
        if op.name in ('expand_dims', 'stack'):
            nd += 1
        axes = _norm_axes(ax, nd) if ax is not None else (0,)
        if 0 in axes:
            return _fallback(op, args, kwargs, slots)
        batch = {w for w, _ in slots}
        return _rows(op, args, kwargs, slots, batch)
    return rule


def _transpose(op, args, kwargs, slots):
    axes = _arg(args, kwargs, 1, 'axes')
    x = slots[0][1]
    if axes is None or tuple(axes)[0] % x.ndim != 0:
        return _fallback(op, args, kwargs, slots)
    return _rows(op, args, kwargs, slots, {slots[0][0]})


def _swapaxes(op, args, kwargs, slots):
    x = slots[0][1]
    a1 = _arg(args, kwargs, 1, 'axis1', 0) % x.ndim
    a2 = _arg(args, kwargs, 2, 'axis2', 1) % x.ndim
    if 0 in (a1, a2):
        return _fallback(op, args, kwargs, slots)
    return _rows(op, args, kwargs, slots, {slots[0][0]})


def _matmul(op, args, kwargs, slots):
    (asl, a), (bsl, b) = slots[0], slots[1]
    batch = {asl}
    if b.ndim >= 3 and a.ndim >= 3:
        batch.add(bsl)
    if a.ndim < 2:
        return _fallback(op, args, kwargs, slots)
    return _rows(op, args, kwargs, slots, batch)


def _first_rows(op, args, kwargs, slots):
    return _rows(op, args, kwargs, slots, {slots[0][0]})


def _all_rows(op, args, kwargs, slots):
    return _rows(op, args, kwargs, slots, {w for w, _ in slots})


def _softmaxish(pos):
    def rule(op, args, kwargs, slots):
        x = slots[0][1]
        axis = _arg(args, kwargs, pos, 'axis', -1)
        if axis is None or axis % x.ndim == 0:
            return _fallback(op, args, kwargs, slots)
        return _all_rows(op, args, kwargs, slots)
    return rule


_ACTIVATIONS = {'relu', 'sigmoid', 'gelu', 'silu', 'softplus', 'leaky_relu',
                'activation', 'hard_sigmoid', 'hard_swish', 'dropout',
                'copy', 'zeros_like', 'ones_like', 'full_like', 'amp_cast'}
_REDUCES = {'sum', 'mean', 'max', 'min', 'prod', 'norm', 'amax', 'amin',
            'argmax', 'argmin', 'nansum', 'nanmean', 'var', 'std', 'all',
            'any', 'average', 'nanmax', 'nanmin', 'nanprod'}

_RULES = {
    'fully_connected': _dense,
    'embedding': _embedding,
    'multi_head_attention': _attention,
    'split': _split,
    'reshape': _reshape,
    '_npi_getitem': _getitem,
    'transpose': _transpose,
    'swapaxes': _swapaxes,
    'matmul': _matmul,
    'dot': _matmul,
    'layer_norm': _first_rows,
    'rms_norm': _first_rows,
    'batch_norm_inference': _first_rows,
    'batch_norm_train': _batch_norm_train,
    'flatten': _first_rows,
    'l2_normalization': _first_rows,
    'flash_attention': _all_rows,
    'one_hot': _first_rows,
    'softmax': _softmaxish(1),
    'log_softmax': _softmaxish(1),
    'softmin': _softmaxish(1),
    'masked_softmax': _softmaxish(2),
    'masked_log_softmax': _softmaxish(2),
    'pick': _axis_not0(2, 'axis', -1),
    'take_along_axis': _axis_not0(2, 'axis', None),
    'expand_dims': _axis_not0(1, 'axis', None),
    'squeeze': _axis_not0(1, 'axis', None),
    'concatenate': _axis_not0(None, 'axis', 0),
    'stack': _axis_not0(None, 'axis', 0),
    'slice_axis': _axis_not0(1, 'axis', None),
}


def _rule(op):
    rule = _RULES.get(op.name)
    if rule is not None:
        return rule
    if op.name in _REDUCES:
        return _reduce
    if op.name in _ACTIVATIONS or op.fn.__module__.endswith('.elemwise'):
        return _elementwise
    return _fallback


def invoke(op, args, kwargs):
    """The frontend call of ``op`` where an argument is sharded (called by
    ``ops.registry.invoke``): the op's form above, on this rank's shards."""
    args, kwargs = list(args), dict(kwargs)
    out = kwargs.pop('out', None)
    dev = next(nd._data.device for _, nd in _nd_slots(args, kwargs)
               if is_sharded(nd))
    args = [array(a, ctx=context_of(dev)) if isinstance(a, _np.ndarray)
            else a for a in args]
    kwargs = {k: array(v, ctx=context_of(dev))
              if isinstance(v, _np.ndarray) else v
              for k, v in kwargs.items()}
    slots = _nd_slots(args, kwargs)
    whole = _tape.is_recording() and check_whole([nd for _, nd in slots])
    with torch.set_grad_enabled(_tape.is_recording()):
        res = _rule(op)(op, args, kwargs, slots)
    if whole:
        _mark_whole(res)
    if out is None:
        return res
    if isinstance(res, tuple):
        raise ValueError('out= not supported for multi-output op')
    out._rebind(res._data)
    out._layout = getattr(res, '_layout', None)
    return out
