"""Gluon ``Parameter`` and ``Constant``.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference
python/mxnet/gluon/parameter.py: Parameter:47, ``_finish_deferred_init``
:336, ``data``:567, ``grad``:604, Constant:708), with the same deferred
initialization, ``grad_req``, ``lr_mult``/``wd_mult`` and structural
names.

The payload is one ``torch.nn.Parameter`` leaf on one device. ``data()``
hands it out as an NDArray that is an autograd variable (``_tape``'s
machinery): while ``autograd.record()`` records, torch accumulates into
the leaf and a hook moves the gradient into the parameter's grad buffer
as ``grad_req`` says. The buffer exists from initialization, as zeros
(reference ``_init_grad``), and is written in place for its life: the
hook copies or adds into it, ``zero_grad`` and ``set_data`` zero it, and
a write through its handle (``p.grad()[:] = 0``) is copied back into it
before it is next read or written (``_tape.sync_grad``). So a Trainer's
captured update graph reads every new gradient at one address.

The leaf keeps its address for the parameter's life, except where its
dtype or device changes (``cast``, ``reset_ctx``): a CUDA graph reads a
weight at its address at capture, and the optimizer kernels update it in
place. So every write goes into the leaf in place: ``set_data`` copies
into it, and a write through the NDArray handle (``p.data()[:] = v``),
which rebinds the handle to a fresh tensor as NDArray writes do, is
copied back into the leaf the next time ``data()`` is read.

Several contexts (``initialize(ctx=[gpu(0), gpu(1)])``, the reference's
single-process data parallelism, JAX ``parameter.py:150-265``) give one
replica a context: the first context's is the leaf above, each other one
a leaf of its own with its own grad buffer. ``data()`` and ``grad()``
with no context are the first replica's, which blocks read, as the JAX
package's blocks do; ``data(ctx)``, ``list_data()``, ``list_grad()`` and
``list_ctx()`` reach the others, and ``set_data`` writes every one. The
Trainer sums the replicas' gradients through its kvstore and writes the
update to each. ``cpu(i)`` contexts are distinct replicas on the host,
as the JAX package's virtual CPU devices are.

Under ``mx.sharding`` (reference ``parameter.py:46-51``, :232-240) a
hybridized call places the parameter by the partition rules
(:meth:`Parameter._shard_to`): the leaf then holds only this rank's shard
(a new leaf, and a grad buffer of the shard's shape), ``_sharding_spec``
and ``_sharding_mesh`` name its spec and context, and ``data()`` is a
sharded NDArray whose ``shape`` is the global shape and whose
``asnumpy()`` gathers. ``set_data`` takes the global value and keeps this
rank's shard of it. ``shard_blocks`` (``{dim: k}``) lays a dim out in
``k`` blocks, each split alike (BERT's fused ``qkv``: every rank then holds
its heads of Q, K and V).
"""

import contextlib
import threading

import numpy as _np
import torch

from .. import _dtypes, _tape
from .. import initializer
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray

__all__ = ['Parameter', 'Constant', 'DeferredInitializationError']

_SUBST = threading.local()


@contextlib.contextmanager
def substituted(values):
    """Inside the block, ``data()`` of a parameter ``p`` with ``id(p)`` in
    ``values`` returns ``values[id(p)]`` (an NDArray) instead of its own
    value, in this thread: ``HybridBlock.pure_function`` runs the forward
    on the tensors it is given this way, and writes no parameter."""
    prev = getattr(_SUBST, 'values', None)
    _SUBST.values = values
    try:
        yield
    finally:
        _SUBST.values = prev


def substitute(param):
    """The value :func:`substituted` gives ``param`` here, or None."""
    values = getattr(_SUBST, 'values', None)
    return None if values is None else values.get(id(param))


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape was known (reference
    parameter.py:DeferredInitializationError)."""


def _ctx_list(ctx):
    """``ctx`` (None for the current context, a Context or a list of
    them) as a list of distinct Contexts."""
    if ctx is None:
        return [current_context()]
    ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
    if not ctxs:
        raise ValueError('ctx is an empty list')
    for c in ctxs:
        if not isinstance(c, Context):
            raise TypeError(f'ctx must be a Context, got {c!r}')
    if len(set(ctxs)) != len(ctxs):
        raise ValueError(f'ctx lists a context twice: {ctxs}')
    return ctxs


def _new_leaf(value, grad_req):
    """A leaf holding ``value`` (detached), its autograd record and its
    NDArray handle; the record's hook moves each gradient into the grad
    buffer."""
    value = value.detach().clone()
    floating = value.is_floating_point() or value.is_complex()
    var = torch.nn.Parameter(value, requires_grad=floating)
    info = _tape.AGInfo(grad=None, grad_req=grad_req)
    if floating:
        var.register_post_accumulate_grad_hook(_tape._write_grad(info))
    handle = NDArray(var)
    handle._param = True    # for mx.sharding's check of whole values
    return var, handle, info


def _reset_grad(var, data, info, grad_req):
    """A zero grad buffer and the variable's marking, or neither for
    ``grad_req='null'``. A buffer that fits the leaf is zeroed in place,
    so that it keeps its address."""
    info.grad_req = grad_req
    info.rsp = None
    if grad_req == 'null':
        var.requires_grad_(False)
        info.grad = info.buf = None
        data._ag = None
        return
    var.requires_grad_(True)
    buf = info.buf
    if buf is not None and buf.shape == var.shape and \
            buf.dtype == var.dtype and buf.device == var.device:
        with torch.no_grad():
            buf.zero_()
        if info.grad is None:
            info.grad = NDArray(buf)
        info.grad._data = buf
    else:
        info.grad = NDArray(torch.zeros_like(var).detach())
        info.buf = info.grad._data
    data._ag = info


def _surface(info):
    """A variable's gradient as the user sees it: the row-sparse one the
    last backward left, else the grad buffer's handle."""
    return info.rsp if info.rsp is not None else info.grad


def _sync_leaf(var, data, info, grad_req):
    """The leaf, after taking back a value written through its handle."""
    if data._data is not var:
        with torch.no_grad():
            var.copy_(data._data)
        data._data = var
        data._ag = info if grad_req != 'null' else None
    return var


class _Replica:
    """The leaf of a parameter on a context after the first."""

    __slots__ = ('ctx', 'var', 'data', 'info')

    def __init__(self, ctx, value, grad_req):
        self.ctx = ctx
        self.var, self.data, self.info = _new_leaf(
            value.to(ctx.to_torch()), grad_req)
        _reset_grad(self.var, self.data, self.info, grad_req)

    def sync(self, grad_req):
        return _sync_leaf(self.var, self.data, self.info, grad_req)


class Parameter:
    """A trainable parameter (reference gluon/parameter.py:47)."""

    def __init__(self, name='weight', grad_req='write', shape=None,
                 dtype='float32', lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype='default', grad_stype='default'):
        for what, st in (('stype', stype), ('grad_stype', grad_stype)):
            if st not in ('default', 'row_sparse', 'csr'):
                raise ValueError(f'{name}: unknown {what} {st!r}')
        self._name = name
        self._grad_req = grad_req if differentiable else 'null'
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._stype = stype
        self._grad_stype = grad_stype
        self._var = None    # the torch.nn.Parameter leaf
        self._data = None   # the NDArray handle over it
        self._info = None   # its autograd record: grad buffer, grad_req
        self._ctxs = None   # its contexts, the leaf's first
        self._replicas = []     # a _Replica for each context after it
        self._deferred_init = None
        self._structure_name = None  # set by Block.collect_params
        self._layout = None         # sharding.dispatch.Layout of the leaf
        self._sharding_spec = None  # its PartitionSpec under a mesh
        self._sharding_mesh = None  # and the ShardingContext
        self.shard_blocks = {}

    # ------------------------------------------------------------------ props
    @property
    def name(self):
        return self._structure_name or self._name

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        if len(self._shape) != len(new_shape) or not all(
                s1 in (0, -1, None) or s1 == s2
                for s1, s2 in zip(self._shape, new_shape)):
            raise ValueError(
                f'Expected shape {self._shape} is incompatible with given '
                f'shape {new_shape} for Parameter {self.name}')
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ('write', 'add', 'null'):
            raise ValueError(f'grad_req must be write, add or null, got '
                             f'{req!r}')
        if not self._differentiable:
            req = 'null'
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._var is not None:
            self._init_grad()

    @property
    def stype(self):
        return self._stype

    def _shape_known(self):
        return self._shape is not None and all(
            s not in (0, -1, None) and s > 0 for s in self._shape)

    # ------------------------------------------------------------------- init
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Reference parameter.py:initialize; deferred while the shape is
        unknown and ``allow_deferred_init``. ``init`` (the block-wide
        initializer) takes precedence over the parameter's own, as in the
        JAX package."""
        if self._var is not None and not force_reinit:
            return
        default_init = default_init or initializer.Uniform()
        ctx = _ctx_list(ctx)
        if not self._shape_known():
            if self._allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError(
                f'Cannot initialize Parameter {self.name} because it has '
                f'invalid shape: {self._shape}.')
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        init = init or self.init or default_init
        if isinstance(init, str):
            init = initializer.create(init)
        proto = NDArray(torch.zeros(self._shape,
                                    dtype=_dtypes.to_torch(self.dtype),
                                    device=ctx[0].to_torch()))
        desc = initializer.InitDesc(self.name, {'__init__': ''})
        if isinstance(init, initializer.Initializer):
            init(desc, proto)
        else:
            init(proto)
        self._deferred_init = None
        self._bind(proto._data, ctx)

    def _finish_deferred_init(self):
        """Reference parameter.py:336: called once the shape is known."""
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f'Parameter {self.name} has unknown shape {self._shape}')
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f'Parameter {self.name}: deferred initialization inside a '
                f'CUDA graph capture; run the block once before it is '
                f'captured (its first call after hybridize() does)')
        init, ctx, default_init = self._deferred_init
        self._finish_init(init, ctx, default_init)

    def _bind(self, value, ctxs=None):
        """Make a new leaf holding ``value`` (detached) the payload, and a
        replica of it on each context of ``ctxs`` after the first
        (default: the contexts it has)."""
        if not (value.is_floating_point() or value.is_complex()):
            self._grad_req = 'null'
        self._var, self._data, self._info = _new_leaf(value, self._grad_req)
        ctxs = ctxs or self._ctxs or [self._data.context]
        self._ctxs = list(ctxs)
        self._replicas = [_Replica(c, self._var, self._grad_req)
                          for c in ctxs[1:]]
        self._init_grad()

    def _init_grad(self):
        """Zero grad buffers and the variables' marking, or neither for
        ``grad_req='null'`` (reference parameter.py:151 ``_init_grad``),
        on every replica; buffers keep their address."""
        _reset_grad(self._var, self._data, self._info, self._grad_req)
        for r in self._replicas:
            _reset_grad(r.var, r.data, r.info, self._grad_req)

    # ------------------------------------------------------------------ access
    def _check_initialized(self):
        if self._var is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f'Parameter {self.name} has not been initialized yet '
                    'because initialization was deferred. Actual '
                    'initialization happens during the first forward pass.')
            raise RuntimeError(
                f'Parameter {self.name} has not been initialized. You '
                'should initialize parameters and create Trainer with '
                'Block.collect_params() instead of Block.params')

    def _sync(self):
        """The leaf, after taking back a value written through the NDArray
        handle (a write rebinds the handle; the leaf keeps its address)."""
        return _sync_leaf(self._var, self._data, self._info, self._grad_req)

    def _replica(self, ctx):
        """The replica of ``ctx``: None for the first context, else its
        :class:`_Replica`; raises for a context the parameter is not on."""
        if ctx is None or ctx == self._ctxs[0]:
            return None
        for r in self._replicas:
            if r.ctx == ctx:
                return r
        raise RuntimeError(
            f'Parameter {self.name} was not initialized on context {ctx}. '
            f'It was only initialized on {self._ctxs}.')

    def data(self, ctx=None):
        """The value on ``ctx`` (default: the first context's) as an
        NDArray that is an autograd variable (reference
        parameter.py:567)."""
        sub = substitute(self)
        if sub is not None:
            return sub
        self._check_initialized()
        rep = self._replica(ctx)
        if rep is not None:
            rep.sync(self._grad_req)
            return rep.data
        self._sync()
        self._data._layout = self._layout
        return self._data

    def list_data(self):
        """The value on every context, in ``list_ctx()``'s order."""
        return [self.data(c) for c in self.list_ctx()]

    def _datas(self):
        """Every replica's leaf (synced), the first context's first."""
        return [self._sync()] + [r.sync(self._grad_req)
                                 for r in self._replicas]

    def grad(self, ctx=None):
        """The gradient on ``ctx`` (reference parameter.py:604): the grad
        buffer, or the ``RowSparseNDArray`` the last backward gave a
        ``grad_stype='row_sparse'`` parameter (the buffer is then not
        written)."""
        self._check_initialized()
        if self._info.grad is None:
            raise RuntimeError(
                f'Cannot get gradient array for Parameter {self.name} '
                'because grad_req="null"')
        rep = self._replica(ctx)
        return _surface(self._info if rep is None else rep.info)

    def list_grad(self):
        self._check_initialized()
        if self._info.grad is None:
            return []
        return [_surface(i) for i in
                [self._info] + [r.info for r in self._replicas]]

    def list_ctx(self):
        if self._var is None and self._deferred_init is not None:
            return list(self._deferred_init[1])
        self._check_initialized()
        return list(self._ctxs)

    def set_data(self, data):
        """Set the value (reference parameter.py:set_data): copied into the
        leaf in place, cast to the parameter's dtype, so that a captured
        graph and the optimizer see it; the grad buffer is zeroed, as the
        reference re-marks the variable."""
        self.shape = data.shape
        if self._var is None:
            if self._deferred_init is not None:
                self._finish_deferred_init()
            else:
                ctx = data.context if isinstance(data, NDArray) \
                    else current_context()
                self._finish_init(initializer.Zero(), [ctx], None)
        if isinstance(data, NDArray):
            src = data._data if data._layout is None \
                else torch.from_numpy(data.asnumpy())
        elif torch.is_tensor(data):
            src = data
        else:
            src = torch.from_numpy(_np.array(data))
        if self._layout is not None:
            from ..sharding.dispatch import cut
            src = cut(src.detach().reshape(self._layout.gshape).to(
                self._var.device), self._layout)
        with torch.no_grad():
            for var in self._datas():
                var.copy_(src.detach().reshape(var.shape))
        if self._grad_req != 'null':
            self._init_grad()

    def zero_grad(self):
        """Zero every grad buffer in place."""
        if self._info is None or self._info.grad is None:
            return
        for info in [self._info] + [r.info for r in self._replicas]:
            info.rsp = None
            info.grad._data = info.buf
            with torch.no_grad():
                info.buf.zero_()

    def _grad_buffer(self):
        """The grad buffer, after taking back a value written through its
        handle; None for ``grad_req='null'``."""
        return _tape.sync_grad(self._info)

    def _grad_buffers(self):
        """Every replica's grad buffer (synced), the first context's
        first; empty for ``grad_req='null'``."""
        if self._info is None or self._info.grad is None:
            return []
        return [_tape.sync_grad(i) for i in
                [self._info] + [r.info for r in self._replicas]]

    def reset_ctx(self, ctx):
        """Move the value to ``ctx`` (a context or a list): new leaves
        there (a block's captured graphs notice the new address and
        capture again)."""
        ctx = _ctx_list(ctx)
        if self._var is not None:
            self._bind(self._sync().detach().to(ctx[0].to_torch()), ctx)
        elif self._deferred_init is not None:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def cast(self, dtype):
        """Cast the value to ``dtype``: new leaves (see :meth:`reset_ctx`)."""
        self.dtype = dtype
        if self._var is None:
            return
        self._bind(self._sync().detach().to(_dtypes.to_torch(dtype)))

    # --------------------------------------------------------------- sharding
    def _full(self):
        """The global value as a detached tensor (gathered where the leaf
        is a shard: a collective)."""
        var = self._sync().detach()
        if self._layout is None:
            return var
        from ..sharding.dispatch import gather_tensor
        with torch.no_grad():
            return gather_tensor(var, self._layout)

    def _shard_to(self, ctx, spec):
        """Keep this rank's shard of the value at ``spec`` on the
        :class:`..sharding.ShardingContext` ``ctx`` (a new leaf, its grad
        buffer of the shard's shape); a spec that splits nothing keeps the
        whole value."""
        from ..sharding import dispatch as _dispatch
        from ..sharding.dispatch import Layout, cut
        lay = Layout(ctx, spec, self._shape, blocks=self.shard_blocks,
                     param=True)
        if self._layout is not None and self._layout.same(lay):
            return
        full = self._full()
        if lay.sharded:
            self._bind(cut(full, lay), self._ctxs)
            self._layout = lay
            _dispatch.made = True
        else:
            if self._layout is not None:
                self._bind(full, self._ctxs)
            self._layout = None
        self._sharding_spec = lay.pspec()
        self._sharding_mesh = ctx

    def _unshard(self):
        """Hold the whole value again (a gather where it is sharded)."""
        if self._layout is not None:
            full = self._full()
            self._layout = None
            self._bind(full, self._ctxs)
        self._sharding_spec = self._sharding_mesh = None

    def var(self):
        """Refused, as the JAX package refuses it: a symbol's variables
        come from ``HybridBlock.export``'s trace, which names them by the
        parameters' structural names."""
        raise NotImplementedError(
            'Parameter.var is not supported; use HybridBlock.export (or '
            '_trace_symbol) for graph capture, as the JAX package does')

    def __repr__(self):
        return (f'Parameter {self.name} (shape={self._shape}, '
                f'dtype={self.dtype})')


class Constant(Parameter):
    """A parameter that is not differentiable and keeps its value
    (reference parameter.py:708). The value stays on the host until
    ``initialize`` places it."""

    def __init__(self, value, name='const'):
        host = value.asnumpy() if isinstance(value, NDArray) \
            else _np.asarray(value)
        # Python data narrows to 32 bits, as array() does
        host = host.astype({'f': _np.float32, 'i': _np.int32}.get(
            host.dtype.kind, host.dtype)) if host.dtype.itemsize == 8 \
            else host
        self._value = host
        super().__init__(name=name, grad_req='null', shape=host.shape,
                         dtype=host.dtype, differentiable=False, init=None)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._var is not None and not force_reinit:
            return
        ctx = _ctx_list(ctx)
        self._bind(torch.as_tensor(self._value).to(
            device=ctx[0].to_torch(), dtype=_dtypes.to_torch(self.dtype)),
            ctx)
