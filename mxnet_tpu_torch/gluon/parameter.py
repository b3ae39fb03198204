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

One device: a list of several contexts raises (ROADMAP A10).
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


def _one_ctx(ctx):
    if ctx is None:
        return current_context()
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                f'parameters on several contexts {list(ctx)}: the port '
                f'keeps a parameter on one device (data-parallel replicas '
                f'are ROADMAP A10)')
        ctx = ctx[0]
    if not isinstance(ctx, Context):
        raise TypeError(f'ctx must be a Context, got {ctx!r}')
    return ctx


class Parameter:
    """A trainable parameter (reference gluon/parameter.py:47)."""

    def __init__(self, name='weight', grad_req='write', shape=None,
                 dtype='float32', lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype='default', grad_stype='default'):
        if stype != 'default' or grad_stype != 'default':
            raise MXNetError(f'{name}: sparse storage ({stype!r}, '
                             f'{grad_stype!r}) is not ported (ROADMAP A3 '
                             f'rest)')
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
        self._deferred_init = None
        self._structure_name = None  # set by Block.collect_params

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
        ctx = _one_ctx(ctx)
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
                                    device=ctx.to_torch()))
        desc = initializer.InitDesc(self.name, {'__init__': ''})
        if isinstance(init, initializer.Initializer):
            init(desc, proto)
        else:
            init(proto)
        self._deferred_init = None
        self._bind(proto._data)

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

    def _bind(self, value):
        """Make a new leaf holding ``value`` (detached) the payload."""
        value = value.detach().clone()
        floating = value.is_floating_point() or value.is_complex()
        if not floating:
            self._grad_req = 'null'
        self._var = torch.nn.Parameter(value, requires_grad=floating)
        self._info = _tape.AGInfo(grad=None, grad_req=self._grad_req)
        if floating:
            self._var.register_post_accumulate_grad_hook(
                _tape._write_grad(self._info))
        self._data = NDArray(self._var)
        self._init_grad()

    def _init_grad(self):
        """A zero grad buffer and the variable's marking, or neither for
        ``grad_req='null'`` (reference parameter.py:151 ``_init_grad``). A
        buffer that fits the leaf is zeroed in place, so that it keeps its
        address."""
        info = self._info
        info.grad_req = self._grad_req
        if self._grad_req == 'null':
            self._var.requires_grad_(False)
            info.grad = info.buf = None
            self._data._ag = None
            return
        self._var.requires_grad_(True)
        buf = info.buf
        if buf is not None and buf.shape == self._var.shape and \
                buf.dtype == self._var.dtype and \
                buf.device == self._var.device:
            with torch.no_grad():
                buf.zero_()
            if info.grad is None:
                info.grad = NDArray(buf)
            info.grad._data = buf
        else:
            info.grad = NDArray(torch.zeros_like(self._var).detach())
            info.buf = info.grad._data
        self._data._ag = info

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
        nd = self._data
        if nd._data is not self._var:
            with torch.no_grad():
                self._var.copy_(nd._data)
            nd._data = self._var
            nd._ag = self._info if self._grad_req != 'null' else None
        return self._var

    def data(self, ctx=None):
        """The value as an NDArray that is an autograd variable (reference
        parameter.py:567)."""
        sub = substitute(self)
        if sub is not None:
            return sub
        self._check_initialized()
        if ctx is not None and ctx != self._data.context:
            raise RuntimeError(
                f'Parameter {self.name} was not initialized on context '
                f'{ctx}. It was only initialized on {[self._data.context]}.')
        self._sync()
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer (reference parameter.py:604)."""
        self._check_initialized()
        if self._info.grad is None:
            raise RuntimeError(
                f'Cannot get gradient array for Parameter {self.name} '
                'because grad_req="null"')
        return self._info.grad

    def list_grad(self):
        self._check_initialized()
        return [] if self._info.grad is None else [self._info.grad]

    def list_ctx(self):
        if self._var is None and self._deferred_init is not None:
            return [self._deferred_init[1]]
        self._check_initialized()
        return [self._data.context]

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
                self._finish_init(initializer.Zero(), ctx, None)
        if isinstance(data, NDArray):
            src = data._data
        elif torch.is_tensor(data):
            src = data
        else:
            src = torch.from_numpy(_np.array(data))
        self._sync()
        with torch.no_grad():
            self._var.copy_(src.detach().reshape(self._var.shape))
        if self._grad_req != 'null':
            self._init_grad()

    def zero_grad(self):
        """Zero the grad buffer in place."""
        if self._info is None or self._info.grad is None:
            return
        self._info.grad._data = self._info.buf
        with torch.no_grad():
            self._info.buf.zero_()

    def _grad_buffer(self):
        """The grad buffer, after taking back a value written through its
        handle; None for ``grad_req='null'``."""
        return _tape.sync_grad(self._info)

    def reset_ctx(self, ctx):
        """Move the value to ``ctx``: a new leaf there (a block's captured
        graphs notice the new address and capture again)."""
        ctx = _one_ctx(ctx)
        if self._var is not None:
            self._bind(self._sync().detach().to(ctx.to_torch()))
        elif self._deferred_init is not None:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def cast(self, dtype):
        """Cast the value to ``dtype``: a new leaf (see :meth:`reset_ctx`)."""
        self.dtype = dtype
        if self._var is None:
            return
        self._bind(self._sync().detach().to(_dtypes.to_torch(dtype)))

    def var(self):
        raise NotImplementedError(
            'Symbol variables are not ported (ROADMAP A11: symbol/)')

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
        ctx = _one_ctx(ctx)
        self._bind(torch.as_tensor(self._value).to(
            device=ctx.to_torch(), dtype=_dtypes.to_torch(self.dtype)))
