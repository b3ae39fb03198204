"""Imperative autograd state and backward, on ``torch.autograd``.

Counterpart of ``mxnet_tpu/_tape.py``. The thread-local ``is_recording``
and ``is_training`` flags are the reference's (imperative.h:309-323);
the tape itself is torch's graph: while recording, ops run with grad mode
on (``ops.registry.apply_op``), so each result carries its ``grad_fn``.

A variable (``attach_grad``, :func:`mark_variables`) is an NDArray whose
payload is a leaf tensor that requires grad, with a hook that moves what
torch accumulates into the variable's own grad buffer, as its
``grad_req`` says: ``'write'`` copies into it, ``'add'`` adds into it,
``'null'`` records but never writes. A write into a variable (``x += 1``,
``x[...] = v``) makes a fresh leaf of the new value, so the marking
outlives it (``NDArray._rebind``).

The grad buffer is written in place and keeps its address for its life,
so that a captured update graph reads each new gradient there. A user's
write through the buffer's handle (``p.grad()[:] = 0``) rebinds the
handle, as NDArray writes do; :func:`sync_grad` copies that value back
into the buffer before the buffer is read or written.

A row-sparse gradient (``Embedding(sparse_grad=True)``, whose lookup
gives torch a sparse COO gradient: one entry a token occurrence) is never
written into the buffer under ``grad_req='write'``: the hook keeps it as a
``RowSparseNDArray`` in ``AGInfo.rsp`` (the reference's ``RowSparseCot``,
``mxnet_tpu/_tape.py:77``), which ``Parameter.grad()`` returns. Under
``'add'`` it is added into the buffer, which is then what counts, as the
reference densifies there.

:func:`backward` keeps the graph (``retain_graph=True`` to torch): the
JAX tape re-linearizes a node whose residuals a first backward dropped,
so a second ``backward()`` over the same heads gives the same gradients
there, and does here.
"""

import threading

import torch

_state = threading.local()


def _st():
    if not hasattr(_state, 'recording'):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    prev = _st().recording
    _state.recording = flag
    return prev


def set_training(flag):
    prev = _st().training
    _state.training = flag
    return prev


class AGInfo:
    """A variable's autograd record (reference imperative.h:54): its grad
    buffer's handle (an NDArray), the buffer tensor itself, and
    ``grad_req``."""

    __slots__ = ('variable', 'grad', 'buf', 'grad_req', 'rsp')

    def __init__(self, grad=None, grad_req='write'):
        self.variable = True
        self.grad = grad
        self.buf = None if grad is None else grad._data
        self.grad_req = grad_req
        self.rsp = None     # the last row-sparse gradient, if it was one


def sync_grad(info):
    """The grad buffer of ``info``, after copying back a value that a write
    through its handle bound there; None without a buffer."""
    if info.grad is None:
        return None
    nd = info.grad
    if info.buf is None:
        info.buf = nd._data
    elif nd._data is not info.buf:
        with torch.no_grad():
            info.buf.copy_(nd._data)
        nd._data = info.buf
    return info.buf


def row_sparse(g, dtype=None):
    """A sparse COO gradient of a table as a ``RowSparseNDArray`` of its
    entries, repeats kept (``_may_have_duplicates``): no dense copy."""
    from .ndarray.ndarray import NDArray
    from .ndarray.sparse import RowSparseNDArray
    vals = g._values().detach()
    rsp = RowSparseNDArray(NDArray(vals if dtype is None else
                                   vals.to(dtype)),
                           NDArray(g._indices()[0]), tuple(g.shape))
    rsp._may_have_duplicates = True
    return rsp


def _write_grad(info):
    def hook(leaf):
        g, leaf.grad = leaf.grad, None
        if g is None or info.grad is None or info.grad_req == 'null':
            return
        if g.is_sparse and info.grad_req != 'add':
            info.rsp = row_sparse(g, info.grad._data.dtype)
            return
        info.rsp = None
        buf = sync_grad(info)
        with torch.no_grad():
            if g.is_sparse:
                buf.index_add_(0, g._indices()[0],
                               g._values().detach().to(buf.dtype))
            elif info.grad_req == 'add':
                buf.add_(g.detach().to(buf.dtype))
            else:
                buf.copy_(g.detach())
    return hook


def track(nd):
    """Make ``nd``'s payload a fresh leaf that requires grad and writes
    its gradient into ``nd``'s buffer; integer payloads have no gradient
    and stay as they are."""
    t = nd._data.detach()
    if t.is_floating_point() or t.is_complex():
        t.requires_grad_(True)
        t.register_post_accumulate_grad_hook(_write_grad(nd._ag))
    nd._data = t


def mark_variables(variables, gradients, grad_reqs='write'):
    """Reference: Imperative::MarkVariables (imperative.h:237)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        var._ag = AGInfo(grad=grad, grad_req=req)
        track(var)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             variables=None, create_graph=False):
    """Reference: Imperative::Backward (src/imperative/imperative.cc:377).

    Fills the grad buffers of the variables the heads reach, as their
    ``grad_req`` says; or, with ``variables`` (the ``autograd.grad``
    path), returns their gradients as NDArrays and writes no buffer. A
    head without a head gradient gets ones. ``create_graph=True``
    records the backward itself, so that the returned gradients can be
    differentiated again. ``retain_graph`` is accepted for the
    reference's signature: the graph is always kept (module docstring).
    """
    from .ndarray.ndarray import NDArray

    tensors, grads = [], []
    if head_grads is None:
        head_grads = [None] * len(heads)
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise ValueError(
                'cannot differentiate a head that was not computed while '
                'autograd recording was on')
        tensors.append(t)
        if hg is None:
            grads.append(torch.ones_like(t))
        elif isinstance(hg, NDArray):
            grads.append(hg._data.to(t.dtype))
        else:
            grads.append(torch.as_tensor(hg, dtype=t.dtype, device=t.device))

    prev = set_training(train_mode)
    try:
        if variables is None:
            torch.autograd.backward(tensors, grads, retain_graph=True,
                                    create_graph=create_graph)
            return None
        for v in variables:
            info = getattr(v, '_ag', None)
            if info is None or not info.variable:
                raise ValueError('grad() variables must be marked '
                                 '(attach_grad/mark_variables)')
        got = torch.autograd.grad(tensors, [v._data for v in variables],
                                  grads, retain_graph=True,
                                  create_graph=create_graph,
                                  allow_unused=True)
    finally:
        set_training(prev)
    # a graphed call's backward hands out its static grad buffers, which
    # the next replay overwrites: the caller gets copies
    return [NDArray(torch.zeros_like(v._data).detach()) if g is None
            else row_sparse(g) if g.is_sparse else NDArray(g.clone())
            for v, g in zip(variables, got)]
