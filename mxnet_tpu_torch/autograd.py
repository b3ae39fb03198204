"""``mx.autograd`` — imperative automatic differentiation.

Counterpart of ``mxnet_tpu/autograd.py`` (reference python/mxnet/
autograd.py: record :121, pause :145, mark_variables :218, backward :245,
grad :272, Function :369). The scopes set the thread-local flags of
:mod:`._tape`; the graph and the backward rules are ``torch.autograd``'s,
and a custom :class:`Function` becomes a ``torch.autograd.Function``.
"""

import torch

from . import _tape
from .ndarray.ndarray import NDArray


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = _tape.set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = _tape.set_training(self._enter_train_mode)
        return self

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            _tape.set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            _tape.set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope in which executed ops are recorded for differentiation."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope in which recording is suspended."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def is_recording():
    return _tape.is_recording()


def is_training():
    return _tape.is_training()


def set_recording(flag):
    return _tape.set_recording(flag)


def set_training(flag):
    return _tape.set_training(flag)


def mark_variables(variables, gradients, grad_reqs='write'):
    """Mark NDArrays as variables with the given grad buffers."""
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    _tape.mark_variables(variables, gradients, grad_reqs)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Fill the grad buffers of the variables ``heads`` reach."""
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None:
            head_grads = [head_grads]
    _tape.backward(heads, head_grads, retain_graph=retain_graph,
                   train_mode=train_mode)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    instead of written. ``create_graph=True`` records the backward, so
    that the gradients are differentiable (higher-order autograd)."""
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None:
            head_grads = [head_grads]
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    for v in variables:
        if v._ag is None or not v._ag.variable:
            raise ValueError('variables must be marked (attach_grad) and '
                             'used in the recorded computation')
    outs = _tape.backward(heads, head_grads, train_mode=train_mode,
                          variables=variables, create_graph=create_graph)
    return outs[0] if single else outs


def get_symbol(x):
    raise NotImplementedError(
        'autograd.get_symbol: graph export goes through HybridBlock.export')


class _Custom(torch.autograd.Function):
    """Links a user :class:`Function`'s outputs, computed outside the
    graph, to its inputs, with the user's ``backward`` as the rule."""

    @staticmethod
    def forward(ctx, fnode, outs, *inputs):
        ctx.fnode = fnode
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *cots):
        with pause():
            ins = ctx.fnode.backward(*[NDArray(c) for c in cots])
        if not isinstance(ins, (tuple, list)):
            ins = (ins,)
        return (None, None) + tuple(
            i._data if isinstance(i, NDArray) else i for i in ins)


class Function:
    """Custom differentiable function (reference autograd.py:369).

    Subclass and implement ``forward`` and ``backward`` over NDArrays;
    ``backward`` receives the output gradients and returns the input
    gradients."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        with pause():
            outputs = self.forward(*inputs)
        multi = isinstance(outputs, (tuple, list))
        out_list = list(outputs) if multi else [outputs]
        if _tape.is_recording() and any(x._data.requires_grad
                                        for x in inputs):
            with torch.enable_grad():
                linked = _Custom.apply(self, [o._data for o in out_list],
                                       *[x._data for x in inputs])
            for o, t in zip(out_list, linked):
                o._data = t
        return outputs
