"""``gluon.Trainer`` of the port: applies an :mod:`..optimizer` to a set of
Gluon :class:`.Parameter`s (``net.collect_params()``) or
``torch.nn.Parameter``s (the ``torch.nn`` Llama's) on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (``__init__``,
``learning_rate``, ``set_learning_rate``, ``step``, ``allreduce_grads``,
``update`` and the dense branch of ``_update``). ``step(batch_size)``
rescales the gradients by ``1 / batch_size`` (``rescale_grad``) and runs
the optimizer once per parameter; Adam and SGD with momentum each launch
their fused kernel once per parameter. On one device there is nothing to
reduce, so the kvstore may only be ``'device'`` or ``None``; the
distributed kvstores, gradient compression, row-sparse gradients,
``save_states``/``load_states`` and AMP are not ported yet.

A Gluon parameter is updated as the JAX Trainer updates it
(``mxnet_tpu/gluon/trainer.py:241-243``): every one whose ``grad_req`` is
not ``'null'`` and that is initialized, with whatever its grad buffer
holds (zeros for a parameter no backward reached, such as BERT's pooler
under an MLM loss), and with its ``lr_mult`` and ``wd_mult``. Its buffer
follows ``grad_req`` (the autograd hook overwrites it for ``'write'``),
so a loop needs no ``zero_grad``.

A ``torch.nn.Parameter`` has no grad buffer, only ``.grad``, into which
PyTorch's ``backward`` accumulates. So :meth:`Trainer.step` (and
:meth:`Trainer.update`) set the ``.grad`` of every such parameter it
updated to ``None`` after the update: the next backward writes a fresh
gradient, as MXNet's ``grad_req='write'`` does, and one without a
gradient since the last step raises unless ``ignore_stale_grad``.
"""

import re

import numpy as np
import torch

from ..base import MXNetError
from .. import optimizer as opt
from .parameter import Parameter

__all__ = ['Trainer']


def _jax_name(name):
    """The JAX package's name of a port parameter: Gluon names the i-th
    block of a list ``layers{i}``, ``torch.nn.ModuleList`` ``layers.{i}``
    (the inverse of the renaming in ``llama.from_jax_params``)."""
    return re.sub(r'\.(\d+)(?=\.)', r'\1', name)


class Trainer:
    """Apply ``optimizer`` (a name or an :class:`..optimizer.Optimizer`)
    to ``params``: a dict of named parameters (``net.collect_params()``,
    ``dict(net.named_parameters())``) or a list of them, all on one
    device."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device', compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            names, params = list(params), list(params.values())
        elif isinstance(params, (list, tuple)):
            names, params = None, list(params)
        else:
            raise ValueError('params must be a dict/list of Parameters')
        for param in params:
            if not isinstance(param, (Parameter, torch.nn.Parameter)):
                raise ValueError(f'invalid parameter {param!r}')
        devices = sorted({str(_device(p)) for p in params
                          if _device(p) is not None})
        if len(devices) > 1:
            raise MXNetError(f'the Trainer updates parameters on one device; '
                             f'got {devices}')
        if kvstore not in (None, '', 'device') or compression_params \
                or update_on_kvstore:
            raise MXNetError(
                f'kvstore={kvstore!r}, compression_params='
                f'{compression_params!r}, update_on_kvstore='
                f'{update_on_kvstore!r}: the port trains on one device '
                f'(kvstore "device" or None); the distributed kvstores '
                f'are ROADMAP A10')
        self._params = params
        self._names = names
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError('optimizer_params must be None if '
                                 'optimizer is an instance')
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._states = {}

    # ------------------------------------------------------------ properties
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------------ step
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to do on one device) and update
        every parameter with ``rescale_grad = scale / batch_size``
        (reference trainer.py:334)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """One device holds every gradient: nothing to reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without reducing (reference trainer.py:update)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        live = []
        for i, param in enumerate(self._params):
            if isinstance(param, Parameter):
                if param.grad_req != 'null' and param._var is not None:
                    live.append((i, param._sync().detach(),
                                 param.grad()._data, None))
                continue
            if not param.requires_grad:          # grad_req='null'
                continue
            if param.grad is None:
                if ignore_stale_grad:
                    continue
                name = self._names[i] if self._names else f'#{i}'
                raise MXNetError(
                    f'Gradient of Parameter `{name}` has not been computed '
                    f'by backward since the last step; call step with '
                    f'ignore_stale_grad=True to skip it')
            live.append((i, param.detach(), param.grad, param))
        for i, weight, grad, leaf in live:
            if i not in self._states:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, weight)
            self._optimizer.update_multi_precision(i, weight, grad,
                                                   self._states[i])
            if leaf is not None:
                leaf.grad = None                 # grad_req='write'

    # ---------------------------------------------------------- carry over
    def load_jax_state(self, states, counts):
        """Take over a JAX ``Trainer``'s optimizer state, as plain numpy.

        ``states`` maps the JAX package's parameter names
        (``model.layers0.self_attn.q_proj.weight``, ...) to the slots of
        that parameter, as the JAX Trainer's ``_states[i]`` holds them:
        Adam's ``(m, v)``, SGD-momentum's ``mom``, ``None`` for none.
        ``counts`` maps names to the update count ``t``
        (``optimizer._index_update_count[i]``), which Adam's bias
        correction reads. The Trainer must have been built from a dict of
        named parameters."""
        if self._names is None:
            raise MXNetError('load_jax_state needs a Trainer built from a '
                             'dict of named parameters')
        index = {_jax_name(n): i for i, n in enumerate(self._names)}
        unknown = sorted((set(states) | set(counts)) - set(index))
        if unknown:
            raise KeyError(f'no parameter of this Trainer is named '
                           f'{unknown}')
        for name, state in states.items():
            param = self._params[index[name]]
            self._states[index[name]] = _state_to_torch(name, state, param)
        optim = self._optimizer
        for name, t in counts.items():
            optim._index_update_count[index[name]] = int(t)
        optim.num_update = max([optim.num_update,
                                *optim._index_update_count.values()])


def _device(param):
    """The device of a parameter; None for a Gluon parameter whose
    initialization is still deferred."""
    if isinstance(param, Parameter):
        return None if param._var is None else param._var.device
    return param.device


def _state_to_torch(name, state, param):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_state_to_torch(name, s, param) for s in state)
    arr = np.asarray(state, dtype=np.float32)
    if arr.shape != tuple(param.shape):
        raise ValueError(f'{name}: state shape {arr.shape}, the parameter '
                         f'is {tuple(param.shape)}')
    return torch.tensor(arr, device=_device(param))
