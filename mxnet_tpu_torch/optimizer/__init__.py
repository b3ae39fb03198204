"""``mx.optimizer`` of the port: :class:`Optimizer`, :class:`SGD` and
:class:`Adam` over ``torch.Tensor`` weights.

Counterpart of ``mxnet_tpu/optimizer/__init__.py``, with the same
hyperparameters, multipliers, update counts and arithmetic. Updates are IN
PLACE: :meth:`Optimizer.update` writes the new weight and the new state
into the tensors it is given, where the reference rebinds its NDArrays to
new arrays. SGD with momentum and Adam go through the fused kernels
(:mod:`..ops.optimizer_ops`); plain SGD (``momentum=0``) is plain PyTorch,
as the reference leaves it to XLA.

Not ported yet: the other optimizers (AdamW, NAG, LAMB, ...), row-sparse
(lazy) updates, and the multi-precision path.
"""

import torch

from ..base import MXNetError
from ..ops.optimizer_ops import fused_adam_step, fused_sgd_mom_step

__all__ = ['Optimizer', 'SGD', 'Adam', 'register', 'create']


class Optimizer:
    """Base optimizer (reference optimizer/optimizer.py:29)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        if multi_precision:
            raise MXNetError('multi_precision is not ported yet: the port '
                             'updates fp32 weights only')
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f'Cannot find optimizer {name}')

    # ------------------------------------------------------------------ state
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

    # ------------------------------------------------------------------- meta
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                'LRScheduler of the optimizer has already been defined. '
                'Note that set_learning_rate can mutate the value of the '
                'learning rate of the optimizer only when the LRScheduler '
                'of the optimizer is undefined.')   # reference optimizer.py
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        param = self.param_dict.get(index)
        if param is not None:
            lr *= getattr(param, 'lr_mult', 1.0)
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        param = self.param_dict.get(index)
        if param is not None:
            wd *= getattr(param, 'wd_mult', 1.0)
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _prep(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    # ---------------------------------------------------------------- updates
    def update(self, index, weight, grad, state):
        """In-place update of ``weight`` and ``state`` from ``grad``.
        Accepts single values or lists (reference optimizer.py:295)."""
        if isinstance(weight, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self._update_one(i, w, g, s)
        else:
            self._update_one(index, weight, grad, state)

    update_multi_precision = update

    def _update_one(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        with torch.no_grad():
            self.step(weight, grad, state, lr, wd, t)

    def step(self, w, g, state, lr, wd, t):
        """Update ``w`` and ``state`` in place (no return value)."""
        raise NotImplementedError

    def __repr__(self):
        return f'{type(self).__name__}(lr={self.lr})'


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


@register
class SGD(Optimizer):
    """SGD with momentum (reference optimizer/sgd.py:111; fused kernel
    src/operator/optimizer_op.cc sgd_mom_update). ``lazy_update`` acts on
    row-sparse gradients only, which the port does not have yet."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def step(self, w, g, state, lr, wd, t):
        if self.momentum == 0.0:
            g = self._prep(g) + wd * w
            w.sub_(lr * g)
            return
        fused_sgd_mom_step(w, g, state, lr=lr, wd=wd, momentum=self.momentum,
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self.clip_gradient)


@register
class Adam(Optimizer):
    """Reference optimizer/adam.py; fused kernel adam_update.
    ``lazy_update`` acts on row-sparse gradients only, which the port does
    not have yet."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.correct_bias = correct_bias
        self.lazy_update = lazy_update   # reference adam.py:77

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def step(self, w, g, state, lr, wd, t):
        fused_adam_step(w, g, state[0], state[1], lr=lr, wd=wd, t=t,
                        beta1=self.beta1, beta2=self.beta2,
                        epsilon=self.epsilon,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self.clip_gradient,
                        correct_bias=self.correct_bias)
