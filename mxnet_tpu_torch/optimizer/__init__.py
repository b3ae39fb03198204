"""``mx.optimizer`` of the port: :class:`Optimizer`, :class:`SGD` and
:class:`Adam` over ``torch.Tensor`` weights.

Counterpart of ``mxnet_tpu/optimizer/__init__.py``, with the same
hyperparameters, multipliers, update counts and arithmetic. Updates are IN
PLACE: :meth:`Optimizer.update` writes the new weight and the new state
into the tensors it is given, where the reference rebinds its NDArrays to
new arrays. SGD with momentum and Adam go through the fused kernels
(:mod:`..ops.kernels.fused_optimizer`), whose wrappers send a weight that
is not fp32 (a net cast to bf16) to their plain versions, as the
reference sends it to XLA; plain SGD (``momentum=0``) is plain PyTorch, as
the reference leaves it to XLA. Such a weight's update is computed in
fp32, as the JAX Trainer's fp32 device scalars promote it, and stored back
in the weight's dtype.

A step's hyperparameters reach :meth:`Optimizer.step` as a row of a
float32 tensor on the weights' device, ``(lr, wd, bc1, bc2)``, as the JAX
Trainer's fused update takes ``lr``, ``wd`` and ``t`` as device vectors
(``mxnet_tpu/gluon/trainer.py:511-533``): :meth:`Optimizer.step_values`
advances the update counts and gives ``lr``, ``wd`` and ``t`` of each
live index, and :meth:`Optimizer.fill_hyper` computes the rest on the
device from the counts (Adam's bias corrections ``1 - beta**t`` in fp32,
as the reference's traced ``t`` gives them). So an update captured in a
CUDA graph reads a new learning rate or count on every replay.

Not ported yet: the other optimizers (AdamW, NAG, LAMB, ...), row-sparse
(lazy) updates, and the multi-precision path.
"""

import torch

from ..base import MXNetError
from ..ops.kernels.fused_optimizer import adam_step, hyper_vector, \
    sgd_mom_step

__all__ = ['Optimizer', 'SGD', 'Adam', 'register', 'create', 'hyper_tensor']


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
        """:meth:`create_state`, with fp32 slots for a weight that is not
        fp32 (a net cast to bf16): the JAX Trainer creates them in the
        weight's dtype, and its fp32 device scalars make them fp32 at the
        first update, before anyone can read them (the values are the
        zeros they were made with)."""
        return _fp32_slots(self.create_state(index, weight), weight)

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

    # --------------------------------------------------------- device vectors
    def step_values(self, indices):
        """Advance the update count of every index in ``indices`` and give
        each one's ``(lrs, wds, ts)``, as the JAX Trainer assembles
        ``lr_vals``, ``wd_vals`` and ``t_vals`` (with ``lr_mult``,
        ``wd_mult`` and the ``lr_scheduler`` at the new count)."""
        for i in indices:
            self._update_count(i)
        return (tuple(self._get_lr(i) for i in indices),
                tuple(self._get_wd(i) for i in indices),
                tuple(self._index_update_count[i] for i in indices))

    def fill_hyper(self, hyper, ts):
        """Write the columns of ``hyper`` (``n x 4`` float32: ``lr``,
        ``wd``, ``bc1``, ``bc2``) that depend on the update counts ``ts``
        (float32, ``n``), on their device: here none, so the bias
        corrections stay 1."""
        hyper[:, 2:].fill_(1.0)

    # ---------------------------------------------------------------- updates
    def update(self, index, weight, grad, state):
        """In-place update of ``weight`` and ``state`` from ``grad``.
        Accepts single values or lists (reference optimizer.py:295)."""
        if not isinstance(weight, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        lrs, wds, ts = self.step_values(index)
        hyper = hyper_tensor(self, lrs, wds, ts, weight[0].device)
        with torch.no_grad():
            for j, (w, g, s) in enumerate(zip(weight, grad, state)):
                self.step(w, g, s, hyper[j])

    update_multi_precision = update

    def step(self, w, g, state, hyper):
        """Update ``w`` and ``state`` in place from ``g`` (no return
        value); ``hyper`` is this index's row ``(lr, wd, bc1, bc2)``."""
        raise NotImplementedError

    def __repr__(self):
        return f'{type(self).__name__}(lr={self.lr})'


register = Optimizer.register
create = Optimizer.create_optimizer


def hyper_tensor(optimizer, lrs, wds, ts, device):
    """The ``n x 4`` float32 hyperparameters ``(lr, wd, bc1, bc2)`` of one
    step on ``device``, from :meth:`Optimizer.step_values`."""
    hyper = hyper_vector([[lr, wd, 1.0, 1.0] for lr, wd in zip(lrs, wds)],
                         device)
    optimizer.fill_hyper(hyper, hyper_vector(ts, device))
    return hyper


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


def _fp32_slots(state, weight):
    """``state`` with its floating slots in fp32 where ``weight`` is not
    fp32."""
    if weight.dtype == torch.float32 or state is None:
        return state
    if torch.is_tensor(state):
        return state.float() if state.is_floating_point() else state
    return type(state)(_fp32_slots(s, weight) for s in state)


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

    def step(self, w, g, state, hyper):
        if self.momentum == 0.0:
            wf = w.float()      # w itself when it is fp32
            g = self._prep(g) + hyper[1] * wf
            w.copy_(wf - hyper[0] * g)
            return
        sgd_mom_step(w, g, state, hyper, momentum=self.momentum,
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

    def fill_hyper(self, hyper, ts):
        """Adam's bias corrections ``1 - beta**t`` from the counts ``ts``,
        in fp32 on their device, as the JAX Trainer computes them from
        its traced ``t`` (``1.0 - beta1 ** t``: an fp32 power)."""
        if not self.correct_bias:
            return super().fill_hyper(hyper, ts)
        for col, beta in ((2, self.beta1), (3, self.beta2)):
            hyper[:, col].copy_(1.0 - torch.pow(torch.full_like(ts, beta),
                                                ts))

    def step(self, w, g, state, hyper):
        adam_step(w, g, state[0], state[1], hyper, beta1=self.beta1,
                  beta2=self.beta2, epsilon=self.epsilon,
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient)
