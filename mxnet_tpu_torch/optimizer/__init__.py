"""``mx.optimizer`` of the port: :class:`Optimizer` and the reference's
seventeen algorithms (SGD, NAG, Adam, AdamW, Adamax, Nadam, AdaGrad,
AdaDelta, RMSProp, Ftrl, FTML, Signum, SGLD, DCASGD, LARS, LAMB, LANS),
:class:`Updater` and :func:`get_updater`, over ``torch.Tensor`` weights.

Counterpart of ``mxnet_tpu/optimizer/__init__.py``, with the same
hyperparameters, defaults, slots, multipliers, update counts and
arithmetic; each class registers under its lower-case name
(``Trainer(params, 'lamb')``). Updates are IN PLACE: :meth:`Optimizer.step`
writes the new weight and the new state into the tensors it is given,
where the reference rebinds its NDArrays to new arrays. SGD with momentum
and Adam go through the fused kernels (:mod:`..ops.kernels.fused_optimizer`),
whose wrappers send a weight that is not fp32 (a net cast to bf16) to
their plain versions, as the reference sends it to XLA; every other update
is plain PyTorch, as the reference leaves it to XLA. Such a weight's
update is computed in fp32, as the JAX Trainer's fp32 device scalars
promote it, and stored back in the weight's dtype. ``multi_precision`` is
accepted and kept, as the reference keeps it: neither keeps an fp32
master copy.

A step's hyperparameters reach :meth:`Optimizer.step` as a row of a
float32 tensor on the weights' device, as the JAX Trainer's fused update
takes ``lr``, ``wd`` and ``t`` as device vectors
(``mxnet_tpu/gluon/trainer.py:511-533``): ``(lr, wd, bc1, bc2)``, and for
Nadam two more columns (:attr:`Optimizer.hyper_width`).
:meth:`Optimizer.step_values` advances the update counts and gives ``lr``,
``wd`` and ``t`` of each live index, and :meth:`Optimizer.fill_hyper`
computes the columns that are functions of ``t`` on the device from the
counts, in fp32, as the reference's traced ``t`` gives them: the bias
corrections ``1 - beta**t`` (Adam, AdamW, Adamax, FTML, LAMB, LANS) and
Nadam's momentum schedule ``beta1 * (1 - 0.5 * 0.96**(t * decay))`` at
``t`` and ``t + 1``. So an update captured in a CUDA graph reads a new
learning rate or count on every replay. Nadam keeps the running product
of its schedule in its state, a device scalar a replay advances
(the JAX Trainer's fused Nadam loses it: ROADMAP C8). SGLD draws its noise
from the device's registered generator (``_rng``), so a replayed update
draws anew.

A row-sparse gradient (``ndarray.sparse.RowSparseNDArray``, what
``Embedding(sparse_grad=True)`` gives) takes the reference's lazy update
(``_update_one_lazy``, ``mxnet_tpu/optimizer/__init__.py:160-218``) when
the optimizer has ``lazy_update=True`` or always updates by rows
(AdaGrad's ``_sparse_rowwise``): its repeated ids are summed at a static
size (``ndarray.sparse.merge_rows``), the rows of the weight and of every
slot are gathered into contiguous tensors, :meth:`Optimizer.step` updates
those in place (so Adam's rows go through B5 and SGD-momentum's through
B6, one launch a parameter), and they are written back. A row no id names
sees no weight decay, no momentum decay and no slot change. Without
``lazy_update`` the gradient is made dense first (the reference's
``std_update``).
"""

import pickle

import numpy as np
import torch

from .. import _rng
from ..ndarray import sparse as _sparse
from ..ops.kernels.fused_optimizer import adam_step, hyper_vector, \
    sgd_mom_step

__all__ = ['Optimizer', 'SGD', 'NAG', 'Adam', 'AdamW', 'Adamax', 'Nadam',
           'AdaGrad', 'AdaDelta', 'RMSProp', 'Ftrl', 'FTML', 'Signum',
           'SGLD', 'DCASGD', 'LARS', 'LAMB', 'LANS', 'Updater',
           'get_updater', 'register', 'create', 'hyper_tensor']


class Optimizer:
    """Base optimizer (reference optimizer/optimizer.py:29)."""

    opt_registry = {}
    #: columns of a step's hyperparameter row: ``(lr, wd, bc1, bc2)``
    hyper_width = 4

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0, use_fused_step=True):
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
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}

    def __getstate__(self):
        """The optimizer without its parameters (a Trainer sets
        ``param_dict``) and without any tensor: what ``dist_async`` sends
        its server, which makes its own slots and hyperparameter rows on
        its device. A parameter's ``lr_mult`` and ``wd_mult`` are kept by
        its index, where :meth:`_get_lr` and :meth:`_get_wd` find them
        once ``param_dict`` is empty."""
        state = {k: v for k, v in self.__dict__.items()
                 if not torch.is_tensor(v)}
        lr_mult, wd_mult = dict(self.lr_mult), dict(self.wd_mult)
        for i, param in self.param_dict.items():
            lr_mult[i] = getattr(param, 'lr_mult', 1.0)
            wd_mult[i] = getattr(param, 'wd_mult', 1.0)
        return dict(state, param_dict={}, lr_mult=lr_mult, wd_mult=wd_mult)

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
        """Write the columns of ``hyper`` (``n x hyper_width`` float32:
        ``lr``, ``wd``, ``bc1``, ``bc2``, ...) that depend on the update
        counts ``ts`` (float32, ``n``), on their device: here none, so the
        bias corrections stay 1."""
        hyper[:, 2:].fill_(1.0)

    # ---------------------------------------------------------------- updates
    #: True: a row-sparse gradient always takes the row-wise update, even
    #: without ``lazy_update`` (reference adagrad.py:125)
    _sparse_rowwise = False

    def update(self, index, weight, grad, state):
        """In-place update of ``weight`` and ``state`` from ``grad``.
        Accepts single values or lists (reference optimizer.py:295).
        Weights and slots are tensors (or NDArrays, whose payloads are
        updated); a gradient may be a ``RowSparseNDArray`` (see the module
        docstring)."""
        if not isinstance(weight, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        weight = [_raw(w) for w in weight]
        state = [_raw(s) for s in state]
        dense = []
        for i, w, g, s in zip(index, weight, grad, state):
            if isinstance(g, _sparse.RowSparseNDArray):
                if getattr(self, 'lazy_update', False) or \
                        self._sparse_rowwise:
                    self._update_rows(i, w, g, s)
                    continue
                g = g._to_dense_raw()       # std_update: every row
            dense.append((i, w, _raw(g), s))
        if not dense:
            return
        lrs, wds, ts = self.step_values([e[0] for e in dense])
        hyper = hyper_tensor(self, lrs, wds, ts, dense[0][1].device)
        with torch.no_grad():
            for j, (_, w, g, s) in enumerate(dense):
                self.step(w, g, s, hyper[j])

    def _update_rows(self, index, weight, grad, state):
        """The lazy update of ``weight`` and ``state`` from the
        row-sparse ``grad`` (reference ``_update_one_lazy``)."""
        lrs, wds, ts = self.step_values([index])
        # the reference runs this update eagerly, its lr and t Python
        # numbers: the functions of t are taken in double precision, and
        # rounded once to the fp32 row the kernels read
        host = torch.ones(1, self.hyper_width, dtype=torch.float64)
        host[0, 0], host[0, 1] = lrs[0], wds[0]
        self.fill_hyper(host, torch.tensor(ts, dtype=torch.float64))
        hyper = hyper_vector(host.float().tolist(), weight.device)[0]
        ids = grad.indices._data.to(weight.device)
        vals = grad.data._data.detach().to(weight.device)
        if ids.numel() == 0:
            return
        valid = None
        if grad._may_have_duplicates:
            ids, vals, valid = _sparse.merge_rows(ids, vals)
        n = weight.shape[0]
        with torch.no_grad():
            rows = [weight.index_select(0, ids)]
            slots = _flat_slots(state, n)
            rows += [s.index_select(0, ids) for s in slots]
            self.step(rows[0], vals.to(weight.dtype).contiguous(),
                      _rows_state(state, rows[1:], n), hyper)
            for dst, src in zip([weight] + slots, rows):
                if valid is not None:
                    # padding repeats the first row: write its value
                    mask = valid.view((-1,) + (1,) * (src.dim() - 1))
                    src = torch.where(mask, src, src[:1])
                dst.index_copy_(0, ids, src)

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
    """The ``n x hyper_width`` float32 hyperparameters ``(lr, wd, bc1,
    bc2, ...)`` of one step on ``device``, from
    :meth:`Optimizer.step_values`."""
    pad = [1.0] * (optimizer.hyper_width - 2)
    hyper = hyper_vector([[lr, wd, *pad] for lr, wd in zip(lrs, wds)],
                         device)
    optimizer.fill_hyper(hyper, hyper_vector(ts, device))
    return hyper


def _raw(x):
    """The tensor of an NDArray (its payload), a tensor or a structure of
    them, as it is."""
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, (list, tuple)):
        return type(x)(_raw(e) for e in x)
    return x


def _flat_slots(state, n):
    """The slot tensors of ``state`` with a row a weight row (``n``
    rows): the ones the lazy update gathers and writes back; a scalar slot
    (Nadam's running product) is not one."""
    if state is None:
        return []
    if torch.is_tensor(state):
        return [state] if state.dim() and state.shape[0] == n else []
    return [t for s in state for t in _flat_slots(s, n)]


def _rows_state(state, rows, n):
    """``state`` with each row-shaped slot replaced by its gathered rows
    from ``rows``, in :func:`_flat_slots`'s order."""
    it = iter(rows)

    def sub(s):
        if s is None:
            return None
        if torch.is_tensor(s):
            return next(it) if s.dim() and s.shape[0] == n else s
        return type(s)(sub(e) for e in s)
    return sub(state)


def _zeros_like(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


def _bias_correction(hyper, col, beta, ts):
    """Column ``col`` of ``hyper`` := ``1 - beta**t``, an fp32 power of the
    counts ``ts`` on their device (the reference's ``1 - beta ** t`` of
    its traced ``t``)."""
    hyper[:, col].copy_(1.0 - torch.pow(torch.full_like(ts, beta), ts))


def _norm(t):
    """The 2-norm of all of ``t`` (``jnp.linalg.norm``)."""
    return torch.linalg.vector_norm(t)


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
    row-sparse gradients only (the module docstring)."""

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
    ``lazy_update`` acts on row-sparse gradients only (the module
    docstring)."""

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
        _bias_correction(hyper, 2, self.beta1, ts)
        _bias_correction(hyper, 3, self.beta2, ts)

    def step(self, w, g, state, hyper):
        adam_step(w, g, state[0], state[1], hyper, beta1=self.beta1,
                  beta2=self.beta2, epsilon=self.epsilon,
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient)


# ------------------------------------------------------------------------
# The other algorithms of the reference (mxnet_tpu/optimizer/__init__.py
# :278-658), plain PyTorch as the reference leaves them to XLA. Each step
# computes in fp32 (``w.float()`` is ``w`` itself for an fp32 weight) and
# writes the weight and the slots back in place; ``hyper`` is the index's
# row of device hyperparameters, whose entries act as the reference's
# traced fp32 scalars.

@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference optimizer/nag.py)."""

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g) + wd * wf
        if self.momentum == 0.0:
            w.copy_(wf - lr * g)
            return
        mom = self.momentum * state - lr * g
        state.copy_(mom)
        w.copy_(wf + self.momentum * mom - lr * g)


@register
class AdamW(Adam):
    """Decoupled weight decay (reference contrib adamw op,
    src/operator/contrib/adamw.cc): always bias-corrected."""

    def fill_hyper(self, hyper, ts):
        _bias_correction(hyper, 2, self.beta1, ts)
        _bias_correction(hyper, 3, self.beta2, ts)

    def step(self, w, g, state, hyper):
        lr, wd, bc1, bc2 = hyper[0], hyper[1], hyper[2], hyper[3]
        wf = w.float()
        g = self._prep(g)
        m = self.beta1 * state[0] + (1 - self.beta1) * g
        v = self.beta2 * state[1] + (1 - self.beta2) * g * g
        state[0].copy_(m)
        state[1].copy_(v)
        mhat, vhat = m / bc1, v / bc2
        w.copy_(wf - lr * (mhat / (torch.sqrt(vhat) + self.epsilon)
                           + wd * wf))


@register
class Adamax(Optimizer):
    """Adam over the infinity norm (reference optimizer/adamax.py)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fill_hyper(self, hyper, ts):
        super().fill_hyper(hyper, ts)
        _bias_correction(hyper, 2, self.beta1, ts)

    def step(self, w, g, state, hyper):
        lr, wd, bc1 = hyper[0], hyper[1], hyper[2]
        wf = w.float()
        g = self._prep(g) + wd * wf
        m = self.beta1 * state[0] + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * state[1], torch.abs(g))
        state[0].copy_(m)
        state[1].copy_(u)
        lr_t = lr / bc1
        w.copy_(wf - lr_t * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (reference optimizer/nadam.py).

    The state is ``(m, v, schedule)``: ``schedule`` is the running product
    of ``momentum_t`` over this parameter's steps, an fp32 scalar on the
    weight's device that each step (and each replay of a captured step)
    multiplies in place. The row is ``(lr, wd, 1, bc2, momentum_t,
    momentum_t+1)``."""

    hyper_width = 6

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                torch.ones((), dtype=torch.float32, device=weight.device))

    def fill_hyper(self, hyper, ts):
        super().fill_hyper(hyper, ts)
        _bias_correction(hyper, 3, self.beta2, ts)
        decay = torch.full_like(ts, 0.96)
        for col, t in ((4, ts), (5, ts + 1.0)):
            hyper[:, col].copy_(self.beta1 * (
                1 - 0.5 * torch.pow(decay, t * self.schedule_decay)))

    def step(self, w, g, state, hyper):
        lr, wd, bc2 = hyper[0], hyper[1], hyper[3]
        momentum_t, momentum_t1 = hyper[4], hyper[5]
        m0, v0, schedule = state
        wf = w.float()
        g = self._prep(g) + wd * wf
        schedule.mul_(momentum_t)
        schedule_next = schedule * momentum_t1
        m = self.beta1 * m0 + (1 - self.beta1) * g
        v = self.beta2 * v0 + (1 - self.beta2) * g * g
        m0.copy_(m)
        v0.copy_(v)
        g_prime = g / (1 - schedule)
        m_prime = m / (1 - schedule_next)
        v_prime = v / bc2
        m_bar = (1 - momentum_t) * g_prime + momentum_t1 * m_prime
        w.copy_(wf - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon))


@register
class AdaGrad(Optimizer):
    """Reference optimizer/adagrad.py; a row-sparse gradient always
    takes the row-wise update (reference adagrad.py:125)."""

    _sparse_rowwise = True

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g) + wd * wf
        h = state + g * g
        state.copy_(h)
        w.copy_(wf - lr * g / (torch.sqrt(h) + self.epsilon))


@register
class AdaDelta(Optimizer):
    """Reference optimizer/adadelta.py."""

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g) + wd * wf
        acc_g = self.rho * state[0] + (1 - self.rho) * g * g
        delta = torch.sqrt(state[1] + self.epsilon) / \
            torch.sqrt(acc_g + self.epsilon) * g
        acc_d = self.rho * state[1] + (1 - self.rho) * delta * delta
        state[0].copy_(acc_g)
        state[1].copy_(acc_d)
        w.copy_(wf - lr * delta)


@register
class RMSProp(Optimizer):
    """Reference optimizer/rmsprop.py, plain or ``centered`` (Graves)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.rho = rho
        self.momentum = momentum
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight)
                     for _ in range(3 if self.centered else 2))

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g) + wd * wf
        n = self.rho * state[0] + (1 - self.rho) * g * g
        if self.centered:
            gbar = self.rho * state[1] + (1 - self.rho) * g
            mom = self.momentum * state[2] - lr * g / torch.sqrt(
                n - gbar * gbar + self.epsilon)
            new = (n, gbar, mom)
        else:
            mom = self.momentum * state[1] - lr * g / torch.sqrt(
                n + self.epsilon)
            new = (n, mom)
        for s, t in zip(state, new):
            s.copy_(t)
        new_w = wf + mom
        if self.clip_weights:
            new_w = new_w.clamp(-self.clip_weights, self.clip_weights)
        w.copy_(new_w)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (reference optimizer/ftrl.py)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g)
        z, n = state
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / lr
        z_new = z + g - sigma * wf
        n_new = n + g * g
        z.copy_(z_new)
        n.copy_(n_new)
        w.copy_(torch.where(
            torch.abs(z_new) > self.lamda1,
            -(z_new - torch.sign(z_new) * self.lamda1) /
            ((self.beta + torch.sqrt(n_new)) / lr + wd), 0.0))


@register
class FTML(Optimizer):
    """Follow the moving leader (reference optimizer/ftml.py)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def fill_hyper(self, hyper, ts):
        _bias_correction(hyper, 2, self.beta1, ts)
        _bias_correction(hyper, 3, self.beta2, ts)

    def step(self, w, g, state, hyper):
        lr, wd, bc1, bc2 = hyper[0], hyper[1], hyper[2], hyper[3]
        wf = w.float()
        g = self._prep(g) + wd * wf
        d, v, z = state
        v_new = self.beta2 * v + (1 - self.beta2) * g * g
        d_t = bc1 / lr * (torch.sqrt(v_new / bc2) + self.epsilon)
        sigma = d_t - self.beta1 * d
        z_new = self.beta1 * z + (1 - self.beta1) * g - sigma * wf
        d.copy_(d_t)
        v.copy_(v_new)
        z.copy_(z_new)
        w.copy_(-z_new / d_t)


@register
class Signum(Optimizer):
    """signSGD with momentum (reference optimizer/signum.py)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g)
        decay = 1 - lr * (wd + self.wd_lh)
        if state is not None:
            mom = self.momentum * state - (1 - self.momentum) * g
            state.copy_(mom)
            w.copy_(decay * wf + lr * torch.sign(mom))
        else:
            w.copy_(decay * wf - lr * torch.sign(g))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference optimizer/sgld.py):
    the noise, ``N(0, 1) * sqrt(lr)``, is drawn from the weight device's
    generator (``mx.random``), which a captured update registers."""

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g) + wd * wf
        noise = torch.randn(w.shape, dtype=torch.float32, device=w.device,
                            generator=_rng.generator(w.device)) \
            * torch.sqrt(lr)
        w.copy_(wf - lr / 2 * g + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference optimizer/dcasgd.py):
    the state is ``(momentum or None, the previous weight)``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros_like(weight) if self.momentum != 0.0 else None,
                weight.detach().clone(
                    memory_format=torch.contiguous_format))

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        mom, prev = state
        wf = w.float()
        g = self._prep(g) + wd * wf
        comp = self.lamda * g * g * (wf - prev)
        if mom is not None:
            m = self.momentum * mom - lr * (g + comp)
            mom.copy_(m)
            new_w = wf + m
        else:
            new_w = wf - lr * (g + comp)
        prev.copy_(new_w)
        w.copy_(new_w)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (reference optimizer/lars.py)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def step(self, w, g, state, hyper):
        lr, wd = hyper[0], hyper[1]
        wf = w.float()
        g = self._prep(g)
        w_norm, g_norm = _norm(wf), _norm(g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon), 1.0)
        g = g + wd * wf
        if state is not None:
            mom = self.momentum * state + trust * lr * g
            state.copy_(mom)
            w.copy_(wf - mom)
        else:
            w.copy_(wf - trust * lr * g)


@register
class LAMB(Optimizer):
    """Layer-wise Adam for large batches (reference optimizer/lamb.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fill_hyper(self, hyper, ts):
        """The bias corrections, or 1 (a division by 1 is exact) without
        ``bias_correction``."""
        super().fill_hyper(hyper, ts)
        if self.bias_correction:
            _bias_correction(hyper, 2, self.beta1, ts)
            _bias_correction(hyper, 3, self.beta2, ts)

    def step(self, w, g, state, hyper):
        self._lamb(w, self._prep(g), state, hyper)

    def _lamb(self, w, g, state, hyper):
        """LAMB's update from the prepared gradient ``g``."""
        lr, wd, bc1, bc2 = hyper[0], hyper[1], hyper[2], hyper[3]
        wf = w.float()
        m = self.beta1 * state[0] + (1 - self.beta1) * g
        v = self.beta2 * state[1] + (1 - self.beta2) * g * g
        state[0].copy_(m)
        state[1].copy_(v)
        mhat, vhat = m / bc1, v / bc2
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * wf
        w_norm, r_norm = _norm(wf), _norm(r)
        if self.lower_bound is not None:
            w_norm = w_norm.clamp_min(self.lower_bound)
        if self.upper_bound is not None:
            w_norm = w_norm.clamp_max(self.upper_bound)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        w.copy_(wf - lr * ratio * r)


@register
class LANS(LAMB):
    """LAMB over the gradient normalized per tensor (reference
    optimizer/lans.py): rescaled and clipped once, then divided by its
    2-norm (at least 1e-12)."""

    def step(self, w, g, state, hyper):
        g = self._prep(g)
        self._lamb(w, g / _norm(g).clamp_min(1e-12), state, hyper)


# ------------------------------------------------------------------ updater
def states_to_host(state):
    """``state`` (a tensor, a tuple of them and None) as numpy copies: the
    Trainer's and the Updater's pickle format."""
    if state is None:
        return None
    if torch.is_tensor(state):      # a copy: a later step writes in place
        return state.detach().to('cpu', copy=True).numpy()
    if isinstance(state, (list, tuple)):
        return tuple(states_to_host(s) for s in state)
    return state


def states_into(host, old, device):
    """``host`` (numpy, a tuple of them, or None) as a state on
    ``device``, written into the tensors of ``old`` where they fit (a
    captured update reads them there)."""
    if host is None:
        return None
    if isinstance(host, (list, tuple)):
        olds = old if isinstance(old, (list, tuple)) and \
            len(old) == len(host) else [None] * len(host)
        return tuple(states_into(h, o, device) for h, o in zip(host, olds))
    src = torch.from_numpy(np.array(host))     # a copy, 0-dim kept
    if torch.is_tensor(old) and old.shape == src.shape and \
            old.dtype == src.dtype:
        with torch.no_grad():
            old.copy_(src)
        return old
    return src.to(device)


class Updater:
    """A per-index state dict around an optimizer (reference
    optimizer/updater.py), as the kvstore's server side applies it:
    ``updater(index, grad, weight)`` creates the index's state on first
    use and updates ``weight`` in place."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        # the kvstore hands NDArrays, as the reference's does: update the
        # tensor each holds, in place
        held = weight
        grad, weight = getattr(grad, '_data', grad), \
            getattr(weight, '_data', weight)
        state = self.states.get(index)
        if state is None or _is_host(state):
            made = self.optimizer.create_state_multi_precision(index, weight)
            state = made if state is None else \
                states_into(state, made, weight.device)
            self.states[index] = state
        self.optimizer.update_multi_precision(index, weight, grad, state)
        if isinstance(held, _sparse.BaseSparseNDArray):
            # the step wrote the dense value: compress it into the
            # components again, as the reference's rebinding write does
            held._rebind(weight)

    def get_states(self, dump_optimizer=False):
        """The states (and the optimizer) pickled, with the slots as numpy
        arrays."""
        states = {i: states_to_host(s) for i, s in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """Take :meth:`get_states`'s bytes: the slots go into the existing
        tensors in place, or onto a weight's device at its next update."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        new = {}
        for i, s in states.items():
            dev = _device_of(self.states.get(i))
            new[i] = s if dev is None else \
                states_into(s, self.states[i], dev)
        self.states = new


def _device_of(state):
    """The device of a state's first tensor, or None (none, or host
    data)."""
    if torch.is_tensor(state):
        return state.device
    if isinstance(state, (list, tuple)):
        return next((s.device for s in state if torch.is_tensor(s)), None)
    return None


def _is_host(state):
    if isinstance(state, np.ndarray):
        return True
    return isinstance(state, (list, tuple)) and any(
        isinstance(s, np.ndarray) for s in state)


def get_updater(optimizer):
    """Reference optimizer/updater.py get_updater."""
    return Updater(optimizer)
