"""Core layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``,
reference python/mxnet/gluon/nn/basic_layers.py): Sequential, Dense,
Dropout, BatchNorm, SyncBatchNorm, LayerNorm, RMSNorm, GroupNorm,
InstanceNorm,
Embedding, Flatten, Identity, Lambda and Concatenate. Each goes through
the registered ops (``layer_norm`` and ``rms_norm`` reach the fused norm
kernel on the card). Unknown ``in_units``/``in_channels`` (0) resolve at
the first forward, as in the reference.
"""

import torch
import torch.distributed as dist

from .activations import Activation
from ..block import Block, HybridBlock, record_aux_update
from ..parameter import Parameter
from ...ops.registry import apply_op, get_op, invoke
from ... import _tape

__all__ = ['Sequential', 'HybridSequential', 'Dense', 'Dropout', 'BatchNorm',
           'BatchNormReLU', 'SyncBatchNorm', 'LayerNorm', 'GroupNorm',
           'InstanceNorm', 'Embedding', 'Flatten', 'HybridLambda', 'Lambda',
           'Identity', 'Concatenate', 'HybridConcatenate', 'RMSNorm']


def _op(name, *args, **kw):
    return invoke(name, args, kw)


def _finish(x_dim, *params):
    """Give every deferred parameter of ``params`` the shape ``(x_dim,)``
    and initialize it."""
    for p in params:
        p.shape = (x_dim,)
        p._finish_deferred_init()


class Sequential(Block):
    """Reference basic_layers.py:Sequential."""

    def __init__(self, *blocks, **kwargs):
        super().__init__(**kwargs)
        self.add(*blocks)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        items = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*items[key])
            return net
        return items[key]

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(Sequential, HybridBlock):
    """Reference basic_layers.py:HybridSequential."""

    def __init__(self, *blocks, **kwargs):
        HybridBlock.__init__(self, **kwargs)
        self.add(*blocks)


class Dense(HybridBlock):
    """Reference basic_layers.py:Dense over ``fully_connected``; weight
    ``(units, in_units)``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype='float32', weight_initializer=None,
                 bias_initializer='zeros', in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._use_bias = use_bias
        self.weight = Parameter('weight', shape=(units, in_units),
                                init=weight_initializer, dtype=dtype,
                                allow_deferred_init=True)
        if use_bias:
            self.bias = Parameter('bias', shape=(units,),
                                  init=bias_initializer, dtype=dtype,
                                  allow_deferred_init=True)
        self.act = Activation(activation) if activation else None

    def _infer(self, x):
        if self.weight.shape[1] == 0:
            in_units = x.size // x.shape[0] if self._flatten else x.shape[-1]
            self.weight.shape = (self._units, in_units)
            self.weight._finish_deferred_init()
        if self._use_bias and self.bias._var is None:
            self.bias._finish_deferred_init()

    def forward(self, x):
        self._infer(x)
        out = _op('fully_connected', x, self.weight.data(),
                  *([self.bias.data()] if self._use_bias else []),
                  num_hidden=self._units, no_bias=not self._use_bias,
                  flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return (f'Dense({self.weight.shape[1] or None} -> {self._units}, '
                f'{"linear" if self.act is None else self.act._act_type})')


class Dropout(HybridBlock):
    """Reference basic_layers.py:Dropout; active only in train mode
    (``autograd.is_training()``), drawing from the device's generator."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        if self._rate == 0:
            return x
        return _op('dropout', x, p=self._rate, axes=self._axes,
                   training=_tape.is_training())


class BatchNorm(HybridBlock):
    """Reference basic_layers.py:BatchNorm. In train mode the batch's
    statistics normalize, and the running statistics are updated in place
    (``record_aux_update``); otherwise the running statistics
    normalize."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer='zeros',
                 gamma_initializer='ones',
                 running_mean_initializer='zeros',
                 running_variance_initializer='ones', in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = Parameter('gamma', shape=(in_channels,),
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter('beta', shape=(in_channels,),
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)
        self.running_mean = Parameter('running_mean', shape=(in_channels,),
                                      init=running_mean_initializer,
                                      grad_req='null', differentiable=False,
                                      allow_deferred_init=True)
        self.running_var = Parameter('running_var', shape=(in_channels,),
                                     init=running_variance_initializer,
                                     grad_req='null', differentiable=False,
                                     allow_deferred_init=True)

    def forward(self, x):
        if self.gamma.shape[0] == 0:
            _finish(x.shape[self._axis], self.gamma, self.beta,
                    self.running_mean, self.running_var)
        if _tape.is_training() and not self._use_global_stats:
            out, mean, var = _op(
                'batch_norm_train', x, self.gamma.data(), self.beta.data(),
                eps=self._epsilon, axis=self._axis,
                fix_gamma=not self._scale)
            m = self._momentum
            record_aux_update(self.running_mean,
                              self.running_mean.data() * m
                              + mean.detach() * (1 - m))
            record_aux_update(self.running_var,
                              self.running_var.data() * m
                              + var.detach() * (1 - m))
            return out
        return _op('batch_norm_inference', x, self.gamma.data(),
                   self.beta.data(), self.running_mean.data(),
                   self.running_var.data(), eps=self._epsilon,
                   axis=self._axis, fix_gamma=not self._scale)


class BatchNormReLU(BatchNorm):
    """BatchNorm then ReLU (reference basic_layers.py:449)."""

    def forward(self, x):
        return _op('relu', super().forward(x))


def _sync_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _allreduce(t):
    """The sum of ``t`` over the processes of the default group."""
    from ...kvstore.fusion import CrossProcess
    flat = t.reshape(-1).contiguous()
    return CrossProcess.get().psum(flat).view(t.shape)


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode BatchNorm over the whole batch of every rank: the
    per-channel count, sum and sum of squares are all-reduced in the
    forward, and the two per-channel sums of the backward (of dy and of dy
    x xhat) in the backward. The gamma and beta gradients stay this
    rank's share, as every gradient does until the kvstore sums them."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, axis, fix_gamma):
        red = tuple(i for i in range(x.dim()) if i != axis)
        shape = [1] * x.dim()
        shape[axis] = -1
        n = x.numel() // x.shape[axis]
        stats = torch.cat([x.sum(red, dtype=torch.float64),
                           (x * x).sum(red, dtype=torch.float64),
                           x.new_full((1,), n, dtype=torch.float64)])
        stats = _allreduce(stats)
        c = x.shape[axis]
        count = stats[2 * c]
        mean = stats[:c] / count
        var = (stats[c:2 * c] / count - mean * mean).clamp_min(0)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        g = torch.ones_like(gamma) if fix_gamma else gamma
        out = xhat * g.view(shape) + beta.view(shape)
        ctx.save_for_backward(xhat, invstd, g)
        ctx.red, ctx.shape, ctx.count = red, shape, count
        ctx.fix_gamma = fix_gamma
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, g = ctx.saved_tensors
        red, shape = ctx.red, ctx.shape
        sum_dy = dy.sum(red)
        sum_dy_xhat = (dy * xhat).sum(red)
        both = _allreduce(torch.cat([sum_dy, sum_dy_xhat]))
        c = sum_dy.numel()
        n = ctx.count.to(dy.dtype)
        dx = (g * invstd).view(shape) * (
            dy - (both[:c] / n).view(shape)
            - xhat * (both[c:] / n).view(shape))
        dgamma = torch.zeros_like(g) if ctx.fix_gamma else sum_dy_xhat
        return dx, dgamma, sum_dy, None, None, None


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference src/operator/contrib/
    sync_batch_norm-inl.h). The JAX package runs SPMD, where the batch
    axis is a mesh axis and plain BatchNorm's statistics are already over
    the whole batch; the port runs one process a rank, so in training this
    layer all-reduces the per-channel count, sum and sum of squares over
    the default process group, and its backward the two per-channel sums
    (:class:`_SyncBatchNormFn`). With one process it is ``BatchNorm``. The
    collectives cannot run inside a CUDA graph capture: a hybridized net
    that holds one runs its training-mode calls eagerly on the card, and
    counts them in ``eager_call_count``."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)

    def syncs(self):
        """True when a training-mode call runs collectives."""
        return not self._use_global_stats and _sync_world() > 1

    def forward(self, x):
        if not (_tape.is_training() and self.syncs()):
            return super().forward(x)
        if self.gamma.shape[0] == 0:
            _finish(x.shape[self._axis], self.gamma, self.beta,
                    self.running_mean, self.running_var)
        axis, eps, fix = self._axis % x.ndim, self._epsilon, not self._scale
        out, mean, var = apply_op(
            get_op('batch_norm_train'),
            [x, self.gamma.data(), self.beta.data()],
            lambda x_, g, b: _SyncBatchNormFn.apply(x_, g, b, eps, axis, fix))
        m = self._momentum
        record_aux_update(self.running_mean,
                          self.running_mean.data() * m
                          + mean.detach() * (1 - m))
        record_aux_update(self.running_var,
                          self.running_var.data() * m
                          + var.detach() * (1 - m))
        return out


class LayerNorm(HybridBlock):
    """Reference basic_layers.py:LayerNorm; over the last axis it is the
    fused norm kernel's LayerNorm mode."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter('gamma', shape=(in_channels,),
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter('beta', shape=(in_channels,),
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)

    def forward(self, x):
        if self.gamma.shape[0] == 0:
            _finish(x.shape[self._axis], self.gamma, self.beta)
        return _op('layer_norm', x, self.gamma.data(), self.beta.data(),
                   axis=self._axis, eps=self._epsilon)


class RMSNorm(HybridBlock):
    """RMSNorm (the JAX package's, for the LLM stack); over the last axis
    the fused norm kernel's RMS mode."""

    def __init__(self, axis=-1, epsilon=1e-6, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter('gamma', shape=(in_channels,), init='ones',
                               allow_deferred_init=True)

    def forward(self, x):
        if self.gamma.shape[0] == 0:
            _finish(x.shape[self._axis], self.gamma)
        return _op('rms_norm', x, self.gamma.data(), axis=self._axis,
                   eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Reference basic_layers.py:GroupNorm."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.gamma = Parameter('gamma', shape=(in_channels,),
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter('beta', shape=(in_channels,),
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)

    def forward(self, x):
        if self.gamma.shape[0] == 0:
            _finish(x.shape[1], self.gamma, self.beta)
        return _op('group_norm', x, self.gamma.data(), self.beta.data(),
                   num_groups=self._num_groups, eps=self._epsilon)


class InstanceNorm(HybridBlock):
    """Reference basic_layers.py:InstanceNorm; channels on ``axis``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter('gamma', shape=(in_channels,),
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter('beta', shape=(in_channels,),
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)

    def forward(self, x):
        if self.gamma.shape[0] == 0:
            _finish(x.shape[self._axis], self.gamma, self.beta)
        if self._axis in (1, -x.ndim + 1):
            return _op('instance_norm', x, self.gamma.data(),
                       self.beta.data(), eps=self._epsilon)
        # channels elsewhere: to axis 1, normalize, and back
        x_t = _op('moveaxis', x, self._axis, 1)
        out = _op('instance_norm', x_t, self.gamma.data(), self.beta.data(),
                  eps=self._epsilon)
        return _op('moveaxis', out, 1, self._axis)


class Embedding(HybridBlock):
    """Reference basic_layers.py:Embedding. With ``sparse_grad=True`` the
    weight's gradient is row-sparse (``grad_stype='row_sparse'``): a
    recorded lookup gives a ``RowSparseNDArray`` of one entry a token
    occurrence, and no backward writes a table-shaped gradient."""

    def __init__(self, input_dim, output_dim, dtype='float32',
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter(
            'weight', shape=(input_dim, output_dim),
            init=weight_initializer, dtype=dtype,
            grad_stype='row_sparse' if sparse_grad else 'default')

    def forward(self, x):
        w = self.weight.data()
        if self.weight._grad_stype == 'row_sparse' and \
                _tape.is_recording() and w._data.requires_grad:
            from ...ops.nn import sparse_grad_embedding
            return apply_op(get_op('embedding'), [x, w],
                            sparse_grad_embedding)
        return _op('embedding', x, w, input_dim=self._input_dim,
                   output_dim=self._output_dim)


class Flatten(HybridBlock):
    def forward(self, x):
        return _op('flatten', x)

    def __repr__(self):
        return 'Flatten'


class Identity(HybridBlock):
    def forward(self, x):
        return x


def _function(function):
    if isinstance(function, str):
        from ... import ndarray as F
        return getattr(F, function)
    return function


class Lambda(Block):
    """Reference basic_layers.py:Lambda: a function (or the name of an
    ``mx.nd`` function) as a block."""

    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._func = _function(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._func = _function(function)

    def forward(self, *args):
        return self._func(*args)


class Concatenate(Sequential):
    """Run each child on the same input and concatenate their outputs on
    ``axis`` (reference basic_layers.py:Concatenate)."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def forward(self, x):
        outs = [block(x) for block in self._children.values()]
        return _op('concatenate', *outs, axis=self.axis)


class HybridConcatenate(HybridSequential):
    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def forward(self, x):
        outs = [block(x) for block in self._children.values()]
        return _op('concatenate', *outs, axis=self.axis)
