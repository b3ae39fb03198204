"""Core layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``,
reference python/mxnet/gluon/nn/basic_layers.py): Sequential, Dense,
Dropout, BatchNorm, LayerNorm, RMSNorm, GroupNorm, InstanceNorm,
Embedding, Flatten, Identity, Lambda and Concatenate. Each goes through
the registered ops (``layer_norm`` and ``rms_norm`` reach the fused norm
kernel on the card). Unknown ``in_units``/``in_channels`` (0) resolve at
the first forward, as in the reference.
"""

from .activations import Activation
from ..block import Block, HybridBlock, record_aux_update
from ..parameter import Parameter
from ...base import MXNetError
from ...ops.registry import invoke
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


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm: needs the distributed kvstore and its
    collectives (ROADMAP A10)."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        raise MXNetError('SyncBatchNorm needs statistics across devices, '
                         'which the port does not have yet (ROADMAP A10)')


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
    """Reference basic_layers.py:Embedding. Row-sparse gradients
    (``sparse_grad=True``) wait for the sparse module (ROADMAP A3 rest)."""

    def __init__(self, input_dim, output_dim, dtype='float32',
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        if sparse_grad:
            raise MXNetError('Embedding(sparse_grad=True) needs row-sparse '
                             'gradients (ROADMAP A3 rest)')
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter('weight', shape=(input_dim, output_dim),
                                init=weight_initializer, dtype=dtype)

    def forward(self, x):
        return _op('embedding', x, self.weight.data(),
                   input_dim=self._input_dim, output_dim=self._output_dim)


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
