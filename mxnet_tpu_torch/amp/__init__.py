"""``mx.amp`` of the port: automatic mixed precision.

Counterpart of ``mxnet_tpu/amp/__init__.py`` (reference
python/mxnet/contrib/amp/: the op lists, the ReducePrecision pass
src/nnvm/low_precision_pass.cc:404, dynamic loss scaling). bf16 is the
target dtype by default; it has fp32's exponent range and needs no loss
scaling. ``init()`` records the policy, :func:`convert_hybrid_block`
casts a block's parameters so that its forward computes in that dtype,
and ``init_trainer``/``scale_loss``/``unscale`` give an fp16 run dynamic
loss scaling, a step after an overflow updating nothing
(``gluon.Trainer`` honours ``_amp_skip_update``). :func:`convert_symbol`
and :func:`convert_model` (:mod:`.pass_`) rewrite a ``Symbol`` by the op
lists, the reference's ReducePrecision pass.
"""

import contextlib

import numpy as _np
import torch

from . import lists

__all__ = ['Policy', 'init', 'is_enabled', 'compute_dtype',
           'DynamicLossScaler', 'init_trainer', 'scale_loss', 'unscale',
           'convert_hybrid_block', 'convert_symbol', 'convert_model',
           'lists']

_state = {'enabled': False, 'dtype': 'bfloat16', 'loss_scale': 1.0}


class Policy:
    """Compute/param/output dtypes (jmp-style)."""

    def __init__(self, compute_dtype='bfloat16', param_dtype='float32',
                 output_dtype='float32'):
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.output_dtype = output_dtype


def init(target_dtype='bfloat16', target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP (reference contrib/amp/amp.py:init) with ``target_dtype``
    bfloat16 (the default, no loss scaling) or float16."""
    _state['enabled'] = True
    _state['dtype'] = 'float16' if target_dtype in ('float16', _np.float16) \
        else 'bfloat16'


def is_enabled():
    return _state['enabled']


def compute_dtype():
    return _state['dtype'] if _state['enabled'] else 'float32'


def _grads(params):
    """The gradient tensors of ``params`` (Gluon ``Parameter``s, whose
    grad buffers are read and written in place, or ``torch.nn.Parameter``s
    with a ``.grad``)."""
    out = []
    for param in params:
        if isinstance(param, torch.Tensor):
            if param.requires_grad and param.grad is not None:
                out.append(param.grad)
        elif param.grad_req != 'null' and param._var is not None:
            buf = param._grad_buffer()
            if buf is not None:
                out.append(buf)
    return out


class DynamicLossScaler:
    """Dynamic loss scaling for fp16 (reference contrib/amp/loss_scaler.py):
    halve on overflow, double after ``scale_window`` clean steps. bf16
    never needs it (fp32's exponent range); it exists for fp16."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = init_scale
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True when any gradient is not finite. Every gradient's check
        stacks into one device value, so there is one host sync (the role
        of the reference's fused multi_all_finite kernel)."""
        flags = [torch.isfinite(g).all() for g in _grads(params)]
        if not flags:
            return False
        return not bool(torch.stack(flags).all())

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0


def init_trainer(trainer):
    """Reference amp.init_trainer: dynamic loss scaling for fp16; bf16
    needs none."""
    if _state['dtype'] == 'float16':
        trainer._amp_loss_scaler = DynamicLossScaler()


def scale_loss(loss, trainer):
    """A context that yields the loss (or a list of losses) times the
    trainer's loss scale (1 without a scaler), reference amp.scale_loss."""

    @contextlib.contextmanager
    def scope():
        scaler = getattr(trainer, '_amp_loss_scaler', None)
        scale = scaler.loss_scale if scaler is not None else 1.0
        if isinstance(loss, (list, tuple)):
            yield [l * scale for l in loss]
        else:
            yield loss * scale
    return scope()


def unscale(trainer):
    """Divide the gradients by the current scale, in place. On an
    overflow, zero them, shrink the scale and arm the trainer's skip flag,
    so that its next ``step()`` updates nothing at all (no weight decay or
    momentum either), as the reference's loss scaler does. Returns False
    after an overflow."""
    scaler = getattr(trainer, '_amp_loss_scaler', None)
    if scaler is None:
        return True
    overflow = scaler.has_overflow(trainer._params)
    with torch.no_grad():
        for g in _grads(trainer._params):
            if overflow:
                g.zero_()
            else:
                g.div_(scaler.loss_scale)
    scaler.update_scale(overflow)
    if overflow:
        trainer._amp_skip_update = True
    return not overflow


def convert_hybrid_block(block, target_dtype='bfloat16', **kwargs):
    """Reference amp.convert_hybrid_block: cast the block's parameters to
    ``target_dtype``, so that its forward computes in that dtype."""
    block.cast(target_dtype)
    return block


from .pass_ import convert_symbol, convert_model  # noqa: E402,F401
