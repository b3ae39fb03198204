"""INT8 post-training quantization (PTQ) in PyTorch.

Counterpart of ``mxnet_tpu/quantization.py``: run calibration batches
through the float net with hooks that collect each quantizable layer's
input, derive per-layer ranges (``naive``, ``percentile`` or ``entropy``),
then swap each layer for its int8 twin. Layer outputs stay float (bf16 by
default), so only layer inputs need calibrated ranges and there is no int8
graph between layers.

:func:`quantize_net` takes a Gluon :class:`~.gluon.Block` (the vision
zoo, BERT, the Llama family, a user's blocks) and walks its ``_children``
as the reference does, swapping each ``Dense`` for a
:class:`QuantizedDense` and each ``Conv2D`` for a :class:`QuantizedConv2D`,
both ``HybridBlock``s with the reference's parameters (``qweight`` int8,
``grad_req='null'``, and ``bias``).

Scheme: symmetric; per tensor for activations (scale = max(|min|, |max|) /
127, zero point 0), per output channel for weights. The products run
through the hand-written int8 kernel with the dequantize in its epilogue
(:func:`.ops.quantization_ops.quantized_dense`; a convolution as its
windows gathered into rows, :func:`.ops.quantization_ops.quantized_conv2d`).
A layer's scales are device tensors made once when it is built: its forward
copies nothing from the host, so a hybridized net's predict call can be
captured as a CUDA graph.

The calibration collector and ``calib_table`` are the reference's, in
numpy. :func:`load_jax_quantized` carries a JAX quantized net's per-layer
state into the port's net of the same structure, as ``QuantizedDense``
layers.
"""

import numpy as _np
import torch

from .gluon.block import Block, HybridBlock
from .gluon.parameter import Parameter
from .ndarray.ndarray import NDArray, array
from .ops.quantization_ops import (quantize_v2, dequantize, requantize,
                                   range_to_scale, quantized_dense,
                                   quantized_conv2d)

__all__ = ['quantize_v2', 'dequantize', 'requantize', 'quantize_net',
           'calib_table', 'QuantizedDense', 'QuantizedConv2D',
           'load_jax_quantized']


# ------------------------------------------------------------ calibration
class _HistogramCollector:
    """Per-layer input min/max + histogram (reference calibrate.cc's
    LayerOutputMinMaxCollector / HistogramCollector)."""

    def __init__(self, num_bins=2048):
        self.num_bins = num_bins
        self.min = None
        self.max = None
        self.hist = None
        self.edges = None

    def collect(self, arr):
        a = _np.asarray(arr, dtype=_np.float32).ravel()
        lo, hi = float(a.min()), float(a.max())
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)
        amax = max(abs(self.min), abs(self.max)) or 1.0
        hist, edges = _np.histogram(a, bins=self.num_bins,
                                    range=(-amax, amax))
        if self.hist is None or len(self.hist) != len(hist) or \
                self.edges[-1] != edges[-1]:
            # range grew: rebuild by re-binning the old histogram midpoints
            if self.hist is not None:
                mids = (self.edges[:-1] + self.edges[1:]) / 2
                old, _ = _np.histogram(mids, bins=self.num_bins,
                                       range=(-amax, amax),
                                       weights=self.hist)
                hist = hist + old.astype(hist.dtype)
            self.edges = edges
        else:
            hist = hist + self.hist
        self.hist = hist

    # threshold selection -------------------------------------------------
    def naive(self):
        return self.min, self.max

    def percentile(self, p=99.99):
        total = self.hist.sum()
        target = total * (p / 100.0)
        c = _np.cumsum(self.hist)
        # symmetric: walk outward from the center until p% mass is covered
        center = self.num_bins // 2
        for w in range(1, center + 1):
            covered = c[min(center + w, self.num_bins - 1)] - \
                (c[center - w - 1] if center - w - 1 >= 0 else 0)
            if covered >= target:
                # covered mass extends through the UPPER edge of bin
                # center+w, i.e. edges[center+w+1]
                t = float(self.edges[min(center + w + 1, self.num_bins)])
                return -t, t
        return self.min, self.max

    def entropy(self, num_quantized_bins=255):
        """KL-divergence threshold search (reference calibrate.cc, the
        TensorRT algorithm: pick the clip threshold whose quantized
        distribution diverges least from the clipped reference)."""
        hist = self.hist.astype(_np.float64)
        total = hist.sum()
        if total == 0:
            return self.min, self.max
        p_full = hist / total
        edges = self.edges
        center = self.num_bins // 2
        eps = 1e-10
        best_t, best_kl = max(abs(self.min), abs(self.max)), _np.inf
        # KL is measured against the FULL distribution, with the window's
        # reconstruction saturating clipped mass onto the edge bins, so
        # clipping genuinely costs divergence
        for w in range(center, num_quantized_bins // 2 - 1,
                       -max(center // 64, 1)):
            lo_i, hi_i = center - w, center + w
            window = hist[lo_i:hi_i]
            if window.sum() == 0:
                continue
            factor = len(window) / num_quantized_bins
            recon = _np.zeros_like(window)
            for i in range(num_quantized_bins):
                s = int(i * factor)
                e = max(int((i + 1) * factor), s + 1)
                chunk = window[s:e]
                nz = (chunk > 0).sum()
                if nz:
                    recon[s:e] = _np.where(chunk > 0, chunk.sum() / nz, 0)
            q = _np.zeros_like(hist)
            q[lo_i:hi_i] = recon
            q[lo_i] += hist[:lo_i].sum()     # saturation
            q[hi_i - 1] += hist[hi_i:].sum()
            q = q / q.sum()
            mask = p_full > 0
            kl = float(_np.sum(p_full[mask] * _np.log(
                p_full[mask] / _np.maximum(q[mask], eps))))
            if kl < best_kl:
                best_kl = kl
                best_t = float(edges[hi_i] if hi_i < len(edges) else
                               edges[-1])
        return -best_t, best_t


def calib_table(collectors, mode='entropy'):
    """collectors: {layer_name: _HistogramCollector} -> {name: (min, max)}.
    Layers never exercised by the calibration data are omitted."""
    if mode not in ('naive', 'percentile', 'entropy'):
        raise ValueError(f'unknown calib_mode {mode!r}; expected '
                         "'naive', 'percentile' or 'entropy'")
    table = {}
    for name, c in collectors.items():
        if c.hist is None:
            continue
        if mode == 'naive':
            table[name] = c.naive()
        elif mode == 'percentile':
            table[name] = c.percentile()
        else:
            table[name] = c.entropy()
    return table


# ------------------------------------------------------- quantized layers
def _torch_dtype(dtype):
    return getattr(torch, str(dtype)) if isinstance(dtype, str) else dtype


def _weight_scale(w):
    """Per-output-channel scale ``max|w| / 127`` over every axis but 0 (1
    where a channel is all zero) and the weight as int8 codes under it."""
    w32 = w.detach().float()
    red = tuple(range(1, w32.dim()))
    amax = w32.abs().amax(dim=red) if red else w32.abs()
    w_scale = torch.where(amax > 0, amax / torch.tensor(127.0,
                                                         device=w.device),
                          torch.ones_like(amax))
    cshape = (-1,) + (1,) * (w32.dim() - 1)
    q = (w32 / w_scale.reshape(cshape)).round_().clamp_(-127, 127)
    return w_scale, q.to(torch.int8)


def _quantize_input(x, x_scale):
    """quantize_v2 under a calibrated range whose scale is the fp32 device
    scalar ``x_scale``: no host value reaches the device."""
    return torch.round(x.float() / x_scale).clamp_(-127, 127) \
        .to(torch.int8)


class _QuantizedLayer(HybridBlock):
    """Shared int8 state of a Gluon twin (reference ``_QuantizedLayer``):
    ``qweight`` (int8, ``grad_req='null'``), ``bias`` when the float layer
    has one, the per-output-channel weight scale ``_w_scale``, the
    calibrated input range ``collected_range`` and, made once on the
    weight's device, the input scale ``_x_scale`` (an fp32 scalar) and the
    combined scale ``_scale = _x_scale * _w_scale`` that the product's
    epilogue applies. The scales are arrays, not Parameters, as in the
    reference."""

    def __init__(self, float_layer, in_min, in_max,
                 activation_dtype='bfloat16', **kwargs):
        super().__init__(**kwargs)
        w = float_layer.weight.data()
        w_scale, qw = _weight_scale(w._data)
        has_bias = getattr(float_layer, 'bias', None) is not None and \
            getattr(float_layer, '_use_bias', True)
        self._init_state(qw, w_scale, (in_min, in_max),
                         float_layer.bias.data() if has_bias else None,
                         w.context, float_layer.act, activation_dtype)

    def _init_state(self, qw, w_scale, in_range, bias, ctx, act,
                    activation_dtype):
        self._act_dtype = _torch_dtype(activation_dtype)
        self._w_scale = w_scale
        dev = ctx.to_torch()
        # the codes and the bias bound as the parameters' values at once
        self.qweight = Parameter('qweight', shape=tuple(qw.shape),
                                 dtype='int8', grad_req='null')
        self.qweight._bind(qw.to(dev, torch.int8), [ctx])
        self._has_bias = bias is not None
        if self._has_bias:
            b = bias._data if isinstance(bias, NDArray) else \
                torch.as_tensor(bias)
            self.bias = Parameter('bias', shape=tuple(b.shape),
                                  grad_req='null')
            self.bias._bind(b.detach().to(dev, torch.float32), [ctx])
        self.collected_range = tuple(in_range)
        # a range from the collector is float64; it rounds to fp32 here as
        # the reference's quantize_v2 rounds it
        rng = torch.tensor([float(v) for v in in_range],
                           dtype=torch.float32, device=w_scale.device)
        self._x_scale = range_to_scale(rng[0], rng[1])
        self._scale = (self._x_scale * self._w_scale).contiguous()
        self.act = act

    def _quantize_input(self, x):
        xr = x._data if isinstance(x, NDArray) else x
        return _quantize_input(xr.detach(), self._x_scale)

    def _bias(self):
        return self.bias.data()._data.detach().float().contiguous() \
            if self._has_bias else None

    def _finish(self, out):
        out = NDArray(out)
        return out if self.act is None else self.act(out)


class QuantizedDense(_QuantizedLayer):
    """int8 FullyConnected (reference ``QuantizedDense``, quantized_fully_
    connected.cc): int8 x int8 -> int32 in the kernel, one fp32 rescale
    per output channel with the bias, out in ``activation_dtype``, then the
    float layer's activation. ``flatten`` as the float ``Dense``'s."""

    def __init__(self, float_layer, in_min, in_max, **kwargs):
        super().__init__(float_layer, in_min, in_max, **kwargs)
        self._flatten = float_layer._flatten

    @classmethod
    def from_state(cls, qweight, w_scale, in_range, bias=None, ctx=None,
                   flatten=True, act=None, activation_dtype='bfloat16'):
        """A layer from its quantized state (the JAX layer's): ``qweight``
        int8 ``(out, in)``, ``w_scale`` ``(out,)``, the input range ``(min,
        max)`` and the float bias or None (tensors or numpy arrays), on
        ``ctx`` (the current context by default)."""
        from .context import current_context
        ctx = ctx or current_context()
        layer = cls.__new__(cls)
        HybridBlock.__init__(layer)
        dev = ctx.to_torch()
        t = torch.tensor        # a copy: the arrays may be read-only
        layer._init_state(
            t(_np.asarray(qweight, _np.int8)),
            t(_np.asarray(w_scale, _np.float32), device=dev),
            tuple(float(v) for v in _np.asarray(in_range).ravel()),
            None if bias is None else t(_np.asarray(bias, _np.float32)),
            ctx, act, activation_dtype)
        layer._flatten = flatten
        return layer

    def forward(self, x):
        q = self._quantize_input(x)
        if self._flatten and q.dim() > 2:
            q = q.reshape(q.shape[0], -1)
        return self._finish(quantized_dense(
            q, self.qweight.data()._data.detach(), self._scale,
            self._bias(), out_dtype=self._act_dtype))


class QuantizedConv2D(_QuantizedLayer):
    """int8 Convolution (reference ``QuantizedConv2D``, quantized_conv.cc)
    with the float ``Conv2D``'s strides, padding, dilation, groups and
    layout."""

    def __init__(self, float_layer, in_min, in_max, **kwargs):
        super().__init__(float_layer, in_min, in_max, **kwargs)
        self._stride = float_layer._strides
        self._pad = float_layer._padding
        self._dilate = float_layer._dilation
        self._groups = float_layer._groups
        self._layout = float_layer._layout or 'NCHW'

    def forward(self, x):
        def pair(v):
            return tuple(v) if isinstance(v, (tuple, list)) else (v, v)
        return self._finish(quantized_conv2d(
            self._quantize_input(x), self.qweight.data()._data.detach(),
            self._scale, self._bias(), out_dtype=self._act_dtype,
            strides=pair(self._stride), padding=pair(self._pad),
            dilation=pair(self._dilate), groups=self._groups,
            layout=self._layout))


# --------------------------------------------------------- graph rewrite
def _gluon_twin(block):
    """The int8 twin class of a Gluon layer, or None (reference
    ``_quantizable``)."""
    from .gluon.nn.basic_layers import Dense
    from .gluon.nn.conv_layers import Conv2D
    if isinstance(block, Dense):
        return QuantizedDense
    if isinstance(block, Conv2D):
        return QuantizedConv2D
    return None


def _gluon_walk(block, prefix=''):
    for name, child in list(block._children.items()):
        path = f'{prefix}{name}'
        yield block, name, path, child
        yield from _gluon_walk(child, path + '.')


def _batch(batch):
    return batch[0] if isinstance(batch, (tuple, list)) else batch


def _calibrate(net, targets, calib_data, num_calib_batches, hook_on,
               run_batch):
    """Run the calibration batches through ``net`` with a collecting hook
    on every target (``hook_on(child, hook)`` installs one and returns its
    remover); returns the collectors by path."""
    collectors = {path: _HistogramCollector() for _, _, path, _ in targets}

    def make_hook(path):
        def hook(block, inputs):
            x = inputs[0]
            x = x._data if isinstance(x, NDArray) else x
            collectors[path].collect(x.detach().float().cpu().numpy())
        return hook

    removers = []
    try:
        for _, _, path, child in targets:
            removers.append(hook_on(child, make_hook(path)))
        for n, batch in enumerate(calib_data, 1):
            run_batch(_batch(batch))
            if num_calib_batches is not None and n >= num_calib_batches:
                break
    finally:
        for remove in removers:
            remove()
    return collectors


def _log_table(logger, table):
    if logger:
        for path, (lo, hi) in table.items():
            logger.info('calibrated %s: [%.5f, %.5f]', path, lo, hi)


def quantize_net(net, calib_data=None, calib_mode='entropy',
                 quantized_dtype='int8', exclude_layers=None,
                 num_calib_batches=None, logger=None,
                 activation_dtype='bfloat16'):
    """Quantize a trained network for int8 inference, in place.

    Runs ``calib_data`` (an iterable of batches; a tuple or list batch
    gives its first element) through ``net`` with a forward pre-hook on
    every quantizable layer that collects its input, derives per-layer
    ranges by ``calib_mode`` ('naive' | 'percentile' | 'entropy'), then
    swaps each layer for its int8 twin built from those ranges. As the
    reference does, hybridization is cleared first (a cached graph would
    bypass the hooks and keep serving the float layers; re-hybridize
    afterwards), and so are the graphs of a Llama's ``generate()``; each
    ``Dense`` becomes a :class:`QuantizedDense` and each ``Conv2D`` a
    :class:`QuantizedConv2D`, swapped in the parent's ``_children`` and in
    its attributes, and the float layer is dropped as soon as its twin is
    built; paths are structural (``features.4.0.body.0``,
    ``model.layers0.mlp.up_proj``).

    A layer that no calibration batch reached stays float (with a warning
    on ``logger``). If ``net`` itself is a quantizable layer its twin is
    the return value: always use the returned net. ``exclude_layers``
    names paths to keep float; ``'.'`` is the net itself."""
    if quantized_dtype != 'int8':
        raise ValueError('only int8 quantization is supported')
    if calib_data is None:
        raise ValueError('calib_data is required for post-training '
                         'quantization')
    exclude_layers = set(exclude_layers or ())
    if not isinstance(net, Block):
        raise TypeError(f'quantize_net takes a Gluon Block, not a '
                        f'{type(net).__name__}')
    return _quantize_gluon(net, calib_data, calib_mode, exclude_layers,
                           num_calib_batches, logger, activation_dtype)


def _quantize_gluon(net, calib_data, calib_mode, exclude_layers,
                    num_calib_batches, logger, activation_dtype):
    """The reference's walk (``mxnet_tpu/quantization.py:265-370``)."""
    net.hybridize(False)
    targets = [(parent, name, path, child)
               for parent, name, path, child in _gluon_walk(net)
               if _gluon_twin(child) and path not in exclude_layers]
    if _gluon_twin(net) is not None and '.' not in exclude_layers:
        targets.append((None, None, '.', net))      # the net IS the layer
    if not targets:
        return net
    ctx = next((p.list_ctx()[0] for p in net.collect_params().values()
                if p._var is not None or p._deferred_init is not None),
               None)

    def hook_on(child, hook):
        child._forward_pre_hooks.append(hook)
        return lambda: child._forward_pre_hooks.remove(hook)

    def run_batch(x):
        net(x if isinstance(x, NDArray) else array(x, ctx=ctx))

    table = calib_table(_calibrate(net, targets, calib_data,
                                   num_calib_batches, hook_on, run_batch),
                        calib_mode)
    if hasattr(net, 'release_graphs'):      # they read the float layers
        net.release_graphs()
    result = net
    while targets:
        parent, name, path, child = targets.pop(0)
        if path not in table:
            if logger:
                logger.warning('layer %s not exercised by calib_data; '
                               'kept in float', path)
            continue
        lo, hi = table[path]
        qlayer = _gluon_twin(child)(child, lo, hi,
                                    activation_dtype=activation_dtype)
        if parent is None:
            result = qlayer     # the root swap happens via the return value
            continue
        _swap(parent, name, child, qlayer)
        del child
    _log_table(logger, table)
    return result


def _swap(parent, name, old, new):
    """``new`` in place of the child ``old`` of ``parent``, also where an
    attribute names it."""
    parent._children[name] = new
    for attr, value in list(parent.__dict__.items()):
        if value is old:
            object.__setattr__(parent, attr, new)


def load_jax_quantized(net, qstate, params=None,
                       activation_dtype='bfloat16'):
    """Load a JAX quantized net's state into the port net ``net`` (a Gluon
    block of the same structure, float or quantized), in place; returns
    ``net``.

    ``qstate`` maps each quantized layer's path
    (``model.layers0.self_attn.q_proj``, the same in both packages) to a
    dict of numpy arrays: ``qweight``, ``w_scale`` (the JAX layer's
    ``_w_scale``), ``collected_range`` and ``bias`` (None without one).
    Each named ``Dense`` (or ``QuantizedDense``) of ``net`` is swapped for
    a :class:`QuantizedDense` built from that state on the layer's
    context. ``params`` optionally maps the names of the float parameters
    that stay (the embedding and the norms) to numpy arrays; every float
    parameter left in ``net`` must then be among them."""
    from .gluon.nn.basic_layers import Dense
    for path, st in qstate.items():
        *head, name = path.split('.')
        parent = net
        for part in head:
            parent = parent._children[part]
        old = parent._children.get(name)
        if not isinstance(old, (Dense, QuantizedDense)):
            raise TypeError(f'{path} is a {type(old).__name__}, not a '
                            f'Dense layer')
        p = old.weight if isinstance(old, Dense) else old.qweight
        want = tuple(p.shape)
        got = tuple(_np.shape(st['qweight']))
        if got != want:
            raise ValueError(f'{path}: qweight {got}, the layer is {want}')
        q = QuantizedDense.from_state(
            st['qweight'], st['w_scale'], st['collected_range'],
            st.get('bias'), ctx=p.list_ctx()[0], flatten=old._flatten,
            act=old.act, activation_dtype=activation_dtype)
        _swap(parent, name, old, q)
    if hasattr(net, 'release_graphs'):
        net.release_graphs()
    if params is not None:
        quantized = tuple(f'{path}.' for path in qstate)
        own = {n: p for n, p in net.collect_params().items()
               if not n.startswith(quantized)}
        missing = sorted(n for n in own if n not in params)
        if missing:
            raise ValueError(f'float parameters missing: {missing}')
        for n, p in own.items():
            p.set_data(_np.asarray(params[n]))
    return net
