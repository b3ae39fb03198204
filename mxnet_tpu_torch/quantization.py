"""INT8 post-training quantization (PTQ) in PyTorch.

Counterpart of ``mxnet_tpu/quantization.py``: run calibration batches
through the float net with hooks that collect each quantizable layer's
input, derive per-layer ranges (``naive``, ``percentile`` or ``entropy``),
then swap each ``nn.Linear`` (the port's Gluon ``Dense``, ``flatten=False``)
for a :class:`QuantizedDense`. Layer outputs stay float (bf16 by default),
so only layer inputs need calibrated ranges and there is no int8 graph
between layers.

Scheme: symmetric; per tensor for activations (scale = max(|min|, |max|) /
127, zero point 0), per output channel for weights. The product runs
through the hand-written int8 kernel with the dequantize in its epilogue
(:func:`.ops.quantization_ops.quantized_dense`).

The calibration collector and ``calib_table`` are the reference's, in
numpy. ``QuantizedConv2D`` is not ported yet: an ``nn.Conv2d`` that is not
excluded raises (ROADMAP A7, with ResNet). :func:`load_jax_quantized`
carries a JAX quantized net's per-layer state into a port net.
"""

import re

import numpy as _np
import torch
from torch import nn

from .ops.quantization_ops import (quantize_v2, dequantize, requantize,
                                   range_to_scale, quantized_dense)

__all__ = ['quantize_v2', 'dequantize', 'requantize', 'quantize_net',
           'calib_table', 'QuantizedDense', 'load_jax_quantized']


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
class QuantizedDense(nn.Module):
    """int8 fully connected layer (reference ``QuantizedDense``): the input
    is quantized per tensor under its calibrated range, the product runs
    int8 x int8 -> int32 in the kernel, and one fp32 rescale per output
    channel (with the bias) leaves in ``activation_dtype``.

    Buffers: ``qweight`` int8 ``(out, in)``, ``w_scale`` fp32 ``(out,)``
    (max |w| / 127 per output channel), ``in_range`` fp32 ``(2,)``, the
    calibrated input range, ``x_scale`` fp32 ``()``, its scale, ``scale``
    fp32 ``(out,)``, the combined input x weight scale the epilogue
    applies, and ``bias`` fp32 or None. The scales are computed once here,
    on the layer's device, so that a forward copies nothing from the
    host."""

    def __init__(self, float_layer, in_min, in_max,
                 activation_dtype='bfloat16'):
        super().__init__()
        w = float_layer.weight.detach()
        bias = float_layer.bias
        with torch.no_grad():
            w32 = w.float()
            amax = w32.abs().amax(dim=1)
            w_scale = torch.where(
                amax > 0, amax / torch.tensor(127.0, device=w.device),
                torch.ones_like(amax))
            q = w32 / w_scale[:, None]
            qweight = q.round_().clamp_(-127, 127).to(torch.int8)
            del q, w32
        self._init_state(qweight, w_scale, (in_min, in_max),
                         None if bias is None else bias.detach().float(),
                         activation_dtype)

    @classmethod
    def from_state(cls, qweight, w_scale, in_range, bias=None,
                   activation_dtype='bfloat16'):
        """A layer from its quantized state: ``qweight`` int8 ``(out,
        in)``, ``w_scale`` ``(out,)``, the input range ``(min, max)`` and
        the float bias or None (tensors or numpy arrays)."""
        layer = cls.__new__(cls)
        nn.Module.__init__(layer)
        t = torch.tensor        # a copy: the arrays may be read-only
        layer._init_state(
            t(_np.asarray(qweight, _np.int8)),
            t(_np.asarray(w_scale, _np.float32)),
            tuple(float(v) for v in _np.asarray(in_range).ravel()),
            None if bias is None else t(_np.asarray(bias, _np.float32)),
            activation_dtype)
        return layer

    def _init_state(self, qweight, w_scale, in_range, bias,
                    activation_dtype):
        dev = qweight.device
        self._act_dtype = getattr(torch, activation_dtype) \
            if isinstance(activation_dtype, str) else activation_dtype
        self.in_features = qweight.shape[1]
        self.out_features = qweight.shape[0]
        # a range from the collector is float64; it rounds to fp32 here as
        # the reference rounds it on use
        rng = torch.tensor([float(in_range[0]), float(in_range[1])],
                           dtype=torch.float32, device=dev)
        self.register_buffer('qweight', qweight.contiguous())
        self.register_buffer('w_scale', w_scale.to(dev, torch.float32))
        self.register_buffer('in_range', rng)
        self.register_buffer('x_scale', range_to_scale(rng[0], rng[1]))
        self.register_buffer('scale',
                             (self.x_scale * self.w_scale).contiguous())
        self.register_buffer('bias', None if bias is None
                             else bias.to(dev, torch.float32).contiguous())

    @property
    def collected_range(self):
        return tuple(float(v) for v in self.in_range.tolist())

    def forward(self, x):
        # quantize_v2 under the calibrated range, with its scale kept
        q = torch.round(x.float() / self.x_scale).clamp_(-127, 127) \
            .to(torch.int8)
        return quantized_dense(q, self.qweight, self.scale, self.bias,
                               out_dtype=self._act_dtype)

    def extra_repr(self):
        return (f'in_features={self.in_features}, '
                f'out_features={self.out_features}, '
                f'bias={self.bias is not None}, '
                f'activation_dtype={self._act_dtype}')


# --------------------------------------------------------- graph rewrite
def _quantizable(module, path):
    """True for an ``nn.Linear``; raises on an ``nn.Conv2d``."""
    if isinstance(module, nn.Conv2d):
        raise NotImplementedError(
            f'quantize_net: {path or "the net"} is an nn.Conv2d; the int8 '
            f'convolution is not ported yet (ROADMAP A7). Exclude it with '
            f'exclude_layers=[{path!r}] to keep it float.')
    return isinstance(module, nn.Linear)


def _walk(module, prefix=''):
    for name, child in list(module.named_children()):
        path = f'{prefix}{name}'
        yield module, name, path, child
        yield from _walk(child, path + '.')


def quantize_net(net, calib_data=None, calib_mode='entropy',
                 quantized_dtype='int8', exclude_layers=None,
                 num_calib_batches=None, logger=None,
                 activation_dtype='bfloat16'):
    """Quantize a float network for int8 inference, in place.

    Runs ``calib_data`` (an iterable of batches; a tuple or list batch
    gives its first element) through ``net`` under ``no_grad`` with a
    forward pre-hook on every quantizable child that collects its input,
    derives per-layer ranges by ``calib_mode`` ('naive' | 'percentile' |
    'entropy'), then swaps each ``nn.Linear`` for a :class:`QuantizedDense`
    with ``setattr`` on its parent (``nn.ModuleList`` children too). The
    float layer is dropped as soon as its twin is built. A layer that no
    calibration batch reached stays float. If ``net`` itself is an
    ``nn.Linear`` its twin is the return value: always use the returned
    module. ``exclude_layers`` names paths (``model.layers.0.mlp.up_proj``)
    to keep float; ``'.'`` is the net itself."""
    if quantized_dtype != 'int8':
        raise ValueError('only int8 quantization is supported')
    if calib_data is None:
        raise ValueError('calib_data is required for post-training '
                         'quantization')
    exclude_layers = set(exclude_layers or ())
    targets = [(parent, name, path, child)
               for parent, name, path, child in _walk(net)
               if path not in exclude_layers and _quantizable(child, path)]
    if '.' not in exclude_layers and _quantizable(net, ''):
        targets.append((None, None, '.', net))     # the net IS the layer
    if not targets:
        return net

    collectors = {path: _HistogramCollector() for _, _, path, _ in targets}

    def make_hook(path):
        def hook(module, inputs):
            collectors[path].collect(
                inputs[0].detach().float().cpu().numpy())
        return hook

    dev = next((p.device for p in net.parameters()), None)
    handles = []
    try:
        for _, _, path, child in targets:
            handles.append(child.register_forward_pre_hook(make_hook(path)))
        with torch.no_grad():
            for n, batch in enumerate(calib_data, 1):
                x = batch[0] if isinstance(batch, (tuple, list)) else batch
                net(torch.as_tensor(x, device=dev))
                if num_calib_batches is not None and n >= num_calib_batches:
                    break
    finally:
        for h in handles:
            h.remove()

    table = calib_table(collectors, calib_mode)
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
        qlayer = QuantizedDense(child, lo, hi,
                                activation_dtype=activation_dtype)
        del child
        if parent is None:
            result = qlayer     # the root swap happens via the return value
        else:
            setattr(parent, name, qlayer)
    if logger:
        for path, (lo, hi) in table.items():
            logger.info('calibrated %s: [%.5f, %.5f]', path, lo, hi)
    return result


def load_jax_quantized(net, qstate, params=None,
                       activation_dtype='bfloat16'):
    """Load a JAX quantized net's state into the port net ``net``, in
    place; returns ``net``.

    ``qstate`` maps each quantized layer's JAX path
    (``model.layers0.self_attn.q_proj``) to a dict of numpy arrays:
    ``qweight``, ``w_scale`` (the JAX layer's ``_w_scale``),
    ``collected_range`` and ``bias`` (None without one). Each named
    ``nn.Linear`` of ``net`` is swapped for a :class:`QuantizedDense`
    built from that state. ``params`` optionally maps the JAX names of
    the float parameters that stay (the embedding and the norms, as
    ``from_jax_params`` takes them) to numpy arrays; every float
    parameter left in ``net`` must then be among them."""
    for jpath, st in qstate.items():
        path = re.sub(r'\.layers(\d+)\.', r'.layers.\1.', jpath)
        *head, name = path.split('.')
        parent = net.get_submodule('.'.join(head))
        old = getattr(parent, name)
        if not isinstance(old, (nn.Linear, QuantizedDense)):
            raise TypeError(f'{jpath}: {path} is a {type(old).__name__}, '
                            f'not a Dense layer')
        dev = next(old.buffers() if isinstance(old, QuantizedDense)
                   else old.parameters()).device
        q = QuantizedDense.from_state(st['qweight'], st['w_scale'],
                                      st['collected_range'], st.get('bias'),
                                      activation_dtype)
        if tuple(q.qweight.shape) != (old.out_features, old.in_features):
            raise ValueError(f'{jpath}: qweight {tuple(q.qweight.shape)}, '
                             f'the layer is ({old.out_features}, '
                             f'{old.in_features})')
        setattr(parent, name, q.to(dev))
    if params is not None:
        own = dict(net.named_parameters())
        sd = {}
        for jname, value in params.items():
            key = re.sub(r'\.layers(\d+)\.', r'.layers.\1.', jname)
            if key in own:
                sd[key] = torch.as_tensor(_np.asarray(value))
        missing = sorted(set(own) - set(sd))
        if missing:
            raise ValueError(f'float parameters missing: {missing}')
        net.load_state_dict(sd, strict=False)
    return net
