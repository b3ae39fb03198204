"""Gluon int8 quantization of the port (``mxnet_tpu_torch/quantization.py``
``QuantizedDense``, ``QuantizedConv2D`` and the Gluon walk of
``quantize_net``) against the JAX package's, on the CPU.

Both packages get the same float weights (carried across by name) and the
same seeded inputs. Weight codes are bit-equal. The int8 sums are exact in
both, so each twin's output is held to one bf16 ulp plus 1e-5 of the
output's scale: the reference's epilogue and the port's round the same
fp32 values once to bf16 (XLA may fuse the rescale and the bias into one
FMA where the port rounds twice, so a few outputs part by one ulp).

In the thumbnail ``resnet18_v1`` every int8 layer is held that way on the
input the JAX net gave it. Whole, the two nets part by more: XLA's fused
BatchNorm and PyTorch's eager one round 3 in 4 of their fp32 outputs
differently (one ulp), an input one ulp from a code's .5 boundary then
takes the next code, and 20 layers compound such moves. So calibration
ranges are held at rtol 1e-5 and the logits at ``LOGIT_TOL`` of their
scale. ``quantized_conv2d``'s gathered route is held to one float64
convolution bit for bit.
"""

import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import quantization as jq
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import quantization as tq
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops.quantization_ops import range_to_scale

torch = pytest.importorskip('torch')

#: the thumbnail's int8 logits, JAX against the port, as a share of their
#: largest magnitude (see the module docstring; up to 0.018 was seen)
LOGIT_TOL = 0.05


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(make, x):
    """The JAX block and the port's from ``make(nn)``, initialized, run
    once on ``x`` and holding the JAX block's weights."""
    jb = make(jnn)
    jb.initialize()
    jb(jmx.np.array(x))
    weights = {k: p.data().asnumpy() for k, p in jb.collect_params().items()}
    tb = make(tnn)
    tb.initialize()
    tb(tmx.np.array(x))
    tb.load_dict(weights)
    return jb, tb


def _bf16_close(got, want):
    """Within one bf16 ulp (of the larger of the two values) plus 1e-5 of
    ``want``'s scale."""
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    top = np.maximum(np.maximum(np.abs(want), np.abs(got)), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    tol = ulp + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


DENSE_CASES = [
    dict(units=6, flatten=True, act=None, bias=True, shape=(4, 2, 5)),
    dict(units=6, flatten=False, act=None, bias=True, shape=(4, 3, 5)),
    dict(units=7, flatten=True, act='relu', bias=False, shape=(3, 9)),
    dict(units=5, flatten=True, act='tanh', bias=True, shape=(2, 16)),
]


@pytest.mark.parametrize('case', DENSE_CASES, ids=lambda c: (
    f'u{c["units"]}-flat{c["flatten"]}-{c["act"]}-bias{c["bias"]}'))
def test_quantized_dense_matches_the_jax_twin(case):
    x = _x(case['shape'], 1)
    jb, tb = _pair(lambda nn: nn.Dense(
        case['units'], activation=case['act'], use_bias=case['bias'],
        flatten=case['flatten']), x)
    lo, hi = float(x.min()), float(x.max())
    jl = jq.QuantizedDense(jb, lo, hi)
    tl = tq.QuantizedDense(tb, lo, hi)
    jp, tp = jl.collect_params(), tl.collect_params()
    assert list(tp) == list(jp)
    np.testing.assert_array_equal(tp['qweight'].data().asnumpy(),
                                  jp['qweight'].data().asnumpy())
    assert tp['qweight'].data().dtype == np.int8
    assert tp['qweight'].grad_req == 'null'
    np.testing.assert_array_equal(tl._w_scale.numpy(),
                                  np.asarray(jl._w_scale))
    assert float(tl._x_scale) == np.float32(jl._x_scale)
    xi = _x(case['shape'], 2)
    want = jl(jmx.np.array(xi))
    got = tl(tmx.np.array(xi))
    assert str(got.dtype) == str(want.dtype) == 'bfloat16'
    assert got.shape == want.shape
    _bf16_close(got.astype('float32').asnumpy(),
                want.astype('float32').asnumpy())


CONV_CASES = [
    dict(channels=8, kernel=3, strides=1, padding=1, dilation=1, groups=1,
         layout='NCHW', bias=True),
    dict(channels=6, kernel=3, strides=2, padding=0, dilation=1, groups=1,
         layout='NCHW', bias=False),
    dict(channels=8, kernel=3, strides=1, padding=2, dilation=2, groups=1,
         layout='NCHW', bias=True),
    dict(channels=8, kernel=3, strides=1, padding=1, dilation=1, groups=2,
         layout='NCHW', bias=True),
    dict(channels=4, kernel=1, strides=2, padding=0, dilation=1, groups=1,
         layout='NCHW', bias=True),
    dict(channels=8, kernel=3, strides=(2, 1), padding=(1, 0), dilation=1,
         groups=1, layout='NCHW', bias=True),
    dict(channels=6, kernel=3, strides=1, padding=1, dilation=1, groups=1,
         layout='NHWC', bias=True),
]


@pytest.mark.parametrize('case', CONV_CASES, ids=lambda c: (
    f'k{c["kernel"]}-s{c["strides"]}-p{c["padding"]}-d{c["dilation"]}-'
    f'g{c["groups"]}-{c["layout"]}'))
def test_quantized_conv2d_matches_the_jax_twin(case):
    shape = (2, 4, 9, 9) if case['layout'] == 'NCHW' else (2, 9, 9, 4)
    x = _x(shape, 3)
    jb, tb = _pair(lambda nn: nn.Conv2D(
        case['channels'], case['kernel'], strides=case['strides'],
        padding=case['padding'], dilation=case['dilation'],
        groups=case['groups'], layout=case['layout'],
        use_bias=case['bias']), x)
    lo, hi = float(x.min()), float(x.max())
    jl = jq.QuantizedConv2D(jb, lo, hi)
    tl = tq.QuantizedConv2D(tb, lo, hi)
    assert list(tl.collect_params()) == list(jl.collect_params())
    np.testing.assert_array_equal(
        tl.qweight.data().asnumpy(), jl.qweight.data().asnumpy())
    xi = _x(shape, 4)
    want = jl(jmx.np.array(xi)).astype('float32').asnumpy()
    got = tl(tmx.np.array(xi)).astype('float32').asnumpy()
    assert got.shape == want.shape
    _bf16_close(got, want)


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_gathered_int8_convolution_equals_the_float64_convolution(layout):
    from mxnet_tpu_torch.ops.quantization_ops import (
        quantized_conv2d, quantized_conv2d_plain)
    g = torch.Generator().manual_seed(0)
    for c, o, k, s, p, d, groups in [(3, 8, 7, 2, 3, 1, 1),
                                     (16, 32, 1, 1, 0, 1, 1),
                                     (6, 4, 3, 1, 2, 2, 2)]:
        x = torch.randint(-127, 128, (2, c, 11, 10), generator=g) \
            .to(torch.int8)
        if layout == 'NHWC':
            x = x.permute(0, 2, 3, 1).contiguous()
        w = torch.randint(-127, 128, (o, c // groups, k, k), generator=g) \
            .to(torch.int8)
        scale = torch.rand(o, generator=g) * 1e-3
        bias = torch.randn(o, generator=g)
        args = (x, w, scale, bias, 'bfloat16', (s, s), (p, p), (d, d),
                groups, layout)
        got, want = quantized_conv2d(*args), quantized_conv2d_plain(*args)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)


def _thumbnail_pair(x):
    jmx.random.seed(0)
    jnet = jvision.resnet18_v1(classes=10, thumbnail=True)
    jnet.initialize()
    jnet(jmx.np.array(x))
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    tnet = tvision.resnet18_v1(classes=10, thumbnail=True)
    tnet.initialize()
    tnet(tmx.np.array(x))
    tnet.load_dict(weights)
    return jnet, tnet


def _layers(net):
    return {path: type(child).__name__
            for _, _, path, child in tq._gluon_walk(net)}


def _ranges(net):
    return {path: child.collected_range
            for _, _, path, child in tq._gluon_walk(net)
            if hasattr(child, 'collected_range')}


def _block_dtypes(net, x):
    """The dtype of each of ``net.features``' children's outputs, and the
    logits."""
    out = {}
    h = x
    for name, child in net.features._children.items():
        h = child(h)
        out[name] = str(h.dtype)
    logits = net.output(h)
    out['output'] = str(logits.dtype)
    return out, logits


def _same_layers(jnet, tnet, x):
    """Each int8 layer of the port on the input its JAX twin got in the
    JAX net's forward, under that twin's calibrated range, against that
    twin's output."""
    seen, twins = {}, {}
    for _, _, path, child in tq._gluon_walk(jnet):
        if hasattr(child, 'collected_range'):
            def hook(block, inputs, path=path):
                seen[path] = inputs[0]
            child._forward_pre_hooks.append(hook)
            twins[path] = child
    jnet(jmx.np.array(x))
    ports = {path: c for _, _, path, c in tq._gluon_walk(tnet)}
    assert set(seen) == set(twins) and len(seen) == 21
    for path, xin in seen.items():
        twins[path]._forward_pre_hooks.clear()
        want = twins[path](xin).astype('float32').asnumpy()
        port = ports[path]
        kept = port._x_scale, port._scale
        # the JAX twin's range: the two calibrations part by fp32 rounding
        lo, hi = (torch.tensor(v, dtype=torch.float32)
                  for v in twins[path].collected_range)
        port._x_scale = range_to_scale(lo, hi)
        port._scale = port._x_scale * port._w_scale
        got = port(tmx.np.array(np.asarray(
            xin.astype('float32').asnumpy()))).astype('float32').asnumpy()
        port._x_scale, port._scale = kept
        _bf16_close(got, want)


@pytest.mark.parametrize('mode', ['naive', 'percentile', 'entropy'])
def test_quantized_thumbnail_resnet18_matches_the_jax_net(mode):
    calib = _x((4, 3, 32, 32), 5)
    jnet, tnet = _thumbnail_pair(calib)
    jq_net = jq.quantize_net(jnet, calib_data=[jmx.np.array(calib)],
                             calib_mode=mode)
    tq_net = tq.quantize_net(tnet, calib_data=[calib], calib_mode=mode)
    assert jq_net is jnet and tq_net is tnet
    layers = _layers(tnet)
    assert layers == _layers(jnet)
    kinds = list(layers.values())
    assert kinds.count('QuantizedConv2D') == 20
    assert kinds.count('QuantizedDense') == 1
    assert 'Conv2D' not in kinds and 'Dense' not in kinds
    jr, tr = _ranges(jnet), _ranges(tnet)
    assert set(tr) == set(jr)
    for path, (lo, hi) in jr.items():
        np.testing.assert_allclose(tr[path], (lo, hi), rtol=1e-5,
                                   atol=1e-7, err_msg=path)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp) == list(jp)
    for k, p in jp.items():
        if k.endswith('qweight'):
            assert tp[k].data().dtype == np.int8
            np.testing.assert_array_equal(tp[k].data().asnumpy(),
                                          p.data().asnumpy(), err_msg=k)
    x = _x((2, 3, 32, 32), 6)
    _same_layers(jnet, tnet, x)
    jd, jlog = _block_dtypes(jnet, jmx.np.array(x))
    td, tlog = _block_dtypes(tnet, tmx.np.array(x))
    assert td == jd
    assert jd['output'] == 'bfloat16'
    want = jlog.astype('float32').asnumpy()
    got = tlog.astype('float32').asnumpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    # the whole net, and its hybridized (cached) call, as the eager walk
    whole = tnet(tmx.np.array(x)).astype('float32').asnumpy()
    np.testing.assert_array_equal(whole, got)
    tnet.hybridize(static_alloc=True)
    tnet(tmx.np.array(x))
    again = tnet(tmx.np.array(x)).astype('float32').asnumpy()
    np.testing.assert_array_equal(again, got)


def test_quantized_thumbnail_pure_function_runs_the_int8_layers():
    calib = _x((2, 3, 32, 32), 7)
    net = tvision.resnet18_v1(classes=10, thumbnail=True)
    net.initialize()
    net(tmx.np.array(calib))
    tq.quantize_net(net, calib_data=[calib], calib_mode='naive')
    net.hybridize(static_alloc=True)
    x = tmx.np.array(_x((2, 3, 32, 32), 8))
    want = net(x)
    fn, ins, mains, auxs = net.pure_function(x, train=False)
    names = [k for k, p in net.collect_params().items()
             if p.grad_req == 'null']
    assert len(auxs) == len(names)
    assert sum(a.dtype == torch.int8 for a in auxs) == 21
    outs, new_auxs = fn(None, ins, mains, auxs)
    assert torch.equal(outs[0], want._data)
    assert all(a is b for a, b in zip(new_auxs, auxs))


def test_resnet50_quantizes_every_conv_and_the_output_dense():
    calib = _x((1, 3, 32, 32), 9)
    net = tvision.resnet50_v1()
    net.initialize()
    net(tmx.np.array(calib))
    float_names = list(net.collect_params())
    tq.quantize_net(net, calib_data=[calib], calib_mode='naive')
    kinds = [type(c).__name__ for _, _, _, c in tq._gluon_walk(net)]
    assert kinds.count('QuantizedConv2D') == 53
    assert 'Conv2D' not in kinds and 'Dense' not in kinds
    assert isinstance(net.output, tq.QuantizedDense)
    # the JAX net's names: each conv's and the Dense's weight becomes
    # qweight, biases and BatchNorm parameters keep theirs
    jnet = jvision.resnet50_v1()
    jnet.initialize()
    assert list(jnet.collect_params()) == float_names
    conv_or_dense = {p.rsplit('.', 1)[0] for p in float_names
                     if p.endswith('.weight')
                     and not p.rsplit('.', 1)[0].endswith(('bn', 'gamma'))}
    want = [p.rsplit('.', 1)[0] + '.qweight'
            if p.endswith('.weight') and p.rsplit('.', 1)[0] in
            conv_or_dense else p for p in float_names]
    assert list(net.collect_params()) == want
    assert sum(p.endswith('.qweight') for p in want) == 54


def _gated_net(gluon, nn):
    class Gated(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.main = nn.Dense(4, in_units=4)
            self.aux = nn.Dense(4, in_units=4)      # never called

        def forward(self, x):
            return self.main(x)
    return Gated()


def test_unexercised_branch_stays_float_with_the_reference_warning(caplog):
    x = np.ones((2, 4), np.float32)
    nets = {}
    for name, mx, q, nn in (('jax', jmx, jq, jnn), ('port', tmx, tq, tnn)):
        net = _gated_net(mx.gluon, nn)
        net.initialize()
        net(mx.np.array(x))
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            q.quantize_net(net, calib_data=[mx.np.array(x)],
                           calib_mode='naive',
                           logger=logging.getLogger('q'))
        nets[name] = (net, [r.getMessage() for r in caplog.records])
    (jnet, jmsg), (tnet, tmsg) = nets['jax'], nets['port']
    assert isinstance(tnet.main, tq.QuantizedDense)
    assert isinstance(tnet.aux, tnn.Dense)
    assert tnet._children['main'] is tnet.main
    assert type(jnet.main).__name__ == type(tnet.main).__name__
    assert tmsg == jmsg == ['layer aux not exercised by calib_data; '
                            'kept in float']


def test_exclude_layers_and_the_root_swap_as_the_reference():
    x = np.ones((2, 4), np.float32)
    for mx, q, nn in ((jmx, jq, jnn), (tmx, tq, tnn)):
        net = nn.HybridSequential()
        net.add(nn.Dense(8, in_units=4), nn.Dense(2, in_units=8))
        net.initialize()
        out = q.quantize_net(net, calib_data=[mx.np.array(x)],
                             calib_mode='naive', exclude_layers=['0'])
        kids = list(out._children.values())
        assert out is net
        assert type(kids[0]).__name__ == 'Dense'
        assert isinstance(kids[1], q.QuantizedDense)
        dense = nn.Dense(3, in_units=4)
        dense.initialize()
        qd = q.quantize_net(dense, calib_data=[(mx.np.array(x), None)],
                            calib_mode='naive')
        assert isinstance(qd, q.QuantizedDense)
        assert str(qd(mx.np.array(x)).dtype) == 'bfloat16'
        kept = q.quantize_net(dense, calib_data=[mx.np.array(x)],
                              exclude_layers=['.'])
        assert kept is dense
    # a torch.nn net is refused: every net of the port is a Gluon block
    with pytest.raises(TypeError, match='Gluon'):
        tq.quantize_net(torch.nn.Linear(4, 3), calib_data=[torch.ones(2, 4)],
                        calib_mode='naive')


def test_hybridized_float_net_is_calibrated_eagerly_and_then_quantized():
    """A net hybridized (and its cache warm) before quantize_net is
    calibrated through its blocks' hooks, as the reference clears its
    cache first; re-hybridized, the int8 net's cached call equals its
    eager one."""
    x = _x((4, 8), 10)
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation='relu', in_units=8),
            tnn.Dense(4, in_units=16))
    net.initialize()
    net.hybridize()
    net(tmx.np.array(x))
    net(tmx.np.array(x))
    tq.quantize_net(net, calib_data=[x], calib_mode='naive')
    assert all(isinstance(b, tq.QuantizedDense) for b in net)
    eager = net(tmx.np.array(x)).astype('float32').asnumpy()
    net.hybridize()
    net(tmx.np.array(x))
    np.testing.assert_array_equal(
        net(tmx.np.array(x)).astype('float32').asnumpy(), eager)
    assert net.compile_count == 1
