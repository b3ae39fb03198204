"""The port's convolution and pooling layers (``gluon/nn/conv_layers.py``)
against the JAX package's, on the CPU.

Every class with the same constructor arguments and the same numpy
weights, carried across by name: forward, and the gradients of the input
and of every parameter under ``autograd.record()``, within 1e-5 (the same
fp32 sums in another order, by two libraries). The cases cover groups,
dilation, a channel-last layout, the ``'full'`` pooling convention
(``ceil_mode``), ``count_include_pad`` and ``output_padding``. Inputs are
standard normal, so no max-pool window holds a tie and the routing of a
max's gradient is the same in both. The fp32 convolution that the port
runs on a card (``ops/nn.py``'s ``_Fp32Conv``, forward and backward under
TF32 off) is held to autograd through ``aten.convolution`` here.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops.nn import _Fp32Conv

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (class name, constructor kwargs, input shape)
CASES = [
    ('Conv1D', dict(channels=4, kernel_size=3, strides=2, padding=1),
     (2, 3, 9)),
    ('Conv1D', dict(channels=6, kernel_size=3, dilation=2, groups=3,
                    in_channels=3), (2, 3, 11)),
    ('Conv2D', dict(channels=6, kernel_size=3, padding=1), (2, 4, 7, 7)),
    ('Conv2D', dict(channels=6, kernel_size=(3, 2), strides=(2, 1),
                    padding=(1, 0), dilation=(2, 1), groups=2), (2, 4, 9, 8)),
    ('Conv2D', dict(channels=5, kernel_size=3, padding=1, layout='NHWC',
                    use_bias=False), (2, 6, 7, 3)),
    ('Conv2D', dict(channels=4, kernel_size=1, strides=2,
                    activation='relu'), (2, 3, 8, 8)),
    ('Conv2D', dict(channels=8, kernel_size=3, padding=1, groups=8,
                    use_bias=False), (2, 8, 6, 6)),
    ('Conv3D', dict(channels=4, kernel_size=(2, 3, 3), strides=(1, 2, 2),
                    padding=(0, 1, 1)), (2, 3, 4, 7, 7)),
    ('Conv1DTranspose', dict(channels=4, kernel_size=3, strides=2,
                             output_padding=1), (2, 3, 6)),
    ('Conv2DTranspose', dict(channels=6, kernel_size=3, strides=2,
                             padding=1, output_padding=1, groups=2,
                             in_channels=4), (2, 4, 5, 5)),
    ('Conv2DTranspose', dict(channels=3, kernel_size=(2, 3), strides=(2, 1),
                             dilation=(1, 2)), (2, 4, 4, 4)),
    ('Conv3DTranspose', dict(channels=2, kernel_size=2, strides=2),
     (1, 3, 3, 3, 3)),
    ('MaxPool1D', dict(pool_size=3, strides=2, padding=1), (2, 3, 10)),
    ('MaxPool2D', dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 9)),
    ('MaxPool2D', dict(pool_size=3, strides=2, ceil_mode=True), (2, 3, 8, 8)),
    ('MaxPool2D', dict(pool_size=2, layout='NHWC'), (2, 6, 6, 3)),
    ('MaxPool3D', dict(pool_size=2, strides=(1, 2, 2)), (1, 2, 4, 6, 6)),
    ('AvgPool1D', dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 10)),
    ('AvgPool2D', dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 9)),
    ('AvgPool2D', dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 9, 9)),
    ('AvgPool2D', dict(pool_size=3, strides=2, ceil_mode=True), (2, 3, 8, 8)),
    ('AvgPool2D', dict(pool_size=2, layout='NHWC'), (2, 6, 6, 3)),
    ('AvgPool3D', dict(pool_size=(2, 2, 2), padding=1,
                       count_include_pad=False), (1, 2, 4, 5, 5)),
    ('GlobalMaxPool1D', {}, (2, 3, 7)),
    ('GlobalMaxPool2D', {}, (2, 3, 5, 6)),
    ('GlobalMaxPool3D', {}, (1, 2, 3, 4, 5)),
    ('GlobalAvgPool1D', {}, (2, 3, 7)),
    ('GlobalAvgPool2D', {}, (2, 3, 5, 6)),
    ('GlobalAvgPool3D', {}, (1, 2, 3, 4, 5)),
    ('ReflectionPad2D', dict(padding=2), (2, 3, 5, 6)),
    ('ReflectionPad2D', dict(padding=(1, 2, 0, 3)), (1, 2, 5, 6)),
]


def _run(mx, ag, layer, x, cot):
    """Forward, and the gradients of ``sum(out * cot)`` with respect to
    the input and every parameter, as numpy."""
    xs = mx.np.array(x)
    xs.attach_grad()
    with ag.record():
        out = layer(xs)
        loss = (out * mx.np.array(cot)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy()
             for k, p in layer.collect_params().items()}
    return out.asnumpy(), xs.grad.asnumpy(), grads


@pytest.mark.parametrize('name,kw,shape', CASES,
                         ids=[f'{c[0]}-{i}' for i, c in enumerate(CASES)])
def test_layer_matches_the_jax_layer(name, kw, shape):
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    x = _x(shape, 0)
    jl.initialize()
    jl(jmx.np.array(x))
    tl.initialize()
    tl(tmx.np.array(x))
    rng = np.random.default_rng(1)
    weights = {k: (0.5 * rng.standard_normal(p.shape)).astype(np.float32)
               for k, p in jl.collect_params().items()}
    for k, w in weights.items():
        jl.collect_params()[k].set_data(w)
    tl.load_dict(weights)
    assert list(tl.collect_params()) == list(jl.collect_params())
    jout = jl(jmx.np.array(x)).asnumpy()
    cot = _x(jout.shape, 2)
    want = _run(jmx, jag, jl, x, cot)
    got = _run(tmx, tmx.autograd, tl, x, cot)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], err_msg='forward', **TOL)
    np.testing.assert_allclose(got[1], want[1], err_msg='input grad', **TOL)
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], err_msg=k, **TOL)


def test_deferred_in_channels_resolve_at_the_first_forward():
    conv = tnn.Conv2D(8, 3, groups=2)
    deconv = tnn.Conv2DTranspose(6, 3, groups=3)
    assert conv.weight.shape == (8, 0, 3, 3)
    assert deconv.weight.shape == (0, 2, 3, 3)
    for layer in (conv, deconv):
        layer.initialize()
        layer(tmx.np.array(_x((1, 6, 5, 5), 3)))
    assert conv.weight.shape == (8, 3, 3, 3)
    assert deconv.weight.shape == (6, 2, 3, 3)


@pytest.mark.parametrize('transposed,groups', [(False, 1), (False, 2),
                                               (True, 1), (True, 2)],
                         ids=['conv', 'grouped', 'transposed',
                              'transposed-grouped'])
def test_fp32_conv_function_gradients_equal_autograd(transposed, groups):
    """The autograd.Function the card runs (TF32 off in its backward too)
    gives aten.convolution's forward and autograd's gradients."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 7, 7, generator=g, requires_grad=True)
    w = torch.randn((4, 6 // groups, 3, 3) if transposed
                    else (6, 4 // groups, 3, 3), generator=g,
                    requires_grad=True)
    b = torch.randn(6, generator=g, requires_grad=True)
    args = ([2, 1], [1, 0], [1, 2], transposed,
            [1, 0] if transposed else [0, 0], groups)
    want = torch.ops.aten.convolution(x, w, b, *args)
    cot = torch.randn(want.shape, generator=g)
    want_grads = torch.autograd.grad((want * cot).sum(), (x, w, b))
    got = _Fp32Conv.apply(x, w, b, args)
    got_grads = torch.autograd.grad((got * cot).sum(), (x, w, b))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, c in zip(got_grads, want_grads):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)
