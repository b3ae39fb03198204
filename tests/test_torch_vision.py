"""The port's vision zoo (``gluon/model_zoo/vision/``) against the JAX
package's, on the CPU.

The same numpy weights, carried across by name (``collect_params()`` keys
equal), give the same forward within 1e-5: ``resnet18_v1``/``v2`` as
thumbnails at (2, 3, 32, 32), ``mobilenet0.25`` and ``squeezenet1.1`` at
224 (as ``tests/test_models.py``), ``alexnet`` and ``vgg11_bn`` at the
smallest input each takes, and the blocks of the nets that cost too much
on the CPU whole (bottlenecks, MobileNetV2's, DenseNet's and
Inception-v3's). Two SGD-momentum steps of a ``resnet18_v1``
thumbnail through ``Trainer(net.collect_params(), 'sgd')`` give the JAX
Trainer's losses, weights and BatchNorm running statistics within 1e-5,
and the same update counts. ``resnet50_v1`` updates the number of
parameters that ``chip_smoke.py``'s resnet phase holds the optimizer
launches to. ``get_model`` builds every name, and ``pretrained=True``
raises naming ROADMAP A11.
"""

import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgl
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(name, shape, **kw):
    """The JAX and the port's ``name`` with the JAX net's weights, and
    those weights."""
    x = _x(shape)
    jnet = jvision.get_model(name, **kw)
    jnet.initialize()
    jnet(jmx.np.array(x))
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    tnet = tvision.get_model(name, **kw)
    tnet.initialize()
    tnet(tmx.np.array(x))
    assert list(tnet.collect_params()) == list(weights)
    assert {k: p.shape for k, p in tnet.collect_params().items()} == \
        {k: w.shape for k, w in weights.items()}
    tnet.load_dict(weights)
    return jnet, tnet, weights


def _same_forward(jnet, tnet, shape, seed=1):
    x = _x(shape, seed)
    want = jnet(jmx.np.array(x)).asnumpy()
    got = tnet(tmx.np.array(x)).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('name', ['resnet18_v1', 'resnet18_v2'])
def test_thumbnail_resnet_forward_matches_the_jax_net(name):
    jnet, tnet, _ = _pair(name, (2, 3, 32, 32), classes=10, thumbnail=True)
    _same_forward(jnet, tnet, (2, 3, 32, 32))


# the smallest input each model takes, and its classes
ZOO_INPUTS = [
    ('mobilenet0.25', (1, 3, 224, 224), 7),
    ('squeezenet1.1', (1, 3, 224, 224), 7),
    ('alexnet', (1, 3, 63, 63), 7),
    ('vgg11_bn', (1, 3, 32, 32), 7),
]


@pytest.mark.parametrize('name,shape,classes', ZOO_INPUTS,
                         ids=[z[0] for z in ZOO_INPUTS])
def test_zoo_model_forward_matches_the_jax_net(name, shape, classes):
    jnet, tnet, _ = _pair(name, shape, classes=classes)
    _same_forward(jnet, tnet, shape)


def _blocks(vision):
    """The zoo's building blocks where its full nets cost too much on the
    CPU: ResNet's bottlenecks in a thumbnail net of one block a stage,
    MobileNetV2's bottleneck (depthwise conv, relu6) with and without its
    shortcut, a DenseNet of two short dense blocks, and Inception-v3's
    five block kinds."""
    inc = vision.inception
    return {
        'bottleneck_v1': (lambda: vision.ResNetV1(
            vision.resnet.BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
            classes=10, thumbnail=True), (2, 3, 16, 16)),
        'bottleneck_v2': (lambda: vision.ResNetV2(
            vision.resnet.BottleneckV2, [1, 1, 1, 1], [16, 32, 64, 128, 256],
            classes=10, thumbnail=True), (2, 3, 16, 16)),
        'linear_bottleneck': (lambda: vision.mobilenet.LinearBottleneck(
            8, 8, 6, 1), (2, 8, 7, 7)),
        'linear_bottleneck_s2': (lambda: vision.mobilenet.LinearBottleneck(
            8, 16, 6, 2), (2, 8, 7, 7)),
        'densenet': (lambda: vision.DenseNet(8, 4, [2, 2], classes=10),
                     (2, 3, 32, 32)),
        'inception_a': (lambda: inc._make_A(8), (1, 16, 9, 9)),
        'inception_b': (inc._make_B, (1, 16, 9, 9)),
        'inception_c': (lambda: inc._make_C(8), (1, 16, 9, 9)),
        'inception_d': (inc._make_D, (1, 16, 9, 9)),
        'inception_e': (inc._InceptionE, (1, 16, 5, 5)),
    }


@pytest.mark.parametrize('block', list(_blocks(tvision)))
def test_zoo_block_matches_the_jax_block(block):
    jmake, shape = _blocks(jvision)[block]
    tmake, _ = _blocks(tvision)[block]
    x = _x(shape)
    jnet, tnet = jmake(), tmake()
    jnet.initialize()
    jnet(jmx.np.array(x))
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    tnet.initialize()
    tnet(tmx.np.array(x))
    assert list(tnet.collect_params()) == list(weights)
    tnet.load_dict(weights)
    _same_forward(jnet, tnet, shape)


def _train(mx, ag, gl, net, steps=2):
    x = mx.np.array(_x((4, 3, 32, 32), 5))
    # float labels, as bench_resnet_train feeds them
    y = mx.np.array(np.array([1, 7, 3, 9], np.float32))
    trainer = gl.Trainer(net.collect_params(), 'sgd',
                         {'learning_rate': 0.05, 'momentum': 0.9})
    loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with ag.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(4)
        losses.append(float(loss.asnumpy()))
    state = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    return losses, state, trainer.optimizer._index_update_count


def test_thumbnail_resnet18_trains_as_the_jax_trainer_trains_it():
    """Two steps from the JAX net's seeded initialization. The second
    step's weights are sensitive to fp32 rounding (BatchNorm over four
    images, ReLU masks): from other initializations the JAX package's own
    eager and hybridized forms part by more than 1e-5 after two steps, as
    the port and the JAX package then do, so this holds one instance."""
    jnet, tnet, start = _pair('resnet18_v1', (4, 3, 32, 32), classes=10,
                              thumbnail=True)
    tnet.hybridize()
    jl, js, jcounts = _train(jmx, jag, jgl, jnet)
    tl, ts, tcounts = _train(tmx, tmx.autograd, tgl, tnet)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], err_msg=k, **TOL)
    # every trained parameter and every running statistic moved
    moved = {k for k in js if not np.array_equal(js[k], start[k])}
    assert moved == set(js), sorted(set(js) - moved)
    assert tcounts == jcounts and set(tcounts.values()) == {2}
    params = tnet.collect_params()
    assert len(tcounts) == sum(p.grad_req != 'null' for p in params.values())


def test_resnet50_updates_the_parameters_the_chip_phase_counts():
    """The JAX Trainer updates every parameter whose grad_req is not
    'null' (mxnet_tpu/gluon/trainer.py:241-243): resnet50_v1's conv
    weights, its bottlenecks' conv biases, BatchNorm's gamma and beta and
    the Dense layer, not the running statistics."""
    counts = []
    for vision in (jvision, tvision):
        params = vision.resnet50_v1().collect_params()
        assert len(params) == 299
        counts.append(sum(p.grad_req != 'null' for p in params.values()))
    assert counts == [cs.RESNET_UPDATED, cs.RESNET_UPDATED]


def test_get_model_builds_every_name():
    names = sorted(jvision._models)
    assert sorted(tvision._models) == names
    for name in names:
        net = tvision.get_model(name, classes=5)
        want = jvision.get_model(name, classes=5)
        assert type(net).__name__ == type(want).__name__
        assert list(net.collect_params()) == list(want.collect_params()), \
            name
    with pytest.raises(ValueError, match='not supported'):
        tvision.get_model('not_a_model')


@pytest.mark.parametrize('name', ['resnet50_v1', 'mobilenet0.25',
                                  'vgg11', 'densenet121'])
def test_pretrained_weights_wait_for_the_model_store(name):
    with pytest.raises(NotImplementedError, match='A11'):
        tvision.get_model(name, pretrained=True)
    with pytest.raises(NotImplementedError, match='A11'):
        tgl.model_zoo.get_model(name, pretrained='weights.params')
