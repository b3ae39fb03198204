"""How far two correct bf16 runs of a small ResNet part after two steps.

Not a test: a measurement that runs on the CPU and prints one line a seed.
``chip_smoke.py``'s bf16 phase trains a ``resnet18_v1`` thumbnail (four
32 x 32 images, SGD-momentum at lr 0.05, momentum 0.9, the weights from
``mx.random.seed(seed)``), cast to bf16, on the card and on the CPU. Here
the same net, from the same weights, trains in the JAX package and in the
port, both on the CPU, in bf16 and in fp32: the losses of three steps and
the change of all the weights together from the start after each of the
first two (|port change - JAX change| over |JAX change|, one vector of
every tensor).
The JAX package is the reference and the port's CPU path is held to it in
``tests/test_torch_bf16.py``; what parts these two runs is where each
framework rounds its bf16 intermediates, which the steps then amplify.

    JAX_PLATFORMS=cpu python tests/torch_bf16_witness.py 15 16 17

takes about 15 s a seed.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import _cpu_guard  # noqa: E402

_cpu_guard.force_cpu()

import numpy as np  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import autograd as jag, gluon as jgl  # noqa: E402
from mxnet_tpu.gluon.model_zoo import vision as jvision  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import gluon as tgl  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402

STEPS = 3


def _host(net):
    return {k: p.data().asnumpy().astype(np.float64)
            for k, p in net.collect_params().items()}


def _steps(mx, ag, gl, net, x, y, dtype):
    """Losses and the weights after each of STEPS SGD-momentum steps, the
    logits cast to fp32 for the loss as bench's bf16 loop does."""
    trainer = gl.Trainer(net.collect_params(), 'sgd',
                         {'learning_rate': 0.05, 'momentum': 0.9})
    xs = mx.np.array(x).astype(dtype)
    losses, states = [], []
    for _ in range(STEPS):
        with ag.record():
            out = net(xs)
            if out.dtype != 'float32':
                out = out.astype('float32')
            loss = gl.loss.SoftmaxCrossEntropyLoss()(
                out, mx.np.array(y)).mean()
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.asnumpy()))
        states.append(_host(net))
    return losses, states


def _gap(got, want, start):
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in start)
    den = sum(float(((want[k] - w0) ** 2).sum()) for k, w0 in start.items())
    return (num / den) ** 0.5


def witness(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = np.array([1, 7, 3, 9], np.float32)
    with tmx.cpu():
        tmx.random.seed(seed)
        tnet = tvision.resnet18_v1(classes=10, thumbnail=True)
        tnet.initialize()
        tnet(tmx.np.array(x))
        weights = {k: p.data().asnumpy()
                   for k, p in tnet.collect_params().items()}
        jnet = jvision.resnet18_v1(classes=10, thumbnail=True)
        jnet.initialize()
        jnet(jmx.np.array(x))
        for k, p in jnet.collect_params().items():
            p.set_data(jmx.np.array(weights[k]))
        if dtype != 'float32':
            tnet.cast(dtype)
            jnet.cast(dtype)
        start = _host(tnet)
        tnet.hybridize()
        jnet.hybridize()
        jl, js = _steps(jmx, jag, jgl, jnet, x, y, dtype)
        tl, ts = _steps(tmx, tmx.autograd, tgl, tnet, x, y, dtype)
    rel = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
    gaps = [_gap(ts[0], js[0], start), _gap(ts[1], js[1], start)]
    print(f'seed {seed} {dtype}: losses JAX {jl}, port {tl}; |port - JAX| '
          f'over JAX by step {[f"{r:.4f}" for r in rel]}; weights\' change '
          f'gap after step 1 {gaps[0]:.4f}, after step 2 {gaps[1]:.4f}',
          flush=True)


if __name__ == '__main__':
    for s in sys.argv[1:] or ['15']:
        for dt in ('bfloat16', 'float32'):
            witness(int(s), dt)
