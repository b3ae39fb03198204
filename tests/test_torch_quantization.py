"""The PyTorch port's int8 post-training quantization against the JAX
package's.

Inputs are made with numpy from a seed and given to both packages. On the
CPU the port's int8 product runs its kernel's plain version (the CUDA
kernel meets that version on the card, in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).

Tolerances, with their reasons:

* the int8 product, the quantize ops and the calibration thresholds are
  held bit-equal: the sum is exact in both packages, and every step after
  it (one rounding to fp32, ``* scale``, ``+ bias``, the cast; a division
  and a round half to even) is one correctly rounded operation in both;
* the quantized weights and their scales are bit-equal, since they come
  from the same float weights; the calibrated input ranges are within
  1e-6 of each other, relative to the range: each is the min and max of a
  norm's output, which the two packages sum in another order (1 ulp);
* a ``llama_tiny`` loaded with the JAX quantized state gives logits
  within 1e-4 of the JAX net's under fp32 activations and within 2**-5,
  two bf16 ulps at its largest logit (about 3.3), under bf16 ones: a norm
  output 1 ulp off can move an int8 code that sits on a .5 boundary. The
  greedy tokens of both ``DecodeServer``s and of ``generate()`` must be
  equal.

The JAX package's ``generate()`` runs its steps as jitted programs, in
which XLA rounds bf16 intermediates in other places than its eager ops,
which the port follows; so under bf16 activations the port's
``generate()`` is held to a greedy loop over the JAX net's eager dense
cache, and under fp32 activations to the JAX ``generate()`` itself.
"""

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import quantization as jax_q
from mxnet_tpu.gluon.model_zoo import llama as jax_llama
from mxnet_tpu.ops import contrib as jax_contrib
from mxnet_tpu.ops import nn as jax_nn
from mxnet_tpu.ops import quantization_ops as jax_ops
from mxnet_tpu.ops.pallas import int8_matmul as jax_int8
from mxnet_tpu.serve import DecodeServer as JaxDecodeServer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import quantization as tq
from mxnet_tpu_torch.gluon import HybridBlock, nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import llama as torch_llama
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.ops import contrib, kernels, nn as torch_nn, \
    quantization_ops as ops
from mxnet_tpu_torch.ops.kernels import int8_matmul
from mxnet_tpu_torch.serve import DecodeServer

SERVER = dict(slots=2, max_length=32, page_size=4, prefill_chunk=8,
              start=False)
BF16_LOGIT_TOL = 2.0 ** -5


def _np(a):
    if isinstance(a, NDArray):
        a = a._data
    if torch.is_tensor(a):
        return onp.asarray(a.detach().float().numpy())
    return onp.asarray(a)


def _equal(got, want):
    got, want = _np(got), onp.asarray(want).astype(_np(got).dtype)
    assert got.shape == want.shape
    onp.testing.assert_array_equal(got, want)


def _int8_case(seed, m_shape, n, k):
    rng = onp.random.RandomState(seed)
    x = rng.randint(-127, 128, m_shape + (k,)).astype(onp.int8)
    w = rng.randint(-127, 128, (n, k)).astype(onp.int8)
    s = rng.uniform(1e-3, 2e-2, (n,)).astype(onp.float32)
    b = rng.randn(n).astype(onp.float32)
    return x, w, s, b


# ----------------------------------------------------------- int8 product
@pytest.mark.parametrize('m_shape,n,k,bias,out,block_k', [
    ((64,), 128, 256, True, 'float32', 512),
    ((64,), 128, 256, False, 'bfloat16', 512),
    ((32,), 128, 512, False, 'float32', 128),     # K over four grid steps
    ((4, 16), 128, 256, False, 'float32', 512),   # leading dims
    ((32,), 256, 128, True, 'bfloat16', 128),
], ids=['bias-f32', 'bf16', 'blocked-k', '3d', 'bias-bf16'])
def test_int8_plain_matches_pallas_interpret(m_shape, n, k, bias, out,
                                             block_k):
    x, w, s, b = _int8_case(0, m_shape, n, k)
    b = b if bias else None
    want = jax_int8.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        None if b is None else jnp.asarray(b), jnp.dtype(out),
        interpret=True, block_k=block_k)
    got = int8_matmul.int8_matmul(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
        None if b is None else torch.from_numpy(b), out)
    assert got.dtype == getattr(torch, out)
    if b is None or out == 'bfloat16':
        _equal(got, want.astype(jnp.float32))
    else:
        # interpret mode contracts ``* scale + bias`` into one FMA; the
        # reference's op and the port round the product first: within 1
        # ulp of the largest product
        prod = onp.abs(x.astype(onp.int64) @ w.T.astype(onp.int64) * s)
        onp.testing.assert_allclose(_np(got), onp.asarray(want), rtol=0,
                                    atol=onp.spacing(onp.float32(prod.max())))


@pytest.mark.parametrize('m_shape,n,k', [
    ((37,), 1000, 200), ((1,), 7, 3), ((2, 5), 130, 33), ((4,), 1, 4100)])
@pytest.mark.parametrize('out', ['float32', 'bfloat16'])
def test_int8_plain_matches_the_reference_on_ragged_shapes(m_shape, n, k,
                                                           out):
    """Shapes the Pallas gate refuses go to the reference's
    ``lax.dot_general`` region; the port's op takes them all."""
    x, w, s, b = _int8_case(1, m_shape, n, k)
    for bias in (None, b):
        want = jax_ops.quantized_dense(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
            None if bias is None else jnp.asarray(bias), out_dtype=out)
        got = ops.quantized_dense(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
            None if bias is None else torch.from_numpy(bias), out_dtype=out)
        _equal(got, want.astype(jnp.float32))


def test_int8_plain_sums_exactly():
    """The widest sums: -128 * -128 over K = 4096, which wraps in an int8
    product and is exact here."""
    x = torch.full((3, 4096), -128, dtype=torch.int8)
    w = torch.full((5, 4096), -128, dtype=torch.int8)
    out = int8_matmul.int8_matmul(x, w, torch.ones(5))
    assert bool((out == 128 * 128 * 4096).all())


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_silu_matches_the_reference(dtype):
    """The SiLU between a quantized net's layers: in bf16 the reference
    rounds each of its steps, and the port takes the same steps, so the
    values are bit-equal; in fp32 one fused op agrees to 1e-6."""
    x = (onp.random.default_rng(9).standard_normal(4096) * 4) \
        .astype(onp.float32)
    want = jax_nn.silu(jnp.asarray(x).astype(dtype)).astype(jnp.float32)
    got = torch_nn.silu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == 'bfloat16':
        _equal(got, want)
    else:
        onp.testing.assert_allclose(_np(got), onp.asarray(want), rtol=1e-6,
                                    atol=1e-6)


# ------------------------------------------------------- quantize ops
def _data(seed=2):
    rng = onp.random.default_rng(seed)
    x = (rng.standard_normal(600) * 3).astype(onp.float32)
    # codes on the .5 boundaries of the scale 3 / 127 (round half to even)
    step = onp.float32(3.0) / onp.float32(127.0)
    ties = (onp.arange(-20, 20) + 0.5).astype(onp.float32) * step
    return onp.concatenate([x, ties, [3.0, -3.0, 0.0]]).astype(onp.float32)


@pytest.mark.parametrize('calib', [None, (-3.0, 3.0), (-1.5, 0.75)])
def test_quantize_v2_int8_matches(calib):
    x = _data()
    lo, hi = calib or (None, None)
    want = jax_ops.quantize_v2(jnp.asarray(x), lo, hi)
    got = ops.quantize_v2(torch.from_numpy(x), lo, hi)
    assert got[0].dtype == torch.int8
    for g, w in zip(got, want):
        _equal(g, w)
    _equal(ops.dequantize(got[0], got[1], got[2]),
           jax_ops.dequantize(want[0], want[1], want[2]))


def test_quantize_v2_uint8_and_dequantize_match():
    x = onp.abs(_data(3))
    want = jax_ops.quantize_v2(jnp.asarray(x), 0.0, 4.0, 'uint8')
    got = ops.quantize_v2(torch.from_numpy(x), 0.0, 4.0, 'uint8')
    assert got[0].dtype == torch.uint8
    _equal(got[0], want[0])
    _equal(ops.dequantize(got[0], 0.0, 4.0),
           jax_ops.dequantize(want[0], 0.0, 4.0))
    with pytest.raises(ValueError, match='out_type'):
        ops.quantize_v2(torch.from_numpy(x), out_type='int4')


@pytest.mark.parametrize('calib', [None, (-2.0, 2.5)])
def test_requantize_matches(calib):
    acc = onp.random.default_rng(4).integers(-40000, 40000, 300) \
        .astype(onp.int32)
    lo, hi = calib or (None, None)
    want = jax_ops.requantize(jnp.asarray(acc), jnp.float32(-40000.0),
                              jnp.float32(40000.0), lo, hi)
    got = ops.requantize(torch.from_numpy(acc), torch.tensor(-40000.0),
                         torch.tensor(40000.0), lo, hi)
    for g, w in zip(got, want):
        _equal(g, w)


def test_range_to_scale_matches():
    for lo, hi, dtype in ((-2.0, 1.0, 'int8'), (0.0, 0.0, 'int8'),
                          (0.0, 5.0, 'uint8'), (-1e-3, 7e-4, 'int8')):
        _equal(ops.range_to_scale(lo, hi, dtype),
               jax_ops.range_to_scale(jnp.float32(lo), jnp.float32(hi),
                                      dtype))


# ---------------------------------------------------------- calibration
def _batches():
    rng = onp.random.default_rng(5)
    # the second batch widens the range, so the histogram is re-binned
    return [rng.standard_normal((8, 64)).astype(onp.float32),
            (rng.standard_normal((8, 64)) * 2.5 + 0.3).astype(onp.float32),
            rng.laplace(size=(4, 64)).astype(onp.float32)]


@pytest.mark.parametrize('mode', ['naive', 'percentile', 'entropy'])
def test_calibration_thresholds_match(mode):
    jc, tc = jax_q._HistogramCollector(), tq._HistogramCollector()
    for b in _batches():
        jc.collect(b)
        tc.collect(torch.from_numpy(b).numpy())
    onp.testing.assert_array_equal(tc.hist, jc.hist)
    onp.testing.assert_array_equal(tc.edges, jc.edges)
    want = jax_q.calib_table({'a': jc, 'idle': jax_q._HistogramCollector()},
                             mode)
    got = tq.calib_table({'a': tc, 'idle': tq._HistogramCollector()}, mode)
    assert got == want and list(got) == ['a']
    with pytest.raises(ValueError, match='calib_mode'):
        tq.calib_table({'a': tc}, 'kl')


def test_calibrate_entropy_matches():
    c = jax_q._HistogramCollector(num_bins=512)
    for b in _batches():
        c.collect(b)
    want = jax_contrib.calibrate_entropy(jnp.asarray(c.hist),
                                         jnp.asarray(c.edges), 63)
    got = contrib.calibrate_entropy(c.hist, c.edges, 63)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _equal(g, w)


# ------------------------------------------------------- quantize_net
def _weights(net, seed=0):
    rng = onp.random.default_rng(seed)
    out = {}
    for name, p in net.collect_params().items():
        w = rng.standard_normal(p.shape).astype(onp.float32) * 0.1
        out[name] = w + 1.0 if name.endswith('norm.weight') else w
    return out


def _jax_state(jnet):
    """The JAX quantized net's per-layer state as numpy arrays."""
    return {path: dict(qweight=child.qweight.data().asnumpy(),
                       w_scale=onp.asarray(child._w_scale),
                       collected_range=onp.asarray(child.collected_range),
                       bias=None)
            for _, _, path, child in jax_q._walk(jnet)
            if isinstance(child, jax_q.QuantizedDense)}


@pytest.fixture(scope='module')
def calibrated():
    """A JAX ``llama_tiny`` and the port's, with the same weights, both
    quantized by ``quantize_net`` (naive) on the same calibration tokens;
    the JAX net's state, and its float weights."""
    jnet = jax_llama.llama_tiny()
    jnet.initialize()
    jnet(mx.np.zeros((1, 2)))
    params = _weights(jnet)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    calib = onp.random.default_rng(5).integers(0, 256, (2, 24))
    jax_q.quantize_net(jnet, calib_data=[mx.np.array(calib.astype(
        onp.int32))], calib_mode='naive')
    tnet = _port_net(params)
    tq.quantize_net(tnet, calib_data=[NDArray(torch.from_numpy(calib))],
                    calib_mode='naive')
    return jnet, tnet, _jax_state(jnet), params


def _port_net(params):
    return torch_llama.from_jax_params(torch_llama.llama_tiny(), params,
                                       ctx=tmx.cpu())


def test_quantize_net_matches_the_reference(calibrated):
    """The port's Llama quantizes through the Gluon walk: a
    ``QuantizedDense`` at every path where the JAX net has one."""
    _, tnet, state, _ = calibrated
    layers = {path: m for _, _, path, m in tq._gluon_walk(tnet)
              if isinstance(m, tq.QuantizedDense)}
    assert set(layers) == set(state) and len(state) == 15
    for path, st in state.items():
        m = layers[path]
        qw = m.qweight.data()._data
        assert qw.dtype == torch.int8
        _equal(qw, st['qweight'])
        _equal(m._w_scale, st['w_scale'])
        want = onp.asarray(st['collected_range'], onp.float64)
        onp.testing.assert_allclose(m.collected_range, want, rtol=0,
                                    atol=1e-6 * onp.abs(want).max())
        assert not m._has_bias and m._act_dtype == torch.bfloat16
    # the float parameters left are the embedding and the norms
    assert sorted({n.split('.')[-2] for n, p in
                   tnet.collect_params().items() if p.dtype != 'int8'}) \
        == ['embed_tokens', 'input_layernorm', 'norm',
            'post_attention_layernorm']


def _loaded(calibrated, act):
    """A fresh port net carrying the JAX quantized state."""
    _, _, state, params = calibrated
    tnet = _port_net(params)
    floats = {n: a for n, a in params.items()
              if 'proj' not in n and 'lm_head' not in n}
    return tq.load_jax_quantized(tnet, state, floats, activation_dtype=act)


def _jax_net(calibrated, act):
    """The JAX quantized net with its layers set to ``act``."""
    jnet = calibrated[0]
    for _, _, _, child in jax_q._walk(jnet):
        if isinstance(child, jax_q.QuantizedDense):
            child._act_dtype = jnp.dtype(act)
    return jnet


@pytest.mark.parametrize('act', ['bfloat16', 'float32'])
def test_quantized_forward_matches(calibrated, act):
    jnet = _jax_net(calibrated, act)
    tnet = _loaded(calibrated, act)
    toks = onp.random.default_rng(1).integers(0, 256, (2, 19))
    want = onp.asarray(jnet(mx.np.array(toks.astype(onp.int32))).asnumpy())
    kernels.reset_launch_counts()
    got = tnet(torch.from_numpy(toks))._data
    assert got.dtype == getattr(torch, act) and str(want.dtype) == act
    tol = BF16_LOGIT_TOL if act == 'bfloat16' else 1e-4
    onp.testing.assert_allclose(_np(got), want.astype(onp.float32), rtol=0,
                                atol=tol)
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain


def _serve(server, requests):
    futs = [server.submit(p, n) for p, n in requests]
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        server.step_once()
    out = [f.result(timeout=0) for f in futs]
    server.close()
    return out


@pytest.mark.parametrize('act', ['bfloat16', 'float32'])
def test_quantized_decode_server_matches(calibrated, act):
    """``DecodeServer`` serves the int8 net unchanged: the same greedy
    tokens as the JAX server over chunked prefill, a prefix hit and
    per-slot decode."""
    rng = onp.random.default_rng(1)
    shared = rng.integers(1, 256, 8).tolist()
    requests = [(shared + rng.integers(1, 256, 5).tolist(), 6),
                (rng.integers(1, 256, 3).tolist(), 4),
                (shared + rng.integers(1, 256, 2).tolist(), 5)]
    want = _serve(JaxDecodeServer(_jax_net(calibrated, act), **SERVER),
                  requests)
    got = _serve(DecodeServer(_loaded(calibrated, act), **SERVER), requests)
    assert [len(t) for t in got] == [6, 4, 5]
    assert got == want


def _jax_eager_greedy(jnet, prompt, n_new, length):
    """Greedy tokens from the JAX net's eager dense-cache forward: the
    port's ``generate()`` loop, one JAX op at a time."""
    caches = jnet.init_caches(prompt.shape[0], length)
    toks = mx.np.array(prompt.astype(onp.int32))
    out = [prompt]
    for i in range(n_new):
        # a 0-dim array offset, so that the eager ops compile once
        off = jnp.asarray(0 if i == 0 else prompt.shape[1] + i - 1,
                          jnp.int32)
        logits, caches = jnet(toks, caches=caches, offset=off)
        nxt = logits.asnumpy()[:, -1].astype(onp.float32).argmax(-1)
        out.append(nxt[:, None])
        toks = mx.np.array(nxt[:, None].astype(onp.int32))
    return onp.concatenate(out, axis=1)


@pytest.mark.parametrize('act', ['bfloat16', 'float32'])
def test_quantized_generate_matches(calibrated, act):
    jnet = _jax_net(calibrated, act)
    tnet = _loaded(calibrated, act)
    prompt = onp.random.default_rng(3).integers(0, 256, (2, 7))
    got = tnet.generate(prompt, max_new_tokens=6).numpy()
    if act == 'float32':
        want = jnet.generate(mx.np.array(prompt.astype(onp.int32)),
                             max_new_tokens=6).asnumpy()
    else:
        want = _jax_eager_greedy(jnet, prompt, 6, 7 + 8 + 1)
    assert got.tolist() == want.tolist()


# ------------------------------------------------------- the net rewrite
class _Mlp(HybridBlock):
    """Two Dense layers registered as a list's children, and one the
    forward never reaches."""

    def __init__(self):
        super().__init__()
        self.blocks = [tnn.Dense(32, in_units=16), tnn.Dense(8, in_units=32)]
        for i, b in enumerate(self.blocks):
            self.register_child(b, f'blocks{i}')
        self.idle = tnn.Dense(8, in_units=8)

    def forward(self, x):
        from mxnet_tpu_torch import npx
        return self._children['blocks1'](npx.relu(
            self._children['blocks0'](x)))


def test_quantize_net_swaps_in_module_lists_and_keeps_idle_layers_float():
    net = _Mlp()
    net.initialize(ctx=tmx.cpu())
    x = NDArray(torch.randn(4, 16, generator=torch.Generator().manual_seed(0)))
    want = net(x)._data
    out = tq.quantize_net(net, calib_data=[(x, None)], calib_mode='entropy',
                          exclude_layers=['blocks1'], num_calib_batches=1,
                          activation_dtype='float32')
    assert out is net
    assert isinstance(net._children['blocks0'], tq.QuantizedDense)
    assert net._children['blocks0']._has_bias
    assert isinstance(net._children['blocks1'], tnn.Dense)     # excluded
    assert isinstance(net.idle, tnn.Dense)                     # never reached
    got = net(x)._data
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0.05)


def test_quantize_net_swaps_a_root_layer_and_refuses_convolutions():
    """A root ``Dense`` comes back as its twin; a ``torch.nn`` net is
    refused (the port's nets are Gluon blocks), and a ``Conv2D`` excluded
    by path stays float."""
    lin = tnn.Dense(4, in_units=8)
    lin.initialize(ctx=tmx.cpu())
    x = NDArray(torch.randn(3, 8))
    q = tq.quantize_net(lin, calib_data=[x], calib_mode='naive')
    assert isinstance(q, tq.QuantizedDense)
    assert q(x)._data.dtype == torch.bfloat16
    with pytest.raises(TypeError, match='Gluon'):
        tq.quantize_net(torch.nn.Linear(8, 4), calib_data=[torch.ones(1, 8)])
    conv = tnn.HybridSequential()
    conv.add(tnn.Conv2D(2, 3, in_channels=1), tnn.Flatten())
    conv.initialize(ctx=tmx.cpu())
    img = NDArray(torch.randn(1, 1, 5, 5))
    kept = tq.quantize_net(conv, calib_data=[img], exclude_layers=['0'])
    assert isinstance(kept[0], tnn.Conv2D)
    with pytest.raises(ValueError, match='calib_data'):
        tq.quantize_net(lin)
    with pytest.raises(ValueError, match='int8'):
        tq.quantize_net(lin, calib_data=[x], quantized_dtype='uint8')
