"""The port's bf16 paths against the JAX package's, on the CPU.

The JAX package runs bf16 by default (``bench.py --dtype bf16``): its
Pallas kernels load bf16, compute in fp32 and store the reference's
output dtype. Here the port's plain versions (what the card's kernels are
held to) meet those kernels in interpret mode on bf16 inputs made with
numpy from a seed: B1 in every (x, weights) dtype pair, RMS and LayerNorm,
with its gradient, and B2, B3 and B4. A bf16 output is held within one
bf16 ulp of the JAX value plus the fp32 tolerance (1e-5): each side rounds
its fp32 result once (half an ulp apiece), and near zero, where
cancellation leaves the fp32 difference above the value's ulp, the fp32
tolerance decides. fp32 outputs keep the fp32 tolerance.

Then whole nets cast to bf16 as bench does (build, initialize, one
forward, ``cast('bfloat16')``): a tiny BERT (forward; two Adam steps
through each package's Trainer), a resnet18 thumbnail (forward; one
SGD-momentum step) and ``llama_tiny`` (forward logits and greedy
``generate()`` tokens). JAX rounds bf16 intermediates in other places than
eager PyTorch (its ops fuse, and a bf16 op's result is rounded where
PyTorch's is), so these are held in relative terms, and the reason is
given at each test. Last, the optimizer's dtype rule: a bf16 weight takes
the plain update in both packages, with the same weights and fp32 slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl
from mxnet_tpu.gluon.model_zoo import bert as jbert, llama as jllama, \
    vision as jvision
from mxnet_tpu.ops.optimizer_ops import fused_adam_step, \
    fused_sgd_mom_step
from mxnet_tpu.ops.pallas.flash_attention import flash_attention as \
    jax_flash, flash_attention_stats as jax_stats
from mxnet_tpu.ops.pallas.fused_norms import _fused_norm, _ln_pallas, \
    _out_dtype
from mxnet_tpu.ops.pallas.paged_attention import \
    paged_attention_decode_pallas

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgl
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert, \
    llama as tllama, vision as tvision
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import flash_attention as fa, \
    fused_norms, fused_optimizer as fo, paged_attention as pa

BF16 = {'bf16': (torch.bfloat16, jnp.bfloat16),
        'fp32': (torch.float32, jnp.float32)}


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dt):
    """numpy ``a`` as a torch and a JAX array of dtype ``dt`` (one
    rounding, to nearest even, on each side)."""
    t, j = BF16[dt]
    return torch.from_numpy(a).to(t), jnp.asarray(a).astype(j)


def _ulp(a):
    """The spacing of bf16 values at ``|a|``."""
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _close(got, want, rtol=1e-5, atol=1e-5):
    """``got`` (torch) against ``want`` (JAX): the same dtype, and within
    ``atol + rtol * |want|``, plus one bf16 ulp of ``want`` when bf16."""
    bf = got.dtype == torch.bfloat16
    assert (want.dtype == jnp.bfloat16) == bf, (got.dtype, want.dtype)
    g = got.detach().float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32)).astype(np.float64)
    assert g.shape == w.shape
    tol = atol + rtol * np.abs(w) + (_ulp(w) if bf else 0.0)
    bad = np.abs(g - w) > tol
    assert not bad.any(), (f'{bad.sum()} of {bad.size} past tolerance, '
                           f'worst {np.abs(g - w).max():.3g}')


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('xdt,wdt', [('bf16', 'bf16'), ('bf16', 'fp32'),
                                     ('fp32', 'bf16')])
def test_fused_norm_in_bf16_matches_pallas_interpret(xdt, wdt, rms):
    """B1 with bf16 x or weights: the output dtype by ``_out_dtype``'s
    promotion (bf16 only when both are), and the gradient through
    ``FusedNormFunction`` against the custom_vjp's, each in its input's
    dtype."""
    rng = np.random.default_rng(3)
    n, d = 6, 256
    x_t, x_j = _both(_randn(rng, n, d, scale=2.0) + 0.3, xdt)
    g_t, g_j = _both(_randn(rng, d) + 1.0, wdt)
    b_t, b_j = (None, None) if rms else _both(_randn(rng, d), wdt)
    want = _ln_pallas(x_j, g_j, b_j, 1e-5, rms, interpret=True,
                      out_dtype=_out_dtype(x_j, g_j, b_j))
    got = fused_norms.fused_norm(x_t, g_t, b_t, 1e-5, rms)
    _close(got, want)

    ct = _randn(rng, n, d)
    args_j = [x_j, g_j] + ([] if rms else [b_j])
    out, pull = jax.vjp(lambda *a: _fused_norm(
        a[0], a[1], None if rms else a[2], 1e-5, rms, True), *args_j)
    grads_j = pull(jnp.asarray(ct).astype(out.dtype))
    leaves = [t.detach().clone().requires_grad_()
              for t in ([x_t, g_t] + ([] if rms else [b_t]))]
    y = fused_norms.FusedNormFunction.apply(
        leaves[0], leaves[1], None if rms else leaves[2], 1e-5, rms)
    y.backward(torch.from_numpy(ct).to(y.dtype))
    for leaf, gj in zip(leaves, grads_j):
        _close(leaf.grad, gj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('causal,t,s', [(True, 64, 64), (False, 64, 64),
                                        (True, 32, 96), (False, 32, 96)],
                         ids=['causal', 'full', 'causal-t<s', 'full-t<s'])
def test_flash_attention_in_bf16_matches_pallas_interpret(causal, t, s):
    """B2 on bf16 q, k, v: the output in q's dtype."""
    rng = np.random.default_rng(4)
    (q_t, q_j), (k_t, k_j), (v_t, v_j) = (
        _both(_randn(rng, 3, n, 32), 'bf16') for n in (t, s, s))
    want = jax_flash(q_j, k_j, v_j, causal=causal, block_q=32, block_k=32,
                     interpret=True)
    got = fa.flash_attention_fwd(q_t, k_t, v_t, 32 ** -0.5, causal)
    _close(got, want)


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'diagonal'])
def test_flash_attention_stats_in_bf16_matches_pallas_interpret(causal):
    """B3 on bf16 q, k, v: acc, m and l all fp32, as the reference's
    out_shape gives them whatever q's dtype."""
    rng = np.random.default_rng(5)
    (q_t, q_j), (k_t, k_j), (v_t, v_j) = (
        _both(_randn(rng, 2, 64, 32), 'bf16') for _ in range(3))
    want = jax_stats(q_j, k_j, v_j, 0.2, causal, True)
    got = fa.flash_attention_stats(q_t, k_t, v_t, 0.2, causal)
    assert [g.dtype for g in got] == [torch.float32] * 3
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize('depths', [[0, 37, 79], [79, 16, 15]])
def test_paged_attention_in_bf16_matches_pallas_interpret(depths):
    """B4 on a bf16 q and a bf16 pool: the output in q's dtype."""
    rng = np.random.default_rng(6)
    B, kv, G, dh, psz, NP = 3, 2, 2, 32, 16, 5
    P = B * NP + 1
    q_t, q_j = _both(_randn(rng, B, kv, G, dh), 'bf16')
    k_t, k_j = _both(_randn(rng, P, psz, kv, dh), 'bf16')
    v_t, v_j = _both(_randn(rng, P, psz, kv, dh), 'bf16')
    pages = rng.permutation(np.arange(1, P))[:B * NP].reshape(B, NP)
    pages = pages.astype(np.int32)
    offset = np.array(depths, np.int32)
    want = paged_attention_decode_pallas(
        q_j, k_j, v_j, jnp.asarray(pages), jnp.asarray(offset), dh ** -0.5,
        interpret=True)
    got = pa.paged_attention_decode(q_t, k_t, v_t, torch.from_numpy(pages),
                                    torch.from_numpy(offset), dh ** -0.5)
    _close(got, want)


# --------------------------------------------------------------- whole nets
def _scaled_gap(got, want):
    """max |got - want| over max |want|: bf16 nets held relative to the
    tensor's scale, as JAX and PyTorch round bf16 results in other
    places (about 2**-9 of a value each time, through every layer)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _change_gap(got, want, start):
    """The two runs' changes of every weight from ``start``, as one
    vector each: |got change - want change| over |want change|."""
    num = den = 0.0
    for k, w0 in start.items():
        w0 = np.asarray(w0, np.float64)
        dg = np.asarray(got[k], np.float64) - w0
        dw = np.asarray(want[k], np.float64) - w0
        num += float(((dg - dw) ** 2).sum())
        den += float((dw ** 2).sum())
    return (num / den) ** 0.5


def _f32(a):
    return np.asarray(a, np.float32) if a.dtype != np.float32 else a


def _host(params):
    return {k: _f32(p.data().asnumpy()) for k, p in params.items()}


TINY_BERT = dict(vocab_size=200, num_layers=2, units=32, hidden_size=64,
                 num_heads=4, max_length=32, dropout=0.0,
                 use_classifier=False)


def _bert_batch(seed=0, b=4, t=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 200, (b, t)).astype(np.int32)
    tt = rng.integers(0, 2, (b, t)).astype(np.int32)
    labels = rng.integers(0, 200, (b, t)).astype(np.int32)
    return ids, tt, labels


def _bert_pair():
    """The tiny BERT in both packages with the JAX net's weights, each
    cast to bf16 after its first forward."""
    ids, tt, _ = _bert_batch()
    jnet = jbert.get_bert_model('bert_12_768_12', **TINY_BERT)
    jnet.initialize()
    jnet(jmx.np.array(ids), jmx.np.array(tt))
    tnet = tbert.get_bert_model('bert_12_768_12', **TINY_BERT)
    tnet.initialize()
    tnet(tmx.np.array(ids), tmx.np.array(tt))
    tnet.load_dict({k: p.data().asnumpy()
                    for k, p in jnet.collect_params().items()})
    jnet.cast('bfloat16')
    tnet.cast('bfloat16')
    return jnet, tnet


def test_tiny_bert_in_bf16_matches_the_jax_net():
    """Every head's output, in bf16, within 2 % of the tensor's largest
    value (0.7 % seen): bf16 keeps 8 bits, and the two frameworks round
    each op's result in other places through both layers."""
    jnet, tnet = _bert_pair()
    ids, tt, _ = _bert_batch(1)
    want = jnet(jmx.np.array(ids), jmx.np.array(tt))
    got = tnet(tmx.np.array(ids), tmx.np.array(tt))
    for a, b in zip(want, got):
        assert str(b.dtype) == 'bfloat16' and b.shape == a.shape
        assert _scaled_gap(_f32(b.asnumpy()), _f32(a.asnumpy())) < 2e-2


def _bert_train(mx, ag, gl, net, steps=2):
    ids, tt, labels = (mx.np.array(a) for a in _bert_batch(3))
    trainer = gl.Trainer(net.collect_params(), 'adam',
                         {'learning_rate': 1e-3})
    loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with ag.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(_f32(loss.asnumpy())))
    return losses, _host(net.collect_params()), trainer


def test_tiny_bert_in_bf16_trains_as_the_jax_trainer_trains_it():
    """Two Adam steps through each package's Trainer: the losses (bf16
    values) within 1e-2, every weight still bf16 and every slot fp32 in
    both, and the change of all the weights together within 15 % of the
    JAX change (5.7 % seen): Adam divides each gradient by its own root
    mean square, so where a gradient is at bf16 rounding-noise level (a
    bias a few steps from zero) the two runs' updates differ by whole
    steps of the learning rate."""
    jnet, tnet = _bert_pair()
    start = _host(jnet.collect_params())
    jl, jw, jt = _bert_train(jmx, jag, jgl, jnet)
    tl, tw, tt = _bert_train(tmx, tmx.autograd, tgl, tnet)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert {str(p.data().dtype)
            for p in tnet.collect_params().values()} == {'bfloat16'}
    for trainer in (jt, tt):
        assert {str(s.dtype) for st in trainer._states.values()
                for s in st} in ({'float32'}, {'torch.float32'})
    assert _change_gap(tw, jw, start) < 0.15


def test_thumbnail_resnet18_in_bf16_matches_and_trains_as_the_jax_net():
    """The forward within 2 % of the logits' scale (0.5 % seen), and one
    SGD-momentum step (the logits cast to fp32 for the loss, as bench's
    bf16 loop does): the loss within 1e-2 and the change of all the
    weights and running statistics within 10 % of the JAX change (2.3 %
    seen; a BatchNorm gamma of 1.0 moves in steps of its bf16 ulp,
    2**-7, so single tensors part by whole ulps). The JAX step runs
    hybridized, as its Trainer tests run it."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    jnet = jvision.resnet18_v1(classes=10, thumbnail=True)
    jnet.initialize()
    jnet(jmx.np.array(x))
    tnet = tvision.resnet18_v1(classes=10, thumbnail=True)
    tnet.initialize()
    tnet(tmx.np.array(x))
    tnet.load_dict({k: p.data().asnumpy()
                    for k, p in jnet.collect_params().items()})
    jnet.cast('bfloat16')
    tnet.cast('bfloat16')
    start = _host(jnet.collect_params())
    want = jnet(jmx.np.array(x).astype('bfloat16'))
    got = tnet(tmx.np.array(x).astype('bfloat16'))
    assert str(got.dtype) == 'bfloat16'
    assert _scaled_gap(_f32(got.asnumpy()), _f32(want.asnumpy())) < 2e-2

    y = np.array([1, 7, 3, 9], np.float32)
    jnet.hybridize()        # one compiled step where eager JAX takes 17 s
    res = []
    for mx, ag, gl, net in ((jmx, jag, jgl, jnet),
                            (tmx, tmx.autograd, tgl, tnet)):
        trainer = gl.Trainer(net.collect_params(), 'sgd',
                             {'learning_rate': 0.1, 'momentum': 0.9})
        xs = mx.np.array(x).astype('bfloat16')
        with ag.record():
            loss = gl.loss.SoftmaxCrossEntropyLoss()(
                net(xs).astype('float32'), mx.np.array(y)).mean()
        loss.backward()
        trainer.step(4)
        res.append((float(loss.asnumpy()), _host(net.collect_params())))
    (jl, jw), (tl, tw) = res
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert _change_gap(tw, jw, start) < 0.1


def test_llama_tiny_in_bf16_matches_the_jax_net():
    """``llama_tiny`` cast to bf16 in both packages: logits within 1 % of
    their scale (equal in this instance), and the same greedy
    ``generate()`` tokens (both decode over fp32 dense caches)."""
    import test_torch_llama as tl
    jnet = jllama.llama_tiny()
    jnet.initialize()
    jnet(jmx.np.zeros((1, 2)))
    params = tl._weights(jnet)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    tnet = tl.port_net(params)
    jnet.cast('bfloat16')
    tnet.cast('bfloat16')
    toks = np.random.default_rng(3).integers(1, 256, (2, 12)).astype(
        np.int32)
    want = jnet(jmx.np.array(toks))
    got = tnet(torch.from_numpy(toks).long())._data
    assert got.dtype == torch.bfloat16
    assert _scaled_gap(got.float().detach().numpy(),
                       _f32(want.asnumpy())) < 1e-2
    prompt = toks[:1, :5]
    want = jnet.generate(jmx.np.array(prompt), max_new_tokens=8).asnumpy()
    got = tnet.generate(torch.from_numpy(prompt).long(), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_bf16_weights_take_the_plain_update_as_the_reference(opt):
    """A bf16 weight goes to the plain update in both packages (the
    reference's XLA path, ``use_pallas`` false for any non-fp32 weight),
    counted in ``plain_updates``; with the fp32 hyperparameters of the
    Trainers' device vectors the update is fp32 arithmetic, its slots fp32
    and its weight rounded back to bf16: the weights within one bf16 ulp,
    the slots within 1e-6."""
    rng = np.random.default_rng(7)
    n = 1000
    w_t, w_j = _both(_randn(rng, n), 'bf16')
    g_t, g_j = _both(_randn(rng, n, scale=3.0), 'bf16')
    slots = [_randn(rng, n, scale=0.1), np.abs(_randn(rng, n, scale=0.1))]
    lr, wd, t = 1e-2, 0.01, 3
    kernels.reset_launch_counts()
    w = w_t.clone()
    s = [torch.from_numpy(a) for a in slots]
    if opt == 'adam':
        want = fused_adam_step(
            w_j, g_j, jnp.asarray(slots[0]), jnp.asarray(slots[1]),
            lr=jnp.float32(lr), wd=jnp.float32(wd), t=jnp.int32(t),
            rescale_grad=0.5, clip_gradient=1.0)
        hyper = torch.tensor([lr, wd, 1 - 0.9 ** t, 1 - 0.999 ** t])
        fo.adam_step(w, g_t, s[0], s[1], hyper, beta1=0.9, beta2=0.999,
                     epsilon=1e-8, rescale_grad=0.5, clip_gradient=1.0)
        got = [w] + s
    else:
        want = fused_sgd_mom_step(w_j, g_j, jnp.asarray(slots[0]),
                                  lr=jnp.float32(lr), wd=jnp.float32(wd),
                                  momentum=0.9, rescale_grad=0.5,
                                  clip_gradient=1.0)
        fo.sgd_mom_step(w, g_t, s[0], torch.tensor([lr, wd]), momentum=0.9,
                        rescale_grad=0.5, clip_gradient=1.0)
        got = [w, s[0]]
    name = 'adam' if opt == 'adam' else 'sgd_mom'
    assert kernels.plain_update_counts()[name] == 1
    assert set(kernels.launch_counts().values()) == {0}
    assert w.dtype == torch.bfloat16
    _close(got[0], want[0].astype(jnp.bfloat16), rtol=0, atol=0)
    for a, b in zip(got[1:], want[1:]):
        assert b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_trainer_states_of_bf16_weights_round_trip(tmp_path):
    """``create_state`` gives a bf16 weight slots of its dtype, as the
    reference's does; ``create_state_multi_precision``, which the Trainer
    calls, gives them in fp32 (what the JAX Trainer's first update
    leaves); ``save_states``/``load_states`` carry them across in both
    directions between the packages, and ``state_dict`` holds copies that
    a later step leaves alone."""
    jnet = jgl.nn.Dense(3, in_units=4)
    jnet.initialize()
    tnet = tgl.nn.Dense(3, in_units=4)
    tnet.initialize()
    tnet.load_dict({k: p.data().asnumpy()
                    for k, p in jnet.collect_params().items()})
    x = np.random.default_rng(8).standard_normal((2, 4)).astype(np.float32)
    trainers = []
    for mx, ag, gl, net in ((jmx, jag, jgl, jnet),
                            (tmx, tmx.autograd, tgl, tnet)):
        net.cast('bfloat16')
        trainer = gl.Trainer(net.collect_params(), 'adam',
                             {'learning_rate': 0.01})
        with ag.record():
            loss = (net(mx.np.array(x).astype('bfloat16')) ** 2).sum()
        loss.backward()
        trainer.step(2)
        trainers.append(trainer)
    jt, tt = trainers
    w = tnet.collect_params()['weight'].data()._data
    assert [str(s.dtype) for s in tt.optimizer.create_state(0, w)] == \
        ['torch.bfloat16'] * 2
    assert [str(s.dtype) for s in
            tt.optimizer.create_state_multi_precision(0, w)] == \
        ['torch.float32'] * 2
    assert [str(s.dtype) for s in jt.optimizer.create_state(
        0, jnet.collect_params()['weight'].data())] == ['bfloat16'] * 2
    for i in jt._states:
        for a, b in zip(tt._states[i], jt._states[i]):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=1e-5,
                                       atol=1e-7)
    jt.save_states(str(tmp_path / 'jax.states'))
    tt.load_states(str(tmp_path / 'jax.states'))
    tt.save_states(str(tmp_path / 'port.states'))
    jt.load_states(str(tmp_path / 'port.states'))
    for i in jt._states:
        for a, b in zip(tt._states[i], jt._states[i]):
            np.testing.assert_array_equal(a.numpy(), b.asnumpy())
    # state_dict() is host data of its own: a later step, which writes
    # the slots in place, leaves it as it was
    sd = tt.state_dict()
    kept = {i: [a.copy() for a in st] for i, st in sd['states'].items()}
    with tmx.autograd.record():
        loss = (tnet(tmx.np.array(x).astype('bfloat16')) ** 2).sum()
    loss.backward()
    tt.step(2)
    assert any(not np.array_equal(a.numpy(), b)
               for i in kept for a, b in zip(tt._states[i], kept[i]))
    for i, st in sd['states'].items():
        for a, b in zip(st, kept[i]):
            np.testing.assert_array_equal(a, b)
