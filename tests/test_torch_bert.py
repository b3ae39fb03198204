"""The port's BERT (``gluon/model_zoo/bert.py`` on the port's Gluon)
against the JAX package's, on the CPU.

The tiny BERT of tests/test_transformer.py (2 layers, 32 units, 4 heads of
8, vocab 200) with the same numpy weights, carried across by name, gives
every head's output within 1e-5 of the JAX net, with and without
``valid_length`` (the masked attention path). Two Adam and two
SGD-momentum steps through ``Trainer(net.collect_params(), ...)``, the port
hybridized and the JAX net as its own test trains it, give losses and
every weight, the pooler's included (an MLM loss gives it no gradient,
and both Trainers update it with a zero one), within 1e-5, and the same
update counts. The number of parameters the JAX Trainer updates a step
for ``bert_12_768_12`` is the one ``chip_smoke.py``'s bert phase holds
the optimizer launches to. ``load_hf_state_dict`` loads an HF-named state
dict the test builds into both packages alike.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgl
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=200, num_layers=2, units=32, hidden_size=64,
            num_heads=4, max_length=32, dropout=0.0)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _batch(seed=0, b=4, t=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 200, (b, t)).astype(np.int32)
    tt = rng.integers(0, 2, (b, t)).astype(np.int32)
    labels = rng.integers(0, 200, (b, t)).astype(np.int32)
    vl = np.array([t, 5, 9, 1][:b], np.int32)
    return ids, tt, labels, vl


def _pair(**kw):
    """The JAX and the port's tiny BERT with the JAX net's weights."""
    cfg = dict(TINY, **kw)
    ids, tt, _, _ = _batch()
    jnet = jbert.get_bert_model('bert_12_768_12', **cfg)
    jnet.initialize()
    jnet(jmx.np.array(ids), jmx.np.array(tt))
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    tnet = tbert.get_bert_model('bert_12_768_12', **cfg)
    tnet.initialize()
    tnet(tmx.np.array(ids), tmx.np.array(tt))
    tnet.load_dict(weights)
    return jnet, tnet, weights


@pytest.mark.parametrize('valid_length', [False, True],
                         ids=['full', 'valid_length'])
def test_tiny_bert_forward_matches_the_jax_net(valid_length):
    jnet, tnet, _ = _pair()
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    ids, tt, _, vl = _batch(1)
    jargs = [jmx.np.array(ids), jmx.np.array(tt)]
    targs = [tmx.np.array(ids), tmx.np.array(tt)]
    if valid_length:
        jargs.append(jmx.np.array(vl))
        targs.append(tmx.np.array(vl))
    want, got = jnet(*jargs), tnet(*targs)
    assert len(got) == len(want) == 4       # sequence, pooled, MLM, NSP
    for a, b in zip(want, got):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), **TOL)


def test_hybridized_tiny_bert_equals_eager():
    _, tnet, _ = _pair(use_classifier=False)
    ids, tt, _, vl = _batch(2)
    args = [tmx.np.array(ids), tmx.np.array(tt)]
    eager = [o.asnumpy() for o in tnet(*args)]
    masked = tnet(*args, tmx.np.array(vl))[0].asnumpy()
    tnet.hybridize(static_alloc=True)
    for _ in range(2):
        for a, b in zip(eager, tnet(*args)):
            np.testing.assert_allclose(b.asnumpy(), a, **TOL)
    np.testing.assert_allclose(tnet(*args, tmx.np.array(vl))[0].asnumpy(),
                               masked, **TOL)
    assert tnet.compile_count == 2          # with and without valid_length


def _train(mx, ag, gl, net, opt, hyper, steps=2):
    ids, tt, labels, _ = _batch(3)
    ids, tt, labels = (mx.np.array(a) for a in (ids, tt, labels))
    trainer = gl.Trainer(net.collect_params(), opt, dict(hyper))
    loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with ag.record():
            _, _, mlm = net(ids, tt)
            loss = loss_fn(mlm, labels).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    weights = {k: p.data().asnumpy()
               for k, p in net.collect_params().items()}
    return losses, weights, trainer.optimizer._index_update_count


@pytest.mark.parametrize('opt,hyper', [
    ('adam', {'learning_rate': 1e-3}),
    ('sgd', {'learning_rate': 0.1, 'momentum': 0.9})], ids=['adam', 'sgd'])
def test_tiny_bert_trains_as_the_jax_trainer_trains_it(opt, hyper):
    jnet, tnet, start = _pair(use_classifier=False)
    tnet.hybridize()
    jl, jw, jcounts = _train(jmx, jag, jgl, jnet, opt, hyper)
    tl, tw, tcounts = _train(tmx, tmx.autograd, tgl, tnet, opt, hyper)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert jl[1] < jl[0]
    assert sorted(tw) == sorted(jw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **TOL)
    # both update every parameter, the pooler with a zero gradient
    assert tcounts == jcounts and set(tcounts.values()) == {2}
    assert len(tcounts) == len(tw)
    np.testing.assert_array_equal(tw['pooler.weight'], start['pooler.weight'])


def test_bert_base_updates_the_parameters_the_chip_phase_counts():
    """Every parameter of bert_12_768_12 without the NSP head has
    grad_req 'write', so the JAX Trainer updates all of them a step: the
    bert phase's optimizer launches a step."""
    counts = []
    for bert in (jbert, tbert):
        net = bert.bert_12_768_12(max_length=128, dropout=0.0,
                                  use_classifier=False)
        params = net.collect_params()
        counts.append(sum(p.grad_req != 'null' for p in params.values()))
        assert len(params) == counts[-1]
    assert counts == [cs.BERT_UPDATED, cs.BERT_UPDATED]


def _hf_state_dict(net_cfg, seed=4):
    """An HF-named BERT state dict of N(0, 0.01) tensors for
    ``net_cfg``."""
    rng = np.random.default_rng(seed)
    u, h, L = net_cfg['units'], net_cfg['hidden_size'], \
        net_cfg['num_layers']
    v, p = net_cfg['vocab_size'], 64
    shapes = {'bert.embeddings.word_embeddings.weight': (v, u),
              'bert.embeddings.token_type_embeddings.weight': (2, u),
              'bert.embeddings.position_embeddings.weight': (p, u),
              'bert.embeddings.LayerNorm.weight': (u,),
              'bert.embeddings.LayerNorm.bias': (u,),
              'bert.pooler.dense.weight': (u, u),
              'bert.pooler.dense.bias': (u,),
              'cls.predictions.transform.dense.weight': (u, u),
              'cls.predictions.transform.dense.bias': (u,),
              'cls.predictions.transform.LayerNorm.weight': (u,),
              'cls.predictions.transform.LayerNorm.bias': (u,),
              'cls.predictions.bias': (v,),
              'cls.seq_relationship.weight': (2, u),
              'cls.seq_relationship.bias': (2,)}
    for i in range(L):
        e = f'bert.encoder.layer.{i}.'
        for n in ('query', 'key', 'value'):
            shapes[e + f'attention.self.{n}.weight'] = (u, u)
            shapes[e + f'attention.self.{n}.bias'] = (u,)
        shapes.update({e + 'attention.output.dense.weight': (u, u),
                       e + 'attention.output.dense.bias': (u,),
                       e + 'attention.output.LayerNorm.weight': (u,),
                       e + 'attention.output.LayerNorm.bias': (u,),
                       e + 'intermediate.dense.weight': (h, u),
                       e + 'intermediate.dense.bias': (h,),
                       e + 'output.dense.weight': (u, h),
                       e + 'output.dense.bias': (u,),
                       e + 'output.LayerNorm.weight': (u,),
                       e + 'output.LayerNorm.bias': (u,)})
    return {k: torch.from_numpy((0.1 * rng.standard_normal(s)).astype(
        np.float32)) for k, s in shapes.items()}


def test_load_hf_state_dict_loads_as_the_jax_one_does():
    jnet, tnet, _ = _pair()
    sd = _hf_state_dict(TINY)
    jbert.load_hf_state_dict(jnet, sd)
    tbert.load_hf_state_dict(tnet, sd)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for k in jp:
        np.testing.assert_array_equal(tp[k].data().asnumpy(),
                                      jp[k].data().asnumpy(), err_msg=k)
    qkv = tp['encoder.cell1.attention.qkv.weight'].data().asnumpy()
    np.testing.assert_array_equal(
        qkv[32:64], sd['bert.encoder.layer.1.attention.self.key.weight'])
    ids, tt, _, _ = _batch(5)
    np.testing.assert_allclose(
        tnet(tmx.np.array(ids), tmx.np.array(tt))[2].asnumpy(),
        jnet(jmx.np.array(ids), jmx.np.array(tt))[2].asnumpy(), **TOL)


def test_head_dims_the_flash_kernel_does_not_take_stay_on_the_cpu_path():
    """The tiny BERT's heads of 8 run the plain flash version on the CPU;
    the card's kernel takes 32, 64 and 128 (the chip phase's small BERT
    has heads of 64)."""
    from mxnet_tpu_torch.ops.kernels.flash_attention import HEAD_DIMS
    assert TINY['units'] // TINY['num_heads'] not in HEAD_DIMS
    assert 128 // 2 in HEAD_DIMS and 768 // 12 in HEAD_DIMS
