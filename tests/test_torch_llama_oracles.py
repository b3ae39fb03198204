"""The oracles of ``tests/test_llama.py`` and the HuggingFace import,
through the port's Gluon Llama against the JAX package, on ``llama_tiny``
(helpers and the shared nets from ``tests/test_torch_llama.py``).

The tensor-parallel oracle runs in ``tests/test_torch_sharding.py``'s
world of gloo ranks; ``test_hf_weight_import_matches_transformers`` needs
``transformers``, which neither machine has: the same HF-named numpy dict
goes through the JAX package's ``load_hf_state_dict`` and the port's
instead, and ``from_hf_pretrained`` reads a ``config.json`` and weights
this file writes, as ``pytorch_model.bin`` and as ``model.safetensors``
(written by ``chip_smoke.write_safetensors``), sharded through an index
too.
"""

import json

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd, gluon as jgluon
from mxnet_tpu.gluon.model_zoo import llama as jax_llama

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd, gluon as tgluon
from mxnet_tpu_torch.gluon.model_zoo import llama as torch_llama
from mxnet_tpu_torch.ndarray.ndarray import NDArray

from test_torch_llama import _close, _np, _weights, jax_net, nets, port_net  # noqa: F401,E501


# ------------------------------------------------ tests/test_llama.py oracles
def test_forward_shape(nets):
    jnet, tnet, _ = nets
    tok = onp.random.default_rng(8).integers(0, 256, (2, 16))
    out = tnet(tmx.nd.array(tok, ctx=tmx.cpu(), dtype='int32'))
    assert isinstance(out, NDArray) and out.shape == (2, 16, 256)
    assert onp.isfinite(out.asnumpy()).all()
    _close(out, jnet(mx.np.array(tok, dtype='int32')).asnumpy())


def test_rope_is_rotation():
    """RoPE preserves pairwise norms, is identity at position 0 and equals
    the JAX package's ``_rope``."""
    x = onp.random.default_rng(9).standard_normal((1, 4, 2, 8)).astype('f')
    tx = torch.from_numpy(x)
    y = torch_llama._rope(tx, *torch_llama._rope_tables(4, 8, 1e4, 0,
                                                        tx.device)).numpy()
    nx = x[..., ::2] ** 2 + x[..., 1::2] ** 2
    ny = y[..., ::2] ** 2 + y[..., 1::2] ** 2
    onp.testing.assert_allclose(nx, ny, rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(y[:, 0], x[:, 0], rtol=1e-6, atol=1e-6)
    want = onp.asarray(jax_llama._rope(jnp.asarray(x), 10000.0))
    onp.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)


def test_rope_relative_shift():
    """Scores q_m·k_n depend only on m-n: shifting both positions by the
    same offset leaves the dot products unchanged, in both packages."""
    rng = onp.random.default_rng(10)
    q = rng.standard_normal((1, 6, 1, 8)).astype('f')
    k = rng.standard_normal((1, 6, 1, 8)).astype('f')

    def scores(off):
        tq, tk = torch.from_numpy(q), torch.from_numpy(k)
        tab = torch_llama._rope_tables(6, 8, 1e4, off, tq.device)
        return torch.einsum('bqhd,bkhd->bqk', torch_llama._rope(tq, *tab),
                            torch_llama._rope(tk, *tab)).numpy()
    s0, s5 = scores(0), scores(5)
    onp.testing.assert_allclose(s0, s5, rtol=1e-4, atol=1e-5)
    want = jnp.einsum('bqhd,bkhd->bqk',
                      jax_llama._rope(jnp.asarray(q), 1e4, offset=5),
                      jax_llama._rope(jnp.asarray(k), 1e4, offset=5))
    onp.testing.assert_allclose(s5, onp.asarray(want), rtol=1e-4, atol=1e-5)


def test_causality(nets):
    """Changing a future token must not change past logits."""
    jnet, tnet, _ = nets
    tok = onp.random.default_rng(11).integers(0, 256, (1, 12))
    out1 = _np(tnet(torch.from_numpy(tok)))
    tok2 = tok.copy()
    tok2[0, -1] = (tok2[0, -1] + 7) % 256
    out2 = _np(tnet(torch.from_numpy(tok2)))
    onp.testing.assert_allclose(out1[0, :-1], out2[0, :-1], rtol=1e-4,
                                atol=1e-5)
    assert onp.abs(out1[0, -1] - out2[0, -1]).max() > 1e-4
    _close(out2, jnet(mx.np.array(tok2.astype(onp.int32))).asnumpy())


def test_gqa_heads(nets):
    """num_kv_heads < num_heads shrinks k/v projections accordingly."""
    jnet, tnet, _ = nets
    attn = tnet.model.layers[0].self_attn
    jattn = jnet.model.layers[0].self_attn
    assert attn.q_proj.weight.shape == jattn.q_proj.weight.shape == (64, 64)
    assert attn.k_proj.weight.shape[0] == 32     # 2 kv heads * dh 16
    assert attn.v_proj.weight.shape == jattn.v_proj.weight.shape
    assert attn._heads() == (4, 2)


def test_train_step_reduces_loss():
    """20 Adam steps through ``Trainer(net.collect_params())``, the loop of
    ``tests/test_llama.py``, from the same weights and tokens: every loss
    held to the JAX run's at 1e-4 (the JAX net hybridized, ROADMAP C4)."""
    jnet0 = jax_net()
    params = _weights(jnet0, seed=12)
    jnet = jax_net(params)
    jnet.hybridize()
    tnet = port_net(params)
    tok = onp.random.default_rng(13).integers(0, 256, (4, 16))
    jtr = jgluon.Trainer(jnet.collect_params(), 'adam',
                         {'learning_rate': 5e-3})
    ttr = tgluon.Trainer(tnet.collect_params(), 'adam',
                         {'learning_rate': 5e-3})
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tgluon.loss.SoftmaxCrossEntropyLoss()
    jt = mx.np.array(tok.astype(onp.int32))
    tt = NDArray(torch.from_numpy(tok))
    jl, tl = [], []
    for _ in range(20):
        with jautograd.record():
            l = jloss(jnet(jt[:, :-1]), jt[:, 1:]).mean()
        l.backward()
        jtr.step(1)
        jl.append(float(l.asnumpy()))
        with tautograd.record():
            l = tloss(tnet(tt[:, :-1]), tt[:, 1:]).mean()
        l.backward()
        ttr.step(1)
        tl.append(float(l.asnumpy()))
    onp.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] * 0.7


def test_hybridize_matches_eager(nets):
    _, _, params = nets
    tnet = port_net(params)
    tok = onp.random.default_rng(14).integers(0, 256, (2, 8))
    eager = _np(tnet(torch.from_numpy(tok)))
    tnet.hybridize()
    hybrid = _np(tnet(torch.from_numpy(tok)))
    again = _np(tnet(torch.from_numpy(tok)))
    assert tnet.compile_count == 1
    onp.testing.assert_allclose(eager, hybrid, rtol=1e-4, atol=1e-5)
    onp.testing.assert_array_equal(hybrid, again)


def test_tied_embeddings():
    jnet = jax_net(tie_word_embeddings=True)
    params = _weights(jnet, seed=15)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    tnet = port_net(params, tie_word_embeddings=True)
    tok = onp.random.default_rng(16).integers(0, 256, (1, 8))
    out = tnet(torch.from_numpy(tok))
    assert out.shape == (1, 8, 256)
    assert not hasattr(tnet, 'lm_head')
    assert 'lm_head.weight' not in tnet.collect_params()
    _close(out, jnet(mx.np.array(tok.astype(onp.int32))).asnumpy())


def test_partition_rules(nets):
    """The port's rules place every parameter as the JAX package's do."""
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu_torch.sharding import match_spec
    jnet, tnet, _ = nets
    jrules = jax_llama.llama_partition_rules('tp')
    trules = torch_llama.llama_partition_rules('tp')

    def jspec(name, shape):
        for pred, s in jrules:
            if pred(name, shape):
                return s
        return JP()
    specs = {}
    for n, p in tnet.collect_params().items():
        got = tuple(match_spec(n, p.shape, trules))
        assert got == tuple(jspec(n, p.shape)), n
        specs[n] = got
    assert all(s == ('tp', None) for n, s in specs.items() if 'q_proj' in n)
    assert all(s == (None, 'tp') for n, s in specs.items() if 'o_proj' in n)
    assert all(s == () for n, s in specs.items() if n.endswith('norm.weight'))
    other = torch_llama.llama_partition_rules('mp')
    assert tuple(match_spec('lm_head.weight', (256, 64), other)) == \
        ('mp', None)


def test_kv_cache_decode_matches_full_forward(nets):
    """Incremental cached decode gives the full forward's predictions."""
    jnet, tnet, _ = nets
    toks = onp.array([[5, 9, 3, 7]])
    caches = tnet.init_caches(1, 16)
    inc, caches = tnet(torch.from_numpy(toks), caches=caches, offset=0)
    full = tnet(torch.from_numpy(toks))
    _close(inc, _np(full), rtol=2e-3, atol=2e-4)
    step, caches = tnet(torch.tensor([[2]]), caches=caches, offset=4)
    full5 = _np(tnet(torch.tensor([[5, 9, 3, 7, 2]])))
    _close(_np(step)[:, 0], full5[:, -1], rtol=2e-3, atol=2e-4)
    want5 = jnet(mx.np.array(onp.array([[5, 9, 3, 7, 2]], 'f'))).asnumpy()
    _close(full5, want5)


def test_generate_greedy_and_sampled(nets):
    jnet, tnet, _ = nets
    prompt = onp.array([[1, 2, 3]])
    out = tnet.generate(prompt, max_new_tokens=5)
    assert out.shape == (1, 8)
    ids = out.numpy()
    assert (ids[:, :3] == [[1, 2, 3]]).all()
    assert (ids >= 0).all() and (ids < 256).all()
    want = jnet.generate(mx.np.array(prompt.astype('f')), max_new_tokens=5)
    assert ids.tolist() == want.asnumpy().astype(onp.int64).tolist()
    assert torch.equal(out, tnet.generate(prompt, max_new_tokens=5))
    out3 = tnet.generate(prompt, max_new_tokens=5, temperature=1.0, seed=1)
    assert out3.shape == (1, 8) and (out3.numpy() < 256).all()


# ----------------------------------------------------------- HF import
HF_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              rope_theta=10000.0, rms_norm_eps=1e-5,
              tie_word_embeddings=False)
HF_TOKS = onp.array([[3, 17, 90, 41, 5, 77]])


def _hf_state(seed=17):
    """A random HF-named Llama state dict (numpy) at HF_CFG's sizes."""
    rng = onp.random.default_rng(seed)
    c = HF_CFG
    u, f, v = c['hidden_size'], c['intermediate_size'], c['vocab_size']
    dh = u // c['num_attention_heads']
    kv = c['num_key_value_heads'] * dh

    def w(*s):
        return rng.standard_normal(s).astype(onp.float32) * 0.1
    sd = {'model.embed_tokens.weight': w(v, u),
          'model.norm.weight': 1 + w(u), 'lm_head.weight': w(v, u)}
    for i in range(c['num_hidden_layers']):
        p = f'model.layers.{i}.'
        sd.update({p + 'self_attn.q_proj.weight': w(u, u),
                   p + 'self_attn.k_proj.weight': w(kv, u),
                   p + 'self_attn.v_proj.weight': w(kv, u),
                   p + 'self_attn.o_proj.weight': w(u, u),
                   p + 'mlp.gate_proj.weight': w(f, u),
                   p + 'mlp.up_proj.weight': w(f, u),
                   p + 'mlp.down_proj.weight': w(u, f),
                   p + 'input_layernorm.weight': 1 + w(u),
                   p + 'post_attention_layernorm.weight': 1 + w(u)})
    return sd


def _cfg_kw():
    c = HF_CFG
    return dict(vocab_size=c['vocab_size'], units=c['hidden_size'],
                num_layers=c['num_hidden_layers'],
                num_heads=c['num_attention_heads'],
                num_kv_heads=c['num_key_value_heads'],
                hidden_size=c['intermediate_size'],
                max_length=c['max_position_embeddings'],
                rope_theta=c['rope_theta'])


@pytest.fixture(scope='module')
def hf():
    """The HF dict, and the JAX net loaded from it by its
    ``load_hf_state_dict``: logits and the cache path's logits."""
    sd = _hf_state()
    jnet = jax_llama.LlamaForCausalLM(jax_llama.LlamaConfig(**_cfg_kw()))
    jnet.initialize()
    jnet(mx.np.array(HF_TOKS.astype('f')))
    jax_llama.load_hf_state_dict(jnet, sd)
    want = jnet(mx.np.array(HF_TOKS.astype('f'))).asnumpy()
    inc, _ = jnet.forward(mx.np.array(HF_TOKS.astype('f')),
                          caches=jnet.init_caches(1, 16), offset=0)
    return sd, want, inc.asnumpy()


def _port_hf_net():
    net = torch_llama.LlamaForCausalLM(torch_llama.LlamaConfig(**_cfg_kw()))
    net.initialize(ctx=tmx.cpu())
    return net


def test_hf_weight_import_matches_the_jax_import(hf):
    """The same HF-named dict through both packages' ``load_hf_state_dict``:
    logits at 1e-5, and through the KV-cache path."""
    sd, want, want_inc = hf
    net = torch_llama.load_hf_state_dict(_port_hf_net(), sd)
    _close(net(torch.from_numpy(HF_TOKS)), want, rtol=1e-5, atol=1e-5)
    inc, _ = net(torch.from_numpy(HF_TOKS), caches=net.init_caches(1, 16),
                 offset=0)
    _close(inc, want_inc, rtol=1e-5, atol=1e-5)
    # torch tensors load as numpy arrays do
    again = torch_llama.load_hf_state_dict(
        _port_hf_net(), {k: torch.from_numpy(v) for k, v in sd.items()})
    onp.testing.assert_array_equal(_np(again(torch.from_numpy(HF_TOKS))),
                                   _np(net(torch.from_numpy(HF_TOKS))))


def test_hf_import_refuses_unknown_wrong_and_missing(hf):
    sd = hf[0]
    with pytest.raises(KeyError, match='no target'):
        torch_llama.load_hf_state_dict(
            _port_hf_net(), dict(sd, **{'model.rotary.inv_freq':
                                        onp.zeros(8, 'f')}))
    bad = dict(sd)
    bad['model.norm.weight'] = onp.ones(63, 'f')
    with pytest.raises(ValueError, match='shape'):
        torch_llama.load_hf_state_dict(_port_hf_net(), bad)
    short = {k: v for k, v in sd.items() if k != 'lm_head.weight'}
    with pytest.raises(ValueError, match='missing'):
        torch_llama.load_hf_state_dict(_port_hf_net(), short)


def _write_hf(path, sd, fmt, shards=1):
    from chip_smoke import write_safetensors
    path.mkdir()
    (path / 'config.json').write_text(json.dumps(
        dict(HF_CFG, architectures=['LlamaForCausalLM'])))
    names = sorted(sd)
    parts = [names[i::shards] for i in range(shards)]
    files = []
    for i, part in enumerate(parts):
        tensors = {n: torch.from_numpy(sd[n]) for n in part}
        if fmt == 'bin':
            name = 'pytorch_model.bin' if shards == 1 else \
                f'pytorch_model-{i + 1:05d}-of-{shards:05d}.bin'
            torch.save(tensors, path / name)
        else:
            name = 'model.safetensors' if shards == 1 else \
                f'model-{i + 1:05d}-of-{shards:05d}.safetensors'
            write_safetensors(path / name, tensors)
        files.append((name, part))
    if shards > 1:
        index = 'pytorch_model.bin.index.json' if fmt == 'bin' else \
            'model.safetensors.index.json'
        (path / index).write_text(json.dumps({'weight_map': {
            n: name for name, part in files for n in part}}))


@pytest.mark.parametrize('fmt,shards', [('bin', 1), ('safetensors', 1),
                                        ('safetensors', 2), ('bin', 2)])
def test_from_hf_pretrained_reads_local_files(hf, tmp_path, fmt, shards):
    """``config.json`` and the weights this test writes, read with no
    ``transformers``: the JAX import's logits at 1e-5."""
    sd, want, _ = hf
    _write_hf(tmp_path / 'ckpt', sd, fmt, shards)
    net = torch_llama.from_hf_pretrained(str(tmp_path / 'ckpt'),
                                         ctx=tmx.cpu())
    assert net.cfg.num_kv_heads == 2 and net.cfg.hidden_size == 128
    _close(net(torch.from_numpy(HF_TOKS)), want, rtol=1e-5, atol=1e-5)


def test_safetensors_reader_reads_every_dtype(tmp_path):
    from chip_smoke import write_safetensors
    g = torch.Generator().manual_seed(18)
    tensors = {'a': torch.randn(3, 4, generator=g),
               'b': torch.randn(5, generator=g).to(torch.bfloat16),
               'c': torch.randint(-9, 9, (2, 2), generator=g),
               'd': torch.randn(2, 1, 3, generator=g).half(),
               'e': torch.zeros(0)}
    write_safetensors(tmp_path / 'x.safetensors', tensors)
    got = torch_llama.read_safetensors(tmp_path / 'x.safetensors')
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    (tmp_path / 'empty').mkdir()
    with pytest.raises(FileNotFoundError):
        torch_llama._hf_files(str(tmp_path / 'empty'))
