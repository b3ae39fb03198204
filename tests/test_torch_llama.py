"""The PyTorch port's Llama against the JAX package's, on ``llama_tiny``.

Both nets are Gluon blocks with the same parameter names and hold the same
weights, drawn with numpy from a seed and carried across by
``from_jax_params``. These outputs are held against the JAX net's
``_param_run``: the full-sequence forward (the flash path), a paged
chunked-prefill call and a per-slot paged decode call, a dense-cache
prefill, lockstep and per-slot decode, with the caches and page pools they
leave behind. Tolerance rtol = atol = 1e-4: the projections sum in another
order in the two frameworks. ``generate()`` must pick the JAX net's greedy
tokens.

The oracles of ``tests/test_llama.py`` and the HuggingFace import are in
``tests/test_torch_llama_oracles.py``; the tensor-parallel forward runs in
``tests/test_torch_sharding.py``'s world of gloo ranks.
"""

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import llama as jax_llama

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import llama as torch_llama
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.ops import kernels

TOL = dict(rtol=1e-4, atol=1e-4)
PSZ, NUM_PAGES = 4, 24


def _weights(net, seed=0):
    """numpy weights for every parameter of the JAX net: N(0, 0.1) for
    projections and embeddings (logits spread enough for a clear greedy
    pick), 1 + N(0, 0.1) for the norms."""
    rng = onp.random.default_rng(seed)
    out = {}
    for name, p in net.collect_params().items():
        w = rng.standard_normal(p.shape).astype(onp.float32) * 0.1
        out[name] = w + 1.0 if name.endswith('norm.weight') else w
    return out


def jax_net(params=None, **kw):
    """The JAX llama_tiny, materialized, with ``params`` if given."""
    net = jax_llama.llama_tiny(**kw)
    net.initialize()
    net(mx.np.zeros((1, 2)))
    if params is not None:
        for name, p in net.collect_params().items():
            p.set_data(params[name])
    return net


def port_net(params, **kw):
    """The port's llama_tiny on the CPU with the JAX net's ``params``."""
    return torch_llama.from_jax_params(torch_llama.llama_tiny(**kw), params,
                                       ctx=tmx.cpu())


@pytest.fixture(scope='module')
def nets():
    jnet = jax_net()
    params = _weights(jnet)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    return jnet, port_net(params), params


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return x.detach().numpy() if torch.is_tensor(x) else onp.asarray(x)


def _close(got, want, **tol):
    onp.testing.assert_allclose(_np(got), onp.asarray(want),
                                **(tol or TOL))


def _pools(tnet, seed):
    """The same random page pool for both nets (numpy, per layer k/v)."""
    rng = onp.random.default_rng(seed)
    cfg = tnet.cfg
    shape = (NUM_PAGES, PSZ, cfg.num_kv_heads, cfg.units // cfg.num_heads)
    arrs = [(rng.standard_normal(shape).astype(onp.float32),
             rng.standard_normal(shape).astype(onp.float32))
            for _ in range(cfg.num_layers)]
    jpool = [(jnp.asarray(k), jnp.asarray(v)) for k, v in arrs]
    tpool = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in arrs]
    return jpool, tpool


def _close_pools(tpool, jpool):
    for (tk, tv), (jk, jv) in zip(tpool, jpool):
        _close(tk, jk)
        _close(tv, jv)


def test_from_jax_params_maps_every_name(nets):
    jnet, tnet, params = nets
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert len(params) == 21
    assert 'model.layers1.self_attn.q_proj.weight' in tnet.collect_params()
    with pytest.raises(KeyError):
        torch_llama.from_jax_params(tnet, {'model.nope': onp.zeros(1)})
    bad = dict(params, **{'lm_head.weight': onp.zeros((3, 3), 'f')})
    with pytest.raises(ValueError, match='shape'):
        torch_llama.from_jax_params(tnet, bad)
    short = {k: v for k, v in params.items() if k != 'lm_head.weight'}
    with pytest.raises(ValueError, match='missing'):
        torch_llama.from_jax_params(tnet, short)


def test_every_part_is_a_hybrid_block(nets):
    _, tnet, _ = nets
    from mxnet_tpu_torch.gluon import HybridBlock
    blk = tnet.model.layers[0]
    parts = [tnet, tnet.model, blk, blk.self_attn, blk.mlp,
             blk.input_layernorm, tnet.model.norm, tnet.lm_head,
             tnet.model.embed_tokens]
    assert all(isinstance(p, HybridBlock) for p in parts)
    assert not isinstance(tnet, torch.nn.Module)
    assert list(tnet.model._children)[1:3] == ['layers0', 'layers1']


@pytest.mark.parametrize('batch', [1, 2])
def test_full_forward_logits_match(nets, batch):
    jnet, tnet, _ = nets
    toks = onp.random.default_rng(1).integers(0, 256, (batch, 19))
    want = jnet(mx.np.array(toks.astype(onp.int32))).asnumpy()
    kernels.reset_launch_counts()
    got = tnet(torch.from_numpy(toks))
    assert got.shape == (batch, 19, 256)
    _close(got, want)
    assert kernels.launch_counts()['flash_attention'] == 0   # CPU: plain


def test_paged_chunked_prefill_matches(nets):
    """Two chunks of one sequence through its block table: the second
    attends over the first chunk's pages and its own."""
    jnet, tnet, _ = nets
    run, praws = jnet._param_run()
    jpool, tpool = _pools(tnet, seed=2)
    pages = onp.asarray([[5, 9, 2, 17, 11, 0]], onp.int32)
    toks = onp.random.default_rng(3).integers(0, 256, (1, 16))
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        want, jpool = run(praws, jnp.asarray(chunk, jnp.int32), jpool,
                          start, pages=jnp.asarray(pages))
        got, tpool = tnet(torch.from_numpy(chunk), caches=tpool,
                          offset=start, pages=torch.from_numpy(pages))
        _close(got, want)
    _close_pools(tpool, jpool)


def test_paged_per_slot_decode_matches(nets):
    """Rows at unequal depths, one of them idle on the garbage page."""
    jnet, tnet, _ = nets
    run, praws = jnet._param_run()
    jpool, tpool = _pools(tnet, seed=4)
    pages = onp.asarray([[3, 7, 1, 0],
                         [0, 0, 0, 0],
                         [12, 4, 20, 8]], onp.int32)
    off = onp.asarray([6, 0, 13], onp.int32)
    toks = onp.asarray([[17], [0], [201]])
    want, jpool = run(praws, jnp.asarray(toks, jnp.int32), jpool,
                      jnp.asarray(off), pages=jnp.asarray(pages))
    got, tpool = tnet(torch.from_numpy(toks), caches=tpool,
                      offset=torch.from_numpy(off),
                      pages=torch.from_numpy(pages))
    # only the idle row writes the garbage page, so all of it compares
    _close(got, want)
    _close_pools(tpool, jpool)


def test_seeded_init_is_reproducible():
    def make(seed):
        net = torch_llama.llama_tiny()
        net.initialize(torch_llama.LlamaInit(seed), ctx=tmx.cpu())
        return net.collect_params()
    net, again, other = make(3), make(3), make(4)
    w = 'lm_head.weight'
    assert torch.equal(net[w].data()._data, again[w].data()._data)
    assert not torch.equal(net[w].data()._data, other[w].data()._data)
    assert torch.equal(net['model.norm.weight'].data()._data, torch.ones(64))
    std = float(net[w].data()._data.detach().std())
    assert 0.018 < std < 0.022


def _dense(tnet, batch, length, seed):
    """The same random dense caches for both nets."""
    rng = onp.random.default_rng(seed)
    cfg = tnet.cfg
    shape = (batch, length, cfg.num_kv_heads, cfg.units // cfg.num_heads)
    arrs = [(rng.standard_normal(shape).astype(onp.float32),
             rng.standard_normal(shape).astype(onp.float32))
            for _ in range(cfg.num_layers)]
    return ([(jnp.asarray(k), jnp.asarray(v)) for k, v in arrs],
            [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in arrs])


def test_init_caches_allocates_per_layer_zeros(nets):
    _, tnet, _ = nets
    caches = tnet.init_caches(3, 20)
    assert len(caches) == 2
    assert all(k.shape == v.shape == (3, 20, 2, 16) and not k.any()
               for k, v in caches)
    assert tnet.init_caches(1)[0][0].shape[1] == tnet.cfg.max_length


def test_dense_prefill_then_lockstep_decode_match(nets):
    """A (2, 7) prefill at offset 0, then two (2, 1) decode calls at the
    shared offsets 7 and 8, over zeroed caches of 12 positions."""
    jnet, tnet, _ = nets
    run, praws = jnet._param_run()
    jc, tc = jnet.init_caches(2, 12), tnet.init_caches(2, 12)
    toks = onp.random.default_rng(5).integers(0, 256, (2, 9))
    for start, stop in ((0, 7), (7, 8), (8, 9)):
        chunk = toks[:, start:stop]
        want, jc = run(praws, jnp.asarray(chunk, jnp.int32), jc, start)
        got, tc = tnet(torch.from_numpy(chunk), caches=tc, offset=start)
        _close(got, want)
    _close_pools(tc, jc)
    with pytest.raises(ValueError, match='outside'):
        tnet(torch.from_numpy(toks), caches=tc, offset=5)


def test_dense_per_slot_decode_matches(nets):
    """Rows of one dense cache at unequal depths."""
    jnet, tnet, _ = nets
    run, praws = jnet._param_run()
    jc, tc = _dense(tnet, 3, 10, seed=6)
    off = onp.asarray([0, 9, 4], onp.int32)
    toks = onp.asarray([[3], [250], [77]])
    want, jc = run(praws, jnp.asarray(toks, jnp.int32), jc,
                   jnp.asarray(off))
    got, tc = tnet(torch.from_numpy(toks), caches=tc,
                   offset=torch.from_numpy(off))
    _close(got, want)
    _close_pools(tc, jc)


@pytest.mark.parametrize('bucket', [None, 4])
def test_generate_greedy_matches(nets, bucket):
    jnet, tnet, _ = nets
    prompt = onp.random.default_rng(7).integers(0, 256, (2, 6))
    want = jnet.generate(mx.np.array(prompt.astype(onp.int32)),
                         max_new_tokens=7, batch_bucket=bucket).asnumpy()
    kernels.reset_launch_counts()
    got = tnet.generate(prompt, max_new_tokens=7, batch_bucket=bucket)
    assert got.shape == (2, 13) and got.dtype == torch.long
    assert (got[:, :6].numpy() == prompt).all()
    assert got.numpy().tolist() == want.tolist()
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain


def test_generate_sampling_is_deterministic_for_a_seed(nets):
    _, tnet, _ = nets
    prompt = torch.tensor([[5, 6, 7]])
    a = tnet.generate(prompt, max_new_tokens=6, temperature=1.0, seed=3)
    b = tnet.generate(prompt, max_new_tokens=6, temperature=1.0, seed=3)
    assert torch.equal(a, b) and a.shape == (1, 9)
    with pytest.raises(ValueError, match='batch_bucket'):
        tnet.generate(prompt, batch_bucket=0)
    with pytest.raises(ValueError, match='too small'):
        tnet.generate(prompt, max_new_tokens=6, max_length=8)
