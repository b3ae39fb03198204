"""What the port's CUDA graphs rest on, held on the CPU against the JAX
package on ``llama_tiny`` (weights drawn with numpy from a seed and
carried across by ``from_jax_params``).

A graph captures the forward with its offsets as tensors read on the
device, so those paths must compute what the Python-int paths and the
JAX net compute: a paged prefill chunk at a 0-dim tensor offset against
the JAX prefill at rtol = atol = 1e-4 (the projections sum in another
order in the two frameworks) and bit-equal to the int offset, and the
RoPE tables built once a forward bit-equal to the tables each layer built
before. ``generate()`` and ``DecodeServer`` (with and without warm-up)
must pick the JAX net's greedy tokens; on the CPU nothing is captured, so
``compile_count`` and ``recompiles`` stay 0 and the audit finds every
pool tensor written in place. The card's side (captures, replays, their
launch counts) is in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import llama as jax_llama
from mxnet_tpu.serve import DecodeServer as JaxDecodeServer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _graphs
from mxnet_tpu_torch.gluon.model_zoo import llama as torch_llama
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.serve import DecodeServer

TOL = dict(rtol=1e-4, atol=1e-4)
SERVER = dict(slots=2, max_length=32, page_size=4, prefill_chunk=8,
              start=False)


@pytest.fixture(scope='module')
def nets():
    jnet = jax_llama.llama_tiny()
    jnet.initialize()
    jnet(mx.np.zeros((1, 2)))
    rng = onp.random.default_rng(0)
    params = {}
    for name, p in jnet.collect_params().items():
        w = rng.standard_normal(p.shape).astype(onp.float32) * 0.1
        params[name] = w + 1.0 if name.endswith('norm.weight') else w
        p.set_data(params[name])
    tnet = torch_llama.from_jax_params(torch_llama.llama_tiny(), params,
                                       ctx=tmx.cpu())
    return jnet, tnet


def _rope_each_layer(x, theta, offset=0):
    """RoPE as every layer computed it before the tables were shared:
    inverse frequencies, positions, cos and sin built in the call."""
    _, S, _, Dh = x.shape
    f32 = torch.float32
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=f32,
                                        device=x.device) / Dh))
    off = torch.as_tensor(offset, dtype=f32, device=x.device)
    pos = torch.atleast_1d(off)[:, None] \
        + torch.arange(S, dtype=f32, device=x.device)
    ang = pos[..., None] * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1 = x[..., ::2].float()
    xf2 = x[..., 1::2].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize('offset', [0, 37, 'tensor', 'rows'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rope_tables_give_the_per_layer_rope_bit_for_bit(offset, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 4, 16, generator=g).to(dtype)
    if offset == 'tensor':
        offset = torch.tensor(1000, dtype=torch.int32)
    elif offset == 'rows':
        offset = torch.tensor([0, 9, 4000], dtype=torch.int32)
    tables = torch_llama._rope_tables(5, 16, 5e5, offset, x.device)
    got = torch_llama._rope(x, *tables)
    assert torch.equal(got, _rope_each_layer(x, 5e5, offset))


def _forward_tables_per_layer(net, toks, **kw):
    """The net's forward with every layer building its own RoPE tables
    (``rope=None``), as each did before."""
    m = net.model
    x = m.embed_tokens(NDArray(toks))
    caches = kw.pop('caches', None)
    if caches is None:
        for blk in m.layers:
            x = blk(x)
        return net.lm_head(m.norm(x))._data
    for blk, cache in zip(m.layers, caches):
        x, _ = blk(x, cache=cache, **kw)
    return net.lm_head(m.norm(x))._data


@torch.no_grad()
def test_rope_tables_once_a_forward_give_bit_equal_logits(nets):
    _, tnet = nets
    toks = torch.from_numpy(onp.random.default_rng(1).integers(0, 256,
                                                                (2, 9)))
    assert tnet.cfg.num_layers == 2
    assert torch.equal(tnet(toks)._data,
                       _forward_tables_per_layer(tnet, toks))
    pool = tnet.init_paged_pool(9, 4)
    pool2 = [(k.clone(), v.clone()) for k, v in pool]
    pages = torch.tensor([[3, 1, 7, 2]], dtype=torch.int32)
    got, _ = tnet(toks[:1, :8], caches=pool, offset=4, pages=pages)
    want = _forward_tables_per_layer(tnet, toks[:1, :8], caches=pool2,
                                     offset=4, pages=pages)
    assert torch.equal(got._data, want)
    off = torch.tensor([12, 3], dtype=torch.int32)
    bt = torch.tensor([[3, 1, 7, 2], [5, 6, 0, 0]], dtype=torch.int32)
    got, _ = tnet(toks[:, :1], caches=pool, offset=off, pages=bt)
    want = _forward_tables_per_layer(tnet, toks[:, :1], caches=pool2,
                                     offset=off, pages=bt)
    assert torch.equal(got._data, want)


def _pool(tnet, seed, num_pages=24, psz=4):
    rng = onp.random.default_rng(seed)
    cfg = tnet.cfg
    shape = (num_pages, psz, cfg.num_kv_heads, cfg.units // cfg.num_heads)
    return [(rng.standard_normal(shape).astype(onp.float32),
             rng.standard_normal(shape).astype(onp.float32))
            for _ in range(cfg.num_layers)]


@torch.no_grad()
def test_prefill_chunk_at_a_tensor_offset_matches_the_reference(nets):
    """Two chunks of one sequence, their offsets 0-dim int32 tensors as a
    graph takes them: against the JAX prefill at a traced offset, and
    bit-equal to the same chunks at Python-int offsets."""
    jnet, tnet = nets
    run, praws = jnet._param_run()
    arrs = _pool(tnet, seed=2)
    jpool = [(jnp.asarray(k), jnp.asarray(v)) for k, v in arrs]
    tpool = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in arrs]
    ipool = [(k.clone(), v.clone()) for k, v in tpool]
    pages = onp.asarray([[5, 9, 2, 17, 11, 0]], onp.int32)
    toks = onp.random.default_rng(3).integers(0, 256, (1, 16))
    for start in (0, 8):
        chunk = toks[:, start:start + 8]
        want, jpool = run(praws, jnp.asarray(chunk, jnp.int32), jpool,
                          jnp.asarray(start, jnp.int32),
                          pages=jnp.asarray(pages))
        got, tpool = tnet(torch.from_numpy(chunk).int(), caches=tpool,
                          offset=torch.tensor(start, dtype=torch.int32),
                          pages=torch.from_numpy(pages))
        at_int, ipool = tnet(torch.from_numpy(chunk), caches=ipool,
                             offset=start, pages=torch.from_numpy(pages))
        onp.testing.assert_allclose(got.asnumpy(), onp.asarray(want), **TOL)
        assert torch.equal(got._data, at_int._data)
    for (tk, tv), (jk, jv), (ik, iv) in zip(tpool, jpool, ipool):
        onp.testing.assert_allclose(tk.numpy(), onp.asarray(jk), **TOL)
        onp.testing.assert_allclose(tv.numpy(), onp.asarray(jv), **TOL)
        assert torch.equal(tk, ik) and torch.equal(tv, iv)


@torch.no_grad()
def test_dense_cache_at_a_tensor_offset_equals_the_int_offset(nets):
    """Prefill and lockstep decode over the dense cache at 0-dim tensor
    offsets write and read what the Python-int offsets do."""
    _, tnet = nets
    toks = torch.from_numpy(onp.random.default_rng(4).integers(0, 256,
                                                               (2, 9)))
    a, b = tnet.init_caches(2, 12), tnet.init_caches(2, 12)
    for start, stop in ((0, 7), (7, 8), (8, 9)):
        got, a = tnet(toks[:, start:stop], caches=a,
                      offset=torch.tensor(start, dtype=torch.int32))
        want, b = tnet(toks[:, start:stop], caches=b, offset=start)
        assert torch.equal(got._data, want._data)
    for (ak, av), (bk, bv) in zip(a, b):
        assert torch.equal(ak, bk) and torch.equal(av, bv)


@pytest.mark.parametrize('batch,n_new', [(1, 9), (3, 5), (2, 2)])
def test_generate_matches_the_reference(nets, batch, n_new):
    """Greedy ``generate()`` at step counts a power of two pads (9 new
    tokens: 8 decode steps) and not, against the JAX ``lax.scan`` loop;
    ``graph=False`` is the same loop on the CPU."""
    jnet, tnet = nets
    prompt = onp.random.default_rng(8).integers(0, 256, (batch, 5))
    want = jnet.generate(mx.np.array(prompt.astype(onp.int32)),
                         max_new_tokens=n_new).asnumpy()
    got = tnet.generate(prompt, max_new_tokens=n_new)
    assert got.numpy().tolist() == want.tolist()
    assert torch.equal(tnet.generate(prompt, max_new_tokens=n_new,
                                     graph=False), got)
    assert tnet.graph_captures == 0 and not tnet._decode_loops   # CPU


def test_sampling_draws_what_multinomial_draws():
    """``_pick``'s draw is ``torch.multinomial``'s, from the same
    generator state, without its host-side check."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 1, 300, generator=g) * 3
    probs = torch.softmax(logits[:, -1].float() / 0.7, dim=-1)
    for seed in range(5):
        got = torch_llama._pick(logits, 0.7,
                                torch.Generator().manual_seed(seed))
        want = torch.multinomial(probs, 1,
                                 generator=torch.Generator().manual_seed(
                                     seed))[:, 0]
        assert torch.equal(got, want)


def _serve(server, requests):
    futs = [server.submit(p, n) for p, n in requests]
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        server.step_once()
    return [f.result(timeout=0) for f in futs], server.stats()


def _requests():
    rng = onp.random.default_rng(1)
    shared = rng.integers(1, 256, 8).tolist()
    return [(shared + rng.integers(1, 256, 5).tolist(), 6),
            (rng.integers(1, 256, 3).tolist(), 4),
            (shared + rng.integers(1, 256, 2).tolist(), 5)]


@pytest.mark.parametrize('warmup', [True, False])
def test_server_with_and_without_warmup_matches_the_reference(nets,
                                                              warmup):
    jnet, tnet = nets
    js = JaxDecodeServer(jnet, **SERVER)
    want, jstats = _serve(js, _requests())
    js.close()
    ds = DecodeServer(tnet, warmup=warmup, **SERVER)
    assert ds.warmup_compiles == 0
    assert ds.compile_baseline == (0 if warmup else None)
    got, stats = _serve(ds, _requests())
    assert got == want
    assert stats['compile_count'] == stats['recompiles'] == 0
    assert set(stats) == set(jstats)
    report = ds.audit_donation()
    n = 2 * tnet.cfg.num_layers
    assert report.ok, report
    assert report.stats['donated_args'] == report.stats['aliased_args'] == n
    assert report.stats['allocations_per_step'] is None     # CPU
    ds.close()
    assert ds._released and not ds._graphs


def test_warmup_writes_only_the_garbage_page(nets):
    """Warm-up runs the chunk and the step over all-zero block tables:
    page 0 takes every write, every other page stays zero."""
    _, tnet = nets
    ds = DecodeServer(tnet, **SERVER)
    for k, v in ds._pool:
        assert k[0].any() and v[0].any()
        assert not k[1:].any() and not v[1:].any()
    ds.close()


def test_audit_before_the_step_ran_is_an_error(nets):
    _, tnet = nets
    ds = DecodeServer(tnet, warmup=False, **SERVER)
    report = ds.audit_donation()
    assert not report.ok
    assert report.stats['aliased_args'] == 0
    assert report.by_rule('donation')
    ds.close()


def test_audit_finds_a_pool_the_step_does_not_write(nets):
    """A pool swapped after the step ran is not what the step writes."""
    _, tnet = nets
    ds = DecodeServer(tnet, **SERVER)
    ds._pool[0] = (ds._pool[0][0].clone(), ds._pool[0][1])
    report = ds.audit_donation()
    assert not report.ok
    assert report.stats['aliased_args'] == 2 * tnet.cfg.num_layers - 1
    ds.close()


def test_step_graph_needs_a_card():
    assert isinstance(_graphs.captures_generators(), bool)
    with pytest.raises(ValueError, match='CUDA'):
        _graphs.StepGraph(lambda: None, 'cpu')


def test_add_launch_counts_adds_and_takes_back():
    before, paths = kernels.launch_counts(), kernels.path_counts()
    kernels.add_launch_counts({'fused_norm': 5, 'int8_matmul': 2},
                              {'int8_matmul': {'tma': 2}}, times=3)
    after = kernels.launch_counts()
    assert after['fused_norm'] == before['fused_norm'] + 15
    assert after['int8_matmul'] == before['int8_matmul'] + 6
    assert kernels.path_counts()['int8_matmul']['tma'] == \
        paths['int8_matmul']['tma'] + 6
    kernels.add_launch_counts({'fused_norm': 5, 'int8_matmul': 2},
                              {'int8_matmul': {'tma': 2}}, times=-3)
    assert kernels.launch_counts() == before
    assert kernels.path_counts() == paths
