"""The port's CUDA kernels on the card, at shapes and template cases the
serving path of ``chip_smoke.py`` does not reach: rows that are not a
multiple of 4 floats, head dims 32 and 64, query groups 1, 2 and 8, small
pages, one query row, and the inputs the wrappers refuse.

Every test needs a CUDA card and skips without one. The tests import no
JAX, so on a machine without it they run with

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: 1e-5 for the norms (fp32
statistics summed in another order), 1e-4 for attention (online against
one-pass softmax).
"""

import copy

import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.llama import get_llama
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels import (fused_norms, flash_attention,
                                         paged_attention)
from mxnet_tpu_torch.serve import DecodeServer

pytestmark = pytest.mark.cuda

NORM_TOL = dict(rtol=1e-5, atol=1e-5)
ATT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev)


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('shape', [(3, 1000), (2, 5, 4096), (1, 130)])
def test_fused_norm_matches_plain(dev, rms, shape):
    x = _randn(dev, *shape) * 2 + 0.5
    d = shape[-1]
    g, b = _randn(dev, d, seed=1) + 1, _randn(dev, d, seed=2)
    beta = None if rms else b
    n = fused_norms.fused_norm.launches
    got = fused_norms.fused_norm(x, g, beta, 1e-5, rms)
    torch.cuda.synchronize()
    assert fused_norms.fused_norm.launches == n + 1
    torch.testing.assert_close(
        got, fused_norms.fused_norm_plain(x, g, beta, 1e-5, rms),
        **NORM_TOL)


@pytest.mark.parametrize('d', [32, 64, 128])
@pytest.mark.parametrize('causal,t,s', [
    (True, 1, 1), (True, 1, 300), (False, 65, 33), (True, 100, 100),
    (True, 37, 130)])
def test_flash_attention_matches_plain(dev, d, causal, t, s):
    bh = 3
    q, k, v = (_randn(dev, bh, n, d, seed=i)
               for i, n in enumerate((t, s, s)))
    got = flash_attention.flash_attention_fwd(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_attention.flash_attention_plain(q, k, v, d ** -0.5,
                                                   causal), **ATT_TOL)


@pytest.mark.parametrize('dh', [64, 128])
@pytest.mark.parametrize('groups', [1, 2, 8])
@pytest.mark.parametrize('psz,np_', [(4, 5), (16, 40)])
def test_paged_attention_matches_plain(dev, dh, groups, psz, np_):
    B, kv = 3, 2
    P = B * np_ + 1
    q = _randn(dev, B, kv, groups, dh)
    kp, vp = _randn(dev, P, psz, kv, dh, seed=1), \
        _randn(dev, P, psz, kv, dh, seed=2)
    pages = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
             [:B * np_] + 1).reshape(B, np_).to(torch.int32)
    pages[1] = 0                                   # an all-garbage row
    pages = pages.to(dev)
    offset = torch.tensor([np_ * psz - 1, 0, psz], dtype=torch.int32,
                          device=dev)
    got = paged_attention.paged_attention_decode(q, kp, vp, pages, offset,
                                                 dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, paged_attention.paged_attention_decode_plain(
            q, kp, vp, pages, offset, dh ** -0.5), **ATT_TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.ones(4, 64, device=dev)
    with pytest.raises(MXNetError, match='float32'):
        fused_norms.fused_rms_norm(x.half(), torch.ones(64, device=dev))
    qkv = torch.ones(2, 8, 16, device=dev)
    with pytest.raises(MXNetError, match='head dim'):
        flash_attention.flash_attention_fwd(qkv, qkv, qkv, 0.25, False)
    with pytest.raises(MXNetError, match='device'):
        fused_norms.fused_rms_norm(x, torch.ones(64))
    q = torch.ones(1, 1, 3, 64, device=dev)
    pool = torch.ones(2, 4, 1, 64, device=dev)
    pages = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(MXNetError, match='group'):
        paged_attention.paged_attention_decode(q, pool, pool, pages, off, 1.)


def test_small_llama_serves_the_same_tokens_on_the_card(dev):
    """A 2-layer Llama with head dim 64 and GQA 4/2 serves the same greedy
    tokens through the kernels as through the plain versions on the CPU,
    and launches each kernel where it should."""
    cfg = dict(vocab_size=512, units=256, num_layers=2, num_heads=4,
               num_kv_heads=2, hidden_size=512, max_length=128)
    gen_cpu = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 512, (n,), generator=gen_cpu).tolist()
               for n in (5, 19, 40)]
    outs = {}
    cpu_net = get_llama('llama_tiny', device='cpu', seed=3, **cfg)
    for where in ('cpu', 'cuda'):
        net = copy.deepcopy(cpu_net).to(where)
        kernels.reset_launch_counts()
        ds = DecodeServer(net, slots=2, max_length=64, page_size=4,
                          prefill_chunk=8, start=False)
        futs = [ds.submit(p, 6) for p in prompts]
        while not all(f.done() for f in futs):
            ds.step_once()
        outs[where] = [f.result() for f in futs]
        steps = ds.stats()['steps']
        ds.close()
        counts = kernels.launch_counts()
        if where == 'cuda':
            assert counts['paged_attention_decode'] == 2 * steps
            assert counts['fused_norm'] > 0
        else:
            assert set(counts.values()) == {0}
        with torch.no_grad():
            logits = net(torch.tensor([prompts[1]], device=where))
        outs[where + '_logits'] = logits.cpu()
    assert kernels.launch_counts()['flash_attention'] == 2
    assert outs['cuda'] == outs['cpu']
    torch.testing.assert_close(outs['cuda_logits'], outs['cpu_logits'],
                               **ATT_TOL)
