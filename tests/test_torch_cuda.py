"""The port's CUDA kernels on the card, at shapes and template cases the
main paths of ``chip_smoke.py`` do not reach: rows that are not a
multiple of 4 floats, head dims 32 and 64, query groups 1, 2 and 8, small
pages, one query row, optimizer steps over ragged and unaligned buffers,
int8 products at ragged and unaligned shapes, and the inputs the wrappers
refuse; the norm's three designs, each forced, at widths that select them (one
row, 2049 rows, 768, 4100 with a masked tail, 12288 above the
register-resident limit), data one float off 16-byte alignment and the
norm replayed from a CUDA graph; the norm and flash gradients on the
card; a small Llama
served and trained on the card against the CPU, float and int8
(served through the server's CUDA graphs); the
flash-attention stats kernel over head dims, ragged edges and both masks;
a two-rank ring (two processes sharing the card over gloo) against dense
attention, with each rank's stats launches; ``rtc`` kernels compiled
from CUDA source, bit-equal to their torch twins, and a source that does
not compile; each design that the int8 product's and flash attention's
plans pick (split or not, and the int8 product's sm80 design for layouts
TMA refuses), counted under its path; split plans that miss a tile,
which the C entries refuse; split calls on two streams at once; the
kernels that opt in to more than 48 KB of shared memory, launched on
every visible card; paged decode split 1 to 8 ways over depth-0,
garbage and out-of-pool rows, the plan's split count passed to the
kernel, and one call replayed from a CUDA graph after its offsets and
block table were rewritten; split counters that outlive a graph that
captured them; every kernel launched on a card that is not the
current one (the two multi-card tests skip on a machine with one
card); and the serving calls as CUDA graphs: a server's graphs against
eager steps at the same shapes, captured at warm-up and never again
under mixed depths, its pool audit, a graph's launch counts over its
replays, and ``generate()``'s replayed decode loop against its eager
one, greedy and sampled, its cache of at most 16 graphs and their
release when the layers are swapped or moved; the port's ``Conv2D``
against fp64 with cuDNN's TF32 flag left on (fp32 forward and
gradients), ``io.PrefetchingIter`` onto the card against
``NDArrayIter``'s batches across a reset, and ``DataLoader`` workers
forked after CUDA was initialized; and the bf16 kernels against their
plain versions (the norm in every (x, weights) dtype pair and design,
both flash forms over head dims and masks, paged decode over head dims,
groups, page sizes and split counts), a bf16 weight's plain update, and
a bf16 Gluon LayerNorm and BERT encoder cell on the card against the CPU.
bf16 outputs are held within one bf16 ulp plus the fp32 tolerance (each
side rounds its fp32 result once; near zero the fp32 tolerance decides).

Every test needs a CUDA card and skips without one. The tests import no
JAX, so on a machine without it they run with

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: 1e-5 for the norms (fp32
statistics summed in another order), 1e-4 for attention (online against
one-pass softmax; also the stats kernel and the ring) and for gradients
and training losses, rtol 1e-6 and atol 1e-7 for the optimizer steps (the
same fp32 operations), and 0 for the int8 product (an exact int32 sum,
then the same rounded operations) and the rtc kernels (the same fp32
roundings, none contracted).
"""

import copy

import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import Trainer, loss as gloss
from mxnet_tpu_torch.gluon.model_zoo.llama import get_llama
from mxnet_tpu_torch.ops import contrib, kernels, nn as nn_ops
from mxnet_tpu_torch.ops.kernels import (fused_norms, flash_attention,
                                         fused_optimizer, int8_matmul,
                                         paged_attention)
from mxnet_tpu_torch.quantization import QuantizedLinear, quantize_net
from mxnet_tpu_torch.serve import DecodeServer
from mxnet_tpu_torch.serve.errors import ServerClosed

pytestmark = pytest.mark.cuda

NORM_TOL = dict(rtol=1e-5, atol=1e-5)
ATT_TOL = dict(rtol=1e-4, atol=1e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
SMALL_LLAMA = dict(vocab_size=512, units=256, num_layers=2, num_heads=4,
                   num_kv_heads=2, hidden_size=512, max_length=128)


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
@pytest.mark.parametrize('shape', [(3, 1000), (2, 5, 4096), (1, 130),
                                   (1, 4096), (2049, 4096), (4, 768),
                                   (3, 4100), (2, 12288), (5, 6)])
def test_fused_norm_matches_plain(dev, rms, shape):
    """The wrapper's call, counted under its plan's design, and then each
    design that takes the shape (the register-resident ones, with their
    masked tails at 4100 and 768; the general one, which takes every
    shape), forced through the C entry, against the plain version."""
    x = _randn(dev, *shape) * 2 + 0.5
    d = shape[-1]
    g, b = _randn(dev, d, seed=1) + 1, _randn(dev, d, seed=2)
    beta = None if rms else b
    want = fused_norms.fused_norm_plain(x, g, beta, 1e-5, rms)
    n = fused_norms.fused_norm.launches
    path = fused_norms.plan(x.numel() // d, d, True, 132, rms).path
    by_path = fused_norms.fused_norm.launches_by_path[path]
    got = fused_norms.fused_norm(x, g, beta, 1e-5, rms)
    torch.cuda.synchronize()
    assert fused_norms.fused_norm.launches == n + 1
    assert fused_norms.fused_norm.launches_by_path[path] == by_path + 1
    torch.testing.assert_close(got, want, **NORM_TOL)
    plans = {fused_norms.plan(m, d, True, 132, True) for m in (1, 64)} | {
        fused_norms.Plan('general', fused_norms.GENERAL_THREADS, 0, 1)}
    assert {p.path for p in plans} >= (
        {'regs', 'general'} if d % 4 == 0 and d <= fused_norms.MAX_D
        else {'general'})
    for p in plans:
        out = torch.empty_like(x)
        fused_norms._launch(x, g, beta, out, 1e-5, rms, p)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, **NORM_TOL)


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('which', ['x', 'gamma'])
def test_fused_norm_off_alignment_takes_the_general_design(dev, rms, which):
    """A contiguous view one float off a 16-byte boundary plans the
    general design, and the C entry refuses it to the register-resident
    ones."""
    n, d = 4, 4096
    xbuf = _randn(dev, n * d + 1) * 2 + 0.5
    gbuf = _randn(dev, d + 1, seed=1) + 1
    x = xbuf[1:].view(n, d) if which == 'x' else xbuf[:n * d].view(n, d)
    g = gbuf[1:] if which == 'gamma' else gbuf[:d]
    beta = None if rms else _randn(dev, d, seed=2)
    before = fused_norms.fused_norm.launches_by_path['general']
    got = fused_norms.fused_norm(x, g, beta, 1e-5, rms)
    torch.cuda.synchronize()
    assert fused_norms.fused_norm.launches_by_path['general'] == before + 1
    torch.testing.assert_close(
        got, fused_norms.fused_norm_plain(x, g, beta, 1e-5, rms),
        **NORM_TOL)
    for m in (n, 64):       # the cluster design, and regs
        with pytest.raises(MXNetError, match='CUDA error'):
            fused_norms._launch(x, g, beta, torch.empty_like(x), 1e-5, rms,
                                fused_norms.plan(m, d, True, 132, True))


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('n,d', [(4, 4096), (32, 4096), (3, 4100),
                                 (64, 4096)])
def test_fused_norm_graph_replay_equals_eager(dev, rms, n, d):
    """The norm captured in a CUDA graph, replayed after its input was
    rewritten in place, gives the eager call's output bit for bit."""
    x = _randn(dev, n, d) * 2 + 0.5
    g, b = _randn(dev, d, seed=1) + 1, _randn(dev, d, seed=2)
    beta = None if rms else b
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fused_norms.fused_norm(x, g, beta, 1e-5, rms)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fused_norms.fused_norm(x, g, beta, 1e-5, rms)
    for seed in (3, 4):
        x.copy_(_randn(dev, n, d, seed=seed) * 3 - 0.25)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fused_norms.fused_norm(x, g, beta, 1e-5,
                                                       rms))


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
    tokens through the kernels (its calls replayed from CUDA graphs) as
    through the plain versions on the CPU, and launches each kernel where
    it should."""
    gen_cpu = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 512, (n,), generator=gen_cpu).tolist()
               for n in (5, 19, 40)]
    outs = {}
    cpu_net = get_llama('llama_tiny', device='cpu', seed=3,
                        **SMALL_LLAMA)
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
        if where == 'cuda':     # + the warm-up's eager step
            assert counts['paged_attention_decode'] == 2 * (steps + 1)
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


def _slots(dev, n, offset, k):
    """A weight, its gradient and ``k`` slots of ``n`` floats each, every
    one starting ``offset`` floats into its own buffer (``offset`` 1
    leaves the pointers off 16-byte alignment, so the kernel takes its
    scalar loop)."""
    out = []
    for i in range(2 + k):
        buf = _randn(dev, n + offset, seed=10 + i)
        if i == 1:
            buf *= 3.0                               # the clip bites
        if i >= 2:
            buf = buf * 0.1 if i == 2 else (buf * 0.1).square()
        out.append(buf[offset:])
    return out


def _clone_at(x, offset):
    """A copy of ``x`` that starts ``offset`` floats into its buffer."""
    buf = torch.empty(x.numel() + offset, device=x.device)
    buf[offset:].copy_(x)
    return buf[offset:]


@pytest.mark.parametrize('t', [1, 1000])
@pytest.mark.parametrize('n,offset', [(1000, 0), (1001, 0), (7, 0),
                                      (4096 * 3 + 2, 1), (1000, 1)])
def test_optimizer_kernels_match_plain(dev, n, offset, t):
    """Adam and SGD-momentum over ragged sizes (a tail of n % 4) and
    unaligned buffers, with rescale, clip and weight decay, in place."""
    hyper = dict(rescale_grad=0.5, clip_gradient=1.0)
    w, g, m, v = _slots(dev, n, offset, 2)
    vec = torch.tensor([1e-3, 0.01, 1 - 0.9 ** t, 1 - 0.999 ** t],
                       device=dev)
    kin = [_clone_at(x, offset) for x in (w, m, v)]
    pin = [x.clone() for x in (w, m, v)]
    ptrs = [x.data_ptr() for x in kin]
    launches = fused_optimizer.adam_step.launches
    got = fused_optimizer.adam_step(kin[0], g, kin[1], kin[2], vec,
                                    beta1=0.9, beta2=0.999,
                                    epsilon=1e-8, **hyper)
    want = fused_optimizer.adam_step_plain(pin[0], g, pin[1], pin[2], vec,
                                           beta1=0.9, beta2=0.999,
                                           epsilon=1e-8, **hyper)
    torch.cuda.synchronize()
    assert fused_optimizer.adam_step.launches == launches + 1
    assert [x.data_ptr() for x in got] == ptrs
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **OPT_TOL)
    w, g, mom = _slots(dev, n, offset, 1)
    kin = [_clone_at(w, offset), _clone_at(mom, offset)]
    pin = [w.clone(), mom.clone()]
    vec = torch.tensor([0.1, 0.01], device=dev)
    got = fused_optimizer.sgd_mom_step(kin[0], g, kin[1], vec,
                                       momentum=0.9, **hyper)
    want = fused_optimizer.sgd_mom_step_plain(pin[0], g, pin[1], vec,
                                              momentum=0.9, **hyper)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **OPT_TOL)


def test_optimizer_kernels_refuse_what_they_do_not_take(dev):
    w = torch.zeros(4, 8, device=dev)
    vec = torch.tensor([0.1, 0.0, 1.0, 1.0], device=dev)
    # an fp32 weight with a gradient of another dtype (a weight of another
    # dtype takes the plain update: test_bf16_weights_take_the_plain_update)
    with pytest.raises(MXNetError, match='float32'):
        fused_optimizer.sgd_mom_step(w, w.half(), w.clone(), vec,
                                     momentum=0.9)
    with pytest.raises(MXNetError, match='contiguous'):
        fused_optimizer.adam_step(w.t(), w.t(), w.t(), w.t(), vec,
                                  beta1=0.9, beta2=0.999, epsilon=1e-8)
    with pytest.raises(MXNetError, match='distinct'):
        fused_optimizer.sgd_mom_step(w, w.clone(), w, vec, momentum=0.9)
    with pytest.raises(MXNetError, match='device'):
        fused_optimizer.sgd_mom_step(w, torch.zeros(4, 8), w.clone(), vec,
                                     momentum=0.9)
    with pytest.raises(MXNetError, match='hyperparameters'):
        fused_optimizer.sgd_mom_step(w, w.clone(), w.clone(), vec.cpu(),
                                     momentum=0.9)


def _grads(fn, args, ct):
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*leaves)
    out.backward(ct)
    return [out.detach().cpu()] + [x.grad.cpu() for x in leaves]


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
def test_norm_gradients_on_the_card_match_the_cpu(dev, rms):
    """The op through the kernel's Function on the card against the same
    op on the CPU (the plain forward), output and every gradient."""
    x = _randn(dev, 3, 5, 1000) * 2 + 0.5
    args = [x, _randn(dev, 1000, seed=1) + 1]
    if not rms:
        args.append(_randn(dev, 1000, seed=2))
    ct = _randn(dev, 3, 5, 1000, seed=3)
    fn = nn_ops.rms_norm if rms else nn_ops.layer_norm
    n = fused_norms.fused_norm.launches
    got = _grads(fn, args, ct)
    assert fused_norms.fused_norm.launches == n + 1
    want = _grads(fn, [a.cpu() for a in args], ct.cpu())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **ATT_TOL)


@pytest.mark.parametrize('causal,t,s', [(True, 64, 64), (False, 64, 64),
                                        (True, 33, 100), (False, 33, 100)])
def test_flash_gradients_on_the_card_match_the_cpu(dev, causal, t, s):
    args = [_randn(dev, 2, 3, n, 64, seed=i) for i, n in enumerate((t, s, s))]
    ct = _randn(dev, 2, 3, t, 64, seed=5)

    def fn(q, k, v):
        return contrib.flash_attention(q, k, v, causal=causal)
    n = flash_attention.flash_attention_fwd.launches
    got = _grads(fn, args, ct)
    assert flash_attention.flash_attention_fwd.launches == n + 1
    want = _grads(fn, [a.cpu() for a in args], ct.cpu())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **ATT_TOL)


def test_small_llama_trains_the_same_on_the_card(dev):
    """Two Adam steps of a Llama with head dim 64 and GQA 4/2 on the card
    (every kernel) and on the CPU (every plain version): the same losses,
    and every parameter gets a gradient on the card."""
    cpu_net = get_llama('llama_tiny', device='cpu', seed=4, **SMALL_LLAMA)
    toks = torch.randint(0, 512, (2, 33),
                         generator=torch.Generator().manual_seed(5))
    losses = {}
    for where in ('cpu', 'cuda'):
        net = copy.deepcopy(cpu_net).to(where)
        params = dict(net.named_parameters())
        trainer = Trainer(params, 'adam', {'learning_rate': 1e-3})
        t = toks.to(where)
        kernels.reset_launch_counts()
        losses[where] = []
        for i in range(2):
            loss = gloss.SoftmaxCrossEntropyLoss()(net(t[:, :-1]),
                                                    t[:, 1:]).mean()
            loss.backward()
            if i == 0:
                assert all(p.grad is not None and bool((p.grad != 0).any())
                           for p in params.values())
            trainer.step(1)
            losses[where].append(float(loss.detach()))
        counts = kernels.launch_counts()
        if where == 'cuda':
            assert counts['adam'] == 2 * len(params)
            assert counts['fused_norm'] == 2 * 5
            assert counts['flash_attention'] == 2 * 2
        else:
            assert set(counts.values()) == {0}
    torch.testing.assert_close(torch.tensor(losses['cuda']),
                               torch.tensor(losses['cpu']), rtol=1e-4,
                               atol=0)


def _int8(dev, *shape, seed=0, offset=0):
    """Seeded int8 values in [-127, 127] of ``shape``, starting ``offset``
    bytes into their buffer (1 leaves them off 16-byte alignment)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 1
    for d in shape:
        n *= d
    buf = torch.randint(-127, 128, (n + offset,), generator=g, device=dev,
                        dtype=torch.int8)
    return buf[offset:].view(shape)


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('m,n,k,offset', [
    (1, 8, 16, 0), (4, 1000, 200, 0), (37, 1000, 200, 0), (17, 130, 48, 1),
    (65, 257, 4096, 0), (300, 96, 520, 1), (4, 4096, 4100, 0),
    (129, 128, 32, 0)])
def test_int8_matmul_matches_plain(dev, m, n, k, offset, out_dtype):
    """Every tile shape (M up to 16, up to 64, above), ragged M, N and K,
    K not a multiple of 16 and x and w off 16-byte alignment (the byte
    loads), with and without bias: bit-equal to the plain version."""
    x = _int8(dev, m, k, seed=1, offset=offset)
    w = _int8(dev, n, k, seed=2, offset=offset)
    scale = _randn(dev, n, seed=3).abs() * 1e-4 + 1e-6
    bias = _randn(dev, n, seed=4)
    for b in (None, bias):
        launches = int8_matmul.int8_matmul.launches
        got = int8_matmul.int8_matmul(x, w, scale, b, out_dtype)
        torch.cuda.synchronize()
        assert int8_matmul.int8_matmul.launches == launches + 1
        assert got.dtype == out_dtype and got.shape == (m, n)
        want = int8_matmul.int8_matmul_plain(x, w, scale, b, out_dtype)
        assert torch.equal(got, want)


def test_int8_matmul_takes_leading_dims_and_extreme_codes(dev):
    """(B, S, K) inputs, and sums of -128 * -128 over K = 4096 codes."""
    x = torch.full((2, 3, 4096), -128, dtype=torch.int8, device=dev)
    w = torch.full((40, 4096), -128, dtype=torch.int8, device=dev)
    scale = torch.ones(40, device=dev)
    got = int8_matmul.int8_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert got.shape == (2, 3, 40)
    assert bool((got == 128 * 128 * 4096).all())


def test_int8_matmul_refuses_what_the_kernel_does_not_take(dev):
    x = _int8(dev, 4, 64)
    w = _int8(dev, 8, 64)
    s = torch.ones(8, device=dev)
    with pytest.raises(MXNetError, match='int8'):
        int8_matmul.int8_matmul(x.float(), w, s)
    with pytest.raises(MXNetError, match='want x'):
        int8_matmul.int8_matmul(_int8(dev, 4, 32), w, s)
    with pytest.raises(MXNetError, match='scale'):
        int8_matmul.int8_matmul(x, w, torch.ones(7, device=dev))
    with pytest.raises(MXNetError, match='float32'):
        int8_matmul.int8_matmul(x, w, s.half())
    with pytest.raises(MXNetError, match='out_dtype'):
        int8_matmul.int8_matmul(x, w, s, out_dtype=torch.float16)
    with pytest.raises(MXNetError, match='contiguous'):
        int8_matmul.int8_matmul(_int8(dev, 64, 4).t(), w, s)
    with pytest.raises(MXNetError, match='device'):
        int8_matmul.int8_matmul(x, w, torch.ones(8))


@pytest.mark.parametrize('act', ['bfloat16', 'float32'])
def test_small_quantized_llama_serves_the_same_tokens_on_the_card(dev, act):
    """A 2-layer Llama quantized on the CPU, then served on the card
    (every int8 product through the kernel) and on the CPU (the plain
    version): the same greedy tokens, one int8 launch per Dense per call,
    and logits within 1e-2 of each other. The int8 products are exact on
    both sides; the norms and attention differ by float rounding, and a
    code at a .5 boundary can flip in the quantize after them."""
    gen_cpu = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 512, (n,), generator=gen_cpu).tolist()
               for n in (5, 19, 40)]
    calib = torch.randint(0, 512, (2, 24), generator=gen_cpu)
    cpu_net = get_llama('llama_tiny', device='cpu', seed=3, **SMALL_LLAMA)
    quantize_net(cpu_net, calib_data=[calib], calib_mode='naive',
                 activation_dtype=act)
    dense = [m for m in cpu_net.modules() if isinstance(m, QuantizedLinear)]
    assert len(dense) == 15
    outs = {}
    for where in ('cpu', 'cuda'):
        net = copy.deepcopy(cpu_net).to(where)
        kernels.reset_launch_counts()
        ds = DecodeServer(net, slots=2, max_length=64, page_size=4,
                          prefill_chunk=8, start=False)
        futs = [ds.submit(p, 6) for p in prompts]
        while not all(f.done() for f in futs):
            ds.step_once()
        outs[where] = [f.result() for f in futs]
        stats = ds.stats()
        ds.close()
        counts = kernels.launch_counts()
        if where == 'cuda':     # + the warm-up's eager chunk and step
            calls = stats['steps'] + stats['prefill_chunks'] + 2
            assert counts['int8_matmul'] == 15 * calls
            assert counts['paged_attention_decode'] == \
                2 * (stats['steps'] + 1)
        else:
            assert set(counts.values()) == {0}
        with torch.no_grad():
            logits = net(torch.tensor([prompts[1]], device=where))
        assert logits.dtype == getattr(torch, act)
        outs[where + '_logits'] = logits.float().cpu()
    assert outs['cuda'] == outs['cpu']
    torch.testing.assert_close(outs['cuda_logits'], outs['cpu_logits'],
                               rtol=0, atol=1e-2)


# ------------------------------------- flash stats kernel, ring attention
@pytest.mark.parametrize('d', [32, 64, 128])
@pytest.mark.parametrize('causal,t,s', [
    (True, 1, 1), (True, 100, 100), (True, 130, 130), (False, 65, 33),
    (False, 1, 300), (False, 37, 130)])
def test_flash_attention_stats_matches_plain(dev, d, causal, t, s):
    """acc, m and l of the stats kernel against its plain version, with
    ragged query and key edges; m is in the units of the scaled scores,
    which the kernel forms as (q * scale) k and the plain version as
    (q k) * scale."""
    bh = 3
    q, k, v = (_randn(dev, bh, n, d, seed=i)
               for i, n in enumerate((t, s, s)))
    n = flash_attention.flash_attention_stats.launches
    got = flash_attention.flash_attention_stats(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_stats.launches == n + 1
    want = flash_attention.flash_attention_stats_plain(q, k, v, d ** -0.5,
                                                       causal)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **ATT_TOL)


def test_flash_attention_stats_refuses_what_it_does_not_take(dev):
    x = _randn(dev, 2, 8, 32)
    with pytest.raises(MXNetError, match='T == S'):
        flash_attention.flash_attention_stats(x, _randn(dev, 2, 9, 32), _randn(
            dev, 2, 9, 32), 0.1, True)
    with pytest.raises(MXNetError, match='head dim'):
        y = _randn(dev, 2, 8, 48)
        flash_attention.flash_attention_stats(y, y, y, 0.1, False)
    with pytest.raises(MXNetError, match='float32'):
        flash_attention.flash_attention_stats(x.half(), x.half(), x.half(),
                                              0.1, False)


def _ring_on_one_card(seed, shape):
    """A rank of a ring that shares cuda:0 with the others (gloo): its
    output for each causal mode and path, and the stats launches of each
    flash run."""
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel import make_mesh, ring_attention
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device('cuda', 0)
    full = [_randn(dev, *shape, seed=seed + i) for i in range(3)]
    sl = shape[2] // world
    q, k, v = (x[:, :, rank * sl:(rank + 1) * sl].contiguous() for x in full)
    mesh = make_mesh(sp=world)
    out = {}
    for causal in (False, True):
        for flash in (False, True):
            n = flash_attention.flash_attention_stats.launches
            o = ring_attention.ring_attention(q, k, v, mesh, causal=causal,
                                              use_flash=flash)
            out[causal, flash] = o.cpu()
            out['launches', causal, flash] = \
                flash_attention.flash_attention_stats.launches - n
    return out


def test_two_rank_ring_on_one_card_matches_dense_attention(dev):
    from mxnet_tpu_torch.parallel import launch
    shape = (1, 2, 256, 64)
    ranks = launch.spawn(_ring_on_one_card, 2, 7, shape, timeout=300)
    q, k, v = (_randn(dev, *shape, seed=7 + i).view(2, 256, 64)
               for i in range(3))
    for causal in (False, True):
        want = flash_attention.flash_attention_plain(q, k, v, 64 ** -0.5,
                                                     causal).view(shape)
        for flash in (False, True):
            got = torch.cat([r[causal, flash] for r in ranks], dim=2)
            torch.testing.assert_close(got, want.cpu(), **ATT_TOL)
            assert [r['launches', causal, flash] for r in ranks] == (
                [0, 0] if not flash else [1, 2] if causal else [2, 2])


RTC_SOURCE = r'''
extern "C" __global__ void double_kernel(const float* x, long long n,
                                         float* y) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

// out = a * x + y rounded as torch rounds it (no contraction into an
// FMA), and the sign of x as an int
extern "C" __global__ void axpy_sign(const float* x, const float* y,
                                     float a, long long n, float* out,
                                     int* sign) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = __fadd_rn(__fmul_rn(a, x[i]), y[i]);
    sign[i] = x[i] < 0.f ? -1 : 1;
  }
}
'''


def test_rtc_kernels_run_bit_equal_to_their_torch_twins(dev):
    from mxnet_tpu_torch.rtc import CudaModule
    mod = CudaModule(RTC_SOURCE, exports=('double_kernel', 'axpy_sign'))
    x, y = _randn(dev, 37, 1001), _randn(dev, 37, 1001, seed=1)
    n = x.numel()
    grid = (n + 255) // 256
    c = kernels.launch_counts()['rtc']
    (d2,) = mod.get_kernel('double_kernel').launch(
        [x, n], grid=grid, block=256, out_shapes=x.shape)
    out, sign = mod.get_kernel('axpy_sign').launch(
        [x, y, 0.37, n], grid=(grid, 1), block=(256,),
        out_shapes=[x.shape, x.shape], out_dtypes=['float32', 'int32'])
    torch.cuda.synchronize()
    assert kernels.launch_counts()['rtc'] == c + 2
    assert torch.equal(d2, x * 2)
    assert torch.equal(out, 0.37 * x + y)
    assert sign.dtype == torch.int32
    assert torch.equal(sign, torch.where(x < 0, -1, 1).int())
    with pytest.raises(MXNetError, match='wants torch.float32'):
        mod.get_kernel('double_kernel').launch(
            [x.double(), n], grid=grid, block=256, out_shapes=x.shape)


def test_rtc_kernel_with_more_than_48_kb_of_shared_memory(dev):
    """Each block reverses 16384 floats through 64 KB of dynamic shared
    memory, which the launch must allow (cuFuncSetAttribute)."""
    from mxnet_tpu_torch.rtc import CudaModule
    mod = CudaModule(r'''
extern "C" __global__ void reverse_rows(const float* x, float* y) {
  extern __shared__ float buf[];
  const float* row = x + blockIdx.x * 16384ll;
  for (int i = threadIdx.x; i < 16384; i += blockDim.x) buf[i] = row[i];
  __syncthreads();
  for (int i = threadIdx.x; i < 16384; i += blockDim.x)
    y[blockIdx.x * 16384ll + i] = buf[16383 - i];
}''')
    x = _randn(dev, 3, 16384)
    (y,) = mod.get_kernel('reverse_rows').launch(
        [x], grid=3, block=1024, out_shapes=x.shape, shared_mem=65536)
    torch.cuda.synchronize()
    assert torch.equal(y, x.flip(1))


def test_rtc_source_that_does_not_compile_raises_with_the_log(dev):
    from mxnet_tpu_torch.rtc import CudaModule
    mod = CudaModule('extern "C" __global__ void broken(float* y) '
                     '{ y[0] = undeclared_name; }')
    with pytest.raises(MXNetError, match='undeclared_name'):
        mod.get_kernel('broken').launch([], grid=1, block=1, out_shapes=(1,))


# ------------------------------- the planned designs, and every card
@pytest.mark.parametrize('m,n,k,offset,path', [
    (4, 1000, 4096, 0, 'tma_splitk'), (33, 1024, 4096, 0, 'tma_splitk'),
    (64, 130, 14336, 0, 'tma_splitk'), (65, 4096, 4096, 0, 'tma'),
    (300, 200, 4096, 0, 'tma'), (512, 1024, 16, 0, 'tma'),
    (3, 257, 4096, 1, 'sm80'), (200, 130, 4100, 0, 'sm80')])
def test_int8_matmul_takes_its_planned_design(dev, m, n, k, offset, path):
    """Each design, split or not, with ragged M, N and K edges against the
    TMA boxes: bit-equal to the plain version, counted under its path."""
    x = _int8(dev, m, k, seed=1, offset=offset)
    w = _int8(dev, n, k, seed=2, offset=offset)
    scale = _randn(dev, n, seed=3).abs() * 1e-4 + 1e-6
    bias = _randn(dev, n, seed=4)
    for b in (None, bias):          # the second call reuses the counters
        before = dict(int8_matmul.int8_matmul.launches_by_path)
        got = int8_matmul.int8_matmul(x, w, scale, b, torch.bfloat16)
        torch.cuda.synchronize()
        after = int8_matmul.int8_matmul.launches_by_path
        assert {p: after[p] - before[p] for p in after} == {
            p: int(p == path) for p in after}
        assert torch.equal(got, int8_matmul.int8_matmul_plain(
            x, w, scale, b, torch.bfloat16))


@pytest.mark.parametrize('t,s,path', [(1, 2048, 'tf32x3_splitkv'),
                                      (65, 300, 'tf32x3_splitkv'),
                                      (2048, 2048, 'tf32x3')])
def test_flash_attention_takes_its_planned_design(dev, t, s, path):
    """Split-KV at short T (the merge of the partials, twice so that the
    counters are seen to return to zero) and the unsplit grid, both forms,
    against the plain versions."""
    bh, d = 32, 128
    q, k, v = (_randn(dev, bh, n, d, seed=i)
               for i, n in enumerate((t, s, s)))
    for _ in range(2):
        before = dict(flash_attention.flash_attention_fwd.launches_by_path)
        got = flash_attention.flash_attention_fwd(q, k, v, d ** -0.5, True)
        torch.cuda.synchronize()
        after = flash_attention.flash_attention_fwd.launches_by_path
        assert after[path] == before[path] + 1
        torch.testing.assert_close(got, flash_attention.flash_attention_plain(
            q, k, v, d ** -0.5, True), **ATT_TOL)
    if t == s:
        got = flash_attention.flash_attention_stats(q, k, v, d ** -0.5, True)
        want = flash_attention.flash_attention_stats_plain(q, k, v,
                                                           d ** -0.5, True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **ATT_TOL)


def test_split_plans_that_miss_a_tile_are_refused(dev, monkeypatch):
    """The kernels take their split boundaries from the plan; the C entries
    refuse a chunk that leaves a K tile or a key tile unsummed, a split
    with nothing to sum, and a key tile other than the kernel's."""
    x, w = _int8(dev, 4, 4096, seed=1), _int8(dev, 1024, 4096, seed=2)
    scale = torch.ones(1024, device=dev)
    good = int8_matmul.plan(4, 1024, 4096, True, 132)
    assert good.splits > 1      # 32 K tiles of 128 bytes
    for splits, chunk in ((good.splits, good.chunk - 1),
                          (good.splits + 1, good.chunk), (2, 8)):
        bad = good._replace(splits=splits, chunk=chunk)
        monkeypatch.setattr(int8_matmul, 'plan', lambda *a, bad=bad: bad)
        with pytest.raises(MXNetError, match='CUDA error'):
            int8_matmul.int8_matmul(x, w, scale)
    q, k, v = (_randn(dev, 4, n, 128, seed=j)
               for j, n in enumerate((37, 2048, 2048)))
    good = flash_attention.plan(4, 37, 2048, 128, 132)
    assert good.splits > 1 and good.block_k == 32
    for change in (dict(chunk=good.chunk - 1), dict(splits=good.splits + 1),
                   dict(block_k=64)):
        bad = good._replace(**change)
        monkeypatch.setattr(flash_attention, 'plan', lambda *a, bad=bad: bad)
        with pytest.raises(MXNetError, match='CUDA error'):
            flash_attention.flash_attention_fwd(q, k, v, 0.1, True)
        with pytest.raises(MXNetError, match='CUDA error'):
            flash_attention.flash_attention_stats(q, k, v, 0.1)


def test_split_calls_on_two_streams_keep_apart(dev):
    """Split calls of one kernel source on two streams at once: each
    stream has its own tile counters, so neither call counts the other's
    blocks, and both stay equal to their plain versions."""
    x = [_int8(dev, 4, 4096, seed=i) for i in (1, 2)]
    w = _int8(dev, 1024, 4096, seed=3)
    scale = torch.ones(1024, device=dev)
    q, k, v = (_randn(dev, 4, n, 128, seed=j)
               for j, n in enumerate((37, 2048, 2048)))
    assert int8_matmul.plan(4, 1024, 4096, True, 132).splits > 1
    assert flash_attention.plan(4, 37, 2048, 128, 132).splits > 1
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append((int8_matmul.int8_matmul(x[i], w, scale),
                                flash_attention.flash_attention_fwd(
                                    q, k, v, 0.1 * (i + 1), True)))
    torch.cuda.synchronize(dev)
    for i in range(2):
        want = int8_matmul.int8_matmul_plain(x[i], w, scale)
        att = flash_attention.flash_attention_plain(q, k, v, 0.1 * (i + 1),
                                                    True)
        for got, got_att in outs[i]:
            assert torch.equal(got, want)
            torch.testing.assert_close(got_att, att, **ATT_TOL)


def test_kernels_launch_on_every_card(dev):
    """The shared-memory opt-in above 48 KB belongs to the device it was
    made on: each kernel that needs it launches after ``set_device`` on
    every visible card, and agrees with its plain version there."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f'needs two or more CUDA cards to launch on a second '
                    f'one; this machine has {cards}')
    for i in range(cards):
        torch.cuda.set_device(i)
        d = torch.device('cuda', i)
        for m, offset in ((4, 0), (512, 0), (512, 1)):   # swap, tma, sm80
            x = _int8(d, m, 4096, seed=1, offset=offset)
            w = _int8(d, 1024, 4096, seed=2, offset=offset)
            scale = _randn(d, 1024, seed=3).abs() * 1e-4
            assert torch.equal(
                int8_matmul.int8_matmul(x, w, scale),
                int8_matmul.int8_matmul_plain(x, w, scale))
        for t in (37, 512):             # split-KV and unsplit
            q, k, v = (_randn(d, 4, n, 128, seed=j)
                       for j, n in enumerate((t, 512, 512)))
            torch.testing.assert_close(
                flash_attention.flash_attention_fwd(q, k, v, 0.1, True),
                flash_attention.flash_attention_plain(q, k, v, 0.1, True),
                **ATT_TOL)
        torch.cuda.synchronize(d)
    torch.cuda.set_device(0)


# -------------------------- paged decode: splits, graphs; the two repairs
def _paged_inputs(dev, B, NP, depths, kv=8, G=4, dh=128, psz=16):
    """Seeded q and pools, a block table of distinct pages (page 0 is the
    garbage page), and ``depths`` as the int32 offsets."""
    P = B * NP + 1
    q = _randn(dev, B, kv, G, dh)
    kp, vp = _randn(dev, P, psz, kv, dh, seed=1), \
        _randn(dev, P, psz, kv, dh, seed=2)
    pages = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(3))
             [:B * NP] + 1).reshape(B, NP).to(torch.int32).to(dev)
    offset = torch.tensor(depths, dtype=torch.int32, device=dev)
    return q, kp, vp, pages, offset


def _paged_want(q, kp, vp, pages, offset):
    """The plain version over the table as the kernel reads it: page ids
    clamped into the pool (the plain gather would index out of range)."""
    return paged_attention.paged_attention_decode_plain(
        q, kp, vp, pages.clamp(0, kp.shape[0] - 1), offset,
        q.shape[-1] ** -0.5)


@pytest.mark.parametrize('splits', [1, 2, 3, 7, 8])
def test_paged_attention_splits_depths_and_out_of_pool_ids(dev, splits):
    """llama3_8b's heads over 64 pages a row, split 1 to 8 ways (the
    largest portable cluster): a depth-0 row, rows on and past page edges,
    a retired row of garbage pages, a row at the table's end, and a row
    whose table holds ids past both ends of the pool."""
    NP, psz = 64, 16
    depths = [0, 1023, 16, 0, NP * psz - 1, 700]
    q, kp, vp, pages, offset = _paged_inputs(dev, 6, NP, depths)
    pages[3] = 0
    pages[5, 0], pages[5, 7] = kp.shape[0] + 9, -4
    out = torch.empty_like(q)
    paged_attention._launch(q, kp, vp, pages, offset, out, 128 ** -0.5,
                            splits)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, _paged_want(q, kp, vp, pages, offset),
                               **ATT_TOL)


def test_paged_attention_launches_its_plan_once(dev, monkeypatch):
    """The wrapper passes the plan's split count to the kernel and counts
    one launch under it; the C entry refuses a count past 8."""
    from mxnet_tpu_torch.ops.kernels import _build
    q, kp, vp, pages, offset = _paged_inputs(dev, 4, 128, [1024] * 4)
    seen = []
    real = _build.function

    def spy(name, symbol, argtypes, restype=None):
        fn = real(name, symbol, argtypes) if restype is None else \
            real(name, symbol, argtypes, restype)
        if symbol != 'paged_attention_decode_f32':
            return fn

        def call(*args):
            seen.append(args[13])
            return fn(*args)
        return call
    monkeypatch.setattr(_build, 'function', spy)
    want = paged_attention.plan(4, 8, 128, 16, _build.sm_count(dev))
    before = dict(paged_attention.paged_attention_decode.launches_by_path)
    n = paged_attention.paged_attention_decode.launches
    got = paged_attention.paged_attention_decode(q, kp, vp, pages, offset,
                                                 128 ** -0.5)
    torch.cuda.synchronize()
    assert seen == [want] and 1 < want <= paged_attention.MAX_SPLITS
    assert paged_attention.paged_attention_decode.launches == n + 1
    after = paged_attention.paged_attention_decode.launches_by_path
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == f'splits{want}') for p in after}
    torch.testing.assert_close(got, _paged_want(q, kp, vp, pages, offset),
                               **ATT_TOL)
    with pytest.raises(MXNetError, match='CUDA error'):
        paged_attention._launch(q, kp, vp, pages, offset, got, 0.1, 9)


def test_paged_attention_graph_replays_at_new_depths(dev):
    """One call captured in a CUDA graph, then the offsets and the block
    table rewritten in place (a row grows, a row becomes a retired row of
    garbage pages, a row goes back to depth 0): the replay reads the new
    values on the card and meets the plain version at them."""
    q, kp, vp, pages, offset = _paged_inputs(dev, 4, 128, [1024] * 4)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        paged_attention.paged_attention_decode(q, kp, vp, pages, offset,
                                               128 ** -0.5)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = paged_attention.paged_attention_decode(q, kp, vp, pages,
                                                     offset, 128 ** -0.5)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, _paged_want(q, kp, vp, pages, offset),
                               **ATT_TOL)
    new_pages = pages.flip(0).clone()
    new_pages[1] = 0
    for depths in ([2047, 0, 300, 17], [5, 0, 0, 1500]):
        offset.copy_(torch.tensor(depths, dtype=torch.int32))
        pages.copy_(new_pages)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(
            out, _paged_want(q, kp, vp, pages, offset), **ATT_TOL)
    del graph


def test_split_counters_outlive_a_graph_that_captured_them(dev):
    """A graph captures a split flash call and a split int8 call while
    their counter sets are small; a later call needs more counters on the
    same stream, the allocator's cache is emptied and its memory handed
    out again, filled with garbage. The counters the graph holds stay
    alive and zero at rest, so its replays still meet the plain
    versions."""
    from mxnet_tpu_torch.ops.kernels import _build
    q, k, v = (_randn(dev, 4, n, 128, seed=j)
               for j, n in enumerate((37, 2048, 2048)))
    x, w = _int8(dev, 4, 4096, seed=1), _int8(dev, 1024, 4096, seed=2)
    scale = _randn(dev, 1024, seed=3).abs() * 1e-4
    assert flash_attention.plan(4, 37, 2048, 128, 132).splits > 1
    assert int8_matmul.plan(4, 1024, 4096, True, 132).splits > 1

    def calls():
        return (flash_attention.flash_attention_fwd(q, k, v, 0.1, True),
                int8_matmul.int8_matmul(x, w, scale))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        att, prod = calls()
    held = [_build.counters(name, dev, side.cuda_stream, 1).data_ptr()
            for name in ('flash_attention', 'int8_matmul')]
    # a larger plan on the same stream: a larger set takes over
    for name in ('flash_attention', 'int8_matmul'):
        grown = _build.counters(name, dev, side.cuda_stream, 1 << 20)
        assert grown.numel() >= 1 << 20 and grown.data_ptr() not in held
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 22,), 7, dtype=torch.int32, device=dev)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(att, flash_attention.flash_attention_plain(
        q, k, v, 0.1, True), **ATT_TOL)
    assert torch.equal(prod, int8_matmul.int8_matmul_plain(x, w, scale))
    assert int(junk.min()) == 7 == int(junk.max())
    del graph


def test_kernels_launch_on_their_tensors_card(dev):
    """Every kernel, with its tensors on ``cuda:i`` while device 0 stays
    current: each launches on card i (its stream, its shared-memory
    opt-in) and meets its plain version there, and device 0 is still
    current after."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f'needs two or more CUDA cards to launch on one that is '
                    f'not current; this machine has {cards}')
    torch.cuda.set_device(0)
    for i in range(1, cards):
        d = torch.device('cuda', i)
        x = _randn(d, 4, 4096)
        gamma = _randn(d, 4096, seed=1)
        torch.testing.assert_close(
            fused_norms.fused_norm(x, gamma, None, 1e-5, True),
            fused_norms.fused_norm_plain(x, gamma, None, 1e-5, True),
            **NORM_TOL)
        for t in (37, 512):             # split-KV and unsplit
            q, k, v = (_randn(d, 4, n, 128, seed=j)
                       for j, n in enumerate((t, 512, 512)))
            torch.testing.assert_close(
                flash_attention.flash_attention_fwd(q, k, v, 0.1, True),
                flash_attention.flash_attention_plain(q, k, v, 0.1, True),
                **ATT_TOL)
        for a, b in zip(flash_attention.flash_attention_stats(q, k, v, 0.1),
                        flash_attention.flash_attention_stats_plain(
                            q, k, v, 0.1, False)):
            torch.testing.assert_close(a, b, **ATT_TOL)
        args = _paged_inputs(d, 4, 128, [1024, 0, 2047, 5])
        torch.testing.assert_close(
            paged_attention.paged_attention_decode(*args, 128 ** -0.5),
            _paged_want(*args), **ATT_TOL)
        for m in (4, 512):              # swap-AB split-K, and tma
            xq, wq = _int8(d, m, 4096, seed=1), _int8(d, 1024, 4096, seed=2)
            scale = _randn(d, 1024, seed=3).abs() * 1e-4
            assert torch.equal(int8_matmul.int8_matmul(xq, wq, scale),
                               int8_matmul.int8_matmul_plain(xq, wq, scale))
        w, g, m1, v1 = _slots(d, 4096 * 3 + 2, 0, 2)
        vec = torch.tensor([1e-3, 0.0, 0.1, 0.001], device=d)
        want = fused_optimizer.adam_step_plain(
            w.clone(), g, m1.clone(), v1.clone(), vec,
            beta1=0.9, beta2=0.999, epsilon=1e-8)
        got = fused_optimizer.adam_step(w, g, m1, v1, vec,
                                        beta1=0.9, beta2=0.999, epsilon=1e-8)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **OPT_TOL)
        w, g, mom = _slots(d, 1001, 0, 1)
        vec = torch.tensor([0.1, 0.0], device=d)
        want = fused_optimizer.sgd_mom_step_plain(w.clone(), g, mom.clone(),
                                                  vec, momentum=0.9)
        got = fused_optimizer.sgd_mom_step(w, g, mom, vec, momentum=0.9)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **OPT_TOL)
        torch.cuda.synchronize(d)
        assert torch.cuda.current_device() == 0


# ------------------------------------------------------------ CUDA graphs
def _eager_steps(net, prompt, n_new, slots=2, max_length=64, psz=4,
                 chunk=8):
    """Greedy tokens of ``prompt`` from eager ``net(...)`` calls at the
    shapes a ``DecodeServer`` gives its graphs: ``(1, chunk)`` prefill
    chunks through a block-table row of ``max_length / psz`` pages at
    Python-int offsets, then decode steps over ``slots`` rows, the
    sequence in row 0 and the others idle on the garbage page."""
    dev = net.model.embed_tokens.weight.device
    mp = max_length // psz
    pool = net.init_paged_pool(slots * mp + 1, psz)
    row = torch.arange(1, mp + 1, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        for start in range(0, len(prompt), chunk):
            real = min(chunk, len(prompt) - start)
            toks = prompt[start:start + real] + [0] * (chunk - real)
            logits, _ = net(torch.tensor([toks], device=dev), caches=pool,
                            offset=start, pages=row)
        out = [int(logits[0, real - 1].float().argmax())]
        bt = torch.zeros(slots, mp, dtype=torch.int32, device=dev)
        bt[0] = row[0]
        while len(out) < n_new:
            toks = torch.zeros(slots, 1, dtype=torch.long, device=dev)
            toks[0, 0] = out[-1]
            offs = torch.zeros(slots, dtype=torch.int32, device=dev)
            offs[0] = len(prompt) + len(out) - 1
            logits, _ = net(toks, caches=pool, offset=offs, pages=bt)
            out.append(int(logits[0, -1].float().argmax()))
    return out


def _small_net(dev, quantized):
    net = get_llama('llama_tiny', device='cpu', seed=3, **SMALL_LLAMA)
    if quantized:
        calib = torch.randint(0, 512, (2, 24),
                              generator=torch.Generator().manual_seed(1))
        quantize_net(net, calib_data=[calib], calib_mode='naive')
    return net.to(dev)


def _prompts(*lengths):
    g = torch.Generator().manual_seed(1)
    return [torch.randint(1, 512, (n,), generator=g).tolist()
            for n in lengths]


@pytest.mark.parametrize('quantized', [False, True], ids=['fp32', 'int8'])
def test_graphed_server_serves_the_eager_steps_tokens(dev, quantized):
    """Each prompt alone through a server whose step and chunk replay
    their graphs, against eager calls at the same shapes: equal greedy
    tokens."""
    net = _small_net(dev, quantized)
    for prompt in _prompts(5, 19, 40):
        ds = DecodeServer(net, slots=2, max_length=64, page_size=4,
                          prefill_chunk=8, start=False)
        fut = ds.submit(prompt, 7)
        while not fut.done():
            ds.step_once()
        assert ds.stats()['compile_count'] == 2
        ds.close()
        assert fut.result() == _eager_steps(net, prompt, 7)


@pytest.mark.parametrize('quantized', [False, True], ids=['fp32', 'int8'])
def test_graphed_server_captures_at_warmup_and_never_again(dev, quantized):
    """Warm-up captures the chunk and the step; requests of mixed depths
    served by the scheduler thread (which replays what the constructing
    thread captured) capture nothing more. The launches count the two
    warm-up calls and every replay; the audit finds the pool written in
    place and no allocation in a replayed step."""
    net = _small_net(dev, quantized)
    L, dense = 2, 15 if quantized else 0
    kernels.reset_launch_counts()
    ds = DecodeServer(net, slots=2, max_length=64, page_size=4,
                      prefill_chunk=8)
    assert ds.warmup_compiles == ds.compile_baseline == 2
    futs = [ds.submit(p, n) for p, n in zip(_prompts(5, 19, 40, 3, 26),
                                           (7, 3, 9, 12, 5))]
    outs = [f.result(timeout=120) for f in futs]
    stats = ds.stats()
    counts = kernels.launch_counts()
    assert [len(o) for o in outs] == [7, 3, 9, 12, 5]
    assert stats['compile_count'] == 2 and stats['recompiles'] == 0
    calls = stats['steps'] + stats['prefill_chunks'] + 2
    assert counts['fused_norm'] == (2 * L + 1) * calls
    assert counts['paged_attention_decode'] == L * (stats['steps'] + 1)
    assert counts['int8_matmul'] == dense * calls
    report = ds.audit_donation()
    assert report.ok, report
    assert report.stats['donated_args'] == report.stats['aliased_args'] \
        == 2 * L
    assert report.stats['allocations_per_step'] == 0
    ds.close()
    assert ds._released and not ds._graphs
    with pytest.raises(ServerClosed):
        ds.submit([1, 2], 2)


def test_step_graph_counts_each_replay_as_its_capture(dev):
    """A norm and a split int8 product captured once: the capture counts
    only its warm-up, each replay counts the capture's launches again, by
    design too, and replays read the inputs rewritten in place."""
    from mxnet_tpu_torch._graphs import StepGraph
    x, gamma = _randn(dev, 4, 4096), _randn(dev, 4096, seed=1)
    xq, wq = _int8(dev, 4, 4096, seed=1), _int8(dev, 1024, 4096, seed=2)
    scale = _randn(dev, 1024, seed=3).abs() * 1e-4

    def body():
        return (nn_ops.rms_norm(x, gamma, eps=1e-5),
                int8_matmul.int8_matmul(xq, wq, scale))
    kernels.reset_launch_counts()
    g = StepGraph(body, dev)
    norm, prod = g.capture()
    assert g.captures == 1
    assert g.launches == {'fused_norm': 1, 'int8_matmul': 1}
    assert g.paths == {'fused_norm': {'cluster': 1},
                       'int8_matmul': {'tma_splitk': 1}}
    assert kernels.launch_counts()['fused_norm'] == 1     # the warm-up
    g.replay(5)
    counts = kernels.launch_counts()
    assert counts['fused_norm'] == counts['int8_matmul'] == 6
    assert kernels.path_counts()['int8_matmul']['tma_splitk'] == 6
    assert kernels.path_counts()['fused_norm']['cluster'] == 6
    x.mul_(-3.0)
    xq.copy_(xq.flip(0))
    g.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(norm, fused_norms.fused_norm_plain(
        x, gamma, None, 1e-5, True), **NORM_TOL)
    assert torch.equal(prod, int8_matmul.int8_matmul_plain(xq, wq, scale))
    g.release()


@pytest.mark.parametrize('quantized', [False, True], ids=['fp32', 'int8'])
def test_graphed_generate_equals_the_eager_one(dev, quantized):
    """``generate()``'s decode loop replayed from one graph: the eager
    loop's tokens, one capture for a key, its launches the prefill, the
    warm-up step and one step a token; a second prompt of the same shape
    replays the same graph."""
    net = _small_net(dev, quantized)
    L, dense = 2, 15 if quantized else 0
    prompts = torch.tensor(_prompts(7, 7, 7))
    for i, prompt in enumerate((prompts[:2], prompts[1:])):
        eager = net.generate(prompt, max_new_tokens=9, graph=False)
        kernels.reset_launch_counts()
        got = net.generate(prompt, max_new_tokens=9)
        assert torch.equal(got, eager)
        assert net.graph_captures == 1
        calls = 9 + (1 if i == 0 else 0)
        counts = kernels.launch_counts()
        assert counts['fused_norm'] == (2 * L + 1) * calls
        assert counts['int8_matmul'] == dense * calls
    one = net.generate(prompts[:1, :5], max_new_tokens=2)
    assert torch.equal(one, net.generate(prompts[:1, :5], max_new_tokens=2,
                                         graph=False))
    assert net.graph_captures == 2


def test_graphed_sampling_is_deterministic_for_a_seed(dev):
    """Sampling replays its graph with the generator registered, where
    torch allows it; a seed gives the same tokens every time, and those
    of the eager loop."""
    from mxnet_tpu_torch._graphs import captures_generators
    net = _small_net(dev, False)
    prompt = torch.tensor([_prompts(6)[0]])
    eager = net.generate(prompt, max_new_tokens=8, temperature=1.0, seed=5,
                         graph=False)
    a = net.generate(prompt, max_new_tokens=8, temperature=1.0, seed=5)
    b = net.generate(prompt, max_new_tokens=8, temperature=1.0, seed=5)
    assert torch.equal(a, b)
    assert net.graph_captures == (1 if captures_generators() else 0)
    assert torch.equal(a, eager)


def test_generate_keeps_at_most_16_graphs_and_drops_them_on_a_swap(dev):
    """The graph cache is bounded as the reference's program cache is,
    and ``quantize_net`` (which swaps the layers the graphs read) and
    ``.to()`` drop it."""
    net = _small_net(dev, False)
    for s in range(2, 19):
        net.generate(torch.ones(1, s, dtype=torch.long), max_new_tokens=3)
    assert net.graph_captures == 17 and len(net._decode_loops) == 16
    calib = torch.randint(0, 512, (2, 24),
                          generator=torch.Generator().manual_seed(1))
    quantize_net(net, calib_data=[calib], calib_mode='naive')
    assert not net._decode_loops
    net.generate(torch.ones(1, 4, dtype=torch.long), max_new_tokens=3)
    assert len(net._decode_loops) == 1
    net.to('cpu')
    assert not net._decode_loops


# ------------------------------------------------- Gluon's graphed predict
def _small_bert(dev, seed=0):
    """A hybridized 2-layer BERT on the card (heads of 64, which the flash
    kernel takes), its (4, 32) batch and a seeded state."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import bert
    mx.random.seed(seed)
    net = bert.get_bert_model('bert_12_768_12', vocab_size=1000,
                              num_layers=2, units=128, hidden_size=512,
                              num_heads=2, max_length=32, dropout=0.0,
                              use_classifier=False)
    net.initialize(ctx=mx.gpu(0))
    g = torch.Generator().manual_seed(seed)
    ids = mx.np.array(torch.randint(0, 1000, (4, 32), generator=g),
                      dtype='int32', ctx=mx.gpu(0))
    tt = mx.np.zeros((4, 32), dtype='int32', ctx=mx.gpu(0))
    net(ids, tt)
    net.hybridize()
    return net, ids, tt


def _eager_mlm(mx, net, ids, tt):
    with mx.autograd.predict_mode():
        return net.forward(ids, tt)[2]._data


def test_hybridized_predict_replays_see_in_place_writes(dev, tmp_path):
    """A predict call after hybridize() captures once; after a Trainer
    step, load_parameters and set_data the replay gives the new weights'
    output, with no other capture of the predict key (the recorded step
    captures its own two); a cast captures again."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    net, ids, tt = _small_bert(dev)
    before = kernels.launch_counts()
    first = net(ids, tt)[2]._data
    got = {k: v - before[k] for k, v in kernels.launch_counts().items()
           if v != before[k]}
    assert got == {'fused_norm': 6, 'flash_attention': 2}
    assert net.capture_count == 1 and net.compile_count == 1
    torch.testing.assert_close(first, _eager_mlm(mx, net, ids, tt),
                               rtol=0, atol=0)
    net.save_parameters(str(tmp_path / 'w.npz'))
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            {'learning_rate': 1e-2})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(ids, tt)[2], ids).mean()
    loss.backward()
    trainer.step(1)
    trained = net(ids, tt)[2]._data
    assert not torch.equal(trained, first)
    torch.testing.assert_close(trained, _eager_mlm(mx, net, ids, tt),
                               rtol=0, atol=0)
    net.load_parameters(str(tmp_path / 'w.npz'))
    torch.testing.assert_close(net(ids, tt)[2]._data, first, rtol=0, atol=0)
    w = net.collect_params()['decoder_bias']
    w.set_data(w.data() + 1.0)
    torch.testing.assert_close(net(ids, tt)[2]._data, first + 1.0,
                               rtol=1e-6, atol=1e-5)
    # the recorded training call captured its own forward and backward
    assert net.capture_count == 3
    net.cast('float32')         # new leaves: the next call captures again
    net(ids, tt)
    assert net.capture_count == 4


def test_hybridized_graph_equals_eager_and_counts_replays(dev):
    """Three graphed predict calls launch what three eager ones do, and
    their outputs equal the eager forward's; keyword arguments raise."""
    import mxnet_tpu_torch as mx
    net, ids, tt = _small_bert(dev, seed=1)
    want = _eager_mlm(mx, net, ids, tt)
    before = kernels.launch_counts()
    for _ in range(3):
        torch.testing.assert_close(net(ids, tt)[2]._data, want, rtol=0,
                                   atol=0)
    got = {k: v - before[k] for k, v in kernels.launch_counts().items()
           if v != before[k]}
    assert got == {'fused_norm': 18, 'flash_attention': 6}
    assert net.capture_count == 1
    with pytest.raises(ValueError, match='keyword'):
        net(ids, token_types=tt)


def test_conv2d_is_fp32_with_cudnn_tf32_left_on(dev):
    """The port's Conv2D (forward, and the input and weight gradients)
    against the same convolution in fp64 while cuDNN's TF32 flag is True,
    PyTorch's default: errors of fp32, not of TF32's 10-bit mantissa (a
    unit roundoff of 4.9e-4, against fp32's 6e-8). The bound, 5e-5 of the
    largest value, takes the weight gradient's fp32 sum over the batch's
    6272 positions; the flag is left as it was."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv = nn.Conv2D(64, 3, padding=1, in_channels=64)
        conv.initialize(ctx=mx.gpu(0))
        x = mx.NDArray(_randn(dev, 8, 64, 28, 28))
        x.attach_grad()
        cot = _randn(dev, 8, 64, 28, 28, seed=1)
        with mx.autograd.record():
            out = conv(x)
            loss = (out * mx.NDArray(cot)).sum()
        loss.backward()
        assert torch.backends.cudnn.allow_tf32
        x64 = x._data.double().requires_grad_()
        w64 = conv.weight.data()._data.double().requires_grad_()
        want = torch.nn.functional.conv2d(
            x64, w64, conv.bias.data()._data.double(), padding=1)
        gx, gw = torch.autograd.grad((want * cot.double()).sum(), (x64, w64))
        for got, ref in ((out._data, want), (x.grad._data, gx),
                         (conv.weight.grad()._data, gw)):
            err = (got.double() - ref).abs().max() / ref.abs().max()
            assert err < 5e-5, float(err)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_prefetching_iter_on_the_card_equals_ndarray_iter(dev):
    """PrefetchingIter(ctx=gpu(0)) stages batches through pinned memory on
    its own stream; what the consumer reads on its stream equals
    NDArrayIter's batches, across a reset, and the batches are on the
    card."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 3, 16, 16)).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    with mx.cpu():
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in io.NDArrayIter(x, y, batch_size=4)]
    pref = io.PrefetchingIter(io.NDArrayIter(x, y, batch_size=4),
                              ctx=mx.gpu(0), depth=3)
    for _ in range(2):
        got = []
        for b in pref:
            assert b.data[0].context == mx.gpu(0)
            doubled = b.data[0]._data * 2       # read on the consumer's
            got.append(((doubled / 2).cpu().numpy(),      # stream
                        b.label[0].asnumpy(), b.pad))
        assert len(got) == len(want)
        for (gx, gy, gp), (wx, wy, wp) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert gp == wp
        pref.reset()
    pref.close()


def test_dataloader_forks_workers_after_cuda_is_initialized(dev):
    """DataLoader workers forked after CUDA was initialized read host data
    and build numpy only; the caller puts each batch on the current
    context, the card."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import data
    torch.zeros(1, device=dev).sum().item()         # CUDA is initialized
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 4)).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    ds = data.ArrayDataset(mx.np.array(x, ctx=mx.cpu()), y).transform_first(
        lambda v: v * 2)
    loader = data.DataLoader(ds, batch_size=4, num_workers=2)
    got = list(loader)
    assert [b[0].context for b in got] == [mx.gpu(0)] * 3
    np.testing.assert_array_equal(
        np.concatenate([b[0].asnumpy() for b in got]), x * 2)
    np.testing.assert_array_equal(
        np.concatenate([b[1].asnumpy() for b in got]), y)


# ------------------------------------------------- Gluon's graphed training
def _bert_steps(mx, net, trainer, ids, tt, steps):
    from mxnet_tpu_torch import gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(ids, tt)[2], ids).mean()
        loss.backward()
        trainer.step(1)
        losses.append(loss.item())
    return losses


@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_graphed_training_equals_the_eager_steps(dev, opt):
    """Three recorded steps of a small BERT replay one forward, one
    backward and one update graph, launch what the eager steps launch,
    and train as they do, while a FactorScheduler halves the learning
    rate under the replayed update graph at every step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, lr_scheduler
    net, ids, tt = _small_bert(dev, seed=2)
    params = net.collect_params()
    init = {k: p.data()._data.clone() for k, p in params.items()}
    kw = dict(learning_rate=1e-2) if opt == 'adam' else dict(
        learning_rate=0.1, momentum=0.9)
    runs = {}
    for graphed in (False, True):
        for k, p in params.items():
            p.set_data(init[k])
        net.hybridize(graphed)
        trainer = gluon.Trainer(params, opt, dict(
            kw, lr_scheduler=lr_scheduler.FactorScheduler(step=1,
                                                          factor=0.5)))
        before = kernels.launch_counts()
        losses = _bert_steps(mx, net, trainer, ids, tt, 3)
        counts = {k: v - before[k] for k, v in
                  kernels.launch_counts().items() if v != before[k]}
        runs[graphed] = (losses, counts, {k: p.data()._data.clone()
                                          for k, p in params.items()})
    (el, ec, ew), (gl, gc, gw) = runs[False], runs[True]
    assert gc == ec
    assert net.capture_count == 2 and trainer.capture_count == 1
    torch.testing.assert_close(torch.tensor(gl), torch.tensor(el),
                               rtol=1e-4, atol=0)
    for k in ew:
        step_e, step_g = ew[k] - init[k], gw[k] - init[k]
        assert float((step_g - step_e).norm()) <= \
            1e-2 * float(step_e.norm()) + 1e-12, k


def _dropout_net(mx, dev):
    """Dense(1024) with an identity weight and no bias, then Dropout(0.5):
    the input's gradient is the mask times 2 times the head gradient,
    exactly."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(nn.Dense(1024, in_units=1024),
                              nn.Dropout(0.5))
    net.initialize(ctx=mx.gpu(0))
    params = net.collect_params()
    params['0.weight'].set_data(torch.eye(1024, device=dev))
    params['0.bias'].set_data(torch.zeros(1024, device=dev))
    return net


def test_graphed_dropout_draws_a_fresh_mask_every_replay(dev):
    import mxnet_tpu_torch as mx
    net = _dropout_net(mx, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = mx.NDArray(torch.randn(1024, 1024, device=dev, generator=g) + 8.0)
    net(x)
    net.hybridize()
    masks = []
    for i in range(4):
        x.attach_grad()
        head = torch.randn(1024, 1024, device=dev, generator=g)
        with mx.autograd.record():
            out = net(x)
        out.backward(mx.NDArray(head))
        mask = out._data != 0
        masks.append(mask)
        assert torch.equal(x.grad._data, mask * 2.0 * head)
    assert net.capture_count == 2
    assert not torch.equal(masks[2], masks[3])
    assert abs(float(masks[3].float().mean()) - 0.5) < 5e-3


def test_two_recorded_calls_before_one_backward_keep_their_residuals(dev):
    import mxnet_tpu_torch as mx
    net, ids, tt = _small_bert(dev, seed=3)
    x2 = mx.NDArray(torch.roll(ids._data, 1, 1).contiguous())
    grads = {}
    for graphed in (False, True):
        net.hybridize(graphed)
        for _ in range(2):
            with mx.autograd.record():      # capture, then one replay
                out = (net(ids, tt)[0] ** 2).mean()
            out.backward()
        with mx.autograd.record():
            loss = (net(ids, tt)[0] ** 2).mean() + net(x2, tt)[0].mean()
        loss.backward()
        grads[graphed] = {k: p.grad()._data.clone()
                          for k, p in net.collect_params().items()
                          if p.grad_req != 'null'}
    assert net.eager_call_count == 1
    for k, g in grads[False].items():
        torch.testing.assert_close(grads[True][k], g, rtol=1e-5, atol=1e-6)


def test_create_graph_through_a_graphed_call_raises(dev):
    import mxnet_tpu_torch as mx
    net, ids, tt = _small_bert(dev, seed=4)
    for _ in range(2):
        with mx.autograd.record():
            out = net(ids, tt)[0].sum()
    w = net.collect_params()['encoder.cell0.ffn1.weight']
    with pytest.raises(MXNetError, match='A5 rest'):
        mx.autograd.grad(out, [w.data()], create_graph=True)


# ------------------------------------------------------------------- bf16
def _ulp(t):
    """The spacing of bf16 values at ``|t|``, fp32."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _close_bf16(got, want, rtol, atol):
    """The dtypes equal, and ``|got - want| <= atol + rtol * |want|`` plus
    one bf16 ulp of ``want`` for a bf16 output: each side rounds its fp32
    result once (half an ulp apiece), and the fp32 tolerance decides near
    zero."""
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = atol + rtol * want.float().abs()
    if got.dtype == torch.bfloat16:
        tol = tol + _ulp(want)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('xdt,wdt', [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)], ids=['bf16', 'bf16-x', 'bf16-w'])
@pytest.mark.parametrize('shape', [(3, 1000), (2, 5, 4096), (1, 130),
                                   (4, 768), (3, 4104), (2, 12288),
                                   (5, 6)])
def test_fused_norm_in_bf16_matches_plain(dev, shape, xdt, wdt, rms):
    """The norm on bf16 x or weights, the output in the reference's
    promotion, counted under its plan's design; then every design that
    takes the shape, forced (the register designs need d a multiple of 8
    for bf16 x and of 4 for fp32 x)."""
    d = shape[-1]
    x = (_randn(dev, *shape) * 2 + 0.5).to(xdt)
    g = (_randn(dev, d, seed=1) + 1).to(wdt)
    beta = None if rms else _randn(dev, d, seed=2).to(wdt)
    want = fused_norms.fused_norm_plain(x, g, beta, 1e-5, rms)
    assert want.dtype == (torch.bfloat16 if xdt == wdt == torch.bfloat16
                          else torch.float32)
    elems = 16 // x.element_size()
    path = fused_norms.plan(x.numel() // d, d, True, 132, rms, elems).path
    n = fused_norms.fused_norm.launches_by_path[path]
    got = fused_norms.fused_norm(x, g, beta, 1e-5, rms)
    torch.cuda.synchronize()
    assert fused_norms.fused_norm.launches_by_path[path] == n + 1
    _close_bf16(got, want, **NORM_TOL)
    plans = {fused_norms.plan(m, d, True, 132, True, elems)
             for m in (1, 64)} | {
        fused_norms.Plan('general', fused_norms.GENERAL_THREADS, 0, 1)}
    for p in plans:
        out = torch.empty_like(want)
        fused_norms._launch(x, g, beta, out, 1e-5, rms, p)
        torch.cuda.synchronize()
        _close_bf16(out, want, **NORM_TOL)


@pytest.mark.parametrize('d', [32, 64, 128])
@pytest.mark.parametrize('causal,t,s', [
    (True, 100, 100), (False, 100, 100), (True, 37, 300), (False, 1, 129),
    (True, 64, 2048)])
def test_flash_attention_in_bf16_matches_plain(dev, d, causal, t, s):
    """Both flash forms on bf16 q, k, v: the normalised output in bf16
    (fp32 tolerance plus a bf16 ulp), the stats form's acc, m and l in
    fp32 at the fp32 tolerance."""
    q = _randn(dev, 3, t, d).to(torch.bfloat16)
    k = _randn(dev, 3, s, d, seed=1).to(torch.bfloat16)
    v = _randn(dev, 3, s, d, seed=2).to(torch.bfloat16)
    got = flash_attention.flash_attention_fwd(q, k, v, d ** -0.5, causal)
    want = flash_attention.flash_attention_plain(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    _close_bf16(got, want, **ATT_TOL)
    if t == s:
        got = flash_attention.flash_attention_stats(q, k, v, d ** -0.5,
                                                    causal)
        want = flash_attention.flash_attention_stats_plain(q, k, v,
                                                           d ** -0.5, causal)
        torch.cuda.synchronize()
        assert [x.dtype for x in got] == [torch.float32] * 3
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **ATT_TOL)


@pytest.mark.parametrize('dh', [64, 128])
@pytest.mark.parametrize('groups', [1, 2, 4, 8])
@pytest.mark.parametrize('psz,np_', [(4, 5), (16, 40)])
def test_paged_attention_in_bf16_matches_plain(dev, dh, groups, psz, np_):
    """Paged decode on a bf16 q and pool, at mixed depths and split
    counts from 1 to 8, the output in bf16."""
    B, kv = 3, 2
    P = B * np_ + 1
    q = _randn(dev, B, kv, groups, dh).to(torch.bfloat16)
    kp = _randn(dev, P, psz, kv, dh, seed=1).to(torch.bfloat16)
    vp = _randn(dev, P, psz, kv, dh, seed=2).to(torch.bfloat16)
    pages = (torch.randperm(B * np_, device=dev) + 1).reshape(
        B, np_).to(torch.int32)
    offset = torch.tensor([0, psz * np_ // 2, psz * np_ - 1],
                          dtype=torch.int32, device=dev)
    want = paged_attention.paged_attention_decode_plain(q, kp, vp, pages,
                                                        offset, dh ** -0.5)
    for splits in (1, 3, 8):
        out = torch.empty_like(q)
        paged_attention._launch(q, kp, vp, pages, offset, out, dh ** -0.5,
                                splits)
        torch.cuda.synchronize()
        _close_bf16(out, want, **ATT_TOL)
    got = paged_attention.paged_attention_decode(q, kp, vp, pages, offset,
                                                 dh ** -0.5)
    torch.cuda.synchronize()
    _close_bf16(got, want, **ATT_TOL)


def test_bf16_weights_take_the_plain_update_on_the_card(dev):
    """A bf16 weight goes to the plain update by its dtype (no launch,
    one plain update counted), in fp32 arithmetic with fp32 slots, as the
    CPU computes it; mixed dtypes raise."""
    w = _randn(dev, 1000).to(torch.bfloat16)
    g = _randn(dev, 1000, seed=1).to(torch.bfloat16)
    m, v = torch.zeros(1000, device=dev), torch.zeros(1000, device=dev)
    vec = torch.tensor([1e-2, 0.01, 0.1, 0.001], device=dev)
    n, plain = (fused_optimizer.adam_step.launches,
                fused_optimizer.adam_step.plain_updates)
    cpu = [x.cpu() for x in (w, g, m, v)]
    fused_optimizer.adam_step(w, g, m, v, vec, beta1=0.9, beta2=0.999,
                              epsilon=1e-8)
    fused_optimizer.adam_step(*cpu, vec.cpu(), beta1=0.9, beta2=0.999,
                              epsilon=1e-8)
    torch.cuda.synchronize()
    assert fused_optimizer.adam_step.launches == n
    assert fused_optimizer.adam_step.plain_updates == plain + 2
    assert w.dtype == torch.bfloat16 and m.dtype == torch.float32
    _close_bf16(w.cpu(), cpu[0], 0, 0)
    for a, b in zip((m, v), cpu[2:]):
        torch.testing.assert_close(a.cpu(), b, **OPT_TOL)
    with pytest.raises(MXNetError, match='float32'):
        fused_optimizer.adam_step(w, g.float(), m, v, vec, beta1=0.9,
                                  beta2=0.999, epsilon=1e-8)


@pytest.mark.parametrize('what', ['layernorm', 'bert_cell'])
def test_bf16_gluon_blocks_run_on_the_card(dev, what):
    """A Gluon LayerNorm and a BERT encoder cell cast to bf16 run on the
    card, through the bf16 norm and flash kernels, and give the CPU's
    output (the same layer through the plain versions) within 2 % of the
    output's scale: cuBLAS's and the CPU's bf16 products round in other
    places."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import bert
    x = _randn(dev, 2, 16, 128).cpu()
    outs = {}
    for where in (mx.cpu(), mx.gpu(0)):
        with where:
            mx.random.seed(0)
            block = nn.LayerNorm(in_channels=128) if what == 'layernorm' \
                else bert.BERTEncoderCell(128, 256, 2)
            block.initialize(ctx=where)
            xs = mx.np.array(x.numpy())
            block(xs)
            if outs:
                block.load_dict(outs['weights'])
            else:
                outs['weights'] = {k: p.data().asnumpy() for k, p in
                                   block.collect_params().items()}
            block.cast('bfloat16')
            norms = fused_norms.fused_norm.launches
            out = block(xs.astype('bfloat16'))
            assert str(out.dtype) == 'bfloat16'
            if where.device_type == 'gpu':
                assert fused_norms.fused_norm.launches > norms
            outs[str(where)] = out._data.detach().float().cpu()
    want, got = outs['cpu(0)'], outs['gpu(0)']
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())



def test_quantized_thumbnail_graphed_predict_on_the_card(dev):
    """A resnet18 thumbnail quantized on the card (Gluon quantization,
    naive calibration): its graphed predict equals its eager int8 forward
    bit for bit over three calls, one capture, 21 B7 launches a call (20
    convolutions over their gathered windows and the Dense), all in a
    Hopper design; its int8 weights equal those quantized on the CPU."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.default_rng(3)
    calib = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    x = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    codes, weights = {}, None
    for where in (mx.cpu(), mx.gpu(0)):
        with where:
            net = vision.resnet18_v1(classes=10, thumbnail=True)
            net.initialize(ctx=where)
            net(mx.np.array(calib))
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                net.load_dict(weights)
            quantize_net(net, calib_data=[calib], calib_mode='naive')
            codes[str(where)] = {k: p.data().asnumpy() for k, p in
                                 net.collect_params().items()
                                 if k.endswith('qweight')}
    assert len(codes['cpu(0)']) == 21
    for k, v in codes['cpu(0)'].items():
        assert (codes['gpu(0)'][k] == v).all(), k
    xs = mx.np.array(x, ctx=mx.gpu(0))
    eager = net(xs)._data
    net.hybridize(static_alloc=True)
    before = kernels.launch_counts()
    paths = kernels.path_counts()['int8_matmul']
    for _ in range(3):
        torch.testing.assert_close(net(xs)._data, eager, rtol=0, atol=0)
    got = {k: v - before[k] for k, v in kernels.launch_counts().items()
           if v != before[k]}
    assert got == {'int8_matmul': 63}
    designs = {k: v - paths[k]
               for k, v in kernels.path_counts()['int8_matmul'].items()}
    assert designs['tma'] + designs['tma_splitk'] == 63
    assert net.capture_count == 1 and eager.dtype == torch.bfloat16


NEW_OPTIMIZERS = {
    'nag': {'momentum': 0.9}, 'adamw': {'wd': 1e-2}, 'adamax': {},
    'nadam': {}, 'adagrad': {}, 'adadelta': {}, 'rmsprop': {'centered': True},
    'ftrl': {}, 'ftml': {}, 'signum': {}, 'sgld': {},
    'dcasgd': {'momentum': 0.9}, 'lars': {}, 'lamb': {'wd': 1e-2},
    'lans': {}}


@pytest.mark.parametrize('opt', sorted(NEW_OPTIMIZERS))
def test_replayed_update_graph_reads_a_new_learning_rate(dev, opt):
    """A Gluon net's update under each optimizer the port added is one
    graph, captured at the first step and replayed at the next two with
    the learning rate changed before each; the weights equal the same
    steps on the CPU (SGLD: its noise is each device's own, so its
    weights must move and stay finite)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    out, weights = {}, None
    for where in (mx.cpu(), mx.gpu(0)):
        with where:
            net = nn.HybridSequential(nn.Dense(32, in_units=16,
                                               activation='tanh'),
                                      nn.Dense(4, in_units=32))
            net.initialize(ctx=where)
            if weights is None:
                weights = {k: p.data().asnumpy()
                           for k, p in net.collect_params().items()}
            else:
                net.load_dict(weights)
            trainer = gluon.Trainer(net.collect_params(), opt, dict(
                NEW_OPTIMIZERS[opt], learning_rate=0.01))
            for lr in (0.01, 0.03, 0.005):
                trainer.set_learning_rate(lr)
                with mx.autograd.record():
                    loss = ((net(mx.np.array(x)) - mx.np.array(y)) ** 2) \
                        .mean()
                loss.backward()
                trainer.step(1)
            out[str(where)] = {k: p.data().asnumpy() for k, p in
                               net.collect_params().items()}
    assert trainer.capture_count == 1
    for k, w0 in weights.items():
        card, cpu = out['gpu(0)'][k], out['cpu(0)'][k]
        if opt == 'sgld':
            assert np.isfinite(card).all() and not np.array_equal(card, w0)
        else:
            np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------ data parallel (gloo)
def _dist_on_one_card(seed):
    """A rank sharing cuda:0 with the other over gloo: a pushpull of CUDA
    tensors through the pinned staging buffers, twice (the buffers are
    reused), and a dist_sync Trainer whose update graph is replayed after
    each all-reduce; returns what the parent checks."""
    import numpy as np
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, kvstore
    from mxnet_tpu_torch.gluon import nn
    rank = dist.get_rank()
    dev = torch.device('cuda', 0)
    kv = kvstore.create('dist_sync')
    out = {}
    for rep in range(2):
        vals = [_randn(dev, 1000 + 7 * i, seed=seed + rank * 10 + i + rep)
                for i in range(3)]
        ptrs = [v.data_ptr() for v in vals]
        kv.fused_pushpull([0, 1, 2], vals, priorities=[0, -1, -2])
        out['sums', rep] = [v.cpu() for v in vals]
        out['kept', rep] = ptrs == [v.data_ptr() for v in vals]
    out['stage'] = len(kvstore.fusion.CrossProcess.get()._stage._bufs)
    rng = np.random.default_rng(seed + rank)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    y = rng.standard_normal((4, 4)).astype(np.float32)
    with mx.gpu(0):
        mx.random.seed(seed)
        net = nn.HybridSequential(nn.Dense(32, in_units=16,
                                           activation='tanh'),
                                  nn.Dense(4, in_units=32))
        net.initialize(ctx=mx.gpu(0))
        trainer = gluon.Trainer(net.collect_params(), 'adam',
                                {'learning_rate': 0.01}, kvstore='dist_sync')
        grads = []
        for _ in range(3):
            with mx.autograd.record():
                loss = ((net(mx.np.array(x)) - mx.np.array(y)) ** 2).sum()
            loss.backward()
            trainer.allreduce_grads()
            grads.append({k: p.grad()._data.cpu()
                          for k, p in net.collect_params().items()})
            trainer.update(4)
        out['grads'] = grads
        out['weights'] = {k: p.data()._data.cpu()
                          for k, p in net.collect_params().items()}
        out['captures'] = trainer.capture_count
    return out


def test_dist_sync_on_one_card_stages_and_replays(dev):
    """Two gloo ranks on cuda:0: the pushpull sums of CUDA tensors,
    written into them in place through reused pinned buffers; the
    Trainer's update graph, captured once, replayed after each all-reduce
    reading the reduced gradients (both ranks hold the same sums and the
    same weights, bit for bit)."""
    from mxnet_tpu_torch.parallel import launch
    ranks = launch.spawn(_dist_on_one_card, 2, 3, timeout=300)
    for rep in range(2):
        want = [sum(_randn(dev, 1000 + 7 * i, seed=3 + r * 10 + i + rep)
                    for r in range(2)).cpu() for i in range(3)]
        for r in ranks:
            assert r['kept', rep]
            for got, w in zip(r['sums', rep], want):
                torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert all(r['stage'] == ranks[0]['stage'] for r in ranks)
    assert [r['captures'] for r in ranks] == [1, 1]
    for step in range(3):
        for k, g in ranks[0]['grads'][step].items():
            assert torch.equal(g, ranks[1]['grads'][step][k])
    for k, w in ranks[0]['weights'].items():
        assert torch.equal(w, ranks[1]['weights'][k])


def test_a_collective_inside_a_capture_raises(dev, monkeypatch):
    """No captured graph holds a collective: the transport and the ring
    refuse to run while a stream captures (a collective in a graph would
    replay without its peers)."""
    from mxnet_tpu_torch.parallel._staging import refuse_capture
    refuse_capture('kvstore psum')              # not capturing: runs
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: True)
    with pytest.raises(MXNetError, match='capture'):
        refuse_capture('kvstore psum')


def test_a_capture_takes_back_only_its_streams_launches(dev):
    """A graph captured while another thread launches Adam on a stream of
    its own (a dist_async server applying pushes): the capture takes back
    its own norm launches only; the other thread's launches, which ran,
    stay counted, and a replay adds the norm's alone."""
    import threading
    from mxnet_tpu_torch._graphs import StepGraph
    x = _randn(dev, 8, 768)
    g = _randn(dev, 768, seed=1) + 1
    ws = [_randn(dev, 4096, seed=10 + i) for i in range(50)]
    hyper = torch.tensor([1e-3, 0.0, 1.0, 1.0], device=dev)
    slots = [(torch.randn_like(w), torch.zeros_like(w), torch.zeros_like(w))
             for w in ws]
    go, done = threading.Event(), []

    def server():
        side = torch.cuda.Stream(dev)
        go.wait()
        with torch.cuda.stream(side):
            for w, (gr, m, v) in zip(ws, slots):
                fused_optimizer.adam_step(w, gr, m, v, hyper, beta1=0.9,
                                          beta2=0.999, epsilon=1e-8)
        side.synchronize()
        done.append(True)

    def body():
        go.set()
        out = x
        for _ in range(40):
            out = fused_norms.fused_norm(out, g, None, 1e-5, True)
        return [out]

    th = threading.Thread(target=server)
    th.start()
    kernels.reset_launch_counts()
    graph = StepGraph(body, dev)
    graph.capture()
    th.join()
    assert done
    after_capture = kernels.launch_counts()
    assert after_capture['adam'] == len(ws)
    assert after_capture['fused_norm'] == 40          # the warm-up's
    graph.replay()
    assert kernels.launch_counts()['fused_norm'] == 80
    assert kernels.launch_counts()['adam'] == len(ws)


def test_dist_async_server_updates_on_the_card(dev, monkeypatch):
    """A dist_async store's server keeps its weights on the card and
    applies a push through B5 on its own stream; the pulled weights equal
    the plain Adam update of the same gradient."""
    import socket
    from contextlib import closing
    from mxnet_tpu_torch import kvstore, optimizer
    from mxnet_tpu_torch.kvstore import dist_async

    def free():
        with closing(socket.socket()) as s:
            s.bind(('127.0.0.1', 0))
            return s.getsockname()[1]

    port = free()
    monkeypatch.setenv('MX_COORDINATOR', f'127.0.0.1:{free()}')
    monkeypatch.setenv('MXNET_KVSTORE_ASYNC_PORT', str(port))
    monkeypatch.setenv('MX_PROC_ID', '0')
    monkeypatch.setenv('MX_NPROC', '1')
    kv = kvstore.create('dist_async', device=dev)
    try:
        w0, grad = _randn(dev, 1000), _randn(dev, 1000, seed=1)
        kv.init(3, w0)
        kv.set_optimizer(optimizer.create('adam', learning_rate=0.01))
        before = kernels.launch_counts()['adam']
        kv.push(3, grad)
        out = torch.empty_like(w0)
        kv.pull(3, out=out)
        torch.cuda.synchronize()
        assert kernels.launch_counts()['adam'] == before + 1
        srv = dist_async._SERVERS[port]
        assert srv._store[3].device == dev and srv._stream is not None
        w, m, v = w0.clone(), torch.zeros_like(w0), torch.zeros_like(w0)
        hyper = torch.tensor([0.01, 0.0, 1 - 0.9, 1 - 0.999], device=dev)
        fused_optimizer.adam_step_plain(w, grad, m, v, hyper, beta1=0.9,
                                        beta2=0.999, epsilon=1e-8)
        torch.testing.assert_close(out, w, **OPT_TOL)
    finally:
        kv.close()
        dist_async._SERVERS.pop(port).stop()
