"""The port's sequence-parallel path against the JAX package, on the CPU.

- The flash-attention stats kernel's plain version (what a CPU tensor
  runs) against the Pallas stats kernel in interpret mode
  (``flash_attention_stats(..., interpret=True)``). Tolerances: 1e-5 on
  m; relative 1e-5 on l; on acc 1e-5 of its largest entry, since acc is
  a sum whose cancellation leaves some entries near 0, where a relative
  bound per entry says nothing. The kernel scales q first and the plain
  version the scores, as the two JAX forms do: the order of one product.
- ``_merge_stats`` and ``_online_block`` against the JAX functions,
  fully masked (-inf) rows included.
- ``ring_attention`` over four gloo ranks (one ``parallel.launch.spawn``
  for every case) against the JAX ``ring_attention`` on four devices of
  the virtual CPU mesh: both ``use_flash`` settings, causal and full, an
  sp 4 mesh and a dp 2 x sp 2 mesh; tolerance 2e-5, the JAX tests' own
  bound for this path. Malformed specs raise ``ValueError`` in both.

The rank workers below import nothing of JAX: a ``spawn`` child imports
this module to find them, so JAX is imported inside the tests only.
"""

import threading

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_plain, flash_attention_stats, flash_attention_stats_plain)
from mxnet_tpu_torch.parallel import init_distributed, launch, make_mesh
from mxnet_tpu_torch.parallel import ring_attention as ring

RING_TOL = dict(rtol=2e-5, atol=2e-5)
B, H, S, D = 1, 2, 64, 32
#: specs a ring must refuse: the sequence dim not over 'sp' alone, the
#: head dim sharded, 'sp' on another dim too
BAD_SPECS = [(None, None, None, 'sp'), ('sp', None, 'sp', None),
             (None, None, ('dp', 'sp'), None), (None, None, 'dp', None),
             (None, 'sp', 'sp', None)]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(onp.float32)


# -------------------------------------------------------- the stats kernel
@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('bh,t,d', [(2, 64, 32), (3, 64, 64),
                                    (4, 128, 32), (2, 128, 64)])
def test_stats_plain_matches_pallas_interpret(bh, t, d, causal):
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas.flash_attention import \
        flash_attention_stats as jax_stats
    rng = onp.random.default_rng(bh * 1000 + t + d)
    q, k, v = (_randn(rng, bh, t, d) for _ in range(3))
    acc, m, l = (onp.asarray(x) for x in jax_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5, causal,
        True))
    kernels.reset_launch_counts()
    got = flash_attention_stats(*(torch.from_numpy(x) for x in (q, k, v)),
                                d ** -0.5, causal)
    assert kernels.launch_counts()['flash_attention_stats'] == 0   # plain
    assert [tuple(x.shape) for x in got] == [(bh, t, d), (bh, t), (bh, t)]
    assert all(x.dtype == torch.float32 for x in got)
    onp.testing.assert_allclose(got[1].numpy(), m, rtol=0, atol=1e-5)
    onp.testing.assert_allclose(got[2].numpy(), l, rtol=1e-5, atol=0)
    onp.testing.assert_allclose(got[0].numpy(), acc, rtol=0,
                                atol=1e-5 * onp.abs(acc).max())


def test_stats_normalized_is_the_flash_forward():
    """acc / l of the stats form is the normalised form's output (T == S,
    where the diagonal and the bottom-right mask coincide)."""
    rng = onp.random.default_rng(5)
    q, k, v = (torch.from_numpy(_randn(rng, 3, 40, 32)) for _ in range(3))
    for causal in (False, True):
        acc, _, l = flash_attention_stats(q, k, v, 0.2, causal)
        torch.testing.assert_close(
            acc / l[..., None], flash_attention_plain(q, k, v, 0.2, causal),
            rtol=1e-5, atol=1e-6)


def test_stats_refuses_what_it_does_not_take():
    x = torch.zeros(2, 8, 32)
    with pytest.raises(MXNetError, match='T == S'):
        flash_attention_stats(x, torch.zeros(2, 9, 32), torch.zeros(2, 9, 32),
                              0.1, True)
    flash_attention_stats(x, torch.zeros(2, 9, 32), torch.zeros(2, 9, 32),
                          0.1, False)
    with pytest.raises(MXNetError, match='contiguous'):
        flash_attention_stats(x.transpose(1, 2).contiguous().transpose(1, 2),
                              x, x, 0.1, False)
    meta = torch.empty(2, 8, 32, device='meta')
    with pytest.raises(MXNetError, match='CUDA'):
        flash_attention_stats(meta, meta, meta, 0.1, False)


# ------------------------------------------------ merge and online blocks
def _stats_with_masked_rows(rng, *shape):
    """(m, l, o) with some rows fully masked: m = -inf, l = 0, o = 0."""
    m = _randn(rng, *shape)
    m[..., ::3] = -onp.inf
    l = onp.abs(_randn(rng, *shape)) + 0.5
    l[..., ::3] = 0
    o = _randn(rng, *shape, D)
    o[..., ::3, :] = 0
    return m, l, o


def test_merge_stats_matches_jax():
    import jax.numpy as jnp
    from mxnet_tpu.parallel.ring_attention import _merge_stats as jax_merge
    rng = onp.random.default_rng(6)
    first = _stats_with_masked_rows(rng, 2, 3, 12)
    second = list(_stats_with_masked_rows(rng, 2, 3, 12))
    second[0][..., ::2] = -onp.inf           # both masked at rows 0, 6
    second[1][..., ::2] = 0
    second[2][..., ::2, :] = 0
    acc_b = second[2]
    want = jax_merge(*(jnp.asarray(x) for x in first),
                     jnp.asarray(acc_b), jnp.asarray(second[0]),
                     jnp.asarray(second[1]))
    got = ring._merge_stats(*(torch.from_numpy(x) for x in first),
                            torch.from_numpy(acc_b),
                            torch.from_numpy(second[0]),
                            torch.from_numpy(second[1]))
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), rtol=1e-6,
                                    atol=1e-7)
    assert onp.isneginf(got[0].numpy()[..., 0]).all()   # still masked
    assert onp.isfinite(got[2].numpy()).all()


@pytest.mark.parametrize('masked', [False, True], ids=['open', 'masked'])
def test_online_block_matches_jax(masked):
    import jax.numpy as jnp
    from mxnet_tpu.parallel.ring_attention import _online_block as jax_block
    rng = onp.random.default_rng(7)
    q, k, v = (_randn(rng, 1, 2, 8, D) for _ in range(3))
    m, l, o = _stats_with_masked_rows(rng, 1, 2, 8)
    mask = None
    if masked:      # rows 0 and 5 see no key of this block
        mask = onp.tril(onp.ones((8, 8), bool))
        mask[[0, 5]] = False
        mask = mask[None, None]
    want = jax_block(*(jnp.asarray(x) for x in (q, k, v, m, l, o)),
                     D ** -0.5, None if mask is None else jnp.asarray(mask))
    got = ring._online_block(
        *(torch.from_numpy(x) for x in (q, k, v, m, l, o)), D ** -0.5,
        None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), rtol=1e-5,
                                    atol=1e-6)
    if masked:      # row 0 was masked before and is now: still -inf
        assert onp.isneginf(got[0].numpy()[..., 0]).all()


# ------------------------------------------------ the ring, four ranks
def _shard(x, dim, i, n):
    step = x.shape[dim] // n
    return torch.from_numpy(onp.ascontiguousarray(
        x.take(range(i * step, (i + 1) * step), axis=dim)))


def _ring_rank(q, k, v, q2, k2, v2):
    """One rank of the four: every ring case on its shards, then the
    specs a ring must refuse and a mesh too large for the world."""
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    mesh = make_mesh(sp=world)
    shards = [_shard(x, 2, rank, world) for x in (q, k, v)]
    kernels.reset_launch_counts()
    for causal in (False, True):
        for flash in (False, True):
            out['sp4', causal, flash] = ring.ring_attention(
                *shards, mesh, causal=causal, use_flash=flash)
    out['launches'] = kernels.launch_counts()
    mesh2 = make_mesh(dp=2, sp=2)
    dp, sp = mesh2.get_coordinate()
    shards = [_shard(_shard(x, 0, dp, 2).numpy(), 2, sp, 2)
              for x in (q2, k2, v2)]
    for causal in (False, True):
        for flash in (False, True):
            out['dp2sp2', causal, flash] = ring.ring_attention(
                *shards, mesh2, causal=causal, use_flash=flash,
                spec=('dp', None, 'sp', None))
    out['coordinate'] = (dp, sp)
    refused = []
    for spec in BAD_SPECS:
        try:
            ring.ring_attention(*shards, mesh2, spec=spec)
        except ValueError:
            refused.append(spec)
    out['refused'] = refused
    try:
        make_mesh(dp=world, sp=2)
    except MXNetError as e:
        out['too_large'] = str(e)
    return out


@pytest.fixture(scope='module')
def ring_runs():
    """The port's four ranks (in a thread, while JAX computes here) and
    the JAX ring on four devices of the virtual mesh, on the same numpy
    inputs."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from mxnet_tpu.parallel.ring_attention import ring_attention
    rng = onp.random.default_rng(11)
    one = [_randn(rng, B, H, S, D) for _ in range(3)]
    two = [_randn(rng, 2, H, S, D) for _ in range(3)]
    port = {}

    def run():
        try:
            port['ranks'] = launch.spawn(_ring_rank, 4, *one, *two,
                                         timeout=120)
        except BaseException as e:   # raised in the test below
            port['error'] = e

    th = threading.Thread(target=run)
    th.start()
    devs = onp.array(jax.devices()[:4])
    want = {}
    for causal in (False, True):
        for flash in (False, True):
            want['sp4', causal, flash] = onp.asarray(ring_attention(
                *one, Mesh(devs, ('sp',)), causal=causal, use_flash=flash))
        want['dp2sp2', causal] = onp.asarray(ring_attention(
            *two, Mesh(devs.reshape(2, 2), ('dp', 'sp')), causal=causal,
            spec=P('dp', None, 'sp', None), use_flash=False))
    th.join()
    if 'error' in port:
        raise port['error']
    return port['ranks'], want


@pytest.mark.parametrize('flash', [False, True], ids=['plain', 'flash'])
@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
def test_ring_matches_jax_over_four_ranks(ring_runs, causal, flash):
    ranks, want = ring_runs
    got = torch.cat([r['sp4', causal, flash] for r in ranks], dim=2)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), want['sp4', causal, flash],
                                **RING_TOL)


@pytest.mark.parametrize('flash', [False, True], ids=['plain', 'flash'])
@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
def test_ring_on_a_dp_sp_mesh_matches_jax(ring_runs, causal, flash):
    ranks, want = ring_runs
    assert [r['coordinate'] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    got = torch.cat([torch.cat([ranks[2 * dp + sp]['dp2sp2', causal, flash]
                                for sp in range(2)], dim=2)
                     for dp in range(2)], dim=0)
    onp.testing.assert_allclose(got.numpy(), want['dp2sp2', causal],
                                **RING_TOL)


def test_ring_on_cpu_tensors_counts_no_launch(ring_runs):
    """On CPU tensors the stats wrapper takes its plain version, so no
    launch is counted; the blocks each rank computes are counted on the
    card (chip_smoke.py, tests/test_torch_cuda.py)."""
    ranks, _ = ring_runs
    assert all(set(r['launches'].values()) == {0} for r in ranks)


@pytest.mark.parametrize('spec', BAD_SPECS, ids=str)
def test_malformed_specs_raise_as_in_jax(ring_runs, spec):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from mxnet_tpu.parallel.ring_attention import ring_attention
    mesh = Mesh(onp.array(jax.devices()[:4]).reshape(2, 2), ('dp', 'sp'))
    x = jnp.zeros((2, H, S, D), jnp.float32)
    with pytest.raises(ValueError):
        ring_attention(x, x, x, mesh, spec=P(*spec))
    assert all(spec in r['refused'] for r in ring_runs[0])


def test_mesh_larger_than_the_world_raises(ring_runs):
    assert all('mesh needs 8 ranks, have 4' in r['too_large']
               for r in ring_runs[0])


# ------------------------------------------------ without a world
def test_ring_under_autograd_raises():
    """Under autograd the ring is a node of its own (its gradients meet
    JAX's in tests/test_torch_dist.py), and it refuses malformed shards
    as the plain path does."""
    q = torch.zeros(1, 2, 8, 32, requires_grad=True)
    with pytest.raises(MXNetError, match='one shape'):
        ring.ring_attention_kernel(q, q[:, :, :4], q, group=None)


def test_init_distributed_without_environment_is_single_process(
        monkeypatch):
    for var in ('MX_COORDINATOR', 'MX_NPROC', 'MX_PROC_ID'):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert init_distributed(coordinator='localhost:1234',
                            num_processes=1) is False
    with pytest.raises(MXNetError, match='init_distributed'):
        make_mesh(sp=2)


def _fail_or_wait(rank_that_fails):
    import torch.distributed as dist
    if dist.get_rank() == rank_that_fails:
        raise RuntimeError('rank failure on purpose')
    buf = torch.zeros(1)
    dist.recv(buf, src=rank_that_fails)     # never comes: killed


def test_spawn_kills_every_rank_when_one_fails():
    with pytest.raises(MXNetError, match='on purpose') as info:
        launch.spawn(_fail_or_wait, 2, 0, timeout=60)
    assert 'rank 0 of 2 failed' in str(info.value)
