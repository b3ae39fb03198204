"""The plans that pick the fused norm's, the int8 product's and flash
attention's designs and paged decode's split count before a launch,
checked on the CPU with no card (``sm_count=132``, the H100's SMs, passed
in).

Every main-path shape of the norm, RMS at (4 / 32 / 2048, 4096) and
LayerNorm at BERT-base's (512, 768), plans a register-resident design:
rows split over thread-block clusters for batches of at most 32 rows, one
block a row above; widths that are not a multiple of 4 or above their
limit, and data off 16-byte alignment, plan the earlier general design.
Block ``r`` of a row takes the vectors ``r * threads * vecs + k * threads
+ t``: the plan's blocks cover every vector exactly once, with the slots
past the row masked.

Every shape the main paths give the kernels must plan the Hopper designs:
the int8 product at M in {4, 32, 512} (a decode step, a prefill chunk, a
(1, 512) forward) over llama3_8b's projections, and flash attention at
T = S in {512, 2048} and at short T against S = 2048. Layouts that TMA
refuses plan the earlier ``sm80`` design. The kernels take their split
boundaries from the plan (split s sums tiles ``s * chunk`` up to ``(s +
1) * chunk``, the last one to the end) and their C entries refuse a plan
that leaves a split empty or a tile unsummed: the plans' splits cover
every K byte and every key exactly once, and the grids reach about two
blocks an SM, in one wave, where the shape allows.
"""

import pytest

from mxnet_tpu_torch.ops.kernels import flash_attention as fa
from mxnet_tpu_torch.ops.kernels import fused_norms as fnorm
from mxnet_tpu_torch.ops.kernels import int8_matmul as im
from mxnet_tpu_torch.ops.kernels import paged_attention as pa

SMS = 132

#: llama3_8b's int8 projections (N, K): attention q, k, v, o, the MLP's
#: gate, up and down, and the LM head
LLAMA3_8B = {'q': (4096, 4096), 'k': (1024, 4096), 'v': (1024, 4096),
             'o': (4096, 4096), 'gate': (14336, 4096),
             'up': (14336, 4096), 'down': (4096, 14336),
             'head': (128256, 4096)}


def _covered(n, splits, chunk):
    """The tiles each split takes, as the kernels take them from the
    plan, after the check their C entries make."""
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < n <= splits * chunk
    return [list(range(s * chunk, min(n, (s + 1) * chunk)))
            for s in range(splits)]


# -------------------------------------------------------------- fused norm
#: (rows, width, RMS, design) of the norm on the main paths: llama3_8b's
#: RMS at a decode step and a prefill chunk (rows split over clusters) and
#: over a training batch, and BERT-base's LayerNorm over a (512, 768)
#: batch and a short one
NORM_MAIN = [(4, 4096, True, 'cluster'), (32, 4096, True, 'cluster'),
             (2048, 4096, True, 'regs'), (512, 768, False, 'regs'),
             (4, 768, False, 'regs')]


def _norm_owners(p, d):
    """``{vector: (block, thread, k)}`` over the slots of a row's blocks
    that fall inside the row, by the plan's docstring (the kernel's
    formula); fails on a vector taken twice."""
    owners = {}
    for r in range(p.cluster):
        for t in range(p.threads):
            for k in range(p.vecs):
                j = r * p.threads * p.vecs + k * p.threads + t
                if j < d // 4:
                    assert j not in owners
                    owners[j] = (r, t, k)
    return owners


@pytest.mark.parametrize('n,d,rms,design', NORM_MAIN)
def test_norm_main_path_shapes_plan_the_register_designs(n, d, rms, design):
    p = fnorm.plan(n, d, True, SMS, rms)
    assert p.path == design
    threads = fnorm.CLUSTER_THREADS if design == 'cluster' \
        else fnorm.REGS_THREADS
    assert p.threads in threads and p.vecs in fnorm.VECS
    assert sorted(_norm_owners(p, d)) == list(range(d // 4))


def test_norm_plan_at_llama_and_bert_widths():
    """llama3_8b's 4096, RMS: a decode step's 4 rows over clusters of 8
    blocks of one warp (32 blocks), a prefill chunk's 32 over clusters of
    4 (128 blocks, one wave on 132 SMs); 33 rows and more, and LayerNorm
    at any rows, one block of 256 threads a row; BERT-base's 768 64
    threads of three vectors. Every slot of these blocks holds a
    vector."""
    regs = fnorm.Plan('regs', 256, 4, 1)
    assert fnorm.plan(4, 4096, True, SMS, True) == fnorm.Plan('cluster', 32,
                                                              4, 8)
    assert fnorm.plan(32, 4096, True, SMS, True) == fnorm.Plan('cluster', 64,
                                                               4, 4)
    assert fnorm.plan(33, 4096, True, SMS, True) == regs
    assert fnorm.plan(2048, 4096, True, SMS, True) == regs
    assert fnorm.plan(4, 4096, True, SMS, False) == regs
    assert fnorm.plan(512, 768, True, SMS, False) == fnorm.Plan('regs', 64,
                                                                3, 1)


@pytest.mark.parametrize('n,d,aligned', [
    (4, 4098, True), (4, 6, True), (2049, 1001, True),   # d % 4 != 0
    (4, 4096, False), (512, 768, False),                 # unaligned data
    (3, 12288, True), (1, fnorm.MAX_D + 4, True)])      # above the limit
def test_norm_plans_the_general_design_for_what_regs_does_not_take(
        n, d, aligned):
    assert fnorm.MAX_D == 8192
    for rms in (True, False):
        assert fnorm.plan(n, d, aligned, SMS, rms) == fnorm.Plan(
            'general', fnorm.GENERAL_THREADS, 0, 1)


@pytest.mark.parametrize('rms', [True, False], ids=['rms', 'layer'])
@pytest.mark.parametrize('n', [1, 4, 17, 32, 33, 2048])
@pytest.mark.parametrize('d', [4, 64, 100, 256, 768, 1024, 2048, 4096, 4100,
                               5120, 6144, 8188, 8192])
def test_norm_blocks_cover_the_row_exactly_once(n, d, rms):
    """Every vector of the row in exactly one slot, the slots past it
    masked, and no vector column of a row's last block all masked, which
    the C entry refuses (threads * (vecs * cluster - 1) < d / 4 <= threads
    * vecs * cluster); among the blocks that meet that, the fewest idle
    slots."""
    p = fnorm.plan(n, d, True, SMS, rms)
    assert p.path in ('regs', 'cluster')
    nv = d // 4
    assert p.threads * (p.vecs * p.cluster - 1) < nv <= \
        p.threads * p.vecs * p.cluster
    assert sorted(_norm_owners(p, d)) == list(range(nv))
    threads = fnorm.CLUSTER_THREADS if p.path == 'cluster' \
        else fnorm.REGS_THREADS
    assert p.threads * p.vecs * p.cluster - nv == min(
        t * v * p.cluster - nv for t in threads for v in fnorm.VECS
        if t * v * p.cluster >= nv > t * (v * p.cluster - 1))


@pytest.mark.parametrize('n', [1, 2, 4, 16, 17, 32, 33, 64, 2048])
@pytest.mark.parametrize('d', [256, 768, 4096, 8192])
@pytest.mark.parametrize('sms', [8, 66, 132])
def test_norm_cluster_plan_stays_within_the_cluster_limit(n, d, sms):
    """Clusters of 2, 4 or 8 blocks (8 the portable limit), only for RMS
    batches of at most 32 rows, all blocks in one wave (n * cluster <= the
    SMs), at most 32 partials a sum; otherwise, and for LayerNorm, one
    block a row."""
    assert fnorm.plan(n, d, True, sms, False).path == 'regs'
    p = fnorm.plan(n, d, True, sms, True)
    if p.path == 'cluster':
        assert n <= fnorm.CLUSTER_ROWS
        assert p.cluster in fnorm.CLUSTERS and max(fnorm.CLUSTERS) == 8
        assert n * p.cluster <= sms
        assert p.cluster * p.threads // 32 <= fnorm.MAX_PARTS == 32
    else:   # too many rows, or no cluster that fits one wave splits d
        assert p == fnorm.Plan('regs', p.threads, p.vecs, 1)
        assert n > fnorm.CLUSTER_ROWS or all(
            fnorm._fit(d // 4, fnorm.CLUSTER_THREADS, c) is None
            for c in fnorm.CLUSTERS if n * c <= sms)


def test_norm_plan_takes_shapes_only():
    import inspect
    # elems: the elements of x in a 16-byte vector, from its dtype
    assert list(inspect.signature(fnorm.plan).parameters) == [
        'n', 'd', 'aligned', 'sm_count', 'rms', 'elems']
    assert fnorm.PATHS == ('regs', 'cluster', 'general')


@pytest.mark.parametrize('proj', sorted(LLAMA3_8B))
@pytest.mark.parametrize('m', [4, 32, 512])
def test_int8_main_path_shapes_plan_the_hopper_designs(m, proj):
    n, k = LLAMA3_8B[proj]
    p = im.plan(m, n, k, True, SMS)
    ktiles = -(-k // im.TMA_BK)
    assert 1 <= p.splits <= min(ktiles, im.MAX_SPLITS)
    assert sum(_covered(ktiles, p.splits, p.chunk), []) == list(range(ktiles))
    blocks = p.tiles * p.splits
    if m <= 64:
        # out^T = w x^T: 64 weight rows against x's rows rounded up to a
        # wgmma width
        assert p.path == 'tma_splitk'
        assert (p.tile_a, p.tile_b) == (64, 8 if m <= 8 else 32)
        assert p.tiles == -(-n // 64)
        # one wave of two blocks an SM: one more split would not fit,
        # unless K or the split cap runs out first
        assert blocks <= max(2 * SMS, p.tiles)
        assert blocks + p.tiles > 2 * SMS or p.splits in (
            ktiles, im.MAX_SPLITS)
    else:
        assert p.path == 'tma' and (p.tile_a, p.tile_b) == (128, 128)
        assert p.tiles == -(-m // 128) * -(-n // 128)
        # K is split only when the tiles leave whole SMs idle
        assert p.splits == max(1, min(SMS // p.tiles, ktiles, 32))
        assert blocks <= max(SMS, p.tiles)
    assert p.workspace == (p.tiles * p.splits * p.tile_a * p.tile_b
                           if p.splits > 1 else 0)


@pytest.mark.parametrize('m', [1, 8, 9, 16, 17, 32, 33, 64])
def test_int8_plan_rounds_m_up_to_a_wgmma_width(m):
    p = im.plan(m, 4096, 4096, True, SMS)
    assert p.path == 'tma_splitk'
    assert p.tile_b == min(w for w in (8, 16, 32, 64) if w >= m)
    assert im.plan(65, 4096, 4096, True, SMS).path == 'tma'


@pytest.mark.parametrize('aligned,k', [(False, 4096), (True, 4100),
                                       (False, 4100), (True, 200),
                                       (True, 8)])
def test_int8_layouts_tma_refuses_plan_sm80(aligned, k):
    """x or w off 16-byte alignment, or K not a multiple of 16, keep the
    earlier sm80 kernel; a K that is a multiple of 16 and aligned data
    take TMA."""
    for m in (4, 32, 512):
        p = im.plan(m, 1000, k, aligned, SMS)
        want = 'sm80' if not aligned or k % 16 else (
            'tma_splitk' if m <= 64 else 'tma')
        assert p.path == want
        if want == 'sm80':
            assert p.splits == 1 and p.workspace == 0


@pytest.mark.parametrize('k', [200, 4100, 131071, 14336, 208, 4112, 16,
                               128, 131056])
def test_int8_k_splits_cover_k_exactly_once(k):
    """Each K byte is summed by exactly one split, which sums at least one
    whole 128-byte tile, for every N from one 64-row tile up to two
    waves, at M 4 and 512: ragged K whose last tile is part full included.
    A K that is not a multiple of 16 (200, 4100, 131071) plans the sm80
    design, which walks all of K in one block."""
    ktiles = -(-k // im.TMA_BK)
    seen = set()
    for m in (4, 512):
        for n in range(64, 2 * SMS * 64 + 1, 64):
            p = im.plan(m, n, k, True, SMS)
            if k % 16:
                assert (p.path, p.splits, p.workspace) == ('sm80', 1, 0)
                continue
            seen.add(p.splits)
            tiles = _covered(ktiles, p.splits, p.chunk)
            assert all(tiles)
            covered = [b for t in tiles for b in range(
                t[0] * im.TMA_BK, min(k, (t[-1] + 1) * im.TMA_BK))]
            assert covered == list(range(k))
    if k % 16 == 0:     # the split paths were planned where K allows them
        assert max(seen) == min(ktiles, im.MAX_SPLITS) or max(seen) > 8


@pytest.mark.parametrize('t,s', [(512, 512), (2048, 2048), (37, 2048),
                                 (1, 2048), (64, 2048), (65, 2048)])
@pytest.mark.parametrize('d', [32, 64, 128])
def test_flash_main_path_shapes_plan_the_tensor_core_designs(t, s, d):
    bh = 32
    p = fa.plan(bh, t, s, d, SMS)
    blocks = bh * -(-t // fa.BLOCK_Q)
    nt = -(-s // p.block_k)
    assert p.block_k == (32 if d == 128 else 64)
    assert p.blocks == blocks
    assert sum(_covered(nt, p.splits, p.chunk), []) == list(range(nt))
    if blocks >= SMS:
        # a long T fills the card unsplit
        assert p.path == 'tf32x3' and p.splits == 1 and p.workspace == 0
    else:
        assert p.path == 'tf32x3_splitkv' and p.splits > 1
        assert blocks * p.splits <= 2 * SMS
        assert blocks * (p.splits + 1) > 2 * SMS or p.splits == min(
            nt, fa.MAX_SPLITS)
        assert p.workspace == blocks * p.splits * fa.BLOCK_Q * (d + 2)


def test_flash_plan_splits_at_llama_widths():
    """T = S = 512 (a (1, 512) forward), 2048 (a train step, the ring's
    blocks) unsplit; T 37 against S 2048 split."""
    assert fa.plan(32, 512, 512, 128, SMS).path == 'tf32x3'
    assert fa.plan(32, 2048, 2048, 128, SMS).path == 'tf32x3'
    p = fa.plan(32, 37, 2048, 128, SMS)
    assert p.path == 'tf32x3_splitkv' and p.splits == 8


@pytest.mark.parametrize('s', [1, 37, 2048, 2049])
@pytest.mark.parametrize('block_k', [32, 64])
def test_flash_key_splits_cover_s_exactly_once(s, block_k):
    """Every key is taken by exactly one split, which takes at least one
    key tile (32 keys at d 128, 64 below), for every batch*head count
    from one block up to a full wave."""
    d = 128 if block_k == 32 else 64
    for bh in range(1, SMS + 1):
        p = fa.plan(bh, 1, s, d, SMS)
        assert p.block_k == block_k
        nt = -(-s // p.block_k)
        tiles = _covered(nt, p.splits, p.chunk)
        assert all(tiles)
        covered = [j for t in tiles for j in range(
            t[0] * p.block_k, min(s, (t[-1] + 1) * p.block_k))]
        assert covered == list(range(s))


# ------------------------------------------------------------ paged decode
#: the decode step's shapes: 4 slots, llama3_8b's 8 KV heads, 128 pages of
#: 16 a row (max_length 2048)
PAGED_MAIN = dict(b=4, kv=8, np_=128, psz=16)


def _live_tiles(offset, np_, psz):
    """The live tiles of a row at ``offset``, by the plan's docstring."""
    end = 0 if offset < 0 else min(offset + 1, np_ * psz)
    return -(-end // pa.TILE)


def _split_tiles(n_live, split, splits):
    """The tiles split ``split`` of ``splits`` takes, by the plan's
    docstring (the kernel's formula)."""
    return range(n_live * split // splits, n_live * (split + 1) // splits)


def test_paged_plan_takes_shapes_only():
    """The split count is a function of the shapes and the SM count, never
    of the offsets or the block table, so one launch serves every depth
    (and a CUDA graph of it stays right when both are rewritten)."""
    import inspect
    assert list(inspect.signature(pa.plan).parameters) == [
        'b', 'kv', 'np_', 'psz', 'sm_count']
    assert pa.PATHS == tuple(f'splits{n}' for n in
                             range(1, pa.MAX_SPLITS + 1))


@pytest.mark.parametrize('b,kv,np_,psz', [
    (4, 8, 128, 16), (3, 8, 8, 16), (1, 8, 128, 16), (64, 8, 128, 16),
    (3, 2, 5, 4), (3, 2, 40, 16), (1, 1, 1, 1), (2, 8, 7, 32),
    (256, 32, 2048, 16)])
def test_paged_plan_stays_within_the_cluster_limit(b, kv, np_, psz):
    """At most 8 splits (the largest portable cluster, which the C entry
    takes), at most one a tile of the table, and at least one; the blocks
    stay within one and a half an SM unless one split is already more."""
    n = pa.plan(b, kv, np_, psz, SMS)
    tiles = -(-np_ * psz // pa.TILE)
    assert pa.MAX_SPLITS == 8
    assert 1 <= n <= min(pa.MAX_SPLITS, tiles)
    assert b * kv * n <= 3 * SMS // 2 or n == 1


def test_paged_plan_at_the_decode_step():
    """4 rows x 8 KV heads: 6 splits, 192 blocks on the 132 SMs; at depth
    1024 (65 live pages) every split takes 10 or 11 pages, where the
    table's width once gave 16, 16, 16, 16, 1 and three empty splits."""
    n = pa.plan(sm_count=SMS, **PAGED_MAIN)
    assert n == 6
    live = _live_tiles(1024, PAGED_MAIN['np_'], PAGED_MAIN['psz'])
    assert live == 65
    sizes = [len(_split_tiles(live, s, n)) for s in range(n)]
    assert sum(sizes) == live and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize('np_,psz', [(128, 16), (8, 16), (5, 4), (7, 32),
                                     (3, 1)])
def test_paged_splits_cover_every_live_position_once(np_, psz):
    """For every depth from 0 to the table's end (and past it, and a
    negative offset), with the plan's split count and every other one up to
    the cluster limit: each live position falls in the tiles of exactly one
    split, and no split takes a tile past the row's depth."""
    L = np_ * psz
    for n in range(1, pa.MAX_SPLITS + 1):
        for off in list(range(-1, L)) + [L, L + 40]:
            live = _live_tiles(off, np_, psz)
            owner = {}
            for s in range(n):
                for t in _split_tiles(live, s, n):
                    assert t not in owner
                    owner[t] = s
            assert sorted(owner) == list(range(live))
            positions = range(0, min(off + 1, L)) if off >= 0 else ()
            assert {p // pa.TILE for p in positions} == set(owner)
