"""The host side of the tiled f32 rollouts: K1 (``csrc/decode_select_tiled.cu``),
K2 (``csrc/decode_all.cu::decode_all_fwd_tiled_kernel``), K5 (two groups
a warp, ``csrc/select_tiled.cuh::decode_select_ilp_tiled_kernel``) and K4
(``csrc/decode_sorted_tiled.cu``).

The kernels run only on the card (``tests/test_torch_port_cuda.py`` holds
them bit for bit against the warp-per-row kernels). What the host decides
for them is checked here: the launch rules (``decoder.tiled_launch``,
``decoder.tiled_ilp_launch``, ``decode_all.fwd_launch``), pure functions of
the row count and the SM count; the summation order of the split
hidden2pos butterfly (``csrc/rollout_tile.cuh``), replayed in float32
against the 32-lane butterfly of the warp-per-row rollout; K5's pairs of
groups (``csrc/tile_buckets.cuh`` with buckets padded to 2R rows) and K4's
tile, group and output mapping, replayed in numpy.
"""

import numpy as np
import pytest

from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decode_sorted as ks
from mggan_tpu_torch.ops.kernels import decoder as kdec

SMS = 132  # an H100 SXM
MAX_TILE = 1024  # csrc/decode_select_tiled.cu::kMaxTile


def _row_counts():
    """0..2,000,000 sampled: every count up to 4,096, powers of two and
    their neighbours, the main paths' counts, and a seeded spread."""
    rng = np.random.RandomState(0)
    special = [960, 4_096, 9_728, 20_480, 81_920, 1_310_720, 2_000_000]
    powers = [p + d for p in 2 ** np.arange(12, 21) for d in (-1, 0, 1)]
    return np.unique(np.concatenate([np.arange(4_097), special, powers,
                                     rng.randint(4_097, 2_000_001, 2_000)]))


@pytest.mark.parametrize("sms", [SMS, 1, 16])
def test_tiled_k1_launch_covers_rows_and_fills_the_card(sms):
    resident = sms * kdec.TILED_BLOCKS_PER_SM
    for n in _row_counts().tolist():
        rows, tile, blocks = kdec.tiled_launch(n, sms)
        assert rows in kdec.TILED_ROWS and 1 <= tile <= MAX_TILE and tile in kdec.TILED_TILES
        tiles = -(-n // tile)
        assert 1 <= blocks <= max(1, min(tiles, resident))
        assert -(-tiles // blocks) * blocks * tile >= n  # persistent blocks stride over tiles
        if -(-n // kdec.TILED_TILES[-1]) >= sms:  # enough rows: every SM gets a block
            assert blocks >= sms
        if rows > 1:  # every resident warp has at least 4 groups of R rows
            assert n >= 4 * rows * resident * kdec.TILED_WARPS


@pytest.mark.parametrize("sms", [SMS, 1, 16])
def test_tiled_k5_launch_covers_rows_and_fills_the_card(sms):
    for n in _row_counts().tolist():
        rows, tile, blocks = kdec.tiled_ilp_launch(n, sms)
        assert rows in kdec.TILED_ILP_ROWS and tile in kdec.TILED_ILP_TILES and tile <= MAX_TILE
        resident = sms * kdec.TILED_BLOCKS_PER_SM
        tiles = -(-n // tile)
        assert 1 <= blocks <= max(1, min(tiles, resident))
        assert -(-tiles // blocks) * blocks * tile >= n  # persistent blocks stride over tiles
        if -(-n // kdec.TILED_ILP_TILES[-1]) >= resident:  # enough rows: every SM gets a block
            assert blocks >= sms
        if tile != kdec.TILED_ILP_TILES[-1]:  # every resident block gets at least 4 tiles
            assert -(-n // tile) >= 4 * resident
        if rows == 4:  # every resident warp has at least 16 pairs of groups of 4 rows
            assert n >= 16 * 2 * rows * resident * kdec.TILED_WARPS


@pytest.mark.parametrize("num_gens", [4, 1, 3])
def test_tiled_k2_launch_covers_rows_and_fills_the_card(num_gens):
    resident = SMS * kda.FWD_BLOCKS_PER_SM
    for n in _row_counts().tolist():
        rows, per_gen = kda.fwd_launch(n, num_gens, SMS)
        assert rows in kdec.TILED_ROWS
        groups = -(-n // (kda.FWD_WARPS * rows))
        assert 1 <= per_gen <= max(1, groups)
        assert -(-groups // per_gen) * per_gen * kda.FWD_WARPS * rows >= n
        if groups * num_gens >= SMS:
            assert per_gen * num_gens >= SMS
        assert per_gen * num_gens <= resident + num_gens  # one wave, rounded up per generator


def _butterfly32(v):
    """rollout_row's nd sum: ``px += shfl_xor(px, s)`` for s = 16 .. 1 over
    32 lanes in float32; returns every lane's sum."""
    v = v.astype(np.float32).copy()
    for s in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ s]).astype(np.float32)
    return v


def _split16(v16):
    """rollout_tile's split sum over one half-warp: + 0 (the first level's
    zero partner), then s = 8 .. 1."""
    v = (v16.astype(np.float32) + np.float32(0.0)).astype(np.float32)
    for s in (8, 4, 2, 1):
        v = (v + v[np.arange(16) ^ s]).astype(np.float32)
    return v


def test_split_hidden2pos_sum_is_the_32_lane_sum():
    """hid = 16: the split butterfly gives every row the same float32 sum,
    signed zeros included, as the 32-lane butterfly whose lanes 16..31 hold
    +0."""
    rng = np.random.RandomState(1)
    cases = [rng.randn(16).astype(np.float32) * 10 ** rng.uniform(-6, 3)
             for _ in range(2_000)]
    cases += [np.full(16, -0.0, np.float32), np.zeros(16, np.float32),
              np.where(np.arange(16) % 2, -0.0, 0.0).astype(np.float32),
              np.array([1e30, -1e30] * 8, np.float32)]
    for v in cases:
        full = _butterfly32(np.concatenate([v, np.zeros(16, np.float32)]))
        split = _split16(v)
        assert np.array_equal(full[:16].view(np.int32), split.view(np.int32))
        assert np.array_equal(full[:16].view(np.int32), full[16:].view(np.int32))


# ---------------------------------------------------------------------------
# K5: the tiled K1 with two groups of R rows of one generator a warp
# (csrc/select_tiled.cuh::decode_select_ilp_tiled_kernel).

def _tile_buckets(idx, num_gens, group):
    """``csrc/tile_buckets.cuh::TileBuckets::bucket`` for one tile's
    generator choices ``idx``, buckets padded to ``group`` slots: counts per
    32-row chunk, each generator's bucket from the exclusive prefix of the
    padded counts, a row's slot its chunk's offset plus its rank among the
    chunk's earlier rows of its generator. Returns ``(slots, group_gen)``:
    slot -> row in the tile (-1 padding), and the generator of every
    ``group`` slots. Rows with no generator take no slot."""
    rows = len(idx)
    chunks = -(-rows // 32)
    live = (idx >= 0) & (idx < num_gens)
    count = np.zeros((chunks, num_gens), np.int64)
    for i in np.nonzero(live)[0]:
        count[i // 32, idx[i]] += 1
    padded = -(-count.sum(0) // group) * group
    start = np.concatenate([[0], np.cumsum(padded)[:-1]])
    offset = start + np.concatenate([np.zeros((1, num_gens), np.int64),
                                     np.cumsum(count, 0)[:-1]])
    slots = np.full(int(padded.sum()), -1)
    for i in np.nonzero(live)[0]:
        c, lane = divmod(i, 32)
        below = np.arange(c * 32, i)
        slots[offset[c, idx[i]] + np.count_nonzero(idx[below] == idx[i])] = i
    group_gen = np.repeat(np.arange(num_gens), padded // group)
    return slots, group_gen


@pytest.mark.parametrize("num_gens,rows_per_warp,n,case", [
    (4, 4, 1024, "uniform"), (4, 2, 700, "skewed"), (1, 4, 333, "uniform"),
    (1, 1, 37, "uniform"), (4, 4, 259, "rows without a generator"), (3, 2, 100, "skewed")])
def test_k5_pairs_cover_every_row_once_on_its_generator(num_gens, rows_per_warp, n, case):
    """K5's buckets, padded to 2R rows, hold every row with a generator
    exactly once, in row order within its generator's bucket; the two
    groups of R rows of a pair share the pair's generator; padding slots
    (out_row -1) store nothing; an odd number of groups leaves a lone group
    paired with a group of padding rows. A row's group and place differ
    from the tiled K1's (buckets padded to R), which leaves its bits alone:
    a row's arithmetic in rollout_tiles does not depend on its slot."""
    rng = np.random.RandomState(n + num_gens)
    idx = rng.randint(0, num_gens, n)
    if case == "skewed":
        idx = np.where(rng.rand(n) < 0.85, num_gens - 1, idx)
    if case == "rows without a generator":
        idx[::7], idx[3::11] = -1, num_gens
    r2 = 2 * rows_per_warp
    slots, group_gen = _tile_buckets(idx, num_gens, r2)
    assert len(slots) % r2 == 0 and len(group_gen) == len(slots) // r2  # whole pairs
    live = (idx >= 0) & (idx < num_gens)
    placed = slots[slots >= 0]
    assert sorted(placed.tolist()) == np.nonzero(live)[0].tolist()  # each live row once
    for g in range(num_gens):
        bucket = slots[np.repeat(group_gen, r2) == g]
        rows = bucket[bucket >= 0]
        assert np.array_equal(rows, np.sort(rows)) and bool((idx[rows] == g).all())
        assert bool((bucket[len(rows):] == -1).all())  # padding only at the bucket's end
    lone = 0
    for p, gen in enumerate(group_gen):
        pair = slots[p * r2:(p + 1) * r2]
        assert bool((idx[pair[pair >= 0]] == gen).all())  # both groups on the pair's generator
        out_row = np.where(pair >= 0, pair, -1)  # the kernel's: base + slot, or -1 (no store)
        assert bool((out_row[pair < 0] == -1).all())
        lone += bool((pair[:rows_per_warp] >= 0).any() and (pair[rows_per_warp:] < 0).all())
    odd = sum(-(-np.count_nonzero(idx == g) // rows_per_warp) % 2 for g in range(num_gens))
    assert lone == odd  # a generator with an odd number of K1's groups ends in a lone group


def test_k5_pairs_include_lone_groups():
    """The cases above reach a lone group (a generator with an odd number
    of groups of R rows), which runs beside a group of padding rows."""
    idx = np.array([0] * 5 + [1] * 8, np.int64)
    slots, group_gen = _tile_buckets(idx, 2, 8)
    assert group_gen.tolist() == [0, 1]
    assert slots[:8].tolist() == [0, 1, 2, 3, 4, -1, -1, -1]  # R = 4: a group, then padding
    assert slots[8:].tolist() == list(range(5, 13))


# ---------------------------------------------------------------------------
# K4: the tiled rollout on the route's tiles (csrc/decode_sorted_tiled.cu).

@pytest.mark.parametrize("variant", range(len(ks.TILED_WARPS)))
def test_k4_tiles_store_abs_and_rel_in_every_buffer_row(variant):
    """The tiled K4's mapping: block t takes tile t; warp w rolls out
    groups w, w + W, ... of R consecutive rows; buffer row i goes to
    rollout_tile as out_row 2i with out_abs = out, out_rel = out + 2T, and
    rollout_tile stores step s of a row as float2 out_row T + s. So abs
    lands at out[i, 0] and rel at out[i, 1], every buffer row once (padding
    rows included), and nothing else is written."""
    rows_per_warp, warps = ks.TILED_GROUP, ks.TILED_WARPS[variant]
    assert ks.TILE % rows_per_warp == 0 and 16 % warps == 0  # whole groups; 16 warps an SM
    tiles, t = 3, 12
    out = np.full(tiles * ks.TILE * 2 * t * 2 // 2, -1, np.int64)  # float2 slots, -1 unwritten
    for tile in range(tiles):
        for w in range(warps):
            for grp in range(w, ks.TILE // rows_per_warp, warps):
                for r in range(rows_per_warp):
                    i = tile * ks.TILE + grp * rows_per_warp + r
                    out_row = 2 * i
                    for s in range(t):
                        for part, base in ((0, 0), (1, t)):  # out_abs, out_rel (float2 offset)
                            slot = base + out_row * t + s
                            assert out[slot] == -1  # written once
                            out[slot] = (i * 2 + part) * t + s
    got = out.reshape(tiles * ks.TILE, 2, t)
    want = np.arange(tiles * ks.TILE * 2 * t).reshape(tiles * ks.TILE, 2, t)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,sms,variant", [
    (9_728, 132, 0), (20_480, 132, 0), (81_920, 132, 1), (1_310_720, 132, 1),
    (1_310_720, 8_192, 0), (0, 132, 0)])
def test_k4_launch_variant_follows_the_buffer(n, sms, variant):
    """``decode_sorted.tiled_variant`` on the route's buffer (``n`` rows of
    4 generators): 8 warps a block while its tiles fit in one wave of 2
    blocks an SM, then 4; the sweep's fastest at 9,728,
    20,480, 81,920 and 1,310,720 rows."""
    n_buf = -(-n // ks.TILE) * ks.TILE + 4 * ks.TILE
    assert ks.tiled_variant(n_buf, sms) == variant
    assert ks.TILED_WARPS[variant] == (4 if n_buf // ks.TILE > 2 * sms else 8)
