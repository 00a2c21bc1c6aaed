"""The host side of the tiled f32 rollouts: K1 (``csrc/decode_select_tiled.cu``)
and K2 (``csrc/decode_all.cu::decode_all_fwd_tiled_kernel``).

The kernels run only on the card (``tests/test_torch_port_cuda.py`` holds
them bit for bit against the warp-per-row kernels). What the host decides
for them is checked here: the launch rules (``decoder.tiled_launch``,
``decode_all.fwd_launch``), pure functions of the row count and the SM
count, and the summation order of the split hidden2pos butterfly
(``csrc/rollout_tile.cuh``), replayed in float32 against the 32-lane
butterfly of the warp-per-row rollout.
"""

import numpy as np
import pytest

from mggan_tpu_torch.ops.kernels import decode_all as kda
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
