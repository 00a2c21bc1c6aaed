"""The host side of the bf16 tensor-core rollouts: K1-bf16
(``csrc/decode_select_mma.cu``) and K2-bf16 (``csrc/decode_all.cu::
decode_all_fwd_mma_kernel``), which share ``csrc/rollout_mma.cuh``.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``).
What the host computes for them is checked here: the fragment image of the
weights (``decoder.mma_weights``), K1-bf16's rows per tile
(``decoder.mma_tile_rows``) and K2-bf16's launch (``decode_all.mma_launch``).
The image is read back through the operand layouts of ``mma.sync.m16n8k16``
/ ``m16n8k8`` (PTX ISA, bf16 operands, f32 accumulators: lane l is row
``l // 4``, quad ``l % 4``) and rolled out on groups of 16 rows the way
``rollout_group`` does, accumulator fragments feeding the next step's A
fragments; K2-bf16's grouping (16 consecutive rows of one generator, the
last group padded with rows that store nothing) and its store of (h, c)
from the accumulator layout are replayed with the kernel's index
arithmetic. That rollout must reproduce the bf16 plain version, whose own
agreement with the TPU kernel in interpret mode
``tests/test_torch_port_bf16.py`` holds.
"""

import numpy as np
import pytest
import torch

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decode_sorted as ks
from mggan_tpu_torch.ops.kernels import decoder as kdec

T = 12
SMS = 132  # an H100 SXM
ROW, QUAD = torch.arange(32) // 4, torch.arange(32) % 4
_i4, _i2, _e = torch.arange(4)[None, :, None], torch.arange(2)[None, :, None], \
    torch.arange(2)[None, None, :]
# A (16 x 16): lane l, register i, half e -> (row, col)
A16 = (ROW[:, None, None] + 8 * (_i4 % 2), 2 * QUAD[:, None, None] + _e + 8 * (_i4 // 2))
A8 = (ROW[:, None, None] + 8 * _i2, 2 * QUAD[:, None, None] + _e)  # A (16 x 8)
B16 = (2 * QUAD[:, None, None] + _e + 8 * _i2, ROW[:, None, None])  # B (16 x 8): (k, n)
B8 = (2 * QUAD[:, None] + torch.arange(2)[None, :], ROW[:, None])  # B (8 x 8)
C = (ROW[:, None] + 8 * (torch.arange(4)[None, :] // 2), 2 * QUAD[:, None]
     + torch.arange(4)[None, :] % 2)  # C/D (16 x 8): lane l, element i -> (row, col)


def _bf(x):
    return x.to(torch.bfloat16).float()


def _pairs(words):
    """float32 words -> their two bf16 values (low half first), as floats."""
    return words.contiguous().view(torch.bfloat16).float().reshape(*words.shape, 2)


def _mma(acc, a, b, a_map, b_map, k):
    """acc (B, 32, 4) += A . B for B groups, A given as per-lane fragment
    registers (B, 32, ...) and B (one generator's) as (32, ...)."""
    a_mat, b_mat = torch.zeros(a.shape[0], 16, k), torch.zeros(k, 8)
    a_mat[:, a_map[0].expand(a.shape[1:]), a_map[1].expand(a.shape[1:])] = a
    b_mat[b_map[0].expand(b.shape), b_map[1].expand(b.shape)] = b
    return acc + (a_mat @ b_mat)[:, C[0], C[1]]


def _emulate(image, h, hid, fmt, h0, sb, xy, dxdy):
    """The kernel's rollout of B groups of 16 rows on one generator's
    image: h0 (B, 16, h), sb (B, 16, hid), xy and dxdy (B, 16, 2) ->
    abs, rel (B, 16, T, 2) and each step's (h, c) of every lane's two
    units of each unit group, (T, u, B, 32 lanes, 4 accumulator elements)
    each (h as the bf16 value packed into the next A fragment)."""
    whh = _pairs(image[:2048]).reshape(4, 4, 32, 4, 2)
    wemb = _pairs(image[2048:2560]).reshape(4, 32, 4, 2)
    w1 = _pairs(image[2560:3072]).reshape(4, 32, 4, 2)
    bias, w2, b2 = image[3072:3200].reshape(4, 4, 8), image[3200:3264].reshape(16, 4), \
        image[3264:3266]
    pad = lambda x, n: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    bsz = h0.shape[0]
    h0p, sbp = pad(h0, 32), pad(sb, 32)
    ha = _bf(torch.stack([h0p[:, A16[0], A16[1]], h0p[:, A16[0], A16[1] + 16]]))
    sbf = torch.stack([sbp[:, C[0], C[1] + 8 * nt] for nt in range(4)])  # (nt, B, 32, 4)
    x, y, dx, dy = xy[..., 0], xy[..., 1], dxdy[..., 0], dxdy[..., 1]
    c = torch.zeros(4, bsz, 32, 4)
    out_abs, out_rel, h_seq, c_seq = [], [], [], []
    for _ in range(T):
        te = {"rel": [dx, dy], "abs": [x, y], "abs_rel": [x, y, dx, dy]}[fmt]
        ta = _bf(pad(torch.stack(te, -1), 8))[:, A8[0], A8[1]]
        hn = torch.zeros(2, bsz, 32, 4, 2)
        h_step = torch.zeros(4, bsz, 32, 4)
        for u in range((h + 7) // 8):
            acc = []
            for gate in range(4):
                b = bias[u, gate][2 * QUAD[:, None] + torch.arange(2)[None, :]]  # (32, 2)
                a = b.repeat(1, 2).expand(bsz, 32, 4)
                a = _mma(a, ta, wemb[u, :, gate], A8, B8, 8)
                for kt in range(2):
                    a = _mma(a, ha[kt], whh[u, gate][:, 2 * kt:2 * kt + 2], A16, B16, 16)
                acc.append(a)
            i, f, g, o = acc
            c[u] = torch.sigmoid(f) * c[u] + torch.sigmoid(i) * torch.tanh(g)
            hv = torch.sigmoid(o) * torch.tanh(c[u])  # (B, 32, 4): rows r, r+8 x 2 units
            hn[u // 2, :, :, (u % 2) * 2] = hv[..., 0:2]
            hn[u // 2, :, :, (u % 2) * 2 + 1] = hv[..., 2:4]
            h_step[u] = _bf(hv)
        h_seq.append(h_step)
        c_seq.append(c.clone())
        ha = _bf(hn)
        px, py = torch.zeros(bsz, 32, 2), torch.zeros(bsz, 32, 2)
        for nt in range((hid + 7) // 8):
            pre = sbf[nt]
            for kt in range(2):
                pre = _mma(pre, ha[kt], w1[nt][:, 2 * kt:2 * kt + 2], A16, B16, 16)
            a = _bf(torch.where(pre > 0, pre, 0.01 * pre))
            w2q = w2[nt * 4 + QUAD]  # (32, 4): rows 8nt+2q, +1 of W2, (x, y) each
            px += a[..., 0::2] * w2q[:, 0:1] + a[..., 1::2] * w2q[:, 2:3]
            py += a[..., 0::2] * w2q[:, 1:2] + a[..., 1::2] * w2q[:, 3:4]
        # the quad's sums: rows r (lanes 4r..4r+3, index 0) and r + 8 (index 1)
        px, py = px.reshape(bsz, 8, 4, 2).sum(2), py.reshape(bsz, 8, 4, 2).sum(2)
        dx = px.transpose(1, 2).reshape(bsz, 16) + b2[0]
        dy = py.transpose(1, 2).reshape(bsz, 16) + b2[1]
        x, y = x + dx, y + dy
        out_abs.append(torch.stack([x, y], -1))
        out_rel.append(torch.stack([dx, dy], -1))
    return torch.stack(out_abs, 2), torch.stack(out_rel, 2), torch.stack(h_seq), \
        torch.stack(c_seq)


@pytest.mark.parametrize("inp_format,h_dim", [("rel", 32), ("abs", 32), ("abs_rel", 20)])
def test_fragment_image_rolls_out_like_the_plain_version(inp_format, h_dim):
    gen = torch.Generator().manual_seed(h_dim)
    stacked = common.stacked_decoders_init(gen, 2, h_dim // 2, h_dim, inp_format, 8)
    rng = np.random.RandomState(0)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    xy, dxdy, soc, h0 = f32(16, 2), f32(16, 2) * 0.3, f32(16, 8), f32(16, h_dim)
    packed = kdec.pack_decoder_params(stacked, inp_format)
    image = kdec.mma_weights(packed)
    assert image.shape == (2, 3268) and image.dtype == torch.float32
    socb = kdec.social_bias(packed, soc)
    hid = packed["w1h"].shape[2]
    got = [x[0] for x in _emulate(image[1], h_dim, hid, inp_format, h0[None], socb[None, :, 1],
                                  xy[None], dxdy[None])[:2]]
    idx = torch.ones(16, dtype=torch.int32)
    want = kdec.decode_select_reference(stacked, xy, dxdy, soc, h0, idx, T, inp_format,
                                        compute_dtype=torch.bfloat16)
    f32_plain = kdec.decode_select_reference(stacked, xy, dxdy, soc, h0, idx, T, inp_format)
    for a, b, w in zip(got, want, f32_plain):
        # another summation order; a flip of one h's bf16 rounding moves a
        # position by up to ~2e-3 (the bf16 limit of the CPU tests)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)
        assert float((a - b).abs().mean()) < 1e-4
        assert float((w - b).abs().max()) > 2e-4  # the f32 rollout is another function


def test_fragment_image_rejects_widths_beyond_the_fragments():
    stacked = common.stacked_decoders_init(torch.Generator().manual_seed(0), 2, 8, 40, "rel", 8)
    with pytest.raises(ValueError, match="H, hid <= 32"):
        kdec.mma_weights(kdec.pack_decoder_params(stacked, "rel"))


@pytest.mark.parametrize("n,sms,tile", [
    (9_728, 132, 64),  # eval's batch: 152 tiles of 64 rows, every SM busy
    (1_310_720, 132, 256),  # bench.py's sampling batch
    (20_480, 132, 128),
    (960, 132, 32),  # fewer rows than SMs x 32: the smallest tile
    (0, 132, 32),
])
def test_tile_rows_fill_the_card(n, sms, tile):
    assert kdec.mma_tile_rows(n, sms) == tile
    if tile != kdec.MMA_TILES[-1]:
        assert -(-n // tile) >= sms  # every SM gets a tile
    if tile != kdec.MMA_TILES[0]:
        assert -(-n // (2 * tile)) < sms  # and the next larger tile would not do that


# ---------------------------------------------------------------------------
# K2-bf16: every generator on groups of 16 consecutive rows, (h, c) saved.

def _decode_all_bf16_emulated(packed, socb, h0, xy, dxdy, fmt):
    """K2-bf16 as ``decode_all_fwd_mma_kernel`` runs it: per generator g, the
    rows in groups of 16 consecutive rows (row 16k + j in group k, lane row
    j % 8, fragment half j // 8), rows past N computing on zeros and storing
    nothing; abs/rel at ``((g N + row) T + t) 2``, and each lane's (h, c)
    pairs at ``((g N + row) T + t) 2 H + col`` (+ H for c) from the
    accumulator layout, units col < H only. Returns the flat outputs
    reshaped to abs, rel (G, N, T, 2) and hc (G, N, T, 2, H), NaN where
    nothing was stored."""
    image = kdec.mma_weights(packed)
    g_count, h, hid = image.shape[0], packed["w_hh"].shape[1], packed["w1h"].shape[2]
    n, m = h0.shape[0], xy.shape[0]
    groups = -(-n // 16)
    rows = torch.arange(groups * 16)
    live = rows < n
    src = torch.where(live, rows, 0)
    zero_dead = lambda x: torch.where(live.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
    nan = float("nan")
    out = {k: torch.full((g_count * n * T * 2,), nan) for k in ("abs", "rel")}
    hc = torch.full((g_count * n * T * 2 * h,), nan)
    for g in range(g_count):
        per_group = lambda x: zero_dead(x).reshape((groups, 16) + tuple(x.shape[1:]))
        a, r, hs, cs = _emulate(image[g], h, hid, fmt, per_group(h0[src]),
                                per_group(socb[src % m, g]), per_group(xy[src % m]),
                                per_group(dxdy[src % m]))
        out_row = g * n + rows[live]
        for t in range(T):
            at = (out_row * T + t) * 2
            for key, val in (("abs", a), ("rel", r)):
                v = val.reshape(-1, T, 2)[live, t]
                out[key][at], out[key][at + 1] = v[:, 0], v[:, 1]
        # lane l, element e of unit group u: row C[0][l, e] of its group, unit 8u + C[1][l, e]
        row = torch.arange(groups)[:, None, None] * 16 + C[0][None]  # (B, 32, 4)
        for u in range((h + 7) // 8):
            col = (8 * u + C[1])[None].expand(row.shape)
            keep = (row < n) & (col < h)
            for t in range(T):
                at = ((g * n + row) * T + t) * 2 * h + col
                hc[at[keep]] = hs[t, u][keep]
                hc[(at + h)[keep]] = cs[t, u][keep]
    shape = (g_count, n, T, 2)
    return out["abs"].reshape(shape), out["rel"].reshape(shape), hc.reshape(shape + (h,))


@pytest.mark.parametrize("num_gens,n_agents,k,inp_format,h_dim", [
    (1, 1, 1, "rel", 32), (4, 15, 1, "rel", 32), (1, 17, 1, "abs_rel", 20),
    (4, 17, 1, "abs", 32), (4, 37, 20, "rel", 32)])
def test_k2_bf16_groups_and_hc_store_roll_out_like_the_plain_version(num_gens, n_agents, k,
                                                                     inp_format, h_dim):
    """K2-bf16's grouping of consecutive rows and its (h, c) store from the
    accumulator layout, at N = 1, 15, 17 (a group and one row: a ragged
    last group) and 37 x 20 (M < N) rows of G = 1 and 4 generators: every
    (row, generator) is written, abs, rel and hc match the bf16 plain
    version within 2e-3, and every saved h is a bf16 value."""
    gen = torch.Generator().manual_seed(num_gens * 100 + n_agents)
    stacked = common.stacked_decoders_init(gen, num_gens, h_dim // 2, h_dim, inp_format, 8)
    rng = np.random.RandomState(n_agents)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    xy, dxdy, soc = f32(n_agents, 2), f32(n_agents, 2) * 0.3, f32(n_agents, 8)
    h0 = f32(n_agents * k, h_dim)
    packed = kdec.pack_decoder_params(stacked, inp_format)
    socb = kdec.social_bias(packed, soc)
    got = _decode_all_bf16_emulated(packed, socb, h0, xy, dxdy, inp_format)
    inputs = [packed[key] for key in kdec.PACKED] + [socb, h0, xy, dxdy]
    want = kda.decode_all_reference(*inputs, T, inp_format, save_hc=True,
                                    compute_dtype=torch.bfloat16)
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()  # every (row, generator) stored
        # another summation order; a flip of one h's bf16 rounding moves a
        # position by up to ~2e-3 (the bf16 limit of the CPU tests)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-3)
    h = got[2][..., 0, :]
    assert torch.equal(h, h.to(torch.bfloat16).float())


@pytest.mark.parametrize("num_gens", [4, 1, 3, 40])
def test_k2_bf16_launch_covers_rows_and_fills_the_card(num_gens):
    """``decode_all.mma_launch`` over 0..2,000,000 rows (sampled): a known
    variant, one block per 4 groups of 16 rows (no block without a group),
    every row of every generator covered by the kernel's warp-strided
    groups, every SM given a block once there are enough groups, and the
    variant the one with the fewest waves of resident warps (4 blocks an SM
    on a tie)."""
    rng = np.random.RandomState(num_gens)
    counts = np.unique(np.concatenate([np.arange(300), [4_096, 9_728, 81_920, 1_310_720],
                                       rng.randint(300, 2_000_001, 500)]))
    for n in counts.tolist():
        variant, per_gen = kda.mma_launch(n, num_gens, SMS)
        groups = -(-n // 16)
        warps = per_gen * kda.MMA_WARPS  # a generator's warps, striding over its groups
        assert variant in (0, 1) and per_gen == max(1, -(-groups // kda.MMA_WARPS))
        assert -(-groups // warps) * warps * 16 >= n
        if groups * num_gens >= SMS * kda.MMA_WARPS:
            assert per_gen * num_gens >= SMS
        waves = [-(-groups * num_gens // (SMS * b * kda.MMA_WARPS)) for b in kda.MMA_BLOCKS_PER_SM]
        assert waves[variant] == min(waves) and (variant == 0 or waves[1] < waves[0])
        if n <= 64:  # the kernel's row formula, enumerated: every row once per generator
            seen = sorted(grp * 16 + j for w in range(warps) for grp in range(w, groups, warps)
                          for j in range(16) if grp * 16 + j < n)
            assert seen == list(range(n))


@pytest.mark.parametrize("n,variant", [(4_096, 0), (9_728, 1), (20_480, 1), (81_920, 1)])
def test_k2_bf16_launch_picks_the_swept_variant(n, variant):
    """At the swept row counts (x 4 generators, 132 SMs) the rule picks the
    variant the sweep found fastest: 4 blocks an SM where both take the
    groups in one wave (4,096), else 5 (9,728: one wave of 20 warps an SM
    instead of 1.15 of 16)."""
    assert kda.mma_launch(n, 4, SMS)[0] == variant


# ---------------------------------------------------------------------------
# K5-bf16: K1-bf16's tiles and buckets, two groups of 16 rows a warp.

def _select_bf16_emulated(packed, socb, h0, xy, dxdy, idx, fmt, tile, bucket):
    """K1-bf16 (``bucket`` = 16) or K5-bf16 (``bucket`` = 32, a warp per
    pair of groups) as ``decode_select_mma.cu`` maps rows: tiles of ``tile``
    consecutive rows; in each, every generator's rows in order (a stable
    bucket) from a start padded to ``bucket`` slots; each run of 16 slots a
    group, K5-bf16's pairs being slots 32p..32p+31 of a bucket, a lone
    group's partner all padding. Each generator's groups go through
    ``_emulate`` at once (padding rows on zeros, storing nothing); rows
    without a generator are NaN. Returns abs, rel (N, T, 2) and the number
    of groups rolled out."""
    image = kdec.mma_weights(packed)
    g_count, h, hid = image.shape[0], packed["w_hh"].shape[1], packed["w1h"].shape[2]
    n, m = h0.shape[0], xy.shape[0]
    out = torch.full((2, n, T, 2), float("nan"))
    slots = {g: [] for g in range(g_count)}  # each generator's groups: 16 rows, -1 padding
    for base in range(0, n, tile):
        for g in range(g_count):
            rows = [base + i for i in range(min(tile, n - base)) if int(idx[base + i]) == g]
            padded = rows + [-1] * (-len(rows) % bucket)
            slots[g] += [padded[k:k + 16] for k in range(0, len(padded), 16)]
    groups = 0
    for g, grp in slots.items():
        if not grp:
            continue
        rows = torch.tensor(grp)  # (B, 16)
        live, src = rows >= 0, rows.clamp(min=0)
        zero = lambda x: torch.where(live.reshape(live.shape + (1,) * (x.dim() - 2)), x, 0.0)
        a, r = _emulate(image[g], h, hid, fmt, zero(h0[src]), zero(socb[src % m, g]),
                        zero(xy[src % m]), zero(dxdy[src % m]))[:2]
        out[0, rows[live]], out[1, rows[live]] = a[live], r[live]
        groups += rows.shape[0]
    return out[0], out[1], groups


@pytest.mark.parametrize("num_gens,n_agents,k,tile,no_gen", [
    (4, 37, 7, 64, False),  # one odd group a generator per tile: lone groups padded
    (1, 37, 7, 64, False),  # four groups a tile: two whole pairs
    (4, 37, 20, 1024, True),  # every tile size's largest; rows without a generator
    (1, 9, 1, 64, True)])
def test_k5_bf16_pairs_roll_out_like_k1_bf16(num_gens, n_agents, k, tile, no_gen):
    """K5-bf16's pairing of groups (buckets padded to 32 rows, two groups
    a warp) covers every row once on its generator and gives each row
    K1-bf16's bits (a row keeps its place in its group of 16: buckets start
    at multiples of 16 in both); both match the bf16 plain version within
    2e-3; rows without a generator come back NaN."""
    gen = torch.Generator().manual_seed(num_gens * 1000 + n_agents * k)
    stacked = common.stacked_decoders_init(gen, num_gens, 16, 32, "rel", 8)
    rng = np.random.RandomState(n_agents * k)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    xy, dxdy, soc, h0 = f32(n_agents, 2), f32(n_agents, 2) * 0.3, f32(n_agents, 8), \
        f32(n_agents * k, 32)
    idx = torch.from_numpy(rng.randint(0, num_gens, n_agents * k).astype(np.int32))
    if no_gen:  # every fifth row without a generator: below the range, or past it
        idx[::5], idx[::10] = num_gens, -1
    packed = kdec.pack_decoder_params(stacked, "rel")
    socb = kdec.social_bias(packed, soc)
    bad = (idx < 0) | (idx >= num_gens)
    *k5, pair_groups = _select_bf16_emulated(packed, socb, h0, xy, dxdy, idx, "rel", tile, 32)
    *k1, groups = _select_bf16_emulated(packed, socb, h0, xy, dxdy, idx, "rel", min(tile, 256), 16)
    assert pair_groups % 2 == 0  # whole pairs
    if tile <= 256:  # at most one group of padding rows per bucket
        assert groups <= pair_groups <= groups + -(-idx.shape[0] // tile) * num_gens
    want = kdec.decode_select_reference(stacked, xy, dxdy, soc, h0, idx.clamp(0, num_gens - 1),
                                        T, "rel", compute_dtype=torch.bfloat16)
    for a, b, w in zip(k5, k1, want):
        assert bool(torch.isnan(a[bad]).all()) and bool(torch.isfinite(a[~bad]).all())
        if tile <= 256:  # the same tiles: the same rows, the same places
            assert torch.equal(a[~bad], b[~bad])
        np.testing.assert_allclose(a[~bad].numpy(), w[~bad].numpy(), atol=2e-3)


@pytest.mark.parametrize("n,sms,launch", [
    (9_728, 132, (1, 64)),  # eval's batch: fewer tiles than resident blocks
    (20_480, 132, (1, 64)),  # the ablation kernels' check: 320 tiles, 396 blocks
    (81_920, 132, (1, 128)),
    (1_310_720, 132, (1, 1024)),  # the ablation path
    (0, 132, (1, 64)),
])
def test_k5_bf16_launch_fills_the_resident_blocks(n, sms, launch):
    """``decoder.mma_ilp_launch``: 3 blocks an SM (variant 1), and the
    largest tile that still gives every resident block a tile (the next
    larger would not), else the smallest; the picks the sweep found within
    2% of the fastest at 9,728, 20,480 and 1,310,720 rows."""
    variant, tile = kdec.mma_ilp_launch(n, sms)
    assert (variant, tile) == launch and tile % 32 == 0
    resident = sms * kdec.MMA_ILP_BLOCKS_PER_SM[variant]
    if tile != kdec.MMA_ILP_TILES[-1]:
        assert -(-n // tile) >= resident
    if tile != kdec.MMA_ILP_TILES[0]:
        assert -(-n // (2 * tile)) < resident


# ---------------------------------------------------------------------------
# K4-bf16: a block per tile of the route's buffer, 8 groups of 16 rows.

def _sorted_bf16_emulated(packed, rows, tile_gen, h, feat, fmt):
    """K4-bf16 as ``decode_sorted_mma.cu`` runs the buffer: tile t (128
    rows, generator tile_gen[t]) computes socb in f32 per row and column as
    the kernel sums it (an fma over f ascending from 0, then + b1; each fma
    rounded once to f32 through float64) and rolls out its 8 groups of 16
    consecutive rows; every row is stored, padding rows included ->
    (n_buf, 2, T, 2)."""
    image = kdec.mma_weights(packed)
    hid = packed["w1h"].shape[2]
    n_buf = rows.shape[0]
    out = torch.empty((n_buf, 2, T, 2))
    for g in range(image.shape[0]):
        sel = (tile_gen.long().repeat_interleave(ks.TILE) == g).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        soc = rows[sel, h:h + feat].double()
        acc = torch.zeros((sel.numel(), hid), dtype=torch.float64)
        for f in range(feat):
            acc = (soc[:, f:f + 1] * packed["w1s"][g, f].double() + acc).float().double()
        socb = acc.float() + packed["b1"][g]
        grouped = lambda x: x.reshape((-1, 16) + tuple(x.shape[1:]))
        a, r = _emulate(image[g], h, hid, fmt, grouped(rows[sel, :h]), grouped(socb),
                        grouped(rows[sel, h + feat:h + feat + 2]),
                        grouped(rows[sel, h + feat + 2:]))[:2]
        out[sel, 0], out[sel, 1] = a.reshape(-1, T, 2), r.reshape(-1, T, 2)
    return out


@pytest.mark.parametrize("inp_format,feat,skew", [
    ("rel", 8, False), ("abs_rel", 8, True), ("rel", 0, False)])
def test_k4_bf16_tiles_roll_out_like_the_plain_version(inp_format, feat, skew):
    """K4-bf16 on the route's buffer (``sorted_layout``, ``sorted_rows``)
    for 300 rows of 4 generators, uniform or nine in ten on generator 2:
    tiles of one generator, 8 groups of 16 rows each, padding rows rolled
    out on zeros; within 2e-3 of ``sorted_tiles_reference(bf16)``."""
    gen = torch.Generator().manual_seed(19 + feat)
    stacked = common.stacked_decoders_init(gen, 4, 16, 32, inp_format, feat)
    rng = np.random.RandomState(19)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    n = 300
    xy, dxdy, soc, h0 = f32(n, 2), f32(n, 2) * 0.3, f32(n, feat), f32(n, 32)
    idx = rng.randint(0, 4, n)
    if skew:
        idx = np.where(rng.rand(n) < 0.9, 2, idx)
    _, inv, tile_gen, n_buf = ks.sorted_layout(torch.from_numpy(idx.astype(np.int32)), 4)
    rows = ks.sorted_rows(h0, soc, xy, dxdy, inv)
    assert n_buf % ks.TILE == 0 and bool((inv == n).any())  # padding rows in the buffer
    packed = kdec.pack_decoder_params(stacked, inp_format)
    got = _sorted_bf16_emulated(packed, rows, tile_gen, 32, feat, inp_format)
    want = ks.sorted_tiles_reference(tile_gen, ks.TILE, packed, rows, 32, feat, T, inp_format,
                                     compute_dtype=torch.bfloat16)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3)


@pytest.mark.parametrize("num_gens,skew", [(4, False), (4, True), (1, False), (3, True)])
def test_k4_bf16_launch_tiles_hold_whole_groups_of_one_generator(num_gens, skew):
    """K4-bf16 launches one block per tile of the route's buffer with the
    swept warps a block (8): every tile holds rows of one generator only
    (so the kernel needs no bucketing) and is 8 whole groups of 16 rows;
    every row has a place."""
    rng = np.random.RandomState(num_gens)
    for n in (1, 127, 129, 1_000, 20_480):
        idx = rng.randint(0, num_gens, n)
        if skew:
            idx = np.where(rng.rand(n) < 0.9, num_gens - 1, idx)
        dest, inv, tile_gen, n_buf = ks.sorted_layout(torch.from_numpy(idx.astype(np.int32)),
                                                      num_gens)
        assert n_buf % ks.TILE == 0 and ks.TILE % 16 == 0
        assert ks.MMA_WARPS[ks.MMA_VARIANT] == 8 and ks.TILE // 16 == 8
        assert sorted(dest.tolist()) == dest.unique().tolist() and dest.numel() == n
        gen_of_row = torch.full((n_buf,), -1, dtype=torch.long)
        gen_of_row[dest] = torch.from_numpy(idx).long()
        tiles = gen_of_row.reshape(-1, ks.TILE)
        for t in range(tiles.shape[0]):
            live = tiles[t][tiles[t] >= 0]
            assert bool((live == int(tile_gen[t])).all())
