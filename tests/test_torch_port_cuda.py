"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA card (a CUDA kernel has no CPU mode). Imports neither
JAX nor ``mggan_tpu``, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops import kernels
from mggan_tpu_torch.ops.kernels import decode_ablation as kab
from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decode_sorted as ks
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.utils.pytree import tree_leaves

T = 12
ATOL = 1e-4  # f32; summation order and expf/tanhf differ from the CPU


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
@pytest.mark.parametrize("h_dim", [32, 20])
def test_decode_select_kernel_matches_reference(cuda, inp_format, h_dim):
    g_count, m, k = 4, 37, 20
    gen = torch.Generator().manual_seed(h_dim)
    stacked = common.stacked_decoders_init(gen, g_count, h_dim // 2, h_dim,
                                           inp_format, 32)
    rng = np.random.RandomState(0)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    xy, dxdy, soc = f32(m, 2), f32(m, 2) * 0.3, f32(m, 32)
    h0 = f32(m * k, h_dim)
    idx = torch.from_numpy(rng.randint(0, g_count, m * k).astype(np.int32))
    args = (stacked, xy, dxdy, soc, h0, idx)
    before = kernels.launches[kdec.KERNEL]
    got = kdec.decode_select(*[_on(a, cuda) for a in args], T, inp_format)
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL] == before + 1
    want = kdec.decode_select_reference(*args, T, inp_format)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=ATOL)


def _decode_all_case(inp_format, h_dim, g_count=4, m=37, k=20, seed=0):
    gen = torch.Generator().manual_seed(h_dim + seed)
    stacked = common.stacked_decoders_init(gen, g_count, h_dim // 2, h_dim,
                                           inp_format, 32)
    rng = np.random.RandomState(seed)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return stacked, (f32(m, 2), f32(m, 2) * 0.3, f32(m, 32), f32(m * k, h_dim))


def _decode_all_grads(stacked, rows, inp_format, dev):
    """Rollout and grads of a weighted sum of abs/rel (the loss of
    tests/test_pallas_decoder.py) w.r.t. the stacked params and every input."""
    stacked = _on(stacked, dev)
    rows = [x.to(dev) for x in rows]
    leaves = [x.requires_grad_() for x in tree_leaves(stacked) + rows]
    a, r = kda.decode_all(stacked, *rows, T, inp_format)
    wa = torch.linspace(0.5, 1.5, a.numel(), device=dev).reshape(a.shape)
    wr = torch.linspace(-1.0, 1.0, r.numel(), device=dev).reshape(r.shape)
    grads = torch.autograd.grad((a * wa).sum() + (r * wr).sum(), leaves,
                                allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads)]
    return [a.detach(), r.detach()], grads


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
@pytest.mark.parametrize("h_dim", [32, 20])
def test_decode_all_kernels_match_reference(cuda, inp_format, h_dim):
    """K2 (forward, hc saved) and K3 (through DecodeAll's backward) against
    the plain versions on the CPU. Forward atol 1e-4 (12-step rollout);
    grads rtol/atol 2e-4, as tests/test_pallas_decoder.py holds the TPU
    kernel's backward."""
    stacked, rows = _decode_all_case(inp_format, h_dim)
    before = dict(kernels.launches)
    got_out, got_grads = _decode_all_grads(stacked, rows, inp_format, cuda)
    torch.cuda.synchronize()
    assert kernels.launches[kda.KERNEL_FWD] == before.get(kda.KERNEL_FWD, 0) + 1
    assert kernels.launches[kda.KERNEL_BWD] == before.get(kda.KERNEL_BWD, 0) + 1
    want_out, want_grads = _decode_all_grads(stacked, rows, inp_format, "cpu")
    for a, b in zip(got_out, want_out):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=ATOL)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_decode_all_bwd_weight_grads_are_bit_identical(cuda):
    """K3 sums weight grads without atomics: two launches, same bits."""
    stacked, rows = _decode_all_case("rel", 32, m=64, k=20)
    first = _decode_all_grads(stacked, rows, "rel", cuda)[1]
    second = _decode_all_grads(stacked, rows, "rel", cuda)[1]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


BF16_ATOL = 2e-3  # bf16 operands: a rounding of h can flip between the card and the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs", "abs_rel"])
@pytest.mark.parametrize("h_dim", [32, 20])
def test_bf16_kernels_match_reference(cuda, inp_format, h_dim):
    """K1's and K2's bf16 variants against their bf16 plain versions, K2-bf16
    equal to the tensor-core K1-bf16 on the selected rows bit for bit (one
    rollout, rollout_mma.cuh), and the kept warp-per-row K2-bf16 equal to
    the warp-per-row K1-bf16 there (one rollout template, one arithmetic)."""
    stacked, rows = _decode_all_case(inp_format, h_dim, seed=3)
    idx = torch.from_numpy(np.random.RandomState(3).randint(0, 4, rows[3].shape[0])
                           .astype(np.int32))
    bf16 = torch.bfloat16
    before = dict(kernels.launches)
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    sel = kdec.decode_select(*on, T, inp_format, compute_dtype=bf16)
    every = kda.decode_all(*on[:5], T, inp_format, compute_dtype=bf16)
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL_BF16] == before.get(kdec.KERNEL_BF16, 0) + 1
    assert kernels.launches[kda.KERNEL_FWD_BF16] == before.get(kda.KERNEL_FWD_BF16, 0) + 1
    want_sel = kdec.decode_select_reference(stacked, *rows, idx, T, inp_format, bf16)
    want_all = kda.decode_all(stacked, *rows, T, inp_format, compute_dtype=bf16)
    for a, b in zip(sel + every, want_sel + want_all):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=BF16_ATOL)
    rows_n = torch.arange(idx.shape[0], device=cuda)
    pick = idx.to(cuda).long()
    for a, b in zip(sel, every):
        assert torch.equal(a, b[pick, rows_n])
    warp = kdec.launch_decode_select_bf16_warp(kdec.prepare_decode_select(
        *on, T, inp_format, compute_dtype=bf16))
    packed = kdec.pack_decoder_params(on[0], inp_format)
    every_warp = kda.launch_fwd_warp(kda.prepare(
        *[packed[k].contiguous() for k in kda.PACKED],
        kdec.social_bias(packed, on[3]).contiguous(), on[4], on[1], on[2], T, inp_format, bf16),
        save_hc=False)
    for a, b in zip(warp, every_warp):
        assert torch.equal(a, b[pick, rows_n])


def _select_case(n_agents, k, seed, feat=32):
    stacked, rows = _decode_all_case("rel", 32, m=n_agents, k=k, seed=seed)
    idx = torch.from_numpy(np.random.RandomState(seed).randint(0, 4, n_agents * k)
                           .astype(np.int32))
    return stacked, rows, idx


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("k", [20, 7])  # 7 x 37 rows: odd, the last pair has one row
def test_ilp_equals_k1_bit_for_bit(cuda, compute_dtype, k):
    """K5 keeps the warp-per-row K1's operations per row, so its output
    has that kernel's bits, and the tiled K1's, at each rows a group and
    tile; so do the kept warp-per-pair K5
    and B1's f32 variant (K1's activations). In bf16, K5-bf16 runs
    K1-bf16's tensor-core rollout two groups a warp and has the tensor-core
    K1-bf16's bits, and the kept warp-per-row K5-bf16 the warp-per-row
    K1-bf16's."""
    stacked, rows, idx = _select_case(37, k, seed=5)
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    before = dict(kernels.launches)
    prepared = kdec.prepare_decode_select(*on, T, "rel", compute_dtype=compute_dtype)
    if compute_dtype is None:
        k1 = kdec.launch_decode_select_warp(prepared)
    else:
        k1 = kdec.launch_decode_select(prepared)
    k5 = kdec.decode_select(*on, T, "rel", compute_dtype=compute_dtype, ilp=True)
    torch.cuda.synchronize()
    name = kdec.KERNEL_ILP_BF16 if compute_dtype else kdec.KERNEL_ILP
    assert kernels.launches[name] == before.get(name, 0) + 1
    for a, b in zip(k1, k5):
        assert torch.equal(a, b)
    if compute_dtype is None:
        b1 = kab.decode_select_act(*on, T, "f32")
        for a, b in zip(k1, b1):
            assert torch.equal(a, b)
        tiled, kept = kdec.launch_decode_select(prepared), kdec.launch_decode_select_ilp_warp(
            prepared)
        n, sms = idx.shape[0], kdec.sm_count(cuda)
        variants = [kdec.launch_decode_select(prepared, ilp=True, shape=(
            r, tile, max(1, min(-(-n // tile), sms * kdec.TILED_BLOCKS_PER_SM))))
            for r in kdec.TILED_ILP_ROWS for tile in kdec.TILED_TILES]
        torch.cuda.synchronize()
        assert kernels.launches[kdec.KERNEL_ILP_WARP] == \
            before.get(kdec.KERNEL_ILP_WARP, 0) + 1
        for a, b, c in zip(k1, tiled, kept):
            assert torch.equal(a, b) and torch.equal(a, c)
        for out in variants:
            for a, b in zip(out, tiled):
                assert torch.equal(a, b)
    else:
        kept = kdec.launch_decode_select_ilp_bf16_warp(prepared)
        k1_warp = kdec.launch_decode_select_bf16_warp(prepared)
        torch.cuda.synchronize()
        assert kernels.launches[kdec.KERNEL_ILP_BF16_WARP] == \
            before.get(kdec.KERNEL_ILP_BF16_WARP, 0) + 1
        for a, b in zip(k1_warp, kept):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case,inp_format,h_dim", [
    ("random", "rel", 32), ("random", "abs", 32), ("random", "abs_rel", 20),
    ("ragged", "rel", 32), ("one row", "abs_rel", 32), ("all on generator 0", "rel", 32),
    ("rows without a generator", "rel", 32), ("rows without a generator", "abs", 20)])
def test_k5_bf16_equals_k1_bf16_bit_for_bit(cuda, case, inp_format, h_dim):
    """K5-bf16 at both launch variants and every tile size, and at the
    rule's pick, equals the tensor-core K1-bf16 bit for bit in abs and rel:
    37 x 20 = 740 rows (M < N), 37 x 7 = 259 (an odd count: buckets end in a
    lone group, paired with padding rows), one row, every row on one
    generator; rows without a generator come back NaN."""
    stacked, rows, idx = _tiled_k1_case(case, inp_format, h_dim, seed=17)
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    prepared = kdec.prepare_decode_select(*on, T, inp_format, compute_dtype=torch.bfloat16)
    k1 = kdec.launch_decode_select(prepared)
    before = dict(kernels.launches)
    got = [kdec.decode_select(*on, T, inp_format, compute_dtype=torch.bfloat16, ilp=True)] + [
        kdec.launch_decode_select(prepared, ilp=True, shape=(v, tile))
        for v in range(len(kdec.MMA_ILP_BLOCKS_PER_SM)) for tile in kdec.MMA_ILP_TILES]
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL_ILP_BF16] == \
        before.get(kdec.KERNEL_ILP_BF16, 0) + len(got)
    bad = ((idx < 0) | (idx >= 4)).to(cuda)
    for out in got:
        for a, b in zip(out, k1):
            assert torch.equal(a[~bad], b[~bad])
            assert bool(torch.isnan(a[bad]).all()) and bool(torch.isfinite(a[~bad]).all())


# B1-bf16 against its plain version: hexp and __hdiv against torch's exp
# and division, each rounded to bf16; chip_smoke.py's limit (read 3.9e-4
# at 20,480 rows on an H100).
B1_BF16_ATOL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["f32", "bf16", "lin"])
def test_activation_variants_match_reference(cuda, act):
    stacked, rows, idx = _select_case(37, 20, seed=6)
    got = kab.decode_select_act(*[_on(x, cuda) for x in (stacked, *rows, idx)], T, act)
    torch.cuda.synchronize()
    want = kab.decode_select_act_reference(stacked, *rows, idx, T, act)
    atol = B1_BF16_ATOL if act == "bf16" else ATOL
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format,feat,skew", [
    ("rel", 32, False), ("abs", 32, False), ("abs_rel", 32, False), ("rel", 0, False),
    ("abs_rel", 32, True)])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_sorted_route_matches_reference(cuda, inp_format, feat, skew, compute_dtype):
    """K4's route on the card against its plain version on the CPU (the
    same layout), and against K1 on the same draws (in bf16 the tensor-core
    K1-bf16: the same rollout, with socb summed in another order); in f32
    equal to the route on the kept warp-per-row K4 bit for bit."""
    gen = torch.Generator().manual_seed(7)
    stacked = common.stacked_decoders_init(gen, 4, 16, 32, inp_format, feat)
    rng = np.random.RandomState(7)
    f32 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    m, k = 61, 9
    rows = (f32(m, 2), f32(m, 2) * 0.3, f32(m, feat), f32(m * k, 32))
    idx = torch.from_numpy((np.full(m * k, 2) if skew else rng.randint(0, 4, m * k))
                           .astype(np.int32))
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    before = dict(kernels.launches)
    got = ks.decode_select_sorted(*on, T, inp_format, compute_dtype)
    torch.cuda.synchronize()
    name = ks.KERNEL_BF16 if compute_dtype else ks.KERNEL
    assert kernels.launches[name] == before.get(name, 0) + 1
    want = ks.decode_select_sorted(stacked, *rows, idx, T, inp_format, compute_dtype)
    k1 = kdec.decode_select(*on, T, inp_format, compute_dtype=compute_dtype)
    if not compute_dtype:  # the tiled K4 keeps the warp-per-row K4's bits
        kept = ks.decode_select_sorted_warp(*on, T, inp_format)
        torch.cuda.synchronize()
        assert kernels.launches[ks.KERNEL_WARP] == before.get(ks.KERNEL_WARP, 0) + 1
        for a, b in zip(got, kept):
            assert torch.equal(a, b)
    atol = BF16_ATOL if compute_dtype else ATOL
    for a, b, c in zip(got, want, k1):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=atol)
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), atol=atol)
        if compute_dtype:  # chip_smoke.py's mean limit of the bf16 kernels
            assert float((a.cpu() - b).abs().mean()) <= 1e-5
            assert float((a - c).abs().mean()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format,feat,h_dim", [
    ("rel", 32, 32), ("abs_rel", 32, 20), ("abs", 0, 32)])
def test_sorted_bf16_kernels_match_reference(cuda, inp_format, feat, h_dim):
    """K4-bf16 alone on a buffer of 6 tiles (every generator, a tile with
    padding rows, a tile with no generator) at each launch variant, equal
    to one another bit for bit, and the kept warp-per-row K4-bf16, each
    against the bf16 plain version (``sorted_tiles_reference``) on the
    generators' tiles; the tile with no generator comes back NaN."""
    gen = torch.Generator().manual_seed(18)
    stacked = common.stacked_decoders_init(gen, 4, h_dim // 2, h_dim, inp_format, feat)
    packed = _on(kdec.pack_decoder_params(stacked, inp_format), cuda)
    rng = np.random.RandomState(18)
    tiles = np.array([0, 1, 2, 2, 3, 7], dtype=np.int32)  # 7: no generator
    rows = rng.randn(tiles.size * ks.TILE, h_dim + feat + 4).astype(np.float32)
    rows[3 * ks.TILE + 50:4 * ks.TILE] = 0.0  # padding rows of generator 2's last tile
    rows, tile_gen = torch.from_numpy(rows).to(cuda), torch.from_numpy(tiles).to(cuda)
    bf16 = torch.bfloat16
    args = ks.prepare_sorted_tiles(packed, rows, tile_gen, h_dim, feat, T, inp_format, bf16)
    before = dict(kernels.launches)
    got = [ks.launch_sorted_tiles(args, variant=v) for v in range(len(ks.MMA_WARPS))]
    kept = ks.launch_sorted_tiles_bf16_warp(args)
    torch.cuda.synchronize()
    assert kernels.launches[ks.KERNEL_BF16] == before.get(ks.KERNEL_BF16, 0) + len(ks.MMA_WARPS)
    assert kernels.launches[ks.KERNEL_BF16_WARP] == before.get(ks.KERNEL_BF16_WARP, 0) + 1
    ok = torch.arange(rows.shape[0], device=cuda) < 5 * ks.TILE
    want = ks.sorted_tiles_reference(tile_gen.clamp(0, 3), ks.TILE, packed, rows, h_dim, feat, T,
                                     inp_format, bf16)
    for out in got[1:]:
        assert torch.equal(out[ok], got[0][ok])
    for out in (got[0], kept):
        assert bool(torch.isnan(out[~ok]).all())
        np.testing.assert_allclose(out[ok].cpu().numpy(), want[ok].cpu().numpy(),
                                   atol=BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format,feat,h_dim", [
    ("rel", 32, 32), ("abs_rel", 32, 20), ("abs", 0, 32)])
def test_sorted_kernels_match_reference(cuda, inp_format, feat, h_dim):
    """The tiled K4 alone on a buffer of 6 tiles (every generator, a tile
    with padding rows, a tile with no generator) at each launch variant,
    equal to the kept warp-per-row K4 bit for bit, and both within ATOL of
    the plain version (``sorted_tiles_reference``) on the generators'
    tiles; the tile with no generator comes back NaN."""
    gen = torch.Generator().manual_seed(18)
    stacked = common.stacked_decoders_init(gen, 4, h_dim // 2, h_dim, inp_format, feat)
    packed = _on(kdec.pack_decoder_params(stacked, inp_format), cuda)
    rng = np.random.RandomState(18)
    tiles = np.array([0, 1, 2, 2, 3, 7], dtype=np.int32)  # 7: no generator
    rows = rng.randn(tiles.size * ks.TILE, h_dim + feat + 4).astype(np.float32)
    rows[3 * ks.TILE + 50:4 * ks.TILE] = 0.0  # padding rows of generator 2's last tile
    rows, tile_gen = torch.from_numpy(rows).to(cuda), torch.from_numpy(tiles).to(cuda)
    args = ks.prepare_sorted_tiles(packed, rows, tile_gen, h_dim, feat, T, inp_format)
    before = dict(kernels.launches)
    got = [ks.launch_sorted_tiles(args, variant=v) for v in range(len(ks.TILED_WARPS))]
    kept = ks.launch_sorted_tiles_warp(args)
    torch.cuda.synchronize()
    assert kernels.launches[ks.KERNEL_TILES] == \
        before.get(ks.KERNEL_TILES, 0) + len(ks.TILED_WARPS)
    assert kernels.launches[ks.KERNEL_WARP] == before.get(ks.KERNEL_WARP, 0) + 1
    ok = torch.arange(rows.shape[0], device=cuda) < 5 * ks.TILE
    want = ks.sorted_tiles_reference(tile_gen.clamp(0, 3), ks.TILE, packed, rows, h_dim, feat, T,
                                     inp_format)
    for out in got:
        assert torch.equal(out[ok], kept[ok])
    for out in got + [kept]:
        assert bool(torch.isnan(out[~ok]).all())
    np.testing.assert_allclose(kept[ok].cpu().numpy(), want[ok].cpu().numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case,inp_format,h_dim", [
    ("random", "rel", 32), ("random", "abs", 32), ("random", "abs_rel", 20),
    ("ragged", "rel", 32), ("one row", "abs_rel", 32), ("all on generator 0", "rel", 32),
    ("rows without a generator", "rel", 32), ("rows without a generator", "abs", 20)])
def test_k5_equals_tiled_k1_bit_for_bit(cuda, case, inp_format, h_dim):
    """K5 (two groups of R rows of one generator a warp) at the rule's
    pick, at each rows a group with tiles of 8, 64 and 1,024 rows, and
    with one block, equals the tiled K1 bit for bit in abs and
    rel: 740 rows (M < N), 259 (an odd count: buckets end in a lone group,
    paired with padding rows), one row, every row on one generator; rows
    without a generator come back NaN."""
    stacked, rows, idx = _tiled_k1_case(case, inp_format, h_dim, seed=17)
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    prepared = kdec.prepare_decode_select(*on, T, inp_format)
    k1 = kdec.launch_decode_select(prepared)
    n = idx.shape[0]
    before = dict(kernels.launches)
    got = [kdec.decode_select(*on, T, inp_format, ilp=True),
           kdec.launch_decode_select(prepared, ilp=True, shape=(4, 32, 1))]
    got += [kdec.launch_decode_select(prepared, ilp=True, shape=(r, tile, -(-n // tile)))
            for r in kdec.TILED_ILP_ROWS for tile in (8, 64, 1024)]
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL_ILP] == before.get(kdec.KERNEL_ILP, 0) + len(got)
    bad = ((idx < 0) | (idx >= 4)).to(cuda)
    for out in got:
        for a, b in zip(out, k1):
            assert torch.equal(a[~bad], b[~bad])
            assert bool(torch.isnan(a[bad]).all()) and bool(torch.isfinite(a[~bad]).all())


# K2-bf16's saved (h, c) against the bf16 plain forward's: a flip of one h's
# bf16 rounding moves it by one bf16 step, up to 2^-8 (3.9e-3) below 1, and
# such flips are rare (chip_smoke.py's phase 11 on an H100 80GB HBM3 at
# 700 W: mean abs difference 1.3e-8, the f32 forward's hc 1.6e-4; PERF.md).
HC_ATOL, HC_MEAN_ATOL = 4e-3, 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs_rel"])
def test_bf16_grads_match_plain_sweep(cuda, inp_format):
    """K2-bf16's saved (h, c) against the bf16 plain forward's (h rounded to
    bf16, c in f32; the f32 forward's lies beyond the limits), the route
    (K2-bf16 saving hc, then K3 through DecodeAll with
    compute_dtype=bfloat16) against the plain forward and reverse sweep,
    K3 alone against the plain sweep on the kernel's residuals, and the
    route's grads equal K3 on those residuals bit for bit."""
    stacked, rows = _decode_all_case(inp_format, 32, seed=8)
    bf16 = torch.bfloat16
    packed = kdec.pack_decoder_params(_on(stacked, cuda), inp_format)
    inputs = [packed[k].contiguous() for k in kda.PACKED] + [
        kdec.social_bias(packed, rows[2].to(cuda)).contiguous(), rows[3].to(cuda),
        rows[0].to(cuda), rows[1].to(cuda)]
    out = kda.decode_all_fwd(*inputs, T, inp_format, save_hc=True, compute_dtype=bf16)
    out32 = kda.decode_all_fwd(*inputs, T, inp_format, save_hc=True)
    plain = kda.decode_all_reference(*inputs, T, inp_format, save_hc=True, compute_dtype=bf16)
    for a, b in zip(out[:2], plain[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=BF16_ATOL)
    np.testing.assert_allclose(out[2].cpu().numpy(), plain[2].cpu().numpy(), atol=HC_ATOL)
    assert float((out[2] - plain[2]).abs().mean()) <= HC_MEAN_ATOL
    h, c = out[2][..., 0, :], out[2][..., 1, :]
    assert torch.equal(h, h.to(bf16).float())
    assert float((c == c.to(bf16).float()).float().mean()) < 0.01
    h32 = out32[2][..., 0, :]
    assert float((out32[2] - plain[2]).abs().mean()) > HC_MEAN_ATOL
    assert not torch.equal(h32, h32.to(bf16).float())
    out_abs, out_rel, hc = out
    g_abs, g_rel = torch.randn_like(out_abs), torch.randn_like(out_rel)
    saved = (*inputs, out_abs, out_rel, hc, g_abs, g_rel)
    before = dict(kernels.launches)
    got = kda.decode_all_bwd(*saved, T, inp_format, kda.KERNEL_BWD_AFTER_BF16)
    torch.cuda.synchronize()
    assert kernels.launches[kda.KERNEL_BWD_AFTER_BF16] == \
        before.get(kda.KERNEL_BWD_AFTER_BF16, 0) + 1
    want = kda.decode_all_bwd_reference(*saved, T, inp_format)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-4, atol=2e-4)
    # the whole route against the plain one: a row where an h rounding
    # flipped between the two forwards has other residuals, so its per-row
    # grads are not held; the weight grads sum over every row, flips
    # included, and are held as chip_smoke.py holds K3's (1e-3 x max|grad|)
    route_want = kda.decode_all_bwd_reference(*inputs, *plain, g_abs, g_rel, T, inp_format)
    flip = (h != plain[2][..., 0, :]).flatten(2).any(-1).any(0)  # (N,)
    m = rows[0].shape[0]
    same = {"n": ~flip, "m": ~flip.reshape(-1, m).any(0)}
    for i, (a, b) in enumerate(zip(got, route_want)):
        if i < 6:
            assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
        else:  # socb, h0 (N rows), last_xy, last_dxdy
            keep = same["n" if i == 7 else "m"]
            np.testing.assert_allclose(a[keep].cpu().numpy(), b[keep].cpu().numpy(),
                                       rtol=2e-4, atol=2e-4)
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    a, r = kda.DecodeAll.apply(*leaves, T, inp_format, bf16)
    route = torch.autograd.grad((a * g_abs).sum() + (r * g_rel).sum(), leaves)
    for x, y in zip(route, got):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The two kernels redesigned for the H100: K3 with rows of one generator
# tiled per warp (8 rows a tile: 740 rows leave a partial tile) and K1-bf16
# on the tensor cores (rows bucketed by generator, 16 to an mma).


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format", ["rel", "abs_rel"])
def test_tiled_k3_matches_warp_baseline(cuda, inp_format):
    """K3 against the plain sweep and against the warp-per-row sweep it
    replaced, at 37 x 20 = 740 rows: per-row grads at rtol/atol 2e-4,
    weight grads within 1e-3 x max|grad| (chip_smoke.py's limits); two
    launches give the same bits."""
    stacked, rows = _decode_all_case(inp_format, 32, seed=9)
    packed = kdec.pack_decoder_params(_on(stacked, cuda), inp_format)
    inputs = [packed[k].contiguous() for k in kda.PACKED] + [
        kdec.social_bias(packed, rows[2].to(cuda)).contiguous(), rows[3].to(cuda),
        rows[0].to(cuda), rows[1].to(cuda)]
    args = kda.prepare(*inputs, T, inp_format)
    out = kda.launch_fwd(args, save_hc=True)
    gen = torch.Generator(device=cuda).manual_seed(9)
    g_abs = torch.randn(out[0].shape, generator=gen, device=cuda)
    g_rel = torch.randn(out[1].shape, generator=gen, device=cuda)
    before = dict(kernels.launches)
    first = kda.launch_bwd(args, *out, g_abs, g_rel)
    second = kda.launch_bwd(args, *out, g_abs, g_rel)
    base = kda.launch_bwd_warp(args, *out, g_abs, g_rel)
    torch.cuda.synchronize()
    assert kernels.launches[kda.KERNEL_BWD] == before.get(kda.KERNEL_BWD, 0) + 2
    assert kernels.launches[kda.KERNEL_BWD_WARP] == before.get(kda.KERNEL_BWD_WARP, 0) + 1
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    m = rows[0].shape[0]
    got = kda.grads_from_raw(first, m)
    plain = kda.decode_all_bwd_reference(*inputs, *out, g_abs, g_rel, T, inp_format)
    for want in (plain, kda.grads_from_raw(base, m)):
        for i, (a, b) in enumerate(zip(got, want)):
            if i < 6:
                assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
            else:
                np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-4,
                                           atol=2e-4)


def _mma_case(idx_rule, seed=10, m=37, k=20):
    stacked, rows = _decode_all_case("rel", 32, m=m, k=k, seed=seed)
    rng = np.random.RandomState(seed)
    idx = idx_rule(rng.randint(0, 4, m * k)).astype(np.int32)
    return stacked, rows, torch.from_numpy(idx)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "generator 1 absent", "all on generator 3",
                                  "rows without a generator"])
def test_bf16_tensor_core_kernel_matches_reference(cuda, case):
    """K1-bf16 on the tensor cores at 740 rows against its bf16 plain
    version (2e-3, the CPU tests' bf16 limit at this size) and against the
    warp-per-row bf16 kernel it replaced (4e-3, chip_smoke.py's limit);
    rows whose generator is out of range come back NaN."""
    rules = {"random": lambda i: i, "generator 1 absent": lambda i: np.where(i == 1, 0, i),
             "all on generator 3": lambda i: np.full_like(i, 3),
             "rows without a generator": lambda i: np.where(np.arange(i.size) % 13 == 0,
                                                            np.where(i % 2 == 0, -1, 4), i)}
    stacked, rows, idx = _mma_case(rules[case])
    bf16 = torch.bfloat16
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    before = dict(kernels.launches)
    got = kdec.decode_select(*on, T, "rel", compute_dtype=bf16)
    warp = kdec.launch_decode_select_bf16_warp(kdec.prepare_decode_select(
        *on, T, "rel", compute_dtype=bf16))
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL_BF16] == before.get(kdec.KERNEL_BF16, 0) + 1
    bad = ((idx < 0) | (idx >= 4)).numpy()
    want = kdec.decode_select_reference(stacked, *rows, idx.clamp(0, 3), T, "rel", bf16)
    for a, b, w in zip(got, want, warp):
        a, b, w = a.cpu().numpy(), b.numpy(), w.cpu().numpy()
        assert np.isnan(a[bad]).all() and np.isfinite(a[~bad]).all()
        np.testing.assert_allclose(a[~bad], b[~bad], atol=BF16_ATOL)
        np.testing.assert_allclose(a[~bad], w[~bad], atol=4e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format,h_dim", [("abs", 20), ("abs_rel", 32)])
def test_bf16_tensor_core_kernel_widths_and_formats(cuda, inp_format, h_dim):
    """K1-bf16 with hidden units and hidden2pos columns that do not fill
    the fragments (h=20, hid=10) and with every input format; M < N rows
    (k=20 samples of each agent's inputs)."""
    stacked, rows = _decode_all_case(inp_format, h_dim, seed=11)
    idx = torch.from_numpy(np.random.RandomState(11).randint(0, 4, rows[3].shape[0])
                           .astype(np.int32))
    got = kdec.decode_select(*[_on(x, cuda) for x in (stacked, *rows, idx)], T, inp_format,
                             compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = kdec.decode_select_reference(stacked, *rows, idx, T, inp_format, torch.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# K1 and K2 in f32, redesigned with R rows of one generator tiled per warp:
# bit for bit against the warp-per-row kernels they replaced, at every R
# the launch rules can pick (decoder.TILED_ROWS), as each row keeps the
# warp-per-row rollout's operations in its order.


def _tiled_k1_case(case, inp_format, h_dim, seed=12):
    """(stacked, rows, idx) with M = 37 agents and K = 20 samples (M < N),
    or the edge case named."""
    m, k = (1, 1) if case == "one row" else (37, 7) if case == "ragged" else (37, 20)
    stacked, rows = _decode_all_case(inp_format, h_dim, m=m, k=k, seed=seed)
    idx = np.random.RandomState(seed).randint(0, 4, m * k)
    idx = {"generator 1 absent": np.where(idx == 1, 2, idx),
           "all on generator 0": np.zeros_like(idx),
           "rows without a generator": np.where(np.arange(idx.size) % 11 == 0,
                                                np.where(idx % 2 == 0, -1, 4), idx)
           }.get(case, idx)
    return stacked, rows, torch.from_numpy(idx.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case,inp_format,h_dim", [
    ("random", "rel", 32), ("random", "abs", 32), ("random", "abs_rel", 32),
    ("random", "rel", 20), ("random", "abs_rel", 20),
    ("one row", "rel", 32), ("ragged", "rel", 32), ("ragged", "abs", 20),
    ("generator 1 absent", "rel", 32), ("all on generator 0", "rel", 32),
    ("rows without a generator", "abs_rel", 32)])
def test_tiled_k1_equals_warp_baseline(cuda, case, inp_format, h_dim):
    """The tiled K1 at R = 1, 2, 4 and tiles of 8 and 32 rows (and the
    rule's pick, through decode_select) equals the warp-per-row K1 bit for
    bit in abs and rel; rows without a generator come back NaN in both.
    37 x 20 = 740 rows (M < N), 37 x 7 = 259 (not a multiple of R or a
    tile), one row."""
    stacked, rows, idx = _tiled_k1_case(case, inp_format, h_dim)
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    prepared = kdec.prepare_decode_select(*on, T, inp_format)
    before = dict(kernels.launches)
    base = kdec.launch_decode_select_warp(prepared)
    got = {"rule": kdec.decode_select(*on, T, inp_format)}
    n = idx.shape[0]
    for r in kdec.TILED_ROWS:
        for tile in (8, 32):
            got[(r, tile)] = kdec.launch_decode_select(prepared, shape=(r, tile, -(-n // tile)))
    got[(4, 32, 1)] = kdec.launch_decode_select(prepared, shape=(4, 32, 1))  # one block
    torch.cuda.synchronize()
    assert kernels.launches[kdec.KERNEL] == before.get(kdec.KERNEL, 0) + len(got)
    assert kernels.launches[kdec.KERNEL_WARP] == before.get(kdec.KERNEL_WARP, 0) + 1
    bad = ((idx < 0) | (idx >= 4)).to(cuda)
    for b in base:
        assert bool(torch.isnan(b[bad]).all()) and bool(torch.isfinite(b[~bad]).all())
    for shape, out in got.items():
        for a, b in zip(out, base):
            assert torch.equal(a[~bad], b[~bad]), shape
            assert bool(torch.isnan(a[bad]).all()), shape
    want = kdec.decode_select_reference(stacked, *rows, idx.clamp(0, 3), T, inp_format)
    for a, b in zip(base, want):
        np.testing.assert_allclose(a[~bad].cpu().numpy(), b[~bad.cpu()].numpy(), atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("inp_format,h_dim,m,k", [
    ("rel", 32, 37, 20), ("abs", 32, 37, 20), ("abs_rel", 32, 37, 20), ("rel", 20, 37, 20),
    ("abs_rel", 20, 37, 7), ("rel", 32, 37, 7), ("rel", 32, 1, 1), ("rel", 32, 0, 1)])
def test_tiled_k2_equals_warp_baseline(cuda, inp_format, h_dim, m, k):
    """The tiled K2 at R = 1, 2, 4 and 1 or 3 blocks per generator (and the
    rule's pick) equals the warp-per-row K2 bit for bit in abs, rel and hc,
    with and without saving hc: 740 rows, 259 (a ragged last warp), 1 and
    0 rows."""
    stacked, rows = _decode_all_case(inp_format, h_dim, m=max(m, 1), k=k, seed=13)
    packed = kdec.pack_decoder_params(_on(stacked, cuda), inp_format)
    inputs = [packed[key].contiguous() for key in kda.PACKED] + [
        kdec.social_bias(packed, rows[2][:m].to(cuda)).contiguous(), rows[3][:m * k].to(cuda),
        rows[0][:m].to(cuda), rows[1][:m].to(cuda)]
    if m == 0:  # N = 0 rows: M = 1 input row, so that N % M == 0
        inputs[6:] = [inputs[6][:0].new_zeros((1,) + inputs[6].shape[1:]), inputs[7],
                      rows[0][:1].to(cuda), rows[1][:1].to(cuda)]
    args = kda.prepare(*inputs, T, inp_format)
    for save_hc in (True, False):
        base = kda.launch_fwd_warp(args, save_hc)
        outs = [kda.launch_fwd(args, save_hc)] + [
            kda.launch_fwd(args, save_hc, shape=(r, b)) for r in kdec.TILED_ROWS for b in (1, 3)]
        torch.cuda.synchronize()
        for out in outs:
            for a, b in zip(out, base):
                assert (a is None and b is None) or torch.equal(a, b)
    if m:
        want = kda.decode_all_reference(*inputs, T, inp_format, save_hc=True)
        got = kda.launch_fwd(args, True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# K2-bf16 on the tensor cores (K1-bf16's rollout on 16 consecutive rows of
# one generator) and B1 on the tiled f32 rollout.


def _k2_bf16_inputs(stacked, rows, inp_format, dev):
    packed = kdec.pack_decoder_params(_on(stacked, dev), inp_format)
    return [packed[k].contiguous() for k in kda.PACKED] + [
        kdec.social_bias(packed, rows[2].to(dev)).contiguous(), rows[3].to(dev),
        rows[0].to(dev), rows[1].to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [0, 1, 17, 259])
@pytest.mark.parametrize("inp_format,h_dim", [
    ("rel", 32), ("abs", 32), ("abs_rel", 32), ("rel", 20), ("abs", 20), ("abs_rel", 20)])
def test_k2_bf16_equals_k1_bf16_bit_for_bit(cuda, inp_format, h_dim, n_rows):
    """K2-bf16 at every launch variant (1 and 3 blocks per generator, and
    the rule's pick) equals the tensor-core K1-bf16 on the selected rows bit
    for bit, with and without saving hc (one rollout: each row's products
    in one order whatever its group), at 0, 1, 17 and 259 rows (M = N)."""
    m = max(n_rows, 1)
    stacked, rows = _decode_all_case(inp_format, h_dim, m=m, k=1, seed=14)
    rows = tuple(x[:n_rows] if n_rows == 0 and i == 3 else x for i, x in enumerate(rows))
    idx = torch.from_numpy(np.random.RandomState(14).randint(0, 4, n_rows).astype(np.int32))
    bf16 = torch.bfloat16
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    k1 = kdec.decode_select(*on, T, inp_format, compute_dtype=bf16)
    args = kda.prepare(*_k2_bf16_inputs(stacked, rows, inp_format, cuda), T, inp_format, bf16)
    before = dict(kernels.launches)
    outs = [kda.launch_fwd(args, save_hc) for save_hc in (False, True)]
    outs += [kda.launch_fwd(args, True, shape=(v, b))
             for v in range(len(kda.MMA_BLOCKS_PER_SM)) for b in (1, 3)]
    torch.cuda.synchronize()
    launched = len(outs) if n_rows else 0  # no rows: nothing to launch
    assert kernels.launches[kda.KERNEL_FWD_BF16] == before.get(kda.KERNEL_FWD_BF16, 0) + launched
    pick, rows_n = idx.to(cuda).long(), torch.arange(n_rows, device=cuda)
    for out in outs:
        for a, b in zip(k1, out[:2]):
            assert torch.equal(a, b[pick, rows_n])
        if out[2] is not None:
            assert torch.equal(out[2], outs[1][2])


@pytest.mark.cuda
@pytest.mark.parametrize("num_gens,inp_format,h_dim", [
    (4, "rel", 32), (4, "abs_rel", 20), (24, "rel", 32)])
def test_k2_bf16_matches_plain_version_and_saves_hc(cuda, num_gens, inp_format, h_dim):
    """K2-bf16 saving hc at 37 x 20 = 740 rows against the bf16 plain
    version: abs, rel and hc within BF16_ATOL, hc's mean within
    HC_MEAN_ATOL (chip_smoke.py's hc_checks), every saved h a bf16 value,
    almost no saved c one; also at 24 generators, more than K1-bf16's
    shared memory holds (K2-bf16 stages one generator a block)."""
    stacked, rows = _decode_all_case(inp_format, h_dim, g_count=num_gens, seed=15)
    inputs = _k2_bf16_inputs(stacked, rows, inp_format, cuda)
    bf16 = torch.bfloat16
    got = kda.decode_all_fwd(*inputs, T, inp_format, save_hc=True, compute_dtype=bf16)
    torch.cuda.synchronize()
    want = kda.decode_all_reference(*inputs, T, inp_format, save_hc=True, compute_dtype=bf16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=HC_ATOL)
    assert float((got[2] - want[2]).abs().mean()) <= HC_MEAN_ATOL
    h, c = got[2][..., 0, :], got[2][..., 1, :]
    assert torch.equal(h, h.to(bf16).float())
    assert float((c == c.to(bf16).float()).float().mean()) < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["f32", "bf16", "lin"])
@pytest.mark.parametrize("case", ["random", "ragged", "rows without a generator"])
def test_tiled_b1_equals_warp_kernels(cuda, act, case):
    """B1 on the tiled f32 rollout, at R = 1, 2, 4, tiles of 8 and 32 rows
    and the rule's pick, equals its warp-per-row kernel bit for bit (and
    B1-f32 the tiled K1), in abs and rel; rows without a generator come back
    NaN."""
    stacked, rows, idx = _tiled_k1_case(case, "rel", 32, seed=16)
    on = [_on(x, cuda) for x in (stacked, *rows, idx)]
    prepared = kdec.prepare_decode_select(*on, T, "rel")
    before = dict(kernels.launches)
    base = kab.launch_act_warp(prepared, act)
    n = idx.shape[0]
    got = [kab.decode_select_act(*on, T, act)] + [
        kab.launch_act(prepared, act, shape=(r, tile, -(-n // tile)))
        for r in kdec.TILED_ROWS for tile in (8, 32)]
    torch.cuda.synchronize()
    assert kernels.launches[kab.KERNELS[act]] == before.get(kab.KERNELS[act], 0) + len(got)
    assert kernels.launches[kab.KERNELS_WARP[act]] == before.get(kab.KERNELS_WARP[act], 0) + 1
    if act == "f32":
        got.append(kdec.launch_decode_select(prepared))
    bad = ((idx < 0) | (idx >= 4)).to(cuda)
    for out in got:
        for a, b in zip(out, base):
            assert torch.equal(a[~bad], b[~bad])
            assert bool(torch.isnan(a[bad]).all())


@pytest.mark.cuda
def test_patch_bank_gather_equals_host_assembly(cuda):
    """The bank's gather on the card equals host assembly bit for bit, pad
    scenes and padded peds zero."""
    from mggan_tpu_torch.data.batcher import PaddedBatcher
    from mggan_tpu_torch.data.patch_bank import DevicePatchBank
    from mggan_tpu_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(num_windows=40, max_peds=7, seed=5)
    bank = DevicePatchBank(ds, 7, device=cuda)
    host = PaddedBatcher(ds, batch_size=16, max_peds=7)
    idx = np.random.RandomState(0).permutation(40)[:13]
    got = bank.gather(np.concatenate([idx, [-1, -1, -1]]))
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), torch.from_numpy(host.make_batch(idx)["big_patches"]))


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_train_augmentation_matches_cpu(cuda, interp):
    """augment_batch(train=True) on the card against the CPU path, same
    draws: trajectories within 1e-4; bilinear patches within 1e-5, nearest
    ones equal but at source coordinates within 1e-4 px of a half-integer
    (an ulp of cos or sin may round them the other way)."""
    from mggan_tpu_torch.data import augment
    from mggan_tpu_torch.data.batcher import PaddedBatcher
    from mggan_tpu_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(num_windows=32, max_peds=6, seed=6)
    batch = PaddedBatcher(ds, batch_size=32).make_batch(np.arange(32))
    aug = augment.sample_aug_params(torch.Generator().manual_seed(1), 32)
    got = augment.augment_batch(batch, True, device=cuda, interp=interp, aug=aug)
    want = augment.augment_batch(batch, True, device="cpu", interp=interp, aug=aug)
    np.testing.assert_allclose(got["xy"].cpu().numpy(), want["xy"].numpy(), atol=1e-4)
    g, w = got["patches"].cpu().numpy(), want["patches"].numpy()
    if interp == "bilinear":
        np.testing.assert_allclose(g, w, atol=1e-5)
        return
    diff = (g != w).any(axis=(1, 4)).reshape(32, -1)
    sx, sy = augment.source_coords(*aug)
    off = lambda c: np.abs(c.numpy() - np.floor(c.numpy()) - 0.5)
    assert not (diff & (off(sx) >= 1e-4) & (off(sy) >= 1e-4)).any()
    assert diff.sum() <= 8


@pytest.mark.cuda
def test_read_rgb_nvjpeg_matches_cv2_decode(cuda, monkeypatch):
    """read_rgb's nvJPEG route on the committed fixture JPEG against its
    committed cv2 decode: nvJPEG rounds YCbCr to RGB its own way, so pixels
    may differ by up to 4 levels, and at most 16,000 of 414,720 by more
    than 1 (chip_smoke.py's NVJPEG_LIMITS; 4 and 13,733 on an H100)."""
    from pathlib import Path

    from mggan_tpu_torch.data import image_io

    fixtures = Path(__file__).resolve().parents[1] / "mggan_tpu_torch" / "tools" / "fixtures"
    want = np.load(fixtures / "scene_cv2.npz")["rgb"]
    monkeypatch.setattr(image_io, "_cv2", lambda: None)  # as where cv2 is not installed
    assert image_io.decoder() == "nvjpeg"
    got = image_io.read_rgb(fixtures / "scene.jpg")
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(-1)
    assert d.max() <= 4 and (d > 1).sum() <= 16_000
    np.testing.assert_array_equal(image_io.decode_nvjpeg(fixtures / "scene.jpg"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("gan_type,wt,gan_obj", [
    ("gan", "l2", "NS"), ("infogan", "none", "NS"), ("mgan", "ml", "W"),
    ("probgan", "ml", "NS"),
])
def test_golden_family_step_matches_cpu(cuda, gan_type, wt, gan_obj):
    """One train step of each golden family (tests/test_golden.py's config
    and batch) on the card (K1, K2, K3) and on the CPU (plain versions)
    from the same weights and draws, float32 throughout (TF32 off for the
    convolutions too): metrics and parameters within 1e-4, but where a
    gradient is float noise, so that Adam's step may flip sign
    (``tools/state_compare.py``): there the parameter within 2 * lr per
    Adam update and the gradient within 1e-4 of its module's rms. The conv
    biases before train-mode BN are such leaves, and under W the D heads'
    output bias: W's D loss is a difference of two means over the same
    agents, whose derivative by that bias is 0."""
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.models.factory import construct_gan
    from mggan_tpu_torch.tools.state_compare import train_state_diffs
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step, make_draws

    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(dataset="synthetic_memory", batch_size=4, num_gens=2, epochs=2,
                 num_samples=3, num_expectation_samples=2, h_dim=16, decoder_h_dim=16,
                 noise_dim=8, gan_type=gan_type, weighting_target=wt, gan_obj=gan_obj)
    g_pack, d_pack = construct_gan(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(11)
    xy = rng.randn(4, 3, 20, 2).astype(np.float32).cumsum(axis=2)
    mask = np.ones((4, 3), bool)
    mask[0, -1] = False
    xy[~mask] = 0.0
    batch = {"xy": xy, "ped_mask": mask,
             "patches": rng.uniform(-1, 1, (4, 3, 33, 33, 4)).astype(np.float32)}
    draws = make_draws(torch.Generator().manual_seed(1), cfg, 4, 3, g_pack[0], d_pack[0])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        g = (_on(g_pack[0], dev), _on(g_pack[1], dev), g_pack[2])
        d = (_on(d_pack[0], dev), _on(d_pack[1], dev), d_pack[2])
        before = dict(kernels.launches)
        out[dev.type] = build_train_step(cfg, g[2], d[2])(init_train_state(cfg, g, d), batch,
                                                         draws)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for name in (kdec.KERNEL, kda.KERNEL_FWD, kda.KERNEL_BWD):
                assert kernels.launches[name] > before.get(name, 0), name
    (s_gpu, m_gpu), (s_cpu, m_cpu) = out["cuda"], out["cpu"]
    assert set(m_gpu) == set(m_cpu)
    for k, want in m_cpu.items():
        np.testing.assert_allclose(float(m_gpu[k]), float(want), atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    noise = {("scene", "conv1", "b"), ("scene", "conv2", "b")}
    if gan_obj == "W":
        noise.add(("discs", "lin1", "b"))
    diffs = train_state_diffs(s_gpu, s_cpu, cfg, 1e-4, noise)
    assert not diffs["bad"], diffs["bad"][:4]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["sampling", "expected"])
def test_artifact_on_the_card_equals_live_serving(cuda, tmp_path, strategy):
    """An artifact of ``cli.export`` served on the card equals live serving
    of the same weights on the card bit for bit (same kernels, same draws),
    at each bucket; K1 (sampling) or K2 (expected) launches."""
    from mggan_tpu_torch.cli.export import save_artifact
    from mggan_tpu_torch.config import flagship_config
    from mggan_tpu_torch.eval.predict import Predictor
    from mggan_tpu_torch.models.factory import construct_model
    from mggan_tpu_torch.serving.runtime import ServingModel

    cfg = flagship_config()
    params, state, spec = construct_model(cfg, seed=0, device=cuda)
    pred = Predictor(cfg, spec, params, state, device=cuda)
    live = ServingModel.from_predictor(pred, strategy, 8, 16, 20, scene_buckets=(1, 8),
                                       device=cuda)
    save_artifact(pred, tmp_path / "m.mgtorch", strategy, (1, 8), 16, 20)
    art = ServingModel.from_artifact(tmp_path / "m.mgtorch", device=cuda)
    assert art.buckets == (1, 8) and art.device == cuda
    name = kdec.KERNEL if strategy == "sampling" else kda.KERNEL_FWD
    op = ("mggan.decode_select.default" if strategy == "sampling"
          else "mggan.decode_all_fwd.default")
    for b in art.buckets:  # each bucket program calls the kernel's operator
        assert op in {str(n.target) for n in art._calls[b].program.graph.nodes}
    rng = np.random.RandomState(1)
    for n in (1, 5):
        obs = [(rng.randn(p, 8, 2).cumsum(1) * 0.4).astype(np.float32)
               for p in rng.randint(1, 17, n)]
        pat = [rng.uniform(-1, 1, (len(o), 33, 33, 4)).astype(np.float32) for o in obs]
        before = kernels.launches[name]
        got = art.predict_batch(obs, pat, seed=3)
        assert kernels.launches[name] > before
        for a, b in zip(got, live.predict_batch(obs, pat, seed=3)):
            assert np.isfinite(a).all()
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_dp_step_on_two_ranks_matches_one_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (``parallel/dp.py``; NCCL would need
    a card each) run the mgan / ml step on 4 of the 8 scenes each and equal
    the single-device step on the card from the same weights and draws,
    to ``tests/test_parallel.py::assert_steps_match``'s tolerances:
    metrics rtol 1e-5, Adam moments rtol 1e-4 / atol 1e-6, parameters
    2e-3. Both ranks launch K1, K2 and K3 and end bit for bit alike."""
    from _torch_dp_worker import launch
    from mggan_tpu_torch.config import Config
    from mggan_tpu_torch.models.factory import construct_gan
    from mggan_tpu_torch.training.state import init_train_state
    from mggan_tpu_torch.training.steps import build_train_step, make_draws
    from mggan_tpu_torch.utils.pytree import tree_items

    torch.backends.cudnn.allow_tf32 = False
    kw = dict(dataset="synthetic_memory", batch_size=8, num_gens=2, num_samples=4,
              h_dim=16, decoder_h_dim=16, gan_type="mgan", weighting_target="ml")
    cfg = Config(**kw)
    g_pack, d_pack = construct_gan(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(5)
    batch = {"xy": rng.randn(8, 5, 20, 2).astype(np.float32).cumsum(axis=2) * 0.1,
             "ped_mask": np.ones((8, 5), bool),
             "patches": rng.uniform(-1, 1, (8, 5, 33, 33, 4)).astype(np.float32)}
    batch["ped_mask"][3, 2:] = False
    draws = make_draws(torch.Generator().manual_seed(3), cfg, 8, 5)
    weights = {"g_params": g_pack[0], "g_state": g_pack[1], "d_params": d_pack[0],
               "d_state": d_pack[1]}
    g = (_on(g_pack[0], cuda), _on(g_pack[1], cuda), g_pack[2])
    d = (_on(d_pack[0], cuda), _on(d_pack[1], cuda), d_pack[2])
    want, want_m = build_train_step(cfg, g[2], d[2])(init_train_state(cfg, g, d), batch, draws)
    torch.cuda.synchronize()
    ranks = launch(tmp_path, 2, [{"kind": "step", "config": {**kw, "dp": 2},
                                  "weights": weights, "batch": batch, "draws": draws,
                                  "device": "cuda"}],
                   timeout_s=120, device="cuda")
    results = [r[0] for r in ranks]
    for res in results:
        assert res["rows"] == 4
        for name in (kdec.KERNEL, kda.KERNEL_FWD, kda.KERNEL_BWD):
            assert res["launches"].get(name, 0) > 0, name
    for name, tree in results[0]["state"].items():
        if isinstance(tree, dict):
            other = dict(tree_items(results[1]["state"][name]))
            assert all(np.array_equal(x, other[p]) for p, x in tree_items(tree)), name
    got, got_m = results[0]["state"], results[0]["metrics"]
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    for name, tree in (("g_mu", want.g_opt.mu), ("g_nu", want.g_opt.nu),
                       ("d_mu", want.d_opt.mu), ("d_nu", want.d_opt.nu)):
        flat = dict(tree_items(got[name]))
        for path, w in tree_items(tree):
            np.testing.assert_allclose(flat[path], w.cpu().numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {path}")
    for name in ("g_params", "d_params"):
        flat = dict(tree_items(got[name]))
        worst = max(float(np.abs(flat[p] - w.cpu().numpy()).max())
                    for p, w in tree_items(getattr(want, name)))
        assert worst < 2e-3, (name, worst)
