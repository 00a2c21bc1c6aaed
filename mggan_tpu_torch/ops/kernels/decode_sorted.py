"""Sorted-selection decoder rollout: the ports of the TPU kernel K4 and of
B2, its kernel launched alone.

Counterpart of ``mggan_tpu/ops/pallas/decoder.py::pallas_decode_select_sorted``
(kernel ``_fwd_sorted_kernel``) and of
``benchmarks/sorted_select_ablation.py::kernel_only``. The route computes
what K1 (``decoder.decode_select``) computes, another way: it groups the
rows by sampled generator so that each CUDA block holds one generator's
weights instead of all of them.

1. ``sorted_layout``: each row's place in a buffer where the rows of every
   generator are contiguous, each group padded to whole tiles, with JAX's
   arithmetic (bincount, stable rank by a cumulative sum of the one-hot,
   group starts, the inverse scatter, each tile's generator);
2. ``sorted_rows``: one gather of the rows ``[h0 | social | xy | dxdy]``
   into that buffer; padding rows read a zero row;
3. the kernel (through ``launch_sorted_tiles``) on CUDA tensors, or its
   plain version ``sorted_tiles_reference`` on CPU tensors: each tile rolls
   out its generator, ``socb = social @ W1s + b1`` computed per row in f32
   as the TPU kernel does;
4. one gather of the outputs back to the rows' order.

The index maths and the gathers were plain XLA around the Pallas kernel in
JAX, and stay plain tensor ops here. The tile is the CUDA block's rows
(``TILE``), not the TPU's 1024, on both devices.

The f32 kernel (and B2) is ``csrc/decode_sorted_tiled.cu``: a block per
tile stages the tile's generator, computes the tile's socb, and each warp
rolls out groups of ``TILED_GROUP`` rows of the tile with the tiled K1's
rollout (``csrc/rollout_tile.cuh``), 8 or 4 warps a block
(``tiled_variant``), bit-identical to the warp-per-row kernel it
replaced. That kernel stays in ``csrc/decode_sorted.cu`` for comparison
on the card (``launch_sorted_tiles_warp`` and the route
``decode_select_sorted_warp``, counted as ``decode_sorted_warp``); no path
launches it.

``compute_dtype=torch.bfloat16`` is K4-bf16, with K1's bf16 numerics
(``decoder.py``'s module note): ``csrc/decode_sorted_mma.cu``, K1-bf16's
tensor-core rollout on the tile's 8 groups of 16 rows, weights as the
fragment image ``decoder.mma_weights`` (counted as ``decode_sorted_bf16``).
The warp-per-row bf16 kernel it replaced stays in ``csrc/decode_sorted.cu``
for comparison on the card (``launch_sorted_tiles_bf16_warp``, counted as
``decode_sorted_bf16_warp``); no path launches it. Forward only: under
autograd it raises, as K1 does.

Row layout as K1's: ``h0 (N, H)`` and ``gen_idx (N,)`` have a row per
rollout; ``last_xy``, ``last_dxdy`` and ``social_feats`` have ``M`` rows
with ``N % M == 0``, and rollout ``n`` reads row ``n % M``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mggan_tpu_torch.ops import kernels
from mggan_tpu_torch.ops.kernels import build
from mggan_tpu_torch.ops.kernels import decoder as kdec

SOURCE = "decode_sorted"  # csrc/decode_sorted.cu: the warp-per-row K4 and K4-bf16
TILED_SOURCE = "decode_sorted_tiled"  # csrc/decode_sorted_tiled.cu: K4, B2
MMA_SOURCE = "decode_sorted_mma"  # csrc/decode_sorted_mma.cu: K4-bf16
KERNEL = "decode_sorted"  # K4, through the route
KERNEL_WARP = "decode_sorted_warp"  # the warp-per-row K4, for comparison
KERNEL_BF16 = "decode_sorted_bf16"  # K4-bf16, through the route or alone
KERNEL_BF16_WARP = "decode_sorted_bf16_warp"  # the warp-per-row K4-bf16, for comparison
KERNEL_TILES = "sorted_tiles"  # B2: the f32 kernel launched alone on grouped rows
TILE = 128  # rows per CUDA block (kTile in csrc/decode_sorted*.cu)
# K4's groups of rows a warp, and its launch variants: warps a block (16 or
# 20 warps an SM); ``tiled_variant`` picks one.
TILED_GROUP = 4
TILED_WARPS = (8, 4)
# K4-bf16's launch variants: warps a block (16 warps an SM in each), and the
# one the route takes, from the launch sweep of chip_smoke.py --sweep on an
# H100.
MMA_WARPS = (2, 4, 8)
MMA_VARIANT = 2


def stable_rank(idx, num_gens: int):
    """Each row's rank among the earlier rows of its generator: the
    cumulative sum of the one-hot at the row's generator, less one. The
    one-hot is laid out (G, N) and summed flat, one scan over contiguous
    memory; each generator's part then starts from the sum of the parts
    before it. (On the card a sum down the rows of an (N, G) one-hot took
    137 ms at 1,310,720 rows, and one along each of the G rows 1.9 ms.)"""
    n = idx.shape[0]
    onehot = (idx[None, :] == torch.arange(num_gens, device=idx.device)[:, None]).int()
    csum = onehot.reshape(-1).cumsum(0, dtype=torch.int32)
    before = torch.cat([csum.new_zeros(1), csum[n - 1::n][:-1]])
    return csum[idx * n + torch.arange(n, device=idx.device)] - before[idx] - 1


def sorted_layout(gen_idx, num_gens: int, tile: int = TILE):
    """The group-padded layout of ``pallas_decode_select_sorted``.

    Returns ``(dest, inv, tile_gen, n_buf)``: row ``n`` goes to buffer row
    ``dest[n]`` (its group's start plus its stable rank within the group);
    buffer row ``j`` reads row ``inv[j]``, where ``inv[j] == N`` for padding
    (the zero row); tile ``i`` runs generator ``tile_gen[i]`` (int32,
    clipped to ``[0, G-1]``); ``n_buf = ceil(N / tile) * tile + G * tile``.
    """
    n, dev = gen_idx.shape[0], gen_idx.device
    idx = gen_idx.long()
    counts = torch.bincount(idx, minlength=num_gens)
    padded = (counts + tile - 1) // tile * tile
    starts = torch.cat([padded.new_zeros(1), padded.cumsum(0)[:-1]])
    rank = stable_rank(idx, num_gens)
    dest = starts[idx] + rank
    n_buf = -(-n // tile) * tile + num_gens * tile
    tile_start = torch.arange(n_buf // tile, device=dev) * tile
    tile_gen = (torch.searchsorted(starts, tile_start, right=True) - 1).clamp(0, num_gens - 1)
    inv = torch.full((n_buf,), n, dtype=torch.long, device=dev)
    inv[dest] = torch.arange(n, device=dev)
    return dest, inv, tile_gen.to(torch.int32), n_buf


def sorted_rows(h0, social_feats, last_xy, last_dxdy, inv):
    """Gather ``[h0 | social | xy | dxdy]`` into the buffer's order ->
    ``(n_buf, H + F + 4)``; ``inv == N`` reads zeros. With one row per
    rollout (M == N) it is one gather of the concatenated rows."""
    n, m = h0.shape[0], last_xy.shape[0]

    def table(*parts):  # the parts side by side, then a zero row
        out = parts[0].new_zeros((parts[0].shape[0] + 1, sum(x.shape[1] for x in parts)))
        torch.cat(parts, dim=1, out=out[:-1])
        return out

    if m == n:
        return table(h0, social_feats, last_xy, last_dxdy)[inv]
    agent_row = torch.where(inv < n, inv % m, m)
    return torch.cat([table(h0)[inv], table(social_feats, last_xy, last_dxdy)[agent_row]], dim=1)


def _split_rows(rows, h_dim: int, feat: int):
    return (rows[:, :h_dim], rows[:, h_dim:h_dim + feat], rows[:, h_dim + feat:h_dim + feat + 2],
            rows[:, h_dim + feat + 2:])


def sorted_tiles_reference(tile_gen, tile: int, packed, rows, h_dim: int, feat: int,
                           pred_len: int, inp_format: str, compute_dtype=None):
    """The kernel's plain version: every tile of ``rows`` rolled out on its
    generator ``tile_gen[tile]`` (``decoder.rollout_reference`` with that
    generator's folded weights; socb from each row's social features).
    ``packed`` is ``decoder.pack_decoder_params``'s. Returns ``(n_buf, 2,
    T, 2)``: [abs | rel] per row; a tile with no generator is NaN."""
    n_buf = rows.shape[0]
    gen = tile_gen.long().repeat_interleave(tile)
    h0, soc, xy, dxdy = _split_rows(rows, h_dim, feat)
    out = rows.new_full((n_buf, 2, pred_len, 2), float("nan"))
    for g in range(packed["w_hh"].shape[0]):
        sel = (gen == g).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        socb = soc[sel] @ packed["w1s"][g] + packed["b1"][g]
        abs_g, rel_g, _ = kdec.rollout_reference(
            *(packed[k][g:g + 1] for k in kdec.PACKED), socb[:, None], h0[sel], xy[sel],
            dxdy[sel], pred_len, inp_format, compute_dtype=compute_dtype)
        out[sel, 0], out[sel, 1] = abs_g[0], rel_g[0]
    return out


@functools.cache
def _lib(stem: str = TILED_SOURCE):
    """The library of ``csrc/<stem>.cu`` (K4's, the warp-per-row kernels or
    K4-bf16's), its entry points typed and its tile checked (and the tiled
    K4's group and launch variants)."""
    lib = build.load(stem)
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    prefix, entries, smem_args = {
        TILED_SOURCE: ("mggan_decode_sorted_tiled", ("mggan_decode_sorted",), 6),
        SOURCE: ("mggan_decode_sorted", ("mggan_decode_sorted_warp",
                                         "mggan_decode_sorted_bf16_warp"), 3),
        MMA_SOURCE: ("mggan_decode_sorted_mma", ("mggan_decode_sorted_bf16",), 2),
    }[stem]
    ints = 9 if stem == TILED_SOURCE else 8  # the tiled K4: per_gen, then the launch variant
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [ll] + [i32] * ints + [ptr]
        fn.restype = i32
    tile, smem = getattr(lib, f"{prefix}_tile"), getattr(lib, f"{prefix}_smem")
    tile.restype = i32
    smem.argtypes = [i32] * smem_args
    smem.restype = ll
    lib.mggan_cuda_error_string.argtypes = [i32]
    lib.mggan_cuda_error_string.restype = ctypes.c_char_p
    if tile() != TILE:
        raise RuntimeError(f"csrc/{stem}.cu tiles {tile()} rows, decode_sorted.py {TILE}")
    if stem == TILED_SOURCE:
        warps = [lib.mggan_decode_sorted_tiled_warps(v) for v in range(len(TILED_WARPS))]
        if lib.mggan_decode_sorted_tiled_rows() != TILED_GROUP or tuple(warps) != TILED_WARPS:
            raise RuntimeError(f"csrc/{stem}.cu's groups and launch variants are not "
                               f"{TILED_GROUP} rows and {TILED_WARPS} warps")
    return lib


def prepare_sorted_tiles(packed, rows, tile_gen, h_dim: int, feat: int, pred_len: int,
                         inp_format: str, compute_dtype=None):
    """The weight image (f32 or bf16), ``W1s``, ``b1`` and the checked row
    buffer and tile generators the kernel takes (``launch_sorted_tiles``),
    with the shared memory a block of the route's launch (in f32, the tiled
    K4's at ``tiled_variant``'s pick, ``variant``) and of the warp-per-row
    kernel; in bf16 also K4-bf16's fragment image
    (``decoder.mma_weights``)."""
    bf16 = kdec.is_bf16(compute_dtype)
    wflat, per_gen = kdec.kernel_weights(packed, compute_dtype)
    g, in_dim, four_h = packed["w_emb"].shape
    hid = packed["w1h"].shape[2]
    n_buf, dev = rows.shape[0], rows.device
    if dev.type != "cuda":
        raise ValueError(f"the sorted rollout kernel needs CUDA tensors, got {dev}")
    if four_h != 4 * h_dim or packed["w1s"].shape[1] != feat:
        raise ValueError("rows do not fit the decoder's widths")
    if max(h_dim, hid, pred_len, feat) > 32:
        raise ValueError(f"kernel takes H, hid, pred_len, F <= 32; got {h_dim}, {hid}, "
                         f"{pred_len}, {feat}")
    if n_buf % TILE:
        raise ValueError(f"{n_buf} buffer rows are not whole tiles of {TILE}")
    w1s, b1 = packed["w1s"].contiguous(), packed["b1"].contiguous()
    f32 = torch.float32
    kdec.check_arg("wpack", wflat, (g * per_gen,), f32, dev)
    kdec.check_arg("w1s", w1s, (g, feat, hid), f32, dev)
    kdec.check_arg("b1", b1, (g, hid), f32, dev)
    kdec.check_arg("tile_gen", tile_gen, (n_buf // TILE,), torch.int32, dev)
    kdec.check_arg("rows", rows, (n_buf, h_dim + feat + 4), f32, dev)
    smem = _lib(SOURCE).mggan_decode_sorted_smem(feat, hid, per_gen)
    if smem > kdec.MAX_SHARED_BYTES:
        raise ValueError(f"one generator's weights ({smem} B) exceed one block's shared memory")
    args = {"tensors": (wflat, w1s, b1, tile_gen, rows),
            "dims": (n_buf, g, feat, h_dim, hid, in_dim, pred_len, kdec.FORMATS[inp_format],
                     per_gen),
            "bf16": bf16, "warp_smem_bytes": smem}
    if bf16:  # K4-bf16 stages its generator's fragment image, W1s, b1 and the tile's socb
        args["mma_wpack"] = kdec.mma_weights(packed).reshape(-1)
        args["mma_smem_bytes"] = _lib(MMA_SOURCE).mggan_decode_sorted_mma_smem(feat, hid)
        if args["mma_smem_bytes"] > kdec.MAX_SHARED_BYTES:
            raise ValueError(f"K4-bf16's block ({args['mma_smem_bytes']} B) exceeds one "
                             "block's shared memory")
    else:  # the tiled K4 stages its generator, W1s, b1, the tile's socb and the warps' h
        args["variant"] = tiled_variant(n_buf, kdec.sm_count(dev))
        args["smem_bytes"] = tiled_smem(args)
        if args["smem_bytes"] > kdec.MAX_SHARED_BYTES:
            raise ValueError(f"K4's block ({args['smem_bytes']} B) exceeds one block's shared "
                             "memory")
    return args


def tiled_variant(n_buf: int, sms: int) -> int:
    """The tiled K4's launch variant (an index of ``TILED_WARPS``) for a
    buffer of ``n_buf`` rows on ``sms`` SMs: 8 warps a block (each warp
    takes 4 groups, so a tile is done sooner) while the tiles fit in one
    wave of resident 8-warp blocks (2 an SM), else 4 (20 warps an SM, 5
    blocks). From the launch sweep of ``chip_smoke.py --sweep`` on an H100:
    8 warps 30-50% faster at 9,728 and 20,480 rows, 4 warps 8% faster at
    81,920 and 1,310,720; groups of 1 or 2 rows were slower at all four."""
    return 1 if n_buf // TILE > 2 * sms else 0


def tiled_smem(args, variant: int | None = None) -> int:
    """Shared memory a block of the tiled K4's launch variant ``variant``
    (the arguments' by default) takes at these arguments' widths, in
    bytes."""
    _, _, feat, h, hid, _, t, _, per_gen = args["dims"]
    variant = args["variant"] if variant is None else variant
    return _lib().mggan_decode_sorted_tiled_smem(variant, feat, h, hid, t, per_gen)


def launch_sorted_tiles(args, count_as: str | None = None, variant: int | None = None):
    """The K4 kernel on the current stream over every tile of the checked
    buffer (``prepare_sorted_tiles``) -> ``(n_buf, 2, T, 2)``: the tiled f32
    kernel with ``TILED_WARPS[variant]`` warps a block (by default
    ``tiled_variant``'s pick for the buffer), counted under ``count_as`` (B2's name by default; the route
    counts as K4), or K4-bf16 on bf16 arguments, counted as
    ``decode_sorted_bf16`` with ``MMA_WARPS[variant]`` warps a block
    (``MMA_VARIANT`` by default)."""
    if args["bf16"]:
        tensors = (args["mma_wpack"],) + args["tensors"][1:]
        dims = args["dims"][:8] + (MMA_VARIANT if variant is None else variant,)
        return _run(tensors, dims, _lib(MMA_SOURCE).mggan_decode_sorted_bf16, KERNEL_BF16)
    dims = args["dims"] + (args["variant"] if variant is None else variant,)
    return _run(args["tensors"], dims, _lib().mggan_decode_sorted, count_as or KERNEL_TILES)


def launch_sorted_tiles_warp(args):
    """The warp-per-row f32 K4 that the tiled design replaced, on f32
    arguments from ``prepare_sorted_tiles``: the same function, bit for bit,
    for comparing the two on the card (counted as ``decode_sorted_warp``)."""
    if args["bf16"]:
        raise ValueError("the warp-per-row f32 K4 takes f32 arguments")
    return _run(args["tensors"], args["dims"], _lib(SOURCE).mggan_decode_sorted_warp,
                KERNEL_WARP)


def launch_sorted_tiles_bf16_warp(args):
    """The warp-per-row K4-bf16 that the tensor-core design replaced, on
    bf16 arguments from ``prepare_sorted_tiles``: the same function, for
    comparing the two on the card (counted as ``decode_sorted_bf16_warp``)."""
    if not args["bf16"]:
        raise ValueError("the warp-per-row K4-bf16 takes bf16 arguments")
    return _run(args["tensors"], args["dims"], _lib(SOURCE).mggan_decode_sorted_bf16_warp,
                KERNEL_BF16_WARP)


def _warps(fn, *ints) -> int:
    fn.argtypes = [ctypes.c_int] * len(ints) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    rc = fn(*ints, ctypes.byref(warps))
    if rc:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {rc}")
    return warps.value


def tiled_warps_per_sm(args, variant: int | None = None) -> int:
    """Resident warps per SM of the tiled K4's launch variant ``variant``
    (the arguments' by default) at these f32 arguments' widths."""
    _, _, feat, h, hid, _, t, _, per_gen = args["dims"]
    variant = args["variant"] if variant is None else variant
    return _warps(_lib().mggan_decode_sorted_tiled_warps_per_sm, variant, feat, h, hid, t,
                  per_gen)


def mma_warps_per_sm(args, variant: int = MMA_VARIANT) -> int:
    """Resident warps per SM of K4-bf16's launch variant ``variant`` at
    these bf16 arguments' widths."""
    feat, hid = args["dims"][2], args["dims"][4]
    return _warps(_lib(MMA_SOURCE).mggan_decode_sorted_bf16_warps_per_sm, variant, feat, hid)


def _run(tensors, dims, fn, count_as):
    n_buf, t = dims[0], dims[6]
    out = torch.empty((n_buf, 2, t, 2), dtype=torch.float32, device=tensors[0].device)
    lib = _lib(SOURCE)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(x.data_ptr() for x in tensors), out.data_ptr(), *dims, stream)
    if rc:
        err = lib.mggan_cuda_error_string(rc).decode()
        raise RuntimeError(f"{count_as} launch failed: {err} ({rc})")
    kernels.launches[count_as] += 1
    return out


def check_gen_idx(gen_idx, n: int, num_gens: int):
    """Every row must name a generator: the layout has no place for one
    that does not (K1 poisons such a row instead). One host sync."""
    kdec.check_arg("gen_idx", gen_idx, (n,), torch.int32, gen_idx.device)
    lo, hi = torch.aminmax(gen_idx)
    if int(lo) < 0 or int(hi) >= num_gens:
        raise ValueError(f"gen_idx holds {int(lo)}..{int(hi)}, outside 0..{num_gens - 1}")


def _route(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx, pred_len: int,
           inp_format: str, compute_dtype, run_tiles):
    """Layout, row gather, ``run_tiles(packed, rows, tile_gen, h_dim, feat)``
    over the buffer, output gather -> ``(abs, rel)``."""
    packed = kdec.pack_decoder_params(stacked, inp_format)
    g = packed["w_hh"].shape[0]
    n, h_dim = h0.shape
    if n == 0:
        empty = h0.new_empty((0, pred_len, 2))
        return empty, empty.clone()
    check_gen_idx(gen_idx, n, g)
    dest, inv, tile_gen, _ = sorted_layout(gen_idx, g)
    rows = sorted_rows(h0, social_feats, last_xy, last_dxdy, inv)
    out = run_tiles(packed, rows, tile_gen, h_dim, social_feats.shape[1])[dest]
    return out[:, 0], out[:, 1]


def decode_select_sorted_reference(stacked, last_xy, last_dxdy, social_feats, h0,
                                   gen_idx, pred_len: int, inp_format: str,
                                   compute_dtype=None):
    """The route's plain version, on any device: the same layout and
    gathers around ``sorted_tiles_reference``."""
    tiles = lambda packed, rows, tile_gen, h_dim, feat: sorted_tiles_reference(
        tile_gen, TILE, packed, rows, h_dim, feat, pred_len, inp_format, compute_dtype)
    return _route(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx, pred_len,
                  inp_format, compute_dtype, tiles)


def decode_select_sorted(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx,
                         pred_len: int, inp_format: str, compute_dtype=None):
    """Rollout of each row's sampled generator by the sorted route ->
    ``(abs, rel)``, each ``(N, pred_len, 2)``: the kernel on CUDA tensors
    (counted as ``decode_sorted`` / ``decode_sorted_bf16``), the plain
    version on CPU tensors, the same layout on both (see the module note)."""
    kdec.refuse_autograd("decode_select_sorted", stacked, last_xy, last_dxdy, social_feats, h0)
    args = (stacked, last_xy, last_dxdy, social_feats, h0, gen_idx, pred_len, inp_format,
            compute_dtype)
    if h0.device.type == "cpu":
        return decode_select_sorted_reference(*args)
    if h0.device.type != "cuda":
        raise ValueError(f"decode_select_sorted: unsupported device {h0.device}")

    def tiles(packed, rows, tile_gen, h_dim, feat):
        prepared = prepare_sorted_tiles(packed, rows, tile_gen, h_dim, feat, pred_len,
                                        inp_format, compute_dtype)
        return launch_sorted_tiles(prepared, KERNEL)

    return _route(*args, tiles)


def decode_select_sorted_warp(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx,
                              pred_len: int, inp_format: str):
    """The f32 route on the warp-per-row K4 that the tiled kernel replaced
    (counted as ``decode_sorted_warp``): the same layout and gathers, for
    comparing the two routes bit for bit on the card; no path calls it."""
    kdec.refuse_autograd("decode_select_sorted_warp", stacked, last_xy, last_dxdy,
                         social_feats, h0)

    def tiles(packed, rows, tile_gen, h_dim, feat):
        return launch_sorted_tiles_warp(prepare_sorted_tiles(packed, rows, tile_gen, h_dim, feat,
                                                             pred_len, inp_format))

    return _route(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx, pred_len, inp_format,
                  None, tiles)
