"""All-generator decoder rollout and its reverse sweep: the ports of the
TPU kernels K2 and K3.

Counterpart of ``mggan_tpu/ops/pallas/decoder.py::pallas_decode_all``
(forward ``_fwd_kernel``, backward ``_bwd_kernel``). ``decode_all`` rolls
out every generator on every row and returns ``(abs, rel)``, each
``(G, N, pred_len, 2)``. The split mirrors JAX's custom VJP:

* the weight folding (``pack_decoder_params``) and the hoisted social bias
  (``social_bias``) stay plain differentiable PyTorch;
* ``DecodeAll``, a ``torch.autograd.Function`` over the folded per-generator
  tensors ``w_emb, w_hh, b, w1h, w2, b2`` and ``socb, h0, last_xy,
  last_dxdy``, runs the forward with the (h, c) sequence saved, and its
  backward runs the reverse sweep; autograd chains the grads back to the
  stacked params and the social features.

On CUDA tensors the forward launches K2 and the backward K3
(``csrc/decode_all.cu``), or they raise; on CPU tensors they run the plain
versions ``decode_all_reference`` and ``decode_all_bwd_reference``. There
is no other route. The forward goes through the operator
``mggan::decode_all_fwd`` (``library.py``), with or without (h, c), so a
``torch.export`` trace holds one node for it, and the backward through
``mggan::decode_all_bwd``, so a FLOP count reads the same work on both
devices. Without a gradient to take,
``decode_all`` runs the forward alone, without saving (h, c). K2 in f32 is the tiled kernel: a
block per (generator, slice of rows), R rows of one generator a warp (R
and the blocks from ``fwd_launch``), bit-identical to the warp-per-row K2,
which stays compiled as its yardstick (``launch_fwd_warp``, counted as
``decode_all_fwd_warp``; no path launches it).

``compute_dtype=torch.bfloat16`` runs K2's bf16 variant (counted as
``decode_all_fwd_bf16``; plain version ``decode_all_reference`` with the
same argument), with K1's bf16 numerics (``decoder.py``'s module note): K1-bf16's
tensor-core rollout on groups of 16 consecutive rows of one generator, the
generator's fragment image (``decoder.mma_weights``) in shared memory (the
launch from ``mma_launch``), bit-identical to K1-bf16 on the selected rows.
The warp-per-row kernel it replaced stays compiled as its yardstick
(``launch_fwd_warp`` on bf16 arguments, counted as
``decode_all_fwd_bf16_warp``; no path launches it).
Under autograd it saves (h, c) as the TPU kernel does (h the bf16-rounded
value, c in f32), and the backward is K3 on the **f32** folded weights from
those residuals and the bf16 forward's outputs, as JAX's ``_vjp_bwd`` after
``pallas_decode_all(..., compute_dtype=bfloat16)`` (counted as
``decode_all_bwd_after_bf16``; plain version ``decode_all_bwd_reference``
on the same residuals).

Row layout, as K1's: ``h0 (N, H)`` has a row per rollout; ``last_xy``,
``last_dxdy (M, 2)`` and ``socb (M, G, hid)`` have ``M`` rows with
``N % M == 0`` and rollout ``n`` reads row ``n % M`` (rows are
``(k, s, p)``-major). The grads of those M-row inputs are summed over the
K copies here, as the VJP of the broadcast (``.reshape(K, M, ...).sum(0)``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mggan_tpu_torch.ops import kernels
from mggan_tpu_torch.ops.kernels import build
from mggan_tpu_torch.ops.kernels import decoder as kdec

SOURCE = "decode_all"  # csrc/decode_all.cu
KERNEL_FWD = "decode_all_fwd"
# the warp-per-row f32 forward that K2's tiled design replaced, kept for
# comparison on the card (chip_smoke.py, the card tests); no path launches it
KERNEL_FWD_WARP = "decode_all_fwd_warp"
KERNEL_FWD_BF16 = "decode_all_fwd_bf16"
# the warp-per-row bf16 forward that K2-bf16's tensor-core design replaced,
# kept for comparison on the card; no path launches it
KERNEL_FWD_BF16_WARP = "decode_all_fwd_bf16_warp"
KERNEL_BWD = "decode_all_bwd"
KERNEL_BWD_AFTER_BF16 = "decode_all_bwd_after_bf16"  # K3 on a bf16 forward's residuals
# the warp-per-row reverse sweep that K3's tiled design replaced, kept for
# comparison on the card (chip_smoke.py, the card tests); no path launches it
KERNEL_BWD_WARP = "decode_all_bwd_warp"
PACKED = kdec.PACKED
BWD_ROWS = 8  # K3 takes at most one block per 8 rows (the warp-per-row sweep's warps)
FWD_WARPS = 8  # warps of a tiled K2 block (csrc/decode_all.cu::kFwdWarps)
FWD_BLOCKS_PER_SM = 2  # tiled K2 blocks an SM holds (registers: 128 a thread)
# K2-bf16's launch variants (csrc/decode_all.cu::mma_fwd_kernel, in this
# order): the blocks an SM its registers allow; warps a block, each on
# groups of 16 rows (one mma)
MMA_BLOCKS_PER_SM = (4, 5)
MMA_WARPS = 4
MMA_GROUP = 16


def _untile(x, m):
    """The VJP of ``decoder.tile_rows``: ``(N, ...)`` -> ``(M, ...)`` summed
    over copies."""
    return x.reshape((x.shape[0] // m, m) + tuple(x.shape[1:])).sum(0)


# ------------------------------------------------------------ plain versions --
# K2's plain version: every generator's rollout on every row, in f32 or
# bf16, returning (abs, rel, hc or None); the same function is K1's before
# its gather.
decode_all_reference = kdec.rollout_reference


def decode_all_bwd_reference(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy,
                             last_dxdy, out_abs, out_rel, hc, g_abs, g_rel,
                             pred_len: int, inp_format: str):
    """K3's plain version: the explicit reverse sweep of
    ``decoder.py::_bwd_kernel`` from the saved (h, c) and outputs.

    The gates and hidden2pos's pre-activation are recomputed at each step;
    the grads are those of ``DecodeAll``'s inputs, ``(d_w_emb, d_w_hh, d_b,
    d_w1h, d_w2, d_b2, d_socb, d_h0, d_last_xy, d_last_dxdy)``.
    """
    g, n = w_hh.shape[0], h0.shape[0]
    m = last_xy.shape[0]
    xy0 = kdec.tile_rows(last_xy, n)[None].expand(g, n, 2)
    nd0 = kdec.tile_rows(last_dxdy, n)[None].expand(g, n, 2)
    sb = kdec.tile_rows(socb, n).transpose(0, 1)  # (G, N, hid)
    h_init = h0[None].expand((g,) + tuple(h0.shape))
    hs, cs = hc[:, :, :, 0], hc[:, :, :, 1]  # (G, N, T, H)
    t_ = lambda x: x.transpose(1, 2)

    zeros = lambda like: torch.zeros_like(like)
    dh_c, dc_c = zeros(h_init), zeros(h_init)
    dxy_c, dnd_next = zeros(xy0), zeros(xy0)
    d_w_emb, d_w_hh, d_b = zeros(w_emb), zeros(w_hh), zeros(b)
    d_w1h, d_w2, d_b2, d_sb = zeros(w1h), zeros(w2), zeros(b2), zeros(sb)
    for t in range(pred_len - 1, -1, -1):
        h_t, c_t = hs[:, :, t], cs[:, :, t]
        h_p = hs[:, :, t - 1] if t > 0 else h_init
        c_p = cs[:, :, t - 1] if t > 0 else zeros(h_init)
        xy_p = out_abs[:, :, t - 1] if t > 0 else xy0
        nd_p = out_rel[:, :, t - 1] if t > 0 else nd0
        te = kdec.decoder_input(xy_p, nd_p, inp_format)

        dxy_t = g_abs[:, :, t] + dxy_c
        dnd = g_rel[:, :, t] + dxy_t + dnd_next

        # hidden2pos backward, pre-activation recomputed
        pre = torch.bmm(h_t, w1h) + sb
        act = torch.where(pre > 0, pre, 0.01 * pre)
        dhid = torch.bmm(dnd, t_(w2))
        dpre = torch.where(pre > 0, dhid, 0.01 * dhid)
        d_w2 = d_w2 + torch.bmm(t_(act), dnd)
        d_b2 = d_b2 + dnd.sum(1)
        dh = torch.bmm(dpre, t_(w1h)) + dh_c
        d_w1h = d_w1h + torch.bmm(t_(h_t), dpre)
        d_sb = d_sb + dpre

        # LSTM backward, gates recomputed
        gates = torch.bmm(te, w_emb) + torch.bmm(h_p, w_hh) + b[:, None]
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, gg, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
        tanh_c = torch.tanh(c_t)
        d_o = dh * tanh_c
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        dc_c = dc * f
        dgates = torch.cat([
            (dc * gg) * i * (1.0 - i),
            (dc * c_p) * f * (1.0 - f),
            (dc * i) * (1.0 - gg * gg),
            d_o * o * (1.0 - o),
        ], dim=-1)
        dte = torch.bmm(dgates, t_(w_emb))
        dh_c = torch.bmm(dgates, t_(w_hh))
        d_w_emb = d_w_emb + torch.bmm(t_(te), dgates)
        d_w_hh = d_w_hh + torch.bmm(t_(h_p), dgates)
        d_b = d_b + dgates.sum(1)

        if inp_format == "rel":
            dnd_next, dxy_c = dte, dxy_t
        elif inp_format == "abs":
            dxy_c, dnd_next = dxy_t + dte, zeros(dnd_next)
        else:  # te = [x y dx dy]
            dxy_c, dnd_next = dxy_t + dte[..., :2], dte[..., 2:]
    return (d_w_emb, d_w_hh, d_b, d_w1h, d_w2, d_b2,
            _untile(d_sb.transpose(0, 1), m), dh_c.sum(0),
            _untile(dxy_c.sum(0), m), _untile(dnd_next.sum(0), m))


# ---------------------------------------------------------------- kernels --
@functools.cache
def _lib():
    lib = build.load(SOURCE)
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mggan_decode_all_fwd.argtypes = [ptr] * 8 + [ll] * 2 + [i32] * 9 + [ptr]
    lib.mggan_decode_all_fwd.restype = i32
    for fn in (lib.mggan_decode_all_fwd_warp, lib.mggan_decode_all_fwd_bf16_warp):
        fn.argtypes = [ptr] * 8 + [ll] * 2 + [i32] * 7 + [ptr]
        fn.restype = i32
    lib.mggan_decode_all_fwd_bf16.argtypes = [ptr] * 8 + [ll] * 2 + [i32] * 8 + [ptr]
    lib.mggan_decode_all_fwd_bf16.restype = i32
    lib.mggan_decode_all_fwd_bf16_warps_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
    lib.mggan_decode_all_fwd_bf16_warps_per_sm.restype = i32
    lib.mggan_decode_all_fwd_bf16_warp_warps_per_sm.argtypes = [i32] * 2 + [ctypes.POINTER(i32)]
    lib.mggan_decode_all_fwd_bf16_warp_warps_per_sm.restype = i32
    lib.mggan_decode_all_fwd_warps_per_sm.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.mggan_decode_all_fwd_warps_per_sm.restype = i32
    lib.mggan_decode_all_fwd_warp_warps_per_sm.argtypes = [i32] * 2 + [ctypes.POINTER(i32)]
    lib.mggan_decode_all_fwd_warp_warps_per_sm.restype = i32
    for fn in (lib.mggan_decode_all_bwd, lib.mggan_decode_all_bwd_warp):
        fn.argtypes = [ptr] * 16 + [ll] * 2 + [i32] * 8 + [ptr]
        fn.restype = i32
    lib.mggan_decode_all_grad_floats.argtypes = [i32] * 3
    lib.mggan_decode_all_grad_floats.restype = i32
    lib.mggan_decode_all_bwd_config.argtypes = [i32] * 5 + [ctypes.POINTER(i32),
                                                            ctypes.POINTER(ll),
                                                            ctypes.POINTER(i32)]
    lib.mggan_decode_all_bwd_config.restype = i32
    lib.mggan_cuda_error_string.argtypes = [i32]
    lib.mggan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def prepare(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy,
            pred_len: int, inp_format: str, compute_dtype=None):
    """Pack the kernels' weight image and check every row argument
    (``decoder.prepare_rollout``); ``launch_fwd``/``launch_bwd`` take it."""
    packed = dict(zip(PACKED, (w_emb, w_hh, b, w1h, w2, b2)))
    args = kdec.prepare_rollout(packed, socb, h0, last_xy, last_dxdy, pred_len,
                                inp_format, compute_dtype)
    if args["bf16"]:  # K2-bf16's fragment image (the warp image stays for its yardstick)
        args["mma_wpack"] = kdec.mma_weights(packed).reshape(-1)
    return args


def _raise_on(rc, name):
    if rc:
        err = _lib().mggan_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {err} ({rc})")


def fwd_launch(n: int, num_gens: int, sms: int):
    """The tiled K2's launch for ``n`` rows of ``num_gens`` generators on
    ``sms`` SMs: ``(rows_per_warp, blocks_per_gen)``. R rows a warp: the
    largest of ``decoder.TILED_ROWS`` that still gives every resident warp
    R (row, generator) pairs, else 1; blocks per generator: one per group
    of ``FWD_WARPS`` x R rows, at most one wave of resident blocks over all
    generators (the grid is persistent)."""
    resident = sms * FWD_BLOCKS_PER_SM
    rows = next((r for r in kdec.TILED_ROWS if n * num_gens >= r * resident * FWD_WARPS), 1)
    groups = -(-n // (FWD_WARPS * rows))
    return rows, max(1, min(groups, -(-resident // max(num_gens, 1))))


def mma_launch(n: int, num_gens: int, sms: int):
    """K2-bf16's launch for ``n`` rows of ``num_gens`` generators on ``sms``
    SMs: ``(variant, blocks_per_gen)``, the variant an index into
    ``MMA_BLOCKS_PER_SM``. A warp rolls out groups of 16 rows; the variant
    is the one whose resident warps take every group in the fewest waves
    (latency sets a group's pace, so a second wave costs a whole group
    latency), 4 blocks an SM (no spill) on a tie. Blocks per generator: one
    per ``MMA_WARPS`` groups, all in one grid (the card starts a block as
    another retires). Picked from the launch sweep of
    ``chip_smoke.py --sweep`` on an H100."""
    groups = -(-n // MMA_GROUP)
    waves = [-(-groups * num_gens // (sms * per_sm * MMA_WARPS)) for per_sm in MMA_BLOCKS_PER_SM]
    variant = waves.index(min(waves))
    return variant, max(1, -(-groups // MMA_WARPS))


def launch_fwd(args, save_hc: bool, shape=None):
    """K2 (its f32 or bf16 variant, as the arguments say) on the current
    stream -> ``(abs, rel, hc or None)``. ``shape`` replaces the launch
    rule's pick: ``(rows_per_warp, blocks_per_gen)`` for the tiled f32
    kernel (``fwd_launch``), ``(variant, blocks_per_gen)`` for K2-bf16
    (``mma_launch``); for comparing launch shapes on the card."""
    if args["bf16"]:
        return _launch_fwd(_lib().mggan_decode_all_fwd_bf16, args, save_hc, KERNEL_FWD_BF16,
                           shape)
    return _launch_fwd(_lib().mggan_decode_all_fwd, args, save_hc, KERNEL_FWD, shape)


def launch_fwd_warp(args, save_hc: bool):
    """The warp-per-row K2 that the tiled f32 design and the tensor-core
    bf16 design replaced, as ``launch_fwd``, on the arguments' image: in
    f32 the same function bit for bit (counted as ``decode_all_fwd_warp``),
    in bf16 the same function with the warp-per-row K1-bf16's summation
    order (counted as ``decode_all_fwd_bf16_warp``); for comparing the
    designs on the card."""
    kdec.check_all_images(args)
    if args["bf16"]:
        return _launch_fwd(_lib().mggan_decode_all_fwd_bf16_warp, args, save_hc,
                           KERNEL_FWD_BF16_WARP)
    return _launch_fwd(_lib().mggan_decode_all_fwd_warp, args, save_hc, KERNEL_FWD_WARP)


def fwd_warps_per_sm(args, rows_per_warp=None) -> int:
    """Resident warps per SM of the tiled K2 for ``rows_per_warp`` rows a
    warp at these f32 arguments' widths, or with None of the warp-per-row
    K2 (on bf16 arguments: of the warp-per-row K2 on the bf16 image)."""
    _, _, g, h, hid, _, t, _, per_gen = args["dims"]
    warps = ctypes.c_int(0)
    lib = _lib()
    if rows_per_warp is None:
        fn = (lib.mggan_decode_all_fwd_bf16_warp_warps_per_sm if args["bf16"]
              else lib.mggan_decode_all_fwd_warp_warps_per_sm)
        rc = fn(g, per_gen, ctypes.byref(warps))
    else:
        rc = lib.mggan_decode_all_fwd_warps_per_sm(rows_per_warp, h, hid, t, per_gen,
                                                   ctypes.byref(warps))
    _raise_on(rc, KERNEL_FWD)
    return warps.value


def mma_warps_per_sm(variant: int) -> int:
    """Resident warps per SM of K2-bf16's launch variant ``variant``
    (an index into ``MMA_BLOCKS_PER_SM``)."""
    warps = ctypes.c_int(0)
    _raise_on(_lib().mggan_decode_all_fwd_bf16_warps_per_sm(variant, ctypes.byref(warps)),
              KERNEL_FWD_BF16)
    return warps.value


def _launch_fwd(fn, args, save_hc, count_as, shape=None):
    tensors, dims = args["tensors"], args["dims"]
    n, _, g, h, _, _, t = dims[:7]
    dev = tensors[1].device
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out_abs, out_rel = new(g, n, t, 2), new(g, n, t, 2)
    hc = new(g, n, t, 2, h) if save_hc else None
    if n == 0:
        return out_abs, out_rel, hc
    if count_as == KERNEL_FWD:  # rows a warp and blocks per generator after per_gen
        dims = dims + tuple(shape or fwd_launch(n, g, kdec.sm_count(dev)))
    elif count_as == KERNEL_FWD_BF16:  # the fragment image; variant and blocks for per_gen
        tensors = (args["mma_wpack"],) + tensors[1:]
        dims = dims[:8] + tuple(shape or mma_launch(n, g, kdec.sm_count(dev)))
    ptrs = [x.data_ptr() for x in tensors] + [out_abs.data_ptr(), out_rel.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, hc.data_ptr() if save_hc else None, *dims, stream)
    _raise_on(rc, count_as)
    kernels.launches[count_as] += 1
    return out_abs, out_rel, hc


def bwd_blocks_per_gen(n: int, num_gens: int, device) -> int:
    """K3's blocks per generator: one wave of one block per SM over all
    generators, at most one block per 8 rows. Fixed for a card and shape,
    so the weight grads' summation order is too."""
    sms = kdec.sm_count(device)
    return max(1, min(-(-sms // num_gens), -(-n // BWD_ROWS)))


def bwd_config(args, warp: bool = False):
    """K3's launch shape for these arguments (the tiled sweep, or with
    ``warp`` the warp-per-row baseline): ``{"warps_per_block",
    "smem_bytes", "warps_per_sm"}``; raises if no block fits."""
    _, _, _, h, hid, in_dim = args["dims"][:6]
    i32, ll = ctypes.c_int, ctypes.c_longlong
    warps, smem, per_sm = i32(0), ll(0), i32(0)
    rc = _lib().mggan_decode_all_bwd_config(int(warp), h, hid, in_dim, args["dims"][8],
                                            ctypes.byref(warps), ctypes.byref(smem),
                                            ctypes.byref(per_sm))
    _raise_on(rc, KERNEL_BWD_WARP if warp else KERNEL_BWD)
    return {"warps_per_block": warps.value, "smem_bytes": smem.value,
            "warps_per_sm": per_sm.value}


def launch_bwd(args, out_abs, out_rel, hc, g_abs, g_rel, count_as=KERNEL_BWD):
    """K3 on the current stream: the reverse sweep and the fixed-order sum
    of its blocks' weight grads, counted under ``count_as``. ``args`` holds
    the f32 weight image (K3 sweeps in f32 after either forward). Returns
    the raw outputs ``(d_h0 (G,N,H), d_xy0 (G,N,2), d_dxdy0 (G,N,2),
    d_socb (N,G,hid), dw (G,P))``."""
    return _launch_bwd(_lib().mggan_decode_all_bwd, args, out_abs, out_rel, hc, g_abs,
                       g_rel, count_as)


def launch_bwd_warp(args, out_abs, out_rel, hc, g_abs, g_rel):
    """The warp-per-row sweep that K3's tiled design replaced, as
    ``launch_bwd``: the same function and outputs, for comparing the two on
    the card; counted as ``decode_all_bwd_warp``."""
    return _launch_bwd(_lib().mggan_decode_all_bwd_warp, args, out_abs, out_rel, hc, g_abs,
                       g_rel, KERNEL_BWD_WARP)


def _launch_bwd(fn, args, out_abs, out_rel, hc, g_abs, g_rel, count_as):
    tensors, dims = args["tensors"], args["dims"]
    if args["bf16"]:
        raise ValueError("K3 sweeps on the f32 weight image; prepare it without compute_dtype")
    n, _, g, h, hid, in_dim, t = dims[:7]
    dev = tensors[1].device
    for name, x, shape in (("abs", out_abs, (g, n, t, 2)), ("rel", out_rel, (g, n, t, 2)),
                           ("hc", hc, (g, n, t, 2, h)), ("g_abs", g_abs, (g, n, t, 2)),
                           ("g_rel", g_rel, (g, n, t, 2))):
        kdec.check_arg(name, x, shape, torch.float32, dev)
    lib = _lib()
    size = lib.mggan_decode_all_grad_floats(h, hid, in_dim)
    nb = bwd_blocks_per_gen(n, g, dev)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    d_h0, d_xy0, d_dxdy0 = new(g, n, h), new(g, n, 2), new(g, n, 2)
    d_socb, partials, dw = new(n, g, hid), new(g, nb, size), new(g, size)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in tensors),
                *(x.data_ptr() for x in (out_abs, out_rel, hc, g_abs, g_rel, d_h0, d_xy0,
                                         d_dxdy0, d_socb, partials, dw)),
                *dims, nb, stream)
    _raise_on(rc, count_as)
    kernels.launches[count_as] += 1
    return d_h0, d_xy0, d_dxdy0, d_socb, dw


def weight_grads_from_image(dw, h: int, hid: int, in_dim: int):
    """K3's per-generator grad image ``(G, P)`` -> grads in the layout of
    ``w_emb, w_hh, b, w1h, w2, b2``. The image holds ``dWhh^T [j][k][gate]
    | dWemb [in][j][gate] | db [j][gate] | dW1h^T [q][k] | dW2 [q][2] |
    db2 [2]``; the folded weights are gate-major, column ``gate * H + j``."""
    g = dw.shape[0]
    sizes = (h * h * 4, in_dim * h * 4, h * 4, hid * h, hid * 2, 2)
    whh_t, wemb, bias, w1_t, w2, b2 = torch.split(dw, sizes, dim=1)
    return (
        wemb.reshape(g, in_dim, h, 4).permute(0, 1, 3, 2).reshape(g, in_dim, 4 * h),
        whh_t.reshape(g, h, h, 4).permute(0, 2, 3, 1).reshape(g, h, 4 * h),
        bias.reshape(g, h, 4).permute(0, 2, 1).reshape(g, 4 * h),
        w1_t.reshape(g, hid, h).transpose(1, 2),
        w2.reshape(g, hid, 2),
        b2,
    )


def weight_image(d_w_emb, d_w_hh, d_b, d_w1h, d_w2, d_b2):
    """The inverse of ``weight_grads_from_image``: the six weight grads ->
    K3's grad image ``(G, P)``."""
    g, h = d_w_hh.shape[0], d_w_hh.shape[1]
    in_dim, hid = d_w_emb.shape[1], d_w1h.shape[2]
    return torch.cat([
        d_w_hh.reshape(g, h, 4, h).permute(0, 3, 1, 2).reshape(g, -1),
        d_w_emb.reshape(g, in_dim, 4, h).permute(0, 1, 3, 2).reshape(g, -1),
        d_b.reshape(g, 4, h).permute(0, 2, 1).reshape(g, -1),
        d_w1h.transpose(1, 2).reshape(g, -1),
        d_w2.reshape(g, -1),
        d_b2,
    ], dim=1)


def grad_image_floats(h: int, hid: int, in_dim: int) -> int:
    """The width ``P`` of K3's per-generator grad image."""
    return h * h * 4 + in_dim * h * 4 + h * 4 + hid * h + hid * 2 + 2


# ------------------------------------------------------------------ routes --
def decode_all_fwd(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy,
                   pred_len: int, inp_format: str, save_hc: bool,
                   compute_dtype=None):
    """K2 on CUDA tensors, its plain version on CPU tensors, through the
    operator ``mggan::decode_all_fwd`` (``library.py``); any other device
    raises. Returns ``(abs, rel, hc or None)``."""
    from mggan_tpu_torch.ops.kernels import library

    if h0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode_all: unsupported device {h0.device}")
    out_abs, out_rel, hc = library.decode_all_fwd(
        w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, pred_len, inp_format,
        save_hc, kdec.is_bf16(compute_dtype))
    return out_abs, out_rel, hc if save_hc else None


def decode_all_bwd(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy,
                   out_abs, out_rel, hc, g_abs, g_rel, pred_len: int,
                   inp_format: str, after_bf16: bool = False):
    """K3 on CUDA tensors (counted as ``decode_all_bwd``, or with
    ``after_bf16`` as ``decode_all_bwd_after_bf16``), its plain version on
    CPU tensors, through the operator ``mggan::decode_all_bwd``
    (``library.py``); any other device raises. Returns the grads of
    ``DecodeAll``'s tensor inputs, the weights' read from the operator's
    grad image. The residuals may come from either forward; the sweep is
    f32."""
    from mggan_tpu_torch.ops.kernels import library

    if h0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode_all: unsupported device {h0.device}")
    dw, *rows = library.decode_all_bwd(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy,
                                       last_dxdy, out_abs, out_rel, hc, g_abs, g_rel, pred_len,
                                       inp_format, after_bf16)
    return (*weight_grads_from_image(dw, w_hh.shape[1], w1h.shape[2], w_emb.shape[1]), *rows)


def reduce_raw(raw, m: int):
    """K3's raw outputs (``launch_bwd``) -> ``(grad image, d_socb, d_h0,
    d_last_xy, d_last_dxdy)``, the per-row grads summed over generators and
    over the copies of the ``m``-row inputs."""
    d_h0, d_xy0, d_dxdy0, d_socb, dw = raw
    return (dw, _untile(d_socb, m), d_h0.sum(0), _untile(d_xy0.sum(0), m),
            _untile(d_dxdy0.sum(0), m))


def grads_from_raw(raw, m: int):
    """K3's raw outputs -> the grads of ``DecodeAll``'s tensor inputs."""
    d_h0, _, _, d_socb, dw = raw
    h, hid = d_h0.shape[2], d_socb.shape[2]
    in_dim = (dw.shape[1] - grad_image_floats(h, hid, 0)) // (h * 4)
    dw, *rows = reduce_raw(raw, m)
    return (*weight_grads_from_image(dw, h, hid, in_dim), *rows)


class DecodeAll(torch.autograd.Function):
    """Forward K2 (f32 or bf16) with (h, c) saved; backward K3 in f32 (see
    the module note)."""

    @staticmethod
    def forward(ctx, w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy,
                pred_len, inp_format, compute_dtype=None):
        inputs = (w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy)
        out_abs, out_rel, hc = decode_all_fwd(*inputs, pred_len, inp_format,
                                              save_hc=True, compute_dtype=compute_dtype)
        ctx.save_for_backward(*inputs, out_abs, out_rel, hc)
        ctx.pred_len, ctx.inp_format = pred_len, inp_format
        ctx.after_bf16 = kdec.is_bf16(compute_dtype)
        return out_abs, out_rel

    @staticmethod
    def backward(ctx, g_abs, g_rel):
        grads = decode_all_bwd(*ctx.saved_tensors, g_abs, g_rel, ctx.pred_len,
                               ctx.inp_format, ctx.after_bf16)
        return (*grads, None, None, None)


def decode_all(stacked, last_xy, last_dxdy, social_feats, h0, pred_len: int,
               inp_format: str, compute_dtype=None):
    """Every generator's rollout on every row -> ``(abs, rel)``, each
    ``(G, N, pred_len, 2)``; differentiable through ``DecodeAll`` when a
    gradient is needed. See the module note for the row layout and for
    ``compute_dtype``."""
    packed = kdec.pack_decoder_params(stacked, inp_format)
    socb = kdec.social_bias(packed, social_feats)
    inputs = tuple(packed[k] for k in PACKED) + (socb, h0, last_xy, last_dxdy)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return DecodeAll.apply(*inputs, pred_len, inp_format, compute_dtype)
    return decode_all_fwd(*inputs, pred_len, inp_format, save_hc=False,
                          compute_dtype=compute_dtype)[:2]
