"""Fused-selection decoder rollout: the port of the TPU kernel K1.

Counterpart of ``mggan_tpu/ops/pallas/decoder.py::pallas_decode_select``
(kernel ``_fwd_select_kernel``). ``decode_select`` rolls out only each
row's sampled generator and returns its ``(abs, rel)``:

* on CUDA tensors it launches ``csrc/decode_select_tiled.cu`` (built at
  first use) or raises: a block buckets each tile of rows by generator, and
  a warp rolls out R rows of one generator at a time (R and the tile from
  ``tiled_launch``), bit-identical to the warp-per-row K1 of
  ``csrc/decode_select.cu``, which stays compiled as its yardstick
  (``launch_decode_select_warp``, counted as ``decode_select_warp``; no
  path launches it);
* on CPU tensors it runs ``decode_select_reference``, the plain PyTorch
  version: every generator's rollout on the folded weights
  (``rollout_reference``, also K2's plain version) followed by
  ``gather_samples``.

``compute_dtype=torch.bfloat16`` is the TPU kernel's bf16 variant, with the
kernels' numerics (not those of the JAX package's portable scan, which
rounds at other places): the folded ``w_emb``, ``w_hh`` and ``w1h`` and the
operands of their products (``te``, ``h0``, every step's ``h`` and ``hid``
before ``@ w2``) are rounded to bf16; the products accumulate in f32, and the
biases, ``socb``, ``w2``, ``b2``, ``c`` and the position sums stay f32. On
CUDA tensors it launches ``csrc/decode_select_mma.cu`` (counted as
``decode_select_bf16``): rows grouped by generator inside a tile, the
products on the tensor cores, weights as the fragment image
``mma_weights``. The warp-per-row bf16 kernel it replaced stays in
``csrc/decode_select.cu`` for comparison on the card
(``launch_decode_select_bf16_warp``, counted as ``decode_select_bf16_warp``);
no path launches it.

``ilp=True`` is the TPU kernel's ILP variant K5 (``_fwd_select_kernel_ilp``):
on CUDA tensors it launches ``mggan_decode_select_ilp`` (counted as
``decode_select_ilp`` / ``decode_select_ilp_bf16``), a warp per pair of
rows, bit-identical to K1; its plain version is K1's.

Row layout: ``h0 (N, H)`` and ``gen_idx (N,)`` have a row per rollout;
``last_xy``, ``last_dxdy`` and ``social_feats`` have ``M`` rows with
``N % M == 0``, and rollout ``n`` reads row ``n % M``. The sampling path's
rows are ``(k, s, p)``-major, so those per-agent inputs are passed once
rather than once per sample; ``M == N`` is the plain one-row-per-rollout
case.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mggan_tpu_torch.models import common
from mggan_tpu_torch.ops import kernels, sampling
from mggan_tpu_torch.ops.kernels import build
from mggan_tpu_torch.utils.pytree import tree_leaves

KERNEL = "decode_select"  # K1 in f32: csrc/decode_select_tiled.cu
TILED_SOURCE = "decode_select_tiled"
KERNEL_WARP = "decode_select_warp"  # the warp-per-row f32 K1, for comparison
WARP_SOURCE = "decode_select"  # csrc/decode_select.cu: the warp-per-row K1, K5
KERNEL_BF16 = "decode_select_bf16"
KERNEL_BF16_WARP = "decode_select_bf16_warp"  # the warp-per-row bf16 kernel, for comparison
MMA_SOURCE = "decode_select_mma"  # csrc/decode_select_mma.cu, K1-bf16
MMA_TILES = (256, 128, 64, 32)  # rows of one K1-bf16 tile, largest first
# The tiled K1's launch (csrc/decode_select_tiled.cu): rows of one generator
# a warp, largest first; rows of a tile, largest first; warps a block and
# blocks an SM (two fit in shared memory at G = 4, H = 32).
TILED_ROWS = (4, 2, 1)
TILED_TILES = (1024, 512, 256, 128, 64, 32, 16, 8)
TILED_WARPS = 8
TILED_BLOCKS_PER_SM = 2
KERNEL_ILP = "decode_select_ilp"  # K5
KERNEL_ILP_BF16 = "decode_select_ilp_bf16"
FORMATS = {"rel": 0, "abs": 1, "abs_rel": 2}
PACKED = ("w_emb", "w_hh", "b", "w1h", "w2", "b2")  # the folded weights, in order
MAX_SHARED_BYTES = 232448  # per block on the H100, as dynamic shared memory


def pack_decoder_params(stacked, inp_format: str):
    """Fold the stacked decoder params per generator (``_pack_all``'s fold,
    without its lane-packed block-diagonal layout).

    Returns a dict of per-generator tensors: ``w_emb (G, in, 4H)`` (spatial
    embedding folded into the input weights), ``w_hh (G, H, 4H)``,
    ``b (G, 4H)``, ``w1h (G, H, hid)``, ``w1s (G, F, hid)``, ``b1 (G, hid)``,
    ``w2 (G, hid, 2)``, ``b2 (G, 2)``.
    """
    emb, lstm, h2p = stacked["spatial_embedding"], stacked["lstm"], stacked["hidden2pos"]
    in_dim = emb["w"].shape[1]
    if in_dim != common.input_size(inp_format):
        raise ValueError(f"decoder input width {in_dim} does not fit {inp_format!r}")
    h = lstm["w_hh"].shape[1]
    w1 = h2p["lin0"]["w"]
    return {
        "w_emb": emb["w"] @ lstm["w_ih"],
        "w_hh": lstm["w_hh"],
        "b": (emb["b"][:, None, :] @ lstm["w_ih"])[:, 0] + lstm["b_ih"] + lstm["b_hh"],
        "w1h": w1[:, :h],
        "w1s": w1[:, h:],
        "b1": h2p["lin0"]["b"],
        "w2": h2p["lin1"]["w"],
        "b2": h2p["lin1"]["b"],
    }


def is_bf16(compute_dtype) -> bool:
    """True for ``torch.bfloat16``, False for None or ``torch.float32``
    (the same arithmetic as None in the rollout kernels); raises otherwise."""
    if compute_dtype in (None, torch.float32):
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise ValueError(f"compute_dtype must be None, float32 or bfloat16, got {compute_dtype}")


def social_bias(packed, social_feats):
    """``social @ W1_soc + b1`` for every generator: ``(M, G, hid)``.
    Constant over the rollout, so it is hoisted out of the kernel."""
    return torch.einsum("mf,gfh->mgh", social_feats, packed["w1s"]) + packed["b1"][None]


def kernel_weights(packed, compute_dtype=None):
    """The kernels' shared-memory image (``csrc/decoder_rollout.cuh``), per
    generator. f32: ``whh [H][H][4]``, ``wemb [in][H][4]``, ``b [H][4]``,
    ``w1 [H][hid]``, ``w2 [hid][2]``, ``b2 [2]``. bf16: ``whh``, ``wemb``
    and ``w1`` in bf16, zero-padded to 8 values and held two to a float32
    word, then ``b``, ``w2`` and ``b2`` in f32. Either is zero-padded to a
    multiple of 4 words. Returns ``(flat float32 (G * per_gen,), per_gen)``.
    """
    g, in_dim, four_h = packed["w_emb"].shape
    h = four_h // 4
    gate_last = lambda w: w.reshape(g, -1, 4, h).transpose(2, 3).reshape(g, -1)
    whh, wemb, bias = (gate_last(packed[k]) for k in ("w_hh", "w_emb", "b"))
    w1, w2, b2 = (packed[k].reshape(g, -1) for k in ("w1h", "w2", "b2"))
    if is_bf16(compute_dtype):
        mats = torch.cat([whh, wemb, w1], dim=1).to(torch.bfloat16)
        mats = F.pad(mats, (0, -mats.shape[1] % 8)).contiguous()
        flat = torch.cat([mats.view(torch.float32), bias, w2, b2], dim=1)
    else:
        flat = torch.cat([whh, wemb, bias, w1, w2, b2], dim=1)
    flat = F.pad(flat, (0, -flat.shape[1] % 4))
    return flat.contiguous().reshape(-1), flat.shape[1]


# Lane l of a warp is (row l // 4, quad l % 4) in mma.sync's fragments.
_LANE_ROW = torch.arange(32) // 4
_LANE_QUAD = torch.arange(32) % 4
# k of each bf16 value of a lane's m16n8k16 B fragments for k-tiles 0 and 1:
# (lane, word: b0b1 and b2b3 of k-tile 0, then of k-tile 1, half).
_K16 = (16 * (torch.arange(4) // 2)[None, :, None] + 8 * (torch.arange(4) % 2)[None, :, None]
        + 2 * _LANE_QUAD[:, None, None] + torch.arange(2)[None, None, :])
# k of each bf16 value of a lane's m16n8k8 B fragment: (lane, half).
_K8 = 2 * _LANE_QUAD[:, None] + torch.arange(2)[None, :]


def _words(x):
    """bf16 pairs on the last axis -> float32 words (the first of a pair in
    the low 16 bits), flattened per generator."""
    x = x.to(torch.bfloat16).contiguous()
    return x.view(torch.float32).reshape(x.shape[0], -1)


def mma_weights(packed):
    """K1-bf16's shared-memory image (``csrc/decode_select_mma.cu``) per
    generator, ``(G, 3268)`` float32 words: the bf16 B fragments of
    ``w_hh``, ``w_emb`` and ``w1h`` in the order a warp's lanes load them,
    then ``b``, ``w2`` and ``b2`` in f32.

    Gate columns are reordered as (unit group u of 8 hidden units, gate,
    unit): n-tile ``4u + gate`` holds gate ``gate`` of units ``8u..8u+7``.
    Hidden units are padded to 32, hidden2pos columns to 32 and the input to
    8 rows, all with zeros. Lane (row r, quad q) of the B fragment of n-tile
    nt holds column ``8nt + r`` at k = 2q, 2q+1 (and + 8 in a k16 tile):
    * ``whh [u][gate][lane][4 words]``: k-tile 0 (b0b1, b2b3), k-tile 1;
    * ``wemb [u][lane][gate]``: one m16n8k8 word per gate;
    * ``w1 [nt][lane][4 words]``: as ``whh``, n-tile nt of hidden2pos;
    * ``b [u][gate][8]``, ``w2 [32][2]``, ``b2`` padded to 4 (f32).
    """
    g, in_dim, four_h = packed["w_emb"].shape
    h, hid = four_h // 4, packed["w1h"].shape[2]
    if h > 32 or hid > 32 or in_dim > 8:
        raise ValueError(f"K1-bf16 takes H, hid <= 32 and in <= 8; got {h}, {hid}, {in_dim}")

    def gate_tiles(w, k_pad):  # (G, K, 4H) -> (G, u, gate, k_pad, n)
        k = w.shape[1]
        w = F.pad(w.reshape(g, k, 4, h), (0, 32 - h, 0, 0, 0, k_pad - k))
        return w.reshape(g, k_pad, 4, 4, 8).permute(0, 3, 2, 1, 4)

    whh = gate_tiles(packed["w_hh"], 32)[:, :, :, _K16, _LANE_ROW[:, None, None]]
    wemb = gate_tiles(packed["w_emb"], 8)[:, :, :, _K8, _LANE_ROW[:, None]]
    w1 = F.pad(packed["w1h"], (0, 32 - hid, 0, 32 - h)).reshape(g, 32, 4, 8).permute(0, 2, 1, 3)
    w1 = w1[:, :, _K16, _LANE_ROW[:, None, None]]
    bias = F.pad(packed["b"].reshape(g, 4, h), (0, 32 - h)).reshape(g, 4, 4, 8).transpose(1, 2)
    return torch.cat([
        _words(whh), _words(wemb.permute(0, 1, 3, 2, 4)), _words(w1),
        bias.reshape(g, -1), F.pad(packed["w2"], (0, 0, 0, 32 - hid)).reshape(g, -1),
        F.pad(packed["b2"], (0, 2)),
    ], dim=1).contiguous()


def mma_tile_rows(n: int, sms: int) -> int:
    """Rows of one K1-bf16 tile for ``n`` rows on ``sms`` SMs: the largest
    of ``MMA_TILES`` that still gives every SM a tile (fewer rows per tile
    pad more of each generator's bucket to 16), else the smallest."""
    for tile in MMA_TILES:
        if -(-n // tile) >= sms:
            return tile
    return MMA_TILES[-1]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """SMs of a CUDA ``device``, queried once per device: the launch rules
    run on every launch, and the query costs more host time than a small
    kernel takes on the card."""
    device = torch.device(device)
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def tiled_launch(n: int, sms: int):
    """The tiled K1's launch for ``n`` rows on ``sms`` SMs:
    ``(rows_per_warp, tile_rows, blocks)``. R rows of one generator a warp:
    the largest of ``TILED_ROWS`` that gives every resident warp at least 4
    groups of R rows, else 1 (a group's latency hardly grows with R, so
    below that R only pads buckets and leaves warps idle). Rows of a tile:
    the largest of ``TILED_TILES`` that gives every resident block at least
    2 tiles, else the smallest. Blocks: one per tile, at most the resident
    ones (the grid is persistent). Picked from the launch sweep of
    ``chip_smoke.py --sweep`` on an H100."""
    resident = sms * TILED_BLOCKS_PER_SM
    rows = next((r for r in TILED_ROWS if n >= 4 * r * resident * TILED_WARPS), 1)
    tile = next((t for t in TILED_TILES if -(-n // t) >= 2 * resident), TILED_TILES[-1])
    return rows, tile, max(1, min(-(-n // tile), resident))


def tile_rows(x, n):
    """``(M, ...)`` -> ``(N, ...)`` with row n = row n % M."""
    return x.repeat((n // x.shape[0],) + (1,) * (x.dim() - 1))


def decoder_input(xy, nd, inp_format):
    if inp_format == "rel":
        return nd
    if inp_format == "abs":
        return xy
    return torch.cat([xy, nd], dim=-1)


def _sig_bf16(x):
    """sigmoid in bf16 arithmetic, rounded as ``benchmarks/decode_ablation.py``
    rounds it: the input, exp, the add and the divide each to bf16."""
    e = torch.exp(-x.to(torch.bfloat16))
    return (1.0 / (1.0 + e)).float()


def _tanh_bf16(x):
    """tanh as ``(exp(2x) - 1) / (exp(2x) + 1)`` in bf16 arithmetic."""
    xb = x.to(torch.bfloat16)
    e = torch.exp(xb + xb)
    return ((e - 1.0) / (e + 1.0)).float()


# The gate activations (sigmoid, tanh) of the rollout: the kernels' own
# ("f32") and the two stand-ins of the activation ablation B1
# (``csrc/decode_ablation.cu``): "bf16" arithmetic and "lin", linear
# functions with wrong numerics by design.
ACTIVATIONS = {
    "f32": (torch.sigmoid, torch.tanh),
    "bf16": (_sig_bf16, _tanh_bf16),
    "lin": (lambda x: x * 0.25 + 0.5, lambda x: x * 0.5),
}


def rollout_reference(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy,
                      last_dxdy, pred_len: int, inp_format: str,
                      save_hc: bool = False, compute_dtype=None, act: str = "f32"):
    """The plain version of the rollout kernels: every generator's rollout
    on every row, the arithmetic of ``common.relative_decoder_apply`` on the
    folded weights, in f32 or with the bf16 rounding of the module note,
    with the gate activations ``ACTIVATIONS[act]``.

    Returns ``(abs, rel, hc)``: abs/rel ``(G, N, T, 2)`` and, with
    ``save_hc``, each step's h and c as ``(G, N, T, 2, H)`` (else None).
    """
    sig, tnh = ACTIVATIONS[act]
    op = (lambda x: x.to(torch.bfloat16).float()) if is_bf16(compute_dtype) \
        else (lambda x: x)
    w_emb, w_hh, w1h = op(w_emb), op(w_hh), op(w1h)
    g, n = w_hh.shape[0], h0.shape[0]
    xy = tile_rows(last_xy, n)[None].expand(g, n, 2)
    nd = tile_rows(last_dxdy, n)[None].expand(g, n, 2)
    sb = tile_rows(socb, n).transpose(0, 1)  # (G, N, hid)
    h = op(h0)[None].expand((g,) + tuple(h0.shape))
    c = torch.zeros_like(h)
    abs_seq, rel_seq, hc_seq = [], [], []
    for _ in range(pred_len):
        te = op(decoder_input(xy, nd, inp_format))
        gates = torch.bmm(te, w_emb) + torch.bmm(h, w_hh) + b[:, None]
        i, f, gg, o = gates.chunk(4, dim=-1)
        c = sig(f) * c + sig(i) * tnh(gg)
        h = op(sig(o) * tnh(c))
        hid = op(F.leaky_relu(torch.bmm(h, w1h) + sb, 0.01))
        nd = torch.bmm(hid, w2) + b2[:, None]
        xy = xy + nd
        abs_seq.append(xy)
        rel_seq.append(nd)
        if save_hc:
            hc_seq.append(torch.stack([h, c], dim=2))
    hc = torch.stack(hc_seq, dim=2) if save_hc else None
    return torch.stack(abs_seq, 2), torch.stack(rel_seq, 2), hc


def decode_select_reference(stacked, last_xy, last_dxdy, social_feats, h0,
                            gen_idx, pred_len: int, inp_format: str,
                            compute_dtype=None, act: str = "f32"):
    """Plain PyTorch version: all generators, then the per-row gather."""
    n = h0.shape[0]
    packed = pack_decoder_params(stacked, inp_format)
    abs_g, rel_g, _ = rollout_reference(
        *(packed[k] for k in PACKED), social_bias(packed, social_feats), h0,
        last_xy, last_dxdy, pred_len, inp_format, compute_dtype=compute_dtype,
        act=act,
    )  # (G, N, T, 2)
    # as gather_samples' (K, G, S, P, T, 2) and (S, P, K) with K = S = 1
    idx = gen_idx.reshape(1, n, 1)
    pick = lambda x: sampling.gather_samples(x[None, :, None], idx).reshape(n, pred_len, 2)
    return pick(abs_g), pick(rel_g)


SELECT_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
# the tiled K1 takes rows a warp, rows a tile and blocks after per_gen
TILED_ARGTYPES = SELECT_ARGTYPES[:-1] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.cache
def _kernel_fn(stem: str, name: str, tiled: bool):
    """``name`` of the library built from ``csrc/<stem>.cu`` with the
    rollout kernels' argument types (the tiled K1's with ``tiled``), and the
    library's error strings."""
    lib = build.load(stem)
    fn = getattr(lib, name)
    fn.argtypes = TILED_ARGTYPES if tiled else SELECT_ARGTYPES
    fn.restype = ctypes.c_int
    lib.mggan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mggan_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.mggan_cuda_error_string


def check_arg(name, t, shape, dtype, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust these."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def prepare_rollout(packed, socb, h0, last_xy, last_dxdy, pred_len: int,
                    inp_format: str, compute_dtype=None):
    """The weight image and checked row arguments every rollout kernel
    (K1, K2, K3) takes: ``{"tensors": (wpack, h0, socb, last_xy,
    last_dxdy), "dims": (N, M, G, H, hid, in, T, format, per_gen), "bf16":
    whether wpack is the bf16 image}``."""
    bf16 = is_bf16(compute_dtype)
    wflat, per_gen = kernel_weights(packed, compute_dtype)
    g, in_dim, four_h = packed["w_emb"].shape
    h, hid = four_h // 4, packed["w1h"].shape[2]
    n, m = h0.shape[0], last_xy.shape[0]
    dev = h0.device
    if dev.type != "cuda":
        raise ValueError(f"the rollout kernels need CUDA tensors, got {dev}")
    if m == 0 or n % m:
        raise ValueError(f"{n} rollout rows are not a multiple of {m} input rows")
    if h > 32 or hid > 32 or pred_len > 32:
        raise ValueError(f"kernel takes H, hid, pred_len <= 32; got {h}, {hid}, {pred_len}")
    f32 = torch.float32
    check_arg("wpack", wflat, (g * per_gen,), f32, dev)
    check_arg("h0", h0, (n, h), f32, dev)
    check_arg("socb", socb, (m, g, hid), f32, dev)
    check_arg("last_xy", last_xy, (m, 2), f32, dev)
    check_arg("last_dxdy", last_dxdy, (m, 2), f32, dev)
    args = {
        "tensors": (wflat, h0, socb, last_xy, last_dxdy),
        "dims": (n, m, g, h, hid, in_dim, pred_len, FORMATS[inp_format], per_gen),
        "bf16": bf16,
    }
    if not bf16:  # the bf16 kernels of the main paths stage one generator's fragments
        check_all_images(args)
    return args


def check_all_images(args):
    """Raise unless every generator's weight image of ``args`` fits one
    block's shared memory, as the kernels that stage them all (the
    warp-per-row rollouts, K5, the tiled K1) need."""
    g, per_gen = args["dims"][2], args["dims"][8]
    if g * per_gen * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"{g} generators' weights exceed one block's shared memory")


def prepare_decode_select(stacked, last_xy, last_dxdy, social_feats, h0,
                          gen_idx, pred_len: int, inp_format: str,
                          compute_dtype=None):
    """Fold the weights, hoist ``socb`` and check every kernel argument.
    Returns the arguments of ``launch_decode_select``."""
    packed = pack_decoder_params(stacked, inp_format)
    socb = social_bias(packed, social_feats).contiguous()
    args = prepare_rollout(packed, socb, h0, last_xy, last_dxdy, pred_len,
                           inp_format, compute_dtype)
    check_arg("gen_idx", gen_idx, (h0.shape[0],), torch.int32, h0.device)
    args["tensors"] += (gen_idx,)
    if args["bf16"]:  # K1-bf16's fragment image (the warp image stays for K5-bf16)
        image = mma_weights(packed)
        if image.numel() * 4 > MAX_SHARED_BYTES:  # G <= 17 at any width
            raise ValueError(f"{image.shape[0]} generators' K1-bf16 images exceed one "
                             "block's shared memory")
        args["mma_wpack"] = image.reshape(-1)
    return args


def launch_decode_select(args, ilp: bool = False, shape=None):
    """Launch the K1 kernel (its f32 or bf16 variant, as the arguments
    say; K5, a warp per pair of rows, with ``ilp``) on the current stream
    with checked arguments from ``prepare_decode_select``; returns
    ``(abs, rel)``. ``shape`` replaces ``tiled_launch``'s pick for the
    tiled f32 K1, ``(rows_per_warp, tile_rows, blocks)``: for comparing
    launch shapes on the card."""
    if ilp:
        name = KERNEL_ILP_BF16 if args["bf16"] else KERNEL_ILP
        return _launch(args, WARP_SOURCE, "mggan_" + name, name)
    if args["bf16"]:
        return _launch(args, MMA_SOURCE, "mggan_decode_select_bf16", KERNEL_BF16)
    return launch_tiled(args, TILED_SOURCE, "mggan_decode_select", KERNEL, shape)


def launch_tiled(args, stem, symbol, count_as, shape=None):
    """A tiled fused-selection kernel (``csrc/select_tiled.cuh``: K1, and B1
    in ``csrc/decode_ablation.cu``), entry ``symbol`` of ``csrc/<stem>.cu``,
    on f32 arguments from ``prepare_decode_select`` with ``tiled_launch``'s
    pick or ``shape`` = ``(rows_per_warp, tile_rows, blocks)``; counted as
    ``count_as``; returns ``(abs, rel)``."""
    if args["bf16"]:
        raise ValueError("the tiled kernels take f32 arguments")
    return _launch(args, stem, symbol, count_as, shape, tiled=True)


def tiled_warps_per_sm(args, rows_per_warp: int) -> int:
    """Resident warps per SM of the tiled K1 for ``rows_per_warp`` rows a
    warp at these f32 arguments' widths."""
    lib = build.load(TILED_SOURCE)
    fn = lib.mggan_decode_select_tiled_warps_per_sm
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _, _, g, h, hid, _, t, _, per_gen = args["dims"]
    warps = ctypes.c_int(0)
    rc = fn(rows_per_warp, g, per_gen, h, hid, t, ctypes.byref(warps))
    if rc:
        raise RuntimeError(f"mggan_decode_select_tiled_warps_per_sm failed with CUDA error {rc}")
    return warps.value


def launch_decode_select_warp(args):
    """The warp-per-row f32 K1 that the tiled design replaced, on f32
    arguments from ``prepare_decode_select``: the same function, bit for
    bit, for comparing the two on the card (counted as
    ``decode_select_warp``)."""
    if args["bf16"]:
        raise ValueError("the warp-per-row f32 kernel takes f32 arguments")
    return _launch(args, WARP_SOURCE, "mggan_decode_select_warp", KERNEL_WARP)


def mma_warps_per_sm(num_gens: int) -> int:
    """Resident warps per SM of K1-bf16's kernel with ``num_gens``
    generators' images in shared memory."""
    lib = build.load(MMA_SOURCE)
    fn = lib.mggan_decode_select_bf16_warps_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    rc = fn(num_gens, ctypes.byref(warps))
    if rc:
        raise RuntimeError(f"mggan_decode_select_bf16_warps_per_sm failed with CUDA error {rc}")
    return warps.value


def launch_decode_select_bf16_warp(args):
    """The warp-per-row bf16 kernel that K1-bf16's tensor-core design
    replaced, on bf16 arguments from ``prepare_decode_select``: the same
    function, for comparing the two on the card (counted as
    ``decode_select_bf16_warp``)."""
    if not args["bf16"]:
        raise ValueError("the warp-per-row bf16 kernel takes bf16 arguments")
    return _launch(args, WARP_SOURCE, "mggan_decode_select_bf16_warp", KERNEL_BF16_WARP)


def _launch(args, stem, symbol, count_as, shape=None, tiled=False):
    tensors, dims = args["tensors"], args["dims"]
    n, pred_len = dims[0], dims[6]
    dev = tensors[1].device
    if stem == WARP_SOURCE:  # the warp-per-row kernels stage every generator's image
        check_all_images(args)
    out_abs = torch.empty((n, pred_len, 2), dtype=torch.float32, device=dev)
    out_rel = torch.empty((n, pred_len, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return out_abs, out_rel
    fn, err_str = _kernel_fn(stem, symbol, tiled)
    if stem == MMA_SOURCE:  # the fragment image, and rows per tile for the last argument
        sms = sm_count(dev)
        tensors = (args["mma_wpack"],) + tensors[1:]
        dims = dims[:8] + (mma_tile_rows(n, sms),)
    elif tiled:  # rows a warp, rows a tile and blocks after per_gen
        dims = dims + tuple(shape or tiled_launch(n, sm_count(dev)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), out_abs.data_ptr(),
                out_rel.data_ptr(), *dims, stream)
    if rc:
        raise RuntimeError(f"{count_as} launch failed: {err_str(rc).decode()} ({rc})")
    kernels.launches[count_as] += 1
    return out_abs, out_rel


def decode_select_cuda(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx,
                       pred_len: int, inp_format: str, compute_dtype=None,
                       ilp: bool = False):
    """The K1 (or, with ``ilp``, K5) kernel's route; see the module note."""
    return launch_decode_select(prepare_decode_select(
        stacked, last_xy, last_dxdy, social_feats, h0, gen_idx, pred_len,
        inp_format, compute_dtype), ilp)


def refuse_autograd(name, stacked, *tensors):
    """Raise if autograd would differentiate a forward-only selection
    kernel's call: the kernels have no backward on any device."""
    leaves = tree_leaves(stacked) + list(tensors)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        raise RuntimeError(
            f"{name} has no backward; under autograd decode all "
            "generators and gather (decode_select(..., fuse_select=False))")


def decode_select(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx,
                  pred_len: int, inp_format: str, compute_dtype=None,
                  ilp: bool = False):
    """Rollout of each row's sampled generator -> ``(abs, rel)``, each
    ``(N, pred_len, 2)``. CUDA tensors go to the kernel (K5 with ``ilp``),
    CPU tensors to the plain version; there is no other route.

    The kernel has no backward, so a call that autograd would differentiate
    raises on every device: a gradient path decodes all generators and
    gathers (``generator.decode_select(fuse_select=False)``)."""
    refuse_autograd("decode_select", stacked, last_xy, last_dxdy, social_feats, h0)
    if h0.device.type == "cuda":
        return decode_select_cuda(stacked, last_xy, last_dxdy, social_feats,
                                  h0, gen_idx, pred_len, inp_format,
                                  compute_dtype, ilp)
    if h0.device.type == "cpu":
        return decode_select_reference(stacked, last_xy, last_dxdy,
                                       social_feats, h0, gen_idx, pred_len,
                                       inp_format, compute_dtype)
    raise ValueError(f"decode_select: unsupported device {h0.device}")
