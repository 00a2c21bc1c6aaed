"""Activation ablations of the fused-selection rollout: the port of B1.

Counterpart of ``benchmarks/decode_ablation.py::variant_kernel(act)``:
K1's rollout (rel input, f32 weights) with its gate activations swapped,
to split K1's time into its transcendental share and the rest:

* ``f32``: sigmoid and tanh, K1's own (equal to K1 bit for bit on the card);
* ``bf16``: the activations in bf16 arithmetic (``decoder._sig_bf16``,
  ``_tanh_bf16``; on the card ``hexp`` and ``__hdiv``);
* ``lin``: ``x * 0.25 + 0.5`` and ``x * 0.5``, wrong numerics by design.

``decode_select_act`` launches ``csrc/decode_ablation.cu`` on CUDA tensors
(counted as ``decode_select_act_<act>``) and runs the plain version
``decode_select_act_reference`` (``decoder.decode_select_reference`` with
``act``) on CPU tensors. The kernel is the tiled K1
(``csrc/select_tiled.cuh``: rows bucketed by generator, R rows of one
generator a warp, K1's launch ``decoder.tiled_launch``, at the flagship
widths ``WIDTHS``) on the activations of ``act``, so only the activations
differ from K1; each variant equals its warp-per-row kernel (the earlier
design, ``launch_act_warp``, counted as ``decode_select_act_<act>_warp``;
no path launches it) bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mggan_tpu_torch.ops import kernels
from mggan_tpu_torch.ops.kernels import build
from mggan_tpu_torch.ops.kernels import decoder as kdec

SOURCE = "decode_ablation"  # csrc/decode_ablation.cu
ACTS = ("f32", "bf16", "lin")
KERNELS = {act: f"decode_select_act_{act}" for act in ACTS}
WIDTHS = (32, 16)  # (H, hid): the tiled kernels' one instantiation, the flagship's
# the warp-per-row kernels the tiled ones replaced, kept for comparison on
# the card (chip_smoke.py, the card tests); no path launches them
KERNELS_WARP = {act: f"{name}_warp" for act, name in KERNELS.items()}


@functools.cache
def _warp_fn(act: str):
    lib = build.load(SOURCE)
    fn = getattr(lib, f"mggan_{KERNELS[act]}_warp")
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mggan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mggan_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.mggan_cuda_error_string


def _check(act, inp_format):
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if inp_format != "rel":
        raise ValueError(f"the activation ablation takes rel input only, got {inp_format!r}")


def decode_select_act_reference(stacked, last_xy, last_dxdy, social_feats, h0,
                                gen_idx, pred_len: int, act: str, inp_format: str = "rel"):
    """B1's plain version: K1's plain version with the activations of ``act``."""
    _check(act, inp_format)
    return kdec.decode_select_reference(stacked, last_xy, last_dxdy, social_feats, h0,
                                        gen_idx, pred_len, inp_format, act=act)


def _check_args(args, act):
    if args["bf16"] or args["dims"][7] != kdec.FORMATS["rel"]:
        raise ValueError("the activation ablation takes f32 weights and rel input")
    _check(act, "rel")


def _check_widths(args):
    if tuple(args["dims"][3:5]) != WIDTHS:
        raise ValueError(f"the tiled activation ablation is built for (H, hid) = {WIDTHS}, "
                         f"got {tuple(args['dims'][3:5])}")


def launch_act(args, act: str, shape=None):
    """B1 on the current stream with K1's checked f32 arguments
    (``decoder.prepare_decode_select``, rel input) -> ``(abs, rel)``: the
    tiled kernel with ``decoder.tiled_launch``'s pick, or ``shape`` =
    ``(rows_per_warp, tile_rows, blocks)``. Flagship widths only
    (``WIDTHS``)."""
    _check_args(args, act)
    _check_widths(args)
    return kdec.launch_tiled(args, SOURCE, f"mggan_{KERNELS[act]}", KERNELS[act], shape)


def launch_act_warp(args, act: str):
    """The warp-per-row B1 kernel that the tiled one replaced, as
    ``launch_act``: the same function bit for bit, for comparing the two on
    the card (counted as ``decode_select_act_<act>_warp``)."""
    _check_args(args, act)
    kdec.check_all_images(args)
    tensors, dims = args["tensors"], args["dims"]
    n, m, g, h, hid, _, t, _, per_gen = dims
    dev = tensors[1].device
    out_abs = torch.empty((n, t, 2), dtype=torch.float32, device=dev)
    out_rel = torch.empty((n, t, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return out_abs, out_rel
    fn, err_str = _warp_fn(act)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in tensors), out_abs.data_ptr(), out_rel.data_ptr(),
                n, m, g, h, hid, t, per_gen, stream)
    if rc:
        raise RuntimeError(f"{KERNELS_WARP[act]} launch failed: {err_str(rc).decode()} ({rc})")
    kernels.launches[KERNELS_WARP[act]] += 1
    return out_abs, out_rel


def tiled_warps_per_sm(args, act: str, rows_per_warp: int) -> int:
    """Resident warps per SM of the tiled B1 on ``act`` for
    ``rows_per_warp`` rows a warp at these f32 arguments' widths."""
    _check_widths(args)
    fn = build.load(SOURCE).mggan_decode_select_act_tiled_warps_per_sm
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    _, _, g, h, hid, _, t, _, per_gen = args["dims"]
    warps = ctypes.c_int(0)
    rc = fn(ACTS.index(act), rows_per_warp, g, per_gen, h, hid, t, ctypes.byref(warps))
    if rc:
        raise RuntimeError(f"{KERNELS[act]}: resident warps query failed with CUDA error {rc}")
    return warps.value


def decode_select_act(stacked, last_xy, last_dxdy, social_feats, h0, gen_idx,
                      pred_len: int, act: str, inp_format: str = "rel"):
    """K1's rollout with the activations of ``act`` -> ``(abs, rel)``, each
    ``(N, pred_len, 2)``: the kernel on CUDA tensors, the plain version on
    CPU tensors. Forward only, as K1: under autograd it raises."""
    _check(act, inp_format)
    kdec.refuse_autograd("decode_select_act", stacked, last_xy, last_dxdy, social_feats, h0)
    if h0.device.type == "cuda":
        return launch_act(kdec.prepare_decode_select(
            stacked, last_xy, last_dxdy, social_feats, h0, gen_idx, pred_len, inp_format), act)
    if h0.device.type == "cpu":
        return decode_select_act_reference(stacked, last_xy, last_dxdy, social_feats, h0,
                                           gen_idx, pred_len, act, inp_format)
    raise ValueError(f"decode_select_act: unsupported device {h0.device}")
