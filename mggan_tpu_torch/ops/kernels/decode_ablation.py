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
``act``) on CPU tensors.
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


@functools.cache
def _kernel_fn(act: str):
    lib = build.load(SOURCE)
    fn = getattr(lib, f"mggan_{KERNELS[act]}")
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


def launch_act(args, act: str):
    """B1 on the current stream with K1's checked f32 arguments
    (``decoder.prepare_decode_select``, rel input) -> ``(abs, rel)``."""
    if args["bf16"] or args["dims"][7] != kdec.FORMATS["rel"]:
        raise ValueError("the activation ablation takes f32 weights and rel input")
    _check(act, "rel")
    tensors, dims = args["tensors"], args["dims"]
    n, m, g, h, hid, _, t, _, per_gen = dims
    dev = tensors[1].device
    out_abs = torch.empty((n, t, 2), dtype=torch.float32, device=dev)
    out_rel = torch.empty((n, t, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return out_abs, out_rel
    fn, err_str = _kernel_fn(act)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(x.data_ptr() for x in tensors), out_abs.data_ptr(), out_rel.data_ptr(),
                n, m, g, h, hid, t, per_gen, stream)
    if rc:
        raise RuntimeError(f"{KERNELS[act]} launch failed: {err_str(rc).decode()} ({rc})")
    kernels.launches[KERNELS[act]] += 1
    return out_abs, out_rel


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
