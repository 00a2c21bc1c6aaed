"""The decoder kernels K1, K2 and K3 as PyTorch operators.

Three ``torch.library.custom_op``s in the ``mggan`` namespace put the
kernels into the dispatcher, so ``torch.export`` records K1 and K2 as one
graph node each and an exported program calls the kernel when it runs, and
``torch.utils.flop_counter.FlopCounterMode`` counts each by the formula of
``utils/roofline.py`` (registered here) and not by what implements it:

* ``mggan::decode_select``: the fused-selection rollout, K1 (or K1-bf16),
  ``(abs, rel)``, each ``(N, pred_len, 2)``;
* ``mggan::decode_all_fwd``: every generator's rollout, K2 (or K2-bf16),
  ``(abs, rel, hc)``: abs/rel ``(G, N, pred_len, 2)``, hc ``(G, N,
  pred_len, 2, H)`` with ``save_hc``, else an empty ``(0,)`` tensor;
* ``mggan::decode_all_bwd``: K2's reverse sweep, K3, from K2's inputs,
  outputs and (h, c) and the cotangents of abs and rel: the grads of
  ``decode_all.DecodeAll``'s tensor inputs, the six weights' as K3's one
  grad image ``(G, P)`` (``decode_all.decode_all_bwd`` splits it into
  views, outside the operator, whose outputs may not share storage).
  ``after_bf16`` marks residuals of K2-bf16 (K3 still sweeps on the f32
  weights); it changes only the count a launch goes to.

All take the folded per-generator weights ``w_emb, w_hh, b, w1h, w2, b2``
(``decoder.pack_decoder_params``), the hoisted ``socb``
(``decoder.social_bias``), ``h0``, ``last_xy``, ``last_dxdy`` (K1 also
``gen_idx``) and the rollout's sizes; the row layout is ``decoder.py``'s.
The folding stays outside, as tensor ops that a trace records.

The dispatcher picks the implementation from the tensors' device:

* CUDA: the kernel, with the weight image (``decoder.kernel_weights``, or
  the fragment image ``decoder.mma_weights`` for K1-bf16), the argument
  checks and the launch rules of ``decoder.py`` and ``decode_all.py``,
  counted in ``kernels.launches`` as before; a failed build or launch
  raises;
* CPU: the plain versions (``decoder.select_reference``,
  ``decoder.rollout_reference``, ``decode_all.decode_all_bwd_reference``);
* any other device has no implementation and raises.

``register_fake`` gives the output shapes, so tracing never reaches a
kernel. Importing this module registers the operators and their FLOP
formulas (``count_flops``); it loads no library and needs no card.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decoder as kdec
from mggan_tpu_torch.utils import roofline

Tensor = torch.Tensor


def _dtype(bf16: bool):
    return torch.bfloat16 if bf16 else None


def _packed(w_emb, w_hh, b, w1h, w2, b2) -> dict:
    return dict(zip(kdec.PACKED, (w_emb, w_hh, b, w1h, w2, b2)))


@torch.library.custom_op("mggan::decode_select", mutates_args=(), device_types="cpu")
def decode_select(w_emb: Tensor, w_hh: Tensor, b: Tensor, w1h: Tensor, w2: Tensor,
                  b2: Tensor, socb: Tensor, h0: Tensor, last_xy: Tensor, last_dxdy: Tensor,
                  gen_idx: Tensor, pred_len: int, inp_format: str,
                  bf16: bool) -> tuple[Tensor, Tensor]:
    """K1: the rollout of each row's generator ``gen_idx``; on the CPU its
    plain version."""
    return kdec.select_reference(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy,
                                 gen_idx, pred_len, inp_format, _dtype(bf16))


@decode_select.register_kernel("cuda")
def _decode_select_cuda(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, gen_idx,
                        pred_len, inp_format, bf16):
    rows = (x.contiguous() for x in (socb, h0, last_xy, last_dxdy, gen_idx))
    args = kdec.prepare_select(_packed(w_emb, w_hh, b, w1h, w2, b2), *rows, pred_len,
                               inp_format, _dtype(bf16))
    return kdec.launch_decode_select(args)


@decode_select.register_fake
def _decode_select_fake(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, gen_idx,
                        pred_len, inp_format, bf16):
    shape = (h0.shape[0], pred_len, 2)
    return h0.new_empty(shape, dtype=torch.float32), h0.new_empty(shape, dtype=torch.float32)


@torch.library.custom_op("mggan::decode_all_fwd", mutates_args=(), device_types="cpu")
def decode_all_fwd(w_emb: Tensor, w_hh: Tensor, b: Tensor, w1h: Tensor, w2: Tensor,
                   b2: Tensor, socb: Tensor, h0: Tensor, last_xy: Tensor, last_dxdy: Tensor,
                   pred_len: int, inp_format: str, save_hc: bool,
                   bf16: bool) -> tuple[Tensor, Tensor, Tensor]:
    """K2: every generator's rollout of every row; on the CPU its plain
    version."""
    out_abs, out_rel, hc = kda.decode_all_reference(
        w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, pred_len, inp_format,
        save_hc, _dtype(bf16))
    return out_abs, out_rel, hc if save_hc else h0.new_empty((0,), dtype=torch.float32)


@decode_all_fwd.register_kernel("cuda")
def _decode_all_fwd_cuda(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, pred_len,
                         inp_format, save_hc, bf16):
    inputs = (w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy)
    args = kda.prepare(*(x.contiguous() for x in inputs), pred_len, inp_format, _dtype(bf16))
    out_abs, out_rel, hc = kda.launch_fwd(args, save_hc)
    return out_abs, out_rel, hc if save_hc else h0.new_empty((0,), dtype=torch.float32)


@decode_all_fwd.register_fake
def _decode_all_fwd_fake(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, pred_len,
                         inp_format, save_hc, bf16):
    g, h, n = w_hh.shape[0], w_hh.shape[1], h0.shape[0]
    new = lambda *shape: h0.new_empty(shape, dtype=torch.float32)
    hc = new(g, n, pred_len, 2, h) if save_hc else new(0)
    return new(g, n, pred_len, 2), new(g, n, pred_len, 2), hc


@torch.library.custom_op("mggan::decode_all_bwd", mutates_args=(), device_types="cpu")
def decode_all_bwd(w_emb: Tensor, w_hh: Tensor, b: Tensor, w1h: Tensor, w2: Tensor,
                   b2: Tensor, socb: Tensor, h0: Tensor, last_xy: Tensor, last_dxdy: Tensor,
                   out_abs: Tensor, out_rel: Tensor, hc: Tensor, g_abs: Tensor, g_rel: Tensor,
                   pred_len: int, inp_format: str, after_bf16: bool) -> tuple[
                       Tensor, Tensor, Tensor, Tensor, Tensor]:
    """K3: K2's weight grads as K3's grad image ``(G, P)``
    (``decode_all.weight_image``), then the grads of ``socb``, ``h0``,
    ``last_xy`` and ``last_dxdy``; on the CPU its plain version."""
    grads = kda.decode_all_bwd_reference(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy,
                                         last_dxdy, out_abs, out_rel, hc, g_abs, g_rel,
                                         pred_len, inp_format)
    return (kda.weight_image(*grads[:6]), *grads[6:])


@decode_all_bwd.register_kernel("cuda")
def _decode_all_bwd_cuda(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, out_abs,
                         out_rel, hc, g_abs, g_rel, pred_len, inp_format, after_bf16):
    inputs = (w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy)
    args = kda.prepare(*(x.contiguous() for x in inputs), pred_len, inp_format)
    raw = kda.launch_bwd(args, out_abs, out_rel, hc, g_abs.contiguous(), g_rel.contiguous(),
                         kda.KERNEL_BWD_AFTER_BF16 if after_bf16 else kda.KERNEL_BWD)
    return kda.reduce_raw(raw, last_xy.shape[0])


@decode_all_bwd.register_fake
def _decode_all_bwd_fake(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, out_abs,
                         out_rel, hc, g_abs, g_rel, pred_len, inp_format, after_bf16):
    g, in_dim, h, hid = w_emb.shape[0], w_emb.shape[1], w_hh.shape[1], w1h.shape[2]
    image = h0.new_empty((g, kda.grad_image_floats(h, hid, in_dim)), dtype=torch.float32)
    return (image, *(torch.empty_like(x, dtype=torch.float32)
                     for x in (socb, h0, last_xy, last_dxdy)))


# The operators' FLOPs for FlopCounterMode, from the shapes alone (a
# tensor argument arrives as its shape): the products that the kernels'
# bounds count
def _dims(w_emb, w1h, h0):
    """``(G, N, H, hid, in_dim)`` of the folded weights and ``h0``."""
    return w_emb[0], h0[0], h0[1], w1h[2], w_emb[1]


@register_flop_formula(torch.ops.mggan.decode_select)
def _decode_select_flops(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, gen_idx,
                         pred_len, inp_format, bf16, out_shape=None):
    _, n, h, hid, in_dim = _dims(w_emb, w1h, h0)
    return roofline.rollout_flops(n, pred_len, h, hid, in_dim)


@register_flop_formula(torch.ops.mggan.decode_all_fwd)
def _decode_all_fwd_flops(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, pred_len,
                          inp_format, save_hc, bf16, out_shape=None):
    g, n, h, hid, in_dim = _dims(w_emb, w1h, h0)
    return roofline.rollout_flops(g * n, pred_len, h, hid, in_dim)


@register_flop_formula(torch.ops.mggan.decode_all_bwd)
def _decode_all_bwd_flops(w_emb, w_hh, b, w1h, w2, b2, socb, h0, last_xy, last_dxdy, out_abs,
                          out_rel, hc, g_abs, g_rel, pred_len, inp_format, after_bf16,
                          out_shape=None):
    g, n, h, hid, in_dim = _dims(w_emb, w1h, h0)
    return roofline.reverse_sweep_flops(g * n, pred_len, h, hid, in_dim)


def count_flops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``FlopCounterMode`` -> ``(total,
    by_op)``, ``by_op`` mapping an operator's name (``aten.mm``,
    ``mggan.decode_all_bwd``, ...) to its FLOPs; a backward pass counts
    when ``fn`` runs it. The ``mggan::`` operators count by the formulas
    above, whatever implements them."""
    mode = FlopCounterMode(display=False)
    with mode:
        fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in mode.get_flop_counts()["Global"].items()}
    return int(mode.get_total_flops()), by_op
