"""The serving path's decoder kernels as PyTorch operators.

Two ``torch.library.custom_op``s in the ``mggan`` namespace put K1 and K2
into the dispatcher, so ``torch.export`` records each as one graph node and
an exported program calls the kernel when it runs:

* ``mggan::decode_select``: the fused-selection rollout, K1 (or K1-bf16),
  ``(abs, rel)``, each ``(N, pred_len, 2)``;
* ``mggan::decode_all_fwd``: every generator's rollout, K2 (or K2-bf16),
  ``(abs, rel, hc)``: abs/rel ``(G, N, pred_len, 2)``, hc ``(G, N,
  pred_len, 2, H)`` with ``save_hc``, else an empty ``(0,)`` tensor.

Both take the folded per-generator weights ``w_emb, w_hh, b, w1h, w2, b2``
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
  ``decoder.rollout_reference``);
* any other device has no implementation and raises.

``register_fake`` gives the output shapes, so tracing never reaches a
kernel. Importing this module registers the operators; it loads no
library and needs no card.
"""

from __future__ import annotations

import torch

from mggan_tpu_torch.ops.kernels import decode_all as kda
from mggan_tpu_torch.ops.kernels import decoder as kdec

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
