"""FLOP counts of the decoder kernels and the H100's peaks.

Counterpart of ``mggan_tpu/utils/roofline.py``, for one NVIDIA H100 SXM: the
peaks a bound divides by, and the products the decoder kernels execute. A
copy of the arithmetic, not an import: the port imports nothing of
``mggan_tpu``.

``ops/kernels/library.py`` registers ``rollout_flops`` and
``reverse_sweep_flops`` as the ``FlopCounterMode`` formulas of the
operators ``mggan::decode_select``, ``mggan::decode_all_fwd`` and
``mggan::decode_all_bwd``, so a count reads the same work on the card and
on the CPU whatever implements the operator; the kernels' bounds in
``chip_smoke.py`` take their FLOPs from the same two functions. The H100
kernels run each row's generator alone, without the TPU's lane packing
(``_pack_all``), so the FLOPs they execute are the useful ones.
Element-wise work is left out, as in JAX.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores (the
# f32 kernels' operands), bf16 on the tensor cores (the bf16 variants'
# operands) and HBM3 bandwidth.
H100_FP32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_HBM_BPS = 3.35e12


def rollout_flops(n, t, h, hid, in_dim):
    """The products of ``n`` single-generator rollouts of ``t`` steps: per
    step the gate product ``[x, h] @ [W_emb; W_hh]``, hidden2pos's
    ``h @ W1h`` and its output ``hid @ W2``."""
    return n * t * (2 * (in_dim + h) * 4 * h + 2 * h * hid + 2 * hid * 2)


def reverse_sweep_flops(n, t, h, hid, in_dim):
    """The products of the reverse sweep (K3) of ``n`` single-generator
    rollouts of ``t`` steps: per step the gate recompute, ``dgates @ [W_emb;
    W_hh]^T`` and the weight grads' outer products (three products of the
    gate width), and three of hidden2pos's width (the pre-activation
    recompute, ``dh`` and ``dW1h``) and two of its output's."""
    return n * t * (3 * 2 * (in_dim + h) * 4 * h + 3 * 2 * h * hid + 2 * 2 * hid * 2)
