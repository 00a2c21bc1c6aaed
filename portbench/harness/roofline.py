"""The yardstick's arithmetic: the H100's peaks, the decoder kernels'
products, and the least time a kernel's work can take.

The peaks and the two product counts are copied from the measured
program's roofline module as it stood when the benchmark was written, so
that a later change to the program cannot move them.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense): float32 on the CUDA cores, and
# HBM3's bandwidth. The configurations run in float32.
H100_FP32_FLOPS = 67e12
H100_HBM_BPS = 3.35e12
F32 = 4


def rollout_flops(n, t, h, hid, in_dim):
    """The products of ``n`` single-generator rollouts of ``t`` steps: per
    step the gate product ``[x, h] @ [W_emb; W_hh]``, ``h @ W1h`` and
    ``hid @ W2``."""
    return n * t * (2 * (in_dim + h) * 4 * h + 2 * h * hid + 2 * hid * 2)


def reverse_sweep_flops(n, t, h, hid, in_dim):
    """The products of the reverse sweep of ``n`` single-generator
    rollouts: the gate recompute, its two gradient products, and three of
    hidden2pos's width and two of its output's."""
    return n * t * (3 * 2 * (in_dim + h) * 4 * h + 3 * 2 * h * hid + 2 * 2 * hid * 2)


def least_seconds(flops, nbytes):
    """The larger of the products at the float32 peak and the bytes at
    HBM's rate."""
    return max(flops / H100_FP32_FLOPS, nbytes / H100_HBM_BPS)


def decoder_dims(cfg: dict):
    """``(t, h, hid, in_dim, gens)`` of a configuration's decoders."""
    h = cfg["decoder_h_dim"]
    return 12, h, h // 2, 2, cfg["num_gens"]


def _weights_bytes(cfg):
    t, h, hid, in_dim, g = decoder_dims(cfg)
    return F32 * g * (in_dim * 4 * h + h * 4 * h + 4 * h + h * hid + hid * 2 + 2)


def _agent_bytes(cfg):
    """Per agent: the last position and step, and each generator's
    hoisted social term."""
    t, h, hid, in_dim, g = decoder_dims(cfg)
    return F32 * (2 + 2 + g * hid)


def select_seconds(cfg, agents, rows):
    """The fused-selection rollout: ``rows`` (sample, agent) rows of their
    chosen generator; reads each input once (``h0`` and the index a row,
    the agent's inputs, the weights) and writes positions and steps once."""
    t, h, hid, in_dim, g = decoder_dims(cfg)
    nbytes = (_weights_bytes(cfg) + agents * _agent_bytes(cfg)
              + rows * (F32 * h + 4) + rows * 2 * t * 2 * F32)
    return least_seconds(rollout_flops(rows, t, h, hid, in_dim), nbytes)


def all_fwd_seconds(cfg, agents, rows, save_hc):
    """Every generator on ``rows`` rows; with ``save_hc`` it also writes
    each step's (h, c) for the reverse sweep."""
    t, h, hid, in_dim, g = decoder_dims(cfg)
    out = g * rows * 2 * t * 2 * F32
    if save_hc:
        out += g * rows * t * 2 * h * F32
    nbytes = _weights_bytes(cfg) + agents * _agent_bytes(cfg) + rows * F32 * h + out
    return least_seconds(rollout_flops(g * rows, t, h, hid, in_dim), nbytes)


def all_bwd_seconds(cfg, agents, rows):
    """The reverse sweep of every generator on ``rows`` rows: reads the
    forward's inputs, outputs, (h, c) and both cotangents once; writes the
    inputs' gradients and the weights' once."""
    t, h, hid, in_dim, g = decoder_dims(cfg)
    fwd_in = _weights_bytes(cfg) + agents * _agent_bytes(cfg) + rows * F32 * h
    per_row = g * rows * (2 * t * 2 * F32 * 2 + t * 2 * h * F32)
    nbytes = 2 * fwd_in + per_row
    return least_seconds(reverse_sweep_flops(g * rows, t, h, hid, in_dim), nbytes)
