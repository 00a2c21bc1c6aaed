"""Shared model components: trajectory encoder + relative decoder.

Counterpart of ``mggan_tpu/models/common.py``. The decoder here is JAX's
XLA scan in plain PyTorch, in f32 or with JAX's bf16 rounding
(``compute_dtype``): the reference the kernels and their plain versions
(``ops/kernels/``) are held against. No entry point runs it; the port
always decodes through the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mggan_tpu_torch.ops.kernels.decoder import input_size  # noqa: F401  (re-exported)
from mggan_tpu_torch.ops.linear import linear_apply, linear_init, mlp_init
from mggan_tpu_torch.ops.lstm import lstm_init, lstm_scan


class GeneratorOutput(NamedTuple):
    """(rel, abs) prediction pair (common_modules.py:9)."""

    rel: torch.Tensor
    abs: torch.Tensor


def get_input(in_xy, in_dxdy, inp_format: str):
    """Encoder input per format (common_modules.py:12-21).

    in_xy (S, P, 8, 2), in_dxdy (S, P, 7, 2). For ``abs_rel`` the first
    offset is repeated so both spans are 8 steps.
    """
    if inp_format == "rel":
        return in_dxdy
    if inp_format == "abs":
        return in_xy
    dxdy = torch.cat([in_dxdy[..., :1, :], in_dxdy], dim=-2)
    return torch.cat([in_xy, dxdy], dim=-1)


def trajectory_encoder_init(gen, inp_size, hidden_size, embedding_dim):
    params = {"lstm": lstm_init(gen, embedding_dim or inp_size, hidden_size)}
    if embedding_dim is not None:
        params["embed"] = linear_init(gen, inp_size, embedding_dim)
    return params


def trajectory_encoder_apply(params, inp):
    """Encode (S, P, T, D) trajectories -> (S, P, H) final hidden state."""
    s, p, t, d = inp.shape
    x = inp.reshape(s * p, t, d)
    if "embed" in params:
        x = linear_apply(params["embed"], x)
    _, (h_t, _) = lstm_scan(params["lstm"], x.transpose(0, 1))
    return h_t.reshape(s, p, -1)


def relative_decoder_init(gen, embedding_dim, h_dim, inp_format, social_feat_size):
    return {
        "spatial_embedding": linear_init(gen, input_size(inp_format), embedding_dim),
        "lstm": lstm_init(gen, embedding_dim, h_dim),
        # [h + social, h//2, 2] with leaky_relu (common_modules.py:93-95)
        "hidden2pos": mlp_init(gen, [h_dim + social_feat_size, h_dim // 2, 2]),
    }


def _decoder_input(xy, dxdy, inp_format):
    if inp_format == "rel":
        return dxdy
    if inp_format == "abs":
        return xy
    return torch.cat([xy, dxdy], dim=-1)


# LeakyReLU's slope as a value of each dtype (JAX casts the scalar to the
# array's dtype)
_SLOPES = {dt: torch.tensor(0.01, dtype=dt).item()
           for dt in (torch.float32, torch.bfloat16, torch.float16)}


def _leaky_relu(x):
    """``jax.nn.leaky_relu(x, 0.01)``: the slope in ``x``'s dtype."""
    return torch.where(x >= 0, x, x * _SLOPES.get(x.dtype, 0.01))


def relative_decoder_apply(params, last_xy, last_dxdy, social_feats, h0,
                           pred_len: int, inp_format: str, compute_dtype=None):
    """12-step autoregressive rollout of one generator: JAX's ``lax.scan``
    (``mggan_tpu/models/common.py::relative_decoder_apply``) step by step.

    last_xy/last_dxdy (N, 2), social_feats (N, F), h0 (N, H); c0 = 0.
    Returns (abs, rel), each (N, pred_len, 2), float32.

    As in JAX, the spatial embedding is folded into the gate matmul
    (``[te, h] @ [[We @ W_ih], [W_hh]] + (be @ W_ih + b_ih + b_hh)``) and the
    social contribution to hidden2pos is hoisted out of the loop.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) rounds as JAX's scan does:
    the folded gate weights, ``W1h``, the social term, h0, c0 and the output
    layer are cast to it; the gates are the product in that dtype cast to
    float32 plus the f32 bias; c and h go back to h's dtype each step; the
    LeakyReLU and the output layer run in it; the position integrates in
    float32. This is not the kernels' bf16 numerics, which round only the
    products' operands.
    """
    emb, lstm, h2p = params["spatial_embedding"], params["lstm"], params["hidden2pos"]
    w_comb = torch.cat([emb["w"] @ lstm["w_ih"], lstm["w_hh"]], dim=0)
    b_comb = emb["b"] @ lstm["w_ih"] + lstm["b_ih"] + lstm["b_hh"]
    h_dim = lstm["w_hh"].shape[0]
    w1 = h2p["lin0"]["w"]  # (h + F, h//2)
    w1_h, w1_soc = w1[:h_dim], w1[h_dim:]
    soc_contrib = social_feats @ w1_soc + h2p["lin0"]["b"]

    h, c = h0, torch.zeros_like(h0)
    lin1 = h2p["lin1"]
    cd = compute_dtype
    if cd is not None:
        w_comb, w1_h, soc_contrib = w_comb.to(cd), w1_h.to(cd), soc_contrib.to(cd)
        h, c = h.to(cd), c.to(cd)
        lin1 = {"w": lin1["w"].to(cd), "b": lin1["b"].to(cd)}
    xy, dxdy = last_xy, last_dxdy
    abs_seq, rel_seq = [], []
    for _ in range(pred_len):
        te = _decoder_input(xy, dxdy, inp_format)
        if cd is not None:
            te = te.to(cd)
        gates = (torch.cat([te, h], dim=-1) @ w_comb).float() + b_comb
        i, f, g, o = gates.chunk(4, dim=-1)
        c = (torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)).to(h.dtype)
        h = (torch.sigmoid(o) * torch.tanh(c.float())).to(h.dtype)
        hid = _leaky_relu(h @ w1_h + soc_contrib)
        dxdy = linear_apply(lin1, hid).float()
        xy = xy + dxdy
        abs_seq.append(xy)
        rel_seq.append(dxdy)
    return torch.stack(abs_seq, 1), torch.stack(rel_seq, 1)


def stacked_decoders_init(gen, num_gens, embedding_dim, h_dim, inp_format,
                          social_feat_size):
    """G decoders as one tree with a leading generator axis."""
    per_gen = [
        relative_decoder_init(gen, embedding_dim, h_dim, inp_format, social_feat_size)
        for _ in range(num_gens)
    ]
    return stack_trees(per_gen)


def stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def unstack_tree(tree, i):
    if isinstance(tree, dict):
        return {k: unstack_tree(v, i) for k, v in tree.items()}
    return tree[i]


def stacked_decoders_apply(stacked, last_xy, last_dxdy, social_feats, h0,
                           pred_len: int, inp_format: str, compute_dtype=None):
    """Every generator's rollout on the same inputs (JAX: vmap over G), in
    ``compute_dtype`` as ``relative_decoder_apply``.

    Returns (abs, rel), each (G, N, pred_len, 2).
    """
    num_gens = stacked["lstm"]["w_hh"].shape[0]
    outs = [
        relative_decoder_apply(unstack_tree(stacked, g), last_xy, last_dxdy,
                               social_feats, h0, pred_len, inp_format, compute_dtype)
        for g in range(num_gens)
    ]
    return torch.stack([a for a, _ in outs]), torch.stack([r for _, r in outs])
