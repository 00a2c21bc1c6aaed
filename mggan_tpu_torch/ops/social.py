"""Masked social modules over padded scene tensors: sways attention, SGAN
pooling and the legacy Social-GAN's grid pooling.

Counterpart of ``mggan_tpu/ops/social.py`` (``social_features``,
``attention_pool``, ``social_attention_apply``, ``pool_hidden_net_apply``,
``social_pooling_apply``). Scenes are rows of a dense
``(S, P, P)`` pairwise tensor; ``mask (S, P)`` marks real peds. Pairwise
tensors are indexed ``[s, i, j]`` with ``i`` the attending ped.
"""

from __future__ import annotations

import torch

from mggan_tpu_torch.ops.linear import linear_apply, mlp_apply

NEG_INF = -1e9


def social_features(last_xy, last_dxdy, mask):
    """Pairwise (dist, bearing, DCA) features, ``(S, P, P, 3)``; entries that
    involve a padded ped are 0 (reference social.py:51-104)."""
    dp = last_xy[:, :, None, :] - last_xy[:, None, :, :]
    dv = last_dxdy[:, :, None, :] - last_dxdy[:, None, :, :]
    l2 = torch.linalg.vector_norm(dp, dim=-1)

    v_i = last_dxdy[:, :, None, :]
    bearing = (dp * v_i).sum(-1) / (
        l2 * torch.linalg.vector_norm(v_i, dim=-1) + 1e-6
    )

    dv_sq = (dv * dv).sum(-1) + 1e-6
    ttca = -(dp * dv).sum(-1) / dv_sq
    dca = torch.linalg.vector_norm(dp + ttca[..., None] * dv, dim=-1)

    feats = torch.stack([l2, bearing, dca], dim=-1)
    pair_mask = (mask[:, :, None] & mask[:, None, :])[..., None]
    return torch.where(pair_mask, feats, torch.zeros_like(feats))


def attention_pool(w_params, femb, enc_h, mask):
    """Masked dot-product attention (reference social.py:7-30): self and
    padded peers are masked with -1e9; rows of padded peds, and of scenes
    with one ped or fewer, are zeroed.

    ``enc_h`` is ``(..., S, P, H)``: leading sample axes share the pairwise
    embedding ``femb (S, P, P, F)``. Returns ``(..., S, P, H)``.
    """
    p = enc_h.shape[-2]
    wh = linear_apply(w_params, enc_h)  # (..., S, P, F)
    sigma = torch.einsum("sijf,...sjf->...sij", femb, wh)
    eye = torch.eye(p, dtype=torch.bool, device=mask.device)[None]
    valid_j = mask[:, None, :] & ~eye
    sigma = torch.where(valid_j, sigma, torch.full_like(sigma, NEG_INF))
    att = torch.softmax(sigma, dim=-1)
    row_ok = (mask.sum(-1)[:, None] > 1) & mask
    pooled = torch.einsum("...sij,...sjh->...sih", att, enc_h)
    return torch.where(row_ok[..., None], pooled, torch.zeros_like(pooled))


def social_attention_apply(params, last_xy, last_dxdy, enc_h, mask):
    """The sways social module (reference social.py:107-123).

    params = {"embed": mlp [3,32,64,F], "w": linear (H->F)}; enc_h
    ``(..., S, P, H)``. The pairwise geometry is computed once and shared
    by every leading sample (JAX ``social_attention_apply``'s vmap).
    """
    femb = mlp_apply(params["embed"], social_features(last_xy, last_dxdy, mask))
    return attention_pool(params["w"], femb, enc_h, mask)


def pool_hidden_net_apply(params, last_xy, enc_h, mask, activation="relu"):
    """Masked SGAN pooling (``PoolHiddenNet.forward``, social_gan.py:201-229).

    ``rel[s,i,j] = pos_j - pos_i`` is embedded, concatenated with ``h_j``,
    passed through the pre-pool MLP and max-pooled over the real peers j
    (self included, as in the reference); rows of padded peds are zero.
    params = {"spatial": linear (2->emb), "pre_pool": mlp [emb+H, H, H]};
    ``enc_h (..., S, P, H)``: leading sample axes share the geometry (JAX's
    vmap). Returns ``(..., S, P, H)``.
    """
    rel = last_xy[:, None, :, :] - last_xy[:, :, None, :]  # (S, P_i, P_j, 2)
    rel_emb = linear_apply(params["spatial"], rel)
    lead = tuple(enc_h.shape[:-3])
    hj = enc_h[..., None, :, :].expand(lead + tuple(rel_emb.shape[:3]) + (enc_h.shape[-1],))
    inp = torch.cat([rel_emb.expand(lead + tuple(rel_emb.shape)), hj], dim=-1)
    pooled = mlp_apply(params["pre_pool"], inp, activation=activation)
    valid_j = (mask[:, None, :] & mask[:, :, None])[..., None]
    pooled = torch.where(valid_j, pooled, torch.full_like(pooled, NEG_INF))
    out = pooled.max(dim=-2).values
    return torch.where(mask[..., None], out, torch.zeros_like(out))


def social_pooling_apply(params, last_xy, enc_h, mask, neighborhood_size=2.0, grid_size=8):
    """Masked grid-based Social-LSTM pooling (``SocialPooling``,
    social_gan.py:232-358).

    Each ped i owns a ``grid_size x grid_size`` grid spanning
    ``neighborhood_size`` centred on it; every real peer j (not i) inside it
    adds its hidden state into cell(i, j), with y measured downward from the
    grid's top bound as in the reference (social_gan.py:273-276). The sum
    is a scatter-add (``index_add``) over the flattened (i, cell) row of
    each pair, where JAX contracts a one-hot pair tensor. At 64 scenes x 16
    peds, H=32, the scatter-add's pair contributions ``(S, P, P, H)`` hold
    524,288 floats (2 MiB) and the one-hot's ``(S, P, P, grid^2)`` would
    hold 1,048,576 (4 MiB); both write the ``(S, P, grid^2 * H)`` grid,
    2,097,152 floats (8 MiB).
    params = {"pool": mlp [grid^2 * H, ...]}. Returns the MLP's
    output for real peds, zeros for padded ones.
    """
    s, p, h = enc_h.shape
    g2 = grid_size * grid_size
    rel = last_xy[:, None, :, :] - last_xy[:, :, None, :]  # pos_j - pos_i
    half = neighborhood_size / 2.0
    cell_x = torch.floor((rel[..., 0] + half) / neighborhood_size * grid_size)
    cell_y = torch.floor((half - rel[..., 1]) / neighborhood_size * grid_size)
    in_bounds = (cell_x >= 0) & (cell_x < grid_size) & (cell_y >= 0) & (cell_y < grid_size)
    eye = torch.eye(p, dtype=torch.bool, device=mask.device)[None]
    valid = in_bounds & mask[:, None, :] & mask[:, :, None] & ~eye  # (S, P_i, P_j)
    cell = (cell_x + cell_y * grid_size).to(torch.int64).clamp(0, g2 - 1)
    # row (s, i, cell) of the flattened grid each pair (s, i, j) adds into
    row = (torch.arange(s * p, device=mask.device).reshape(s, p, 1) * g2 + cell)
    contrib = enc_h[:, None, :, :] * valid[..., None].to(enc_h.dtype)  # (S, P_i, P_j, H)
    grid = enc_h.new_zeros((s * p * g2, h)).index_add(
        0, row.reshape(-1), contrib.reshape(-1, h))
    out = mlp_apply(params["pool"], grid.reshape(s, p, g2 * h), activation="relu")
    return torch.where(mask[..., None], out, torch.zeros_like(out))
