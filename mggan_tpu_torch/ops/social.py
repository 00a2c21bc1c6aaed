"""Masked social modules over padded scene tensors: sways attention and
SGAN pooling.

Counterpart of ``mggan_tpu/ops/social.py`` (``social_features``,
``attention_pool``, ``social_attention_apply``, ``pool_hidden_net_apply``;
``social_pooling_apply`` belongs to the legacy Social-GAN of ROADMAP.md
queue 1 item 15). Scenes are rows of a dense
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
