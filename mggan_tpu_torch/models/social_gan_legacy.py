"""The legacy Social-GAN generator and discriminator (counterpart of
``mggan_tpu/models/social_gan_legacy.py``; reference social_gan.py:361-757).

The reference vendors the original Social-GAN ``TrajectoryGenerator`` and
``TrajectoryDiscriminator``. The MG-GAN entry points do not use them; they
are part of the component surface. Functional, over the padded ``(S, P)``
layout, on the port's ``ops/{linear,lstm,social}.py``:

* the encoder LSTM runs over the observed offsets;
* optional pooling of the final hidden states: ``pool_net``
  (``pool_hidden_net_apply``) or ``spool`` (the grid's
  ``social_pooling_apply``);
* an MLP maps ``[enc_h, pool]`` to ``decoder_h_dim - noise_dim``, then
  per-scene (``global``) or per-ped (``ped``) noise is appended
  (social_gan.py:476-520);
* the decoder LSTM rolls out ``pred_len`` steps, optionally pooling again
  after every step (``pool_every_timestep``);
* the discriminator encodes the whole 20-step trajectory and scores it,
  per ped (``local``) or after pooling (``global``).

Two behaviours are the JAX model's, kept so the two agree:

* the generator draws standard normal noise whatever ``noise_type`` says
  (``ops/sampling.py::global_noise`` has the uniform draw; this model does
  not call it);
* ``pool_every_timestep`` re-projects ``[h, pool]`` through the context
  MLP, whose output is ``decoder_h_dim - noise_dim`` wide and feeds
  ``hidden2pos`` (``decoder_h_dim`` inputs), so it runs only with
  ``noise_dim=0``; the JAX model fails there with a shape error, and
  ``generator_apply`` refuses the pair up front.

The pooling and the LSTMs are plain PyTorch ops, as they were plain XLA in
JAX (``lstm_scan``, an einsum); no kernel of the repo runs here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.ops import social as social_ops
from mggan_tpu_torch.ops.linear import linear_apply, linear_init, mlp_apply, mlp_init
from mggan_tpu_torch.ops.lstm import lstm_cell, lstm_init, lstm_scan
from mggan_tpu_torch.utils.pytree import tree_map


@dataclass(frozen=True)
class SGANSpec:
    obs_len: int = 8
    pred_len: int = 12
    embedding_dim: int = 16
    encoder_h_dim: int = 32
    decoder_h_dim: int = 32
    mlp_dim: int = 64
    noise_dim: int = 8
    noise_type: str = "gaussian"
    noise_mix_type: str = "global"  # "global" | "ped"
    pooling_type: str = "pool_net"  # "pool_net" | "spool" | "none"
    pool_every_timestep: bool = False
    bottleneck_dim: int = 8
    d_type: str = "local"  # "local" | "global"


def generator_init(gen: torch.Generator, spec: SGANSpec):
    """Random generator parameters from ``gen`` (PyTorch's default
    initialisation), with the JAX model's keys and shapes."""
    params = {
        "enc_embed": linear_init(gen, 2, spec.embedding_dim),
        "encoder": lstm_init(gen, spec.embedding_dim, spec.encoder_h_dim),
        "dec_embed": linear_init(gen, 2, spec.embedding_dim),
        "decoder": lstm_init(gen, spec.embedding_dim, spec.decoder_h_dim),
        "hidden2pos": linear_init(gen, spec.decoder_h_dim, 2),
    }
    pool_out = 0
    if spec.pooling_type == "pool_net":
        params["pool"] = {
            "spatial": linear_init(gen, 2, spec.embedding_dim),
            "pre_pool": mlp_init(gen, [spec.embedding_dim + spec.encoder_h_dim,
                                       spec.mlp_dim, spec.bottleneck_dim]),
        }
        pool_out = spec.bottleneck_dim
    elif spec.pooling_type == "spool":
        params["pool"] = {"pool": mlp_init(gen, [64 * spec.encoder_h_dim,
                                                 spec.bottleneck_dim])}
        pool_out = spec.bottleneck_dim
    ctx_in = spec.encoder_h_dim + pool_out
    ctx_out = spec.decoder_h_dim - spec.noise_dim
    if ctx_in != ctx_out or pool_out or spec.noise_dim:
        params["ctx"] = mlp_init(gen, [ctx_in, spec.mlp_dim, ctx_out])
    return params


def discriminator_init(gen: torch.Generator, spec: SGANSpec):
    """Random discriminator parameters from ``gen``, with the JAX model's
    keys and shapes."""
    params = {
        "embed": linear_init(gen, 2, spec.embedding_dim),
        "encoder": lstm_init(gen, spec.embedding_dim, spec.encoder_h_dim),
        "classifier": mlp_init(gen, [spec.encoder_h_dim, spec.mlp_dim, 1]),
    }
    if spec.d_type == "global":
        params["pool"] = {
            "spatial": linear_init(gen, 2, spec.embedding_dim),
            "pre_pool": mlp_init(gen, [spec.embedding_dim + spec.encoder_h_dim,
                                       spec.mlp_dim, spec.encoder_h_dim]),
        }
    return params


def params_from_jax(np_params, device="cuda"):
    """A JAX parameter tree of this model (nested dicts of numpy arrays;
    the port keeps the layout) as contiguous float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.ascontiguousarray(x, dtype=np.float32),
                                           device=dev), np_params)


def _pool(params, spec: SGANSpec, last_xy, h, mask):
    if spec.pooling_type == "pool_net":
        return social_ops.pool_hidden_net_apply(params["pool"], last_xy, h, mask)
    if spec.pooling_type == "spool":
        return social_ops.social_pooling_apply(params["pool"], last_xy, h, mask)
    return None


def _encode(params, spec: SGANSpec, embed, dxdy, s, p):
    """Final hidden state ``(S, P, H)`` of the encoder LSTM over ``dxdy``."""
    emb = linear_apply(params[embed], dxdy)
    xs = emb.reshape(s * p, -1, spec.embedding_dim).transpose(0, 1)
    _, (h_t, _) = lstm_scan(params["encoder"], xs)
    return h_t.reshape(s, p, -1)


def generator_apply(params, spec: SGANSpec, in_xy, in_dxdy, ped_mask, *, z=None,
                    generator=None, user_noise=None):
    """``in_xy (S,P,8,2)``, ``in_dxdy (S,P,7,2)`` -> ``(abs, rel)``, each
    ``(S, P, pred_len, 2)``.

    The noise is ``user_noise (S,P,noise_dim)`` when given, else ``z``
    (``(S,1,noise_dim)`` for ``global`` mixing, ``(S,P,noise_dim)`` for
    ``ped``), else standard normals of that shape from ``generator``.
    """
    if spec.pool_every_timestep and spec.pooling_type != "none" and spec.noise_dim:
        raise ValueError(
            "pool_every_timestep needs noise_dim=0: the context MLP's output "
            f"({spec.decoder_h_dim - spec.noise_dim} wide) feeds hidden2pos "
            f"({spec.decoder_h_dim} inputs); the JAX model fails there with a shape error")
    s, p = ped_mask.shape
    enc_h = _encode(params, spec, "enc_embed", in_dxdy, s, p)
    last_xy = in_xy[:, :, -1]
    feats = enc_h
    pooled = _pool(params, spec, last_xy, enc_h, ped_mask)
    if pooled is not None:
        feats = torch.cat([enc_h, pooled], -1)
    if "ctx" in params:
        feats = mlp_apply(params["ctx"], feats, activation="relu")

    if spec.noise_dim:
        if user_noise is not None:
            noise = user_noise
        else:
            shape = (s, 1 if spec.noise_mix_type == "global" else p, spec.noise_dim)
            if z is None:
                z = torch.randn(shape, generator=generator, device=generator.device)
            elif tuple(z.shape) != shape:
                raise ValueError(f"z has shape {tuple(z.shape)}, expected {shape}")
            noise = z.expand(s, p, spec.noise_dim)
        feats = torch.cat([feats, noise.to(feats.dtype)], -1)

    h = feats.reshape(s * p, spec.decoder_h_dim)
    c = torch.zeros_like(h)
    xy = last_xy.reshape(s * p, 2)
    dxdy = in_dxdy[:, :, -1].reshape(s * p, 2)
    outs = []
    for _ in range(spec.pred_len):
        h, c = lstm_cell(params["decoder"], linear_apply(params["dec_embed"], dxdy), h, c)
        hh = h
        if spec.pool_every_timestep and spec.pooling_type != "none" and "ctx" in params:
            pooled = _pool(params, spec, xy.reshape(s, p, 2), h.reshape(s, p, -1), ped_mask)
            hp = torch.cat([h.reshape(s, p, -1), pooled], -1)
            hh = mlp_apply(params["ctx"], hp, activation="relu").reshape(s * p, -1)
        dxdy = linear_apply(params["hidden2pos"], hh[..., :spec.decoder_h_dim])
        xy = xy + dxdy
        outs.append(torch.cat([xy, dxdy], -1))
    seq = torch.stack(outs, 1).reshape(s, p, spec.pred_len, 4)
    return seq[..., :2], seq[..., 2:]


def discriminator_apply(params, spec: SGANSpec, traj_xy, traj_dxdy, ped_mask):
    """The whole trajectory (``traj_xy (S,P,T,2)``, ``traj_dxdy
    (S,P,T-1,2)``) -> real/fake scores ``(S, P)``."""
    s, p = ped_mask.shape
    h = _encode(params, spec, "embed", traj_dxdy, s, p)
    if spec.d_type == "global":
        h = social_ops.pool_hidden_net_apply(params["pool"], traj_xy[:, :, 0], h, ped_mask)
    return mlp_apply(params["classifier"], h, activation="relu")[..., 0]
