"""The GAN train step: D step + G step + PM step (counterpart of
``mggan_tpu/training/steps.py``).

``build_train_step(config, g_spec, d_spec)`` returns ``train_step(state,
batch, draws=None) -> (state, metrics)`` for the flagship family: gan_type
mgan with the NS objective, the ml PM target, the min_g_z L2 loss, no D
gating (``num_gen_steps <= 1``) and no unrolling; every other setting
raises ``NotImplementedError``. The three updates mirror the JAX step
(reference train.py:23-213 and 578-658):

* D step: real scores, fakes from the generator with one sample decoded by
  the fused-selection kernel K1 under ``torch.no_grad()``, fake scores,
  the mgan generator-id cross entropy; the D optimizer moves D.
* G step: K samples decoded by all-generator rollout and gather (K2, and
  K3 in the backward); min-over-samples L2, the count-reweighted
  adversarial and classifier losses; the G optimizer moves G.
* PM step: the PM-net against the Bayes posterior of each generator from
  ``num_expectation_samples`` all-generator rollouts (K2 without saving,
  under ``torch.no_grad()``); the G optimizer moves G again.

BN running statistics thread as in JAX: the D step keeps the state of its
real-score pass and the G step that of its generator forward; every other
pass discards its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mggan_tpu_torch.config import OBS_LEN, Config
from mggan_tpu_torch.models import discriminator as D_mod
from mggan_tpu_torch.models import generator as G_mod
from mggan_tpu_torch.ops import losses as L
from mggan_tpu_torch.ops import sampling
from mggan_tpu_torch.training.state import TrainState, optimizers, scheduled_lr
from mggan_tpu_torch.utils.pytree import (
    tree_global_norm, tree_leaves, tree_map, tree_unflatten,
)


class BatchViews(NamedTuple):
    in_xy: torch.Tensor  # (S,P,8,2)
    in_dxdy: torch.Tensor  # (S,P,7,2)
    gt_xy: torch.Tensor  # (S,P,12,2) NaNs zeroed
    gt_dxdy: torch.Tensor  # (S,P,12,2) NaNs zeroed
    ped_mask: torch.Tensor  # (S,P) real agents
    loss_mask: torch.Tensor  # (S,P) real agents with finite futures
    patches: torch.Tensor | None  # (S,P,33,33,4) or None


def batch_views(batch) -> BatchViews:
    """Model inputs and masks from a padded batch dict; ``in_dxdy`` is the
    difference of consecutive observed positions."""
    xy = batch["xy"]
    ped_mask = batch["ped_mask"]
    in_xy = xy[:, :, :OBS_LEN]
    in_dxdy = in_xy[:, :, 1:] - in_xy[:, :, :-1]
    gt_raw = xy[:, :, OBS_LEN:]
    finite = ~torch.isnan(gt_raw).any(dim=-1).any(dim=-1)
    loss_mask = ped_mask & finite
    keep = loss_mask[..., None, None]
    zero = torch.zeros((), dtype=xy.dtype, device=xy.device)
    gt_xy = torch.where(keep, torch.nan_to_num(gt_raw), zero)
    prev = torch.cat([in_xy[:, :, -1:], gt_raw[:, :, :-1]], dim=2)
    gt_dxdy = torch.where(keep, torch.nan_to_num(gt_raw - prev), zero)
    return BatchViews(in_xy, in_dxdy, gt_xy, gt_dxdy, ped_mask, loss_mask,
                      batch.get("patches"))


def _g_forward_sampled(g_params, g_state, g_spec, config: Config, bv: BatchViews,
                       num_samples: int, train: bool, uniforms, z,
                       needs_decoder_grad: bool = False):
    """Encode + PM-sample + decode the sampled generator (standard.py:186-214).

    ``uniforms (K,S,P,G)`` are the Gumbel uniforms of the categorical draw
    and ``z (K,S,1,noise_dim)`` the per-scene noise. ``needs_decoder_grad``
    picks the decode: a gradient path decodes all generators and gathers
    (K2/K3), a path without one uses the fused-selection kernel K1.

    Returns ``(pred (K,S,P,T,2) pair, logits (S,P,G), gen_idxs (S,P,K),
    noise (K,S,P,z), new_g_state)``.
    """
    s, p = bv.ped_mask.shape
    enc_h, social_feats, new_g_state = G_mod.encode(
        g_params, g_state, g_spec, bv.in_xy, bv.in_dxdy, bv.ped_mask,
        bv.patches, train=train,
    )
    logits = G_mod.pm_logits(g_params, g_spec, enc_h)
    gen_idxs = sampling.categorical(logits, num_samples, uniforms=uniforms)
    noise = sampling.global_noise(num_samples, s, p, config.noise_dim, z=z)
    pred = G_mod.decode_select(
        g_params, g_spec, bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1], enc_h,
        social_feats, noise, gen_idxs, fuse_select=not needs_decoder_grad,
    )
    return pred, logits, gen_idxs, noise, new_g_state


def per_module_grad_norms(grads, prefix: str):
    """Per-module gradient norms (reference GradNormLogger, utils.py:168-199):
    the top-level keys of the param tree play the modules' part."""
    return {f"gradnorm/{prefix}/{name}": tree_global_norm(sub)
            for name, sub in grads.items()}


def check_scope(config: Config):
    """Raise for the settings the port's train step does not cover yet."""
    unported = [
        f"{name}={getattr(config, name)!r}"
        for name, ok in (
            ("gan_type", config.gan_type == "mgan"),
            ("gan_obj", config.gan_obj == "NS"),
            ("weighting_target", config.weighting_target == "ml"),
            ("l2_loss_type", config.l2_loss_type == "min_g_z"),
            ("num_gen_steps", config.num_gen_steps <= 1),
            ("num_unrolling_steps", config.num_unrolling_steps == 0),
        ) if not ok
    ]
    if unported:
        raise NotImplementedError(
            f"train step for {', '.join(unported)} is not ported yet "
            "(ROADMAP.md queue 1 item 10)")


DRAW_KEYS = ("d_labels", "d_uniforms", "d_z", "g_labels", "g_uniforms", "g_z", "pm_z")


def make_draws(generator: torch.Generator, config: Config, s: int, p: int):
    """Every random number one train step uses, drawn from ``generator``:
    the D and G steps' label pairs ``(real, fake)``, Gumbel uniforms
    ``(K,S,P,G)`` and noise ``(K,S,1,z)`` (K = 1 for D, ``num_samples``
    for G), and the PM step's noise ``(num_expectation_samples,S,1,z)``."""
    dev = generator.device
    g, zd = config.num_gens, config.noise_dim
    uniforms = lambda k: sampling.GUMBEL_U_MIN + torch.rand(
        (k, s, p, g), generator=generator, device=dev) * (1.0 - sampling.GUMBEL_U_MIN)
    noise = lambda k: torch.randn((k, s, 1, zd), generator=generator, device=dev)
    k = config.num_samples
    return {
        "d_labels": L.gan_labels(generator), "d_uniforms": uniforms(1), "d_z": noise(1),
        "g_labels": L.gan_labels(generator), "g_uniforms": uniforms(k), "g_z": noise(k),
        "pm_z": noise(config.num_expectation_samples),
    }


def _as_tensor(x, device, dtype=None):
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _grads(loss, tree):
    """d loss / d every leaf of ``tree`` (zeros for a leaf off the graph)."""
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(tree, [torch.zeros_like(x) if gr is None else gr
                                 for x, gr in zip(leaves, grads)])


def _trainable(tree):
    return tree_map(lambda x: x.detach().requires_grad_(), tree)


def build_train_step(config: Config, g_spec, d_spec):
    """The train step for ``config``'s scope (see the module note)."""
    check_scope(config)
    phi_1, phi_2, phi_3 = L.phi_losses(config.gan_obj)
    tx_g, tx_d = optimizers(config)
    num_gens = config.num_gens

    def d_step(state: TrainState, bv: BatchViews, dr):
        lr_, lf_ = dr["d_labels"]
        valid = bv.loss_mask
        d_params = _trainable(state.d_params)
        real_scores, _, d_state1 = D_mod.apply(
            d_params, state.d_state, d_spec, bv.in_xy, bv.in_dxdy,
            bv.gt_xy[None], bv.gt_dxdy[None], bv.ped_mask, valid, bv.patches,
            train=True,
        )
        real_loss = L.masked_mean(phi_1(real_scores, lr_, lf_), valid[None])
        with torch.no_grad():
            pred, _, gen_idxs, _, _ = _g_forward_sampled(
                state.g_params, state.g_state, g_spec, config, bv, 1, True,
                dr["d_uniforms"], dr["d_z"])
        fake_scores, branch, _ = D_mod.apply(
            d_params, d_state1, d_spec, bv.in_xy, bv.in_dxdy, pred.abs,
            pred.rel, bv.ped_mask, valid, bv.patches, train=True,
        )
        fake_loss = L.masked_mean(phi_2(fake_scores, lr_, lf_), valid[None])
        # CE of the generator-id branch vs the sampled generator (train.py:181-186)
        ce = L.softmax_cross_entropy(branch, gen_idxs.movedim(-1, 0))
        ce_loss = L.masked_mean(ce, valid[None])
        grads = _grads(real_loss + fake_loss + ce_loss, d_params)
        lr_d = scheduled_lr(config.d_lr, state.epoch, config.epochs)
        metrics = {
            "train/discr_loss": (real_loss + fake_loss).detach(),
            "train/info_mgan_disc_loss": ce_loss.detach(),
            "train/grad_norm_D": tree_global_norm(grads),
            **per_module_grad_norms(grads, "D"),
            "train/lr_D": torch.tensor(lr_d, dtype=torch.float32),
        }
        d_new, d_opt = tx_d.update(grads, state.d_opt, state.d_params, lr_d)
        return state.replace(d_params=d_new, d_opt=d_opt, d_state=d_state1), metrics

    def g_step(state: TrainState, bv: BatchViews, dr):
        lr_, lf_ = dr["g_labels"]
        valid = bv.loss_mask
        g_params = _trainable(state.g_params)
        pred, _, gen_idxs, _, g_state1 = _g_forward_sampled(
            g_params, state.g_state, g_spec, config, bv, config.num_samples,
            True, dr["g_uniforms"], dr["g_z"], needs_decoder_grad=True)
        min_l2 = L.min_scene_l2(pred.abs, bv.gt_xy, valid, bv.ped_mask,
                                config.l2_loss_type)
        scores, branch, _ = D_mod.apply(
            state.d_params, state.d_state, d_spec, bv.in_xy, bv.in_dxdy,
            pred.abs, pred.rel, bv.ped_mask, valid, bv.patches, train=True,
        )
        idx_kf = gen_idxs.movedim(-1, 0)  # (K,S,P), as scores
        adv = L.count_reweighted_mean(phi_3(scores, lr_, lf_), idx_kf, num_gens,
                                      valid[None])
        clf = L.count_reweighted_mean(L.softmax_cross_entropy(branch, idx_kf),
                                      idx_kf, num_gens, valid[None])
        total = state.l2_weight * min_l2 + adv + config.clf_loss_weight * clf
        grads = _grads(total, g_params)
        lr_g = scheduled_lr(config.g_lr, state.epoch, config.epochs)
        metrics = {
            "train/L2_loss": min_l2.detach(),
            "train/gen_loss": adv.detach(),
            "train/info_mgan_loss": clf.detach(),
            "train/grad_norm_G": tree_global_norm(grads),
            **per_module_grad_norms(grads, "G"),
            "train/lr_G": torch.tensor(lr_g, dtype=torch.float32),
        }
        g_new, g_opt = tx_g.update(grads, state.g_opt, state.g_params, lr_g)
        return state.replace(g_params=g_new, g_opt=g_opt, g_state=g_state1), metrics

    def pm_step(state: TrainState, bv: BatchViews, dr):
        valid = bv.loss_mask
        g_params = _trainable(state.g_params)
        enc_h, social_feats, _ = G_mod.encode(
            g_params, state.g_state, g_spec, bv.in_xy, bv.in_dxdy, bv.ped_mask,
            bv.patches, train=True,
        )
        logits = G_mod.pm_logits(g_params, g_spec, enc_h)
        out_probs = torch.softmax(logits, dim=-1)
        metrics = {
            f"probs/Gen {i} probability": L.masked_mean(out_probs[..., i], valid).detach()
            for i in range(num_gens)
        }
        s, p = bv.ped_mask.shape
        noise = sampling.global_noise(config.num_expectation_samples, s, p,
                                      config.noise_dim, z=dr["pm_z"])
        with torch.no_grad():  # the rollouts are targets only (steps.py:355)
            gen_abs = G_mod.decode_all(
                g_params, g_spec, bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1],
                enc_h, social_feats, noise,
            ).abs  # (Ke,G,S,P,T,2)
        # Bayes posterior from the Normal log-likelihood (train.py:626-639)
        lp = L.normal_log_prob(gen_abs - bv.gt_xy[None, None], config.sigma).sum((-1, -2))
        gen_prob = torch.softmax(lp.mean(0), dim=0).movedim(0, -1)  # (S,P,G)
        loss = L.masked_mean(-(gen_prob * torch.log(out_probs)).sum(-1), valid)
        metrics["train/net_chooser_loss"] = loss.detach()
        grads = _grads(loss * config.pi_net_loss_weight, g_params)
        lr_g = scheduled_lr(config.g_lr, state.epoch, config.epochs)
        g_new, g_opt = tx_g.update(grads, state.g_opt, state.g_params, lr_g)
        return state.replace(g_params=g_new, g_opt=g_opt), metrics

    def train_step(state: TrainState, batch, draws=None):
        """One D, G and PM update on ``batch`` (``xy (S,P,20,2)``, ``ped_mask
        (S,P)``, ``patches (S,P,33,33,4)``, tensors or numpy arrays).
        ``draws`` injects every random number (keys ``DRAW_KEYS``, shapes
        as ``make_draws`` gives them); without it they come from
        ``state.generator``. Returns ``(new_state, metrics)``, the metrics
        as 0-d tensors under the JAX step's keys."""
        dev = state.generator.device
        batch = {k: _as_tensor(v, dev) for k, v in batch.items()}
        bv = batch_views(batch)
        s, p = bv.ped_mask.shape
        if draws is None:
            draws = make_draws(state.generator, config, s, p)
        dr = {k: (L.gan_labels(values=draws[k], device=dev) if k.endswith("labels")
                  else _as_tensor(draws[k], dev, torch.float32)) for k in DRAW_KEYS}
        metrics = {}
        for sub in (d_step, g_step, pm_step):
            state, m = sub(state, bv, dr)
            metrics.update(m)
        return state.replace(step=state.step + 1), metrics

    return train_step
