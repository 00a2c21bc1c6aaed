"""The GAN train step: D step(s) + G step + PM step (counterpart of
``mggan_tpu/training/steps.py``; reference abstract_train.py:136-166 and
train.py:23-213, 578-658).

``build_train_step(config, g_spec, d_spec)`` returns ``train_step(state,
batch, draws=None) -> (state, metrics)`` for every family the JAX step
trains: ``gan_type`` gan, mgan, infogan and probgan; the NS, MM, LS and W
objectives (W with the gradient penalty); the PM targets l2, endpoint, ml
and mgan (``wt_mgan_compat`` 1 and 0) or none; every ``l2_loss_type``; the
continuous and the discrete generator, sways or sgan pooling, every
``inp_format`` the models take; D gating and unrolling. Only
``weighting_target="disc_scores"`` raises, as in JAX (train.py:602-603).
``build_split_train_step`` is this step behind JAX's split-step checks.
The updates mirror the JAX step:

* D step: real scores, fakes from the generator with one sample decoded by
  the fused-selection kernel K1 under ``torch.no_grad()``, fake scores;
  mgan adds the generator-id cross entropy, infogan the code regression,
  W the gradient penalty (``_gradient_penalty``: ``torch.autograd.grad``
  with ``create_graph`` through D, which is plain PyTorch, so no double
  backward reaches a kernel), probgan the SGHMC noise loss; the D
  optimizer moves D.
* G step: K samples decoded by all-generator rollout and gather (K2, and
  K3 in the backward); the min-over-samples L2 (unless ``none``), the
  count-reweighted adversarial loss, and per family the classifier loss
  (mgan), the code regression over K (infogan) or the noise loss
  (probgan); the G optimizer moves G.
* PM step (unless ``weighting_target="none"``): the PM-net (or, without
  one, the prior) against its target; l2, endpoint and ml from
  ``num_expectation_samples`` all-generator rollouts (K2 without saving,
  under ``torch.no_grad()``); the G optimizer moves G again.

Control flow, in eager Python where JAX uses ``lax.cond``
(abstract_train.py:136-166):

* D gating: with ``num_gen_steps > 1`` the D step runs when ``step %
  num_gen_steps == 0 or epoch >= keep_gen_steps``; a skipped D step
  reports every D metric as NaN, which the loop's ``nanmean`` skips.
* Unrolling (``num_unrolling_steps = U > 0``, nested inside the gate): D
  runs U + 1 updates, each on its own draws (JAX's ``fold_in(kd, u)``);
  the metrics are the first update's; G and PM see the unrolled D; then
  only ``d_params`` goes back to the first update's. The unrolled D
  optimizer state and BN statistics stay, as in JAX.
* probgan: after the updates, every step with ``step % 10 == 0``,
  ``discriminator.update_hist`` averages the heads into the history.

BN running statistics thread as in JAX: the D step keeps the state of its
real-score pass and the G step that of its generator forward; every other
pass discards its own.

On a data-parallel rank (``parallel/dp.py``) the same step runs on the
rank's scene rows; the counts of the losses, the BatchNorm statistics and
the gradients are summed over the ranks (``parallel/reduce.py``, the
identity on one device), the SGHMC noise losses, which read only the
replicated parameters, count on the first rank alone, and the loss metrics
are each rank's share until ``dp.py`` sums them (``is_replicated_metric``
names the rest).

Under generator parallelism (a model group beside the data group) each
rank holds ``num_gens / gp`` of the stacked decoders and their Adam
moments and decodes with those alone (``models/generator.py``); the PM
step gathers every generator's rollout before its targets
(``decode_all(gather=True)``), and the sums over the parameters (the clip's
and the metrics' global norms, probgan's G noise loss) add the decoder
slices over the model group (``reduce.leaf_sum``). The draws are the
global step's: probgan's decoder normals are drawn for every generator
and each rank keeps its slice (``parallel/dp.py``).
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
from mggan_tpu_torch.parallel import reduce
from mggan_tpu_torch.training.state import TrainState, optimizers, scheduled_lr
from mggan_tpu_torch.utils import trajectory_tools
from mggan_tpu_torch.utils.profiling import span
from mggan_tpu_torch.utils.pytree import tree_items, tree_leaves, tree_map, tree_unflatten


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
    return {f"gradnorm/{prefix}/{name}": reduce.global_norm({name: sub})
            for name, sub in grads.items()}



def check_scope(config: Config):
    """Raise for the settings the JAX step refuses too."""
    if config.weighting_target == "disc_scores":
        raise NotImplementedError(
            "weighting_target='disc_scores' is not implemented (reference "
            "train.py:602-603; the JAX step raises as well)")


# Every step draws these, in this order; the D step's keys carry a leading
# unroll axis of num_unrolling_steps + 1.
DRAW_KEYS = ("d_labels", "d_uniforms", "d_z", "g_labels", "g_uniforms", "g_z", "pm_z")


def needed_draw_keys(config: Config):
    """The draw keys ``config``'s step reads: ``DRAW_KEYS``, then where a
    setting needs them the gradient penalty's interpolation weights
    ``d_alpha`` (W) and the SGHMC normals ``d_noise``, ``g_noise``
    (probgan)."""
    extra = (("d_alpha",) if config.gan_obj == "W" else ()) + (
        ("d_noise", "g_noise") if config.gan_type == "probgan" else ())
    return DRAW_KEYS + extra


def _normals_like(generator, tree, lead=(), num_gens=None):
    """A tree shaped like ``tree`` (with ``lead`` before every leaf's shape)
    of standard normals, drawn leaf by leaf in ``tree_leaves`` order; with
    ``num_gens`` a ``decoders`` leaf has a leading axis of ``num_gens``
    whatever slice of the generators ``tree`` holds."""
    dev = generator.device

    def shape(path, x):
        if num_gens is not None and path[0] == reduce.SHARDED_KEY:
            return (num_gens,) + tuple(x.shape[1:])
        return tuple(x.shape)

    return tree_unflatten(tree, [
        torch.randn(lead + shape(path, x), generator=generator, device=dev)
        for path, x in tree_items(tree)])


def make_draws(generator: torch.Generator, config: Config, s: int, p: int,
               g_params=None, d_params=None):
    """Every random number one train step uses, drawn from ``generator``
    in a fixed order. For each of the ``U + 1`` D updates
    (``U = num_unrolling_steps``): the label pair ``(real, fake)``, Gumbel
    uniforms ``(1,S,P,G)`` and noise ``(1,S,1,z)``, stacked on a leading
    axis of U + 1; then the G step's label pair, uniforms
    ``(num_samples,S,P,G)`` and noise ``(num_samples,S,1,z)``, and the PM
    step's noise ``(num_expectation_samples,S,1,z)``. Then, for W, the
    gradient penalty's uniforms ``d_alpha (U+1,S,P,1,1)``, and for probgan
    standard normals shaped like ``d_params`` (each leaf with the leading
    U + 1 axis) and like ``g_params``, which the noise losses scale by
    ``sghmc_alpha`` (JAX draws them from ``fold_in(key, 1729)`` of each
    update's key); the ``decoders`` normals cover every generator, also
    when ``g_params`` holds a rank's slice of them."""
    dev = generator.device
    g, zd = config.num_gens, config.noise_dim
    units = config.num_unrolling_steps + 1
    uniforms = lambda k: sampling.GUMBEL_U_MIN + torch.rand(
        (k, s, p, g), generator=generator, device=dev) * (1.0 - sampling.GUMBEL_U_MIN)
    noise = lambda k: torch.randn((k, s, 1, zd), generator=generator, device=dev)
    d_units = [(torch.stack(L.gan_labels(generator)), uniforms(1), noise(1))
               for _ in range(units)]
    k = config.num_samples
    draws = {
        "d_labels": torch.stack([u[0] for u in d_units]),
        "d_uniforms": torch.stack([u[1] for u in d_units]),
        "d_z": torch.stack([u[2] for u in d_units]),
        "g_labels": torch.stack(L.gan_labels(generator)), "g_uniforms": uniforms(k),
        "g_z": noise(k), "pm_z": noise(config.num_expectation_samples),
    }
    if config.gan_obj == "W":
        draws["d_alpha"] = torch.rand((units, s, p, 1, 1), generator=generator, device=dev)
    if config.gan_type == "probgan":
        if g_params is None or d_params is None:
            raise ValueError("probgan's draws need the parameter trees' shapes")
        draws["d_noise"] = _normals_like(generator, d_params, (units,))
        draws["g_noise"] = _normals_like(generator, g_params, num_gens=g)
    return draws


def _as_tensor(x, device, dtype=None):
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _grads(loss, tree):
    """d loss / d every leaf of ``tree`` (zeros for a leaf off the graph),
    summed over the data group on a data-parallel rank."""
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return reduce.sum_grads(tree_unflatten(tree, [
        torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads)]))


def _trainable(tree):
    return tree_map(lambda x: x.detach().requires_grad_(), tree)


def _gradient_penalty(d_params, d_state, d_spec, bv: BatchViews, pred, alpha,
                      gp_lambda=10.0):
    """WGAN-GP on interpolated futures (utils.py:42-67; JAX
    ``steps.py::_gradient_penalty``, PARITY.md deviation 11): the gradient
    of the summed real-agent scores w.r.t. the interpolated future, its
    per-agent norm (safe: ``+1e-12`` under the root, as padded agents have
    exactly-zero gradients) and the masked mean of ``(|g| - 1)^2``.
    ``alpha (S,P,1,1)``; ``pred`` is detached, so the penalty reaches the D
    parameters alone, through ``create_graph``."""
    inter_xy = (alpha * bv.gt_xy + (1 - alpha) * pred.abs[0]).requires_grad_()
    inter_dxdy = (alpha * bv.gt_dxdy + (1 - alpha) * pred.rel[0]).requires_grad_()
    scores, _, _ = D_mod.apply(
        d_params, d_state, d_spec, bv.in_xy, bv.in_dxdy, inter_xy[None],
        inter_dxdy[None], bv.ped_mask, bv.loss_mask, bv.patches, train=True)
    score_sum = (scores[0] * bv.loss_mask).sum()
    # the input format reads one of the two or both; the other's gradient is 0
    grads = torch.autograd.grad(score_sum, (inter_xy, inter_dxdy), create_graph=True,
                                allow_unused=True, materialize_grads=True)
    g = torch.cat(grads, dim=-1).reshape(tuple(bv.ped_mask.shape) + (-1,))
    norms = torch.sqrt((g * g).sum(-1) + 1e-12)
    return L.masked_mean((norms - 1.0) ** 2, bv.loss_mask) * gp_lambda


# The metric of each gan_type's D loss term beside the adversarial loss
D_TERM_METRIC = {"mgan": "train/info_mgan_disc_loss", "infogan": "train/disc_info_loss",
                 "probgan": "train/d_noise_loss"}


# Metrics of replicated values (parameters, their summed gradients, the
# learning rate): equal on every data-parallel rank. Every other metric is
# a loss, a rank's share of the global value until summed over the ranks
# (parallel/dp.py).
REPLICATED_METRIC_PREFIXES = ("train/grad_norm_", "gradnorm/", "train/lr_",
                              "train/d_noise_loss", "train/g_noise_loss")


def is_replicated_metric(key: str) -> bool:
    return key.startswith(REPLICATED_METRIC_PREFIXES)


def _d_metric_names(config: Config, d_params):
    """The keys of the D step's metrics (NaN on a gated-out step)."""
    names = ["train/discr_loss", "train/grad_norm_D", "train/lr_D"]
    names += [f"gradnorm/D/{k}" for k in d_params]
    if config.gan_type in D_TERM_METRIC:
        names.append(D_TERM_METRIC[config.gan_type])
    return names


def build_train_step(config: Config, g_spec, d_spec):
    """The train step for ``config`` (see the module note)."""
    check_scope(config)
    phi_1, phi_2, phi_3 = L.phi_losses(config.gan_obj)
    tx_g, tx_d = optimizers(config)
    num_gens, num_samples = config.num_gens, config.num_samples
    gan_type, units = config.gan_type, config.num_unrolling_steps + 1
    keys = needed_draw_keys(config)

    def d_step(state: TrainState, bv: BatchViews, du):
        lr_, lf_ = du["labels"]
        valid = bv.loss_mask
        d_params = _trainable(state.d_params)
        real_scores, _, d_state1 = D_mod.apply(
            d_params, state.d_state, d_spec, bv.in_xy, bv.in_dxdy,
            bv.gt_xy[None], bv.gt_dxdy[None], bv.ped_mask, valid, bv.patches,
            train=True,
        )
        real_loss = L.masked_mean(phi_1(real_scores, lr_, lf_), valid[None])
        with torch.no_grad():
            pred, _, gen_idxs, noise, _ = _g_forward_sampled(
                state.g_params, state.g_state, g_spec, config, bv, 1, True,
                du["uniforms"], du["z"])
        fake_scores, branch, _ = D_mod.apply(
            d_params, d_state1, d_spec, bv.in_xy, bv.in_dxdy, pred.abs,
            pred.rel, bv.ped_mask, valid, bv.patches, train=True,
        )
        fake_loss = L.masked_mean(phi_2(fake_scores, lr_, lf_), valid[None])
        total = real_loss + fake_loss
        metrics = {"train/discr_loss": total.detach()}
        if gan_type == "mgan":
            # CE of the generator-id branch vs the sampled generator (train.py:181-186)
            ce = L.softmax_cross_entropy(branch, gen_idxs.movedim(-1, 0))
            ce_loss = L.masked_mean(ce, valid[None])
            metrics[D_TERM_METRIC[gan_type]] = ce_loss.detach()
            total = total + ce_loss
        elif gan_type == "infogan":
            # regress the code: the noise's first 3 dimensions
            info = 0.5 * L.masked_mean((branch - noise[..., :3]) ** 2,
                                       valid[None, :, :, None])
            metrics[D_TERM_METRIC[gan_type]] = info.detach()
            total = total + info
        if config.gan_obj == "W":
            total = total + _gradient_penalty(d_params, state.d_state, d_spec, bv, pred,
                                              du["alpha"])
        if gan_type == "probgan":
            # SGHMC: lambda * <theta, n> adds lambda * n to every D gradient
            nl = trajectory_tools.noise_loss(d_params, du["noise"], config.sghmc_alpha)
            metrics[D_TERM_METRIC[gan_type]] = nl.detach()
            total = total + reduce.on_first_rank(config.d_noise_loss_lambda * nl)
        grads = _grads(total, d_params)
        lr_d = scheduled_lr(config.d_lr, state.epoch, config.epochs)
        metrics.update({
            "train/grad_norm_D": reduce.global_norm(grads),
            **per_module_grad_norms(grads, "D"),
            "train/lr_D": torch.tensor(lr_d, dtype=torch.float32),
        })
        d_new, d_opt = tx_d.update(grads, state.d_opt, state.d_params, lr_d)
        return state.replace(d_params=d_new, d_opt=d_opt, d_state=d_state1), metrics

    def skipped_d_metrics(state: TrainState, dev):
        """A gated-out D step's metrics: NaN, on the devices the D step's are."""
        return {k: torch.tensor(float("nan"), device="cpu" if k == "train/lr_D" else dev)
                for k in _d_metric_names(config, state.d_params)}

    def g_step(state: TrainState, bv: BatchViews, dr):
        lr_, lf_ = dr["g_labels"]
        valid = bv.loss_mask
        g_params = _trainable(state.g_params)
        pred, _, gen_idxs, noise, g_state1 = _g_forward_sampled(
            g_params, state.g_state, g_spec, config, bv, num_samples,
            True, dr["g_uniforms"], dr["g_z"], needs_decoder_grad=True)
        total, metrics = 0.0, {}
        if config.l2_loss_type != "none":
            min_l2 = L.min_scene_l2(pred.abs, bv.gt_xy, valid, bv.ped_mask,
                                    config.l2_loss_type)
            metrics["train/L2_loss"] = min_l2.detach()
            total = total + state.l2_weight * min_l2
        scores, branch, _ = D_mod.apply(
            state.d_params, state.d_state, d_spec, bv.in_xy, bv.in_dxdy,
            pred.abs, pred.rel, bv.ped_mask, valid, bv.patches, train=True,
        )
        idx_kf = gen_idxs.movedim(-1, 0)  # (K,S,P), as scores
        adv = L.count_reweighted_mean(phi_3(scores, lr_, lf_), idx_kf, num_gens,
                                      valid[None])
        metrics["train/gen_loss"] = adv.detach()
        total = total + adv
        if gan_type == "mgan":
            clf = L.count_reweighted_mean(L.softmax_cross_entropy(branch, idx_kf),
                                          idx_kf, num_gens, valid[None])
            metrics["train/info_mgan_loss"] = clf.detach()
            total = total + config.clf_loss_weight * clf
        elif gan_type == "infogan":
            info = 0.5 * L.masked_mean((branch - noise[..., :3]) ** 2,
                                       valid[None, :, :, None])
            info = info / num_samples  # train.py:123
            metrics["train/info_loss"] = info.detach()
            total = total + info
        if gan_type == "probgan":
            nl = trajectory_tools.noise_loss(g_params, dr["g_noise"], config.sghmc_alpha)
            metrics["train/g_noise_loss"] = nl.detach()
            total = total + reduce.on_first_rank(config.g_noise_loss_lambda * nl)
        grads = _grads(total, g_params)
        lr_g = scheduled_lr(config.g_lr, state.epoch, config.epochs)
        metrics.update({
            "train/grad_norm_G": reduce.global_norm(grads),
            **per_module_grad_norms(grads, "G"),
            "train/lr_G": torch.tensor(lr_g, dtype=torch.float32),
        })
        g_new, g_opt = tx_g.update(grads, state.g_opt, state.g_params, lr_g)
        return state.replace(g_params=g_new, g_opt=g_opt, g_state=g_state1), metrics

    def pm_target_loss(state: TrainState, bv: BatchViews, dr, g_params, enc_h,
                       social_feats, logits, out_probs):
        """The PM loss for ``weighting_target`` (train.py:585-639)."""
        valid, wt = bv.loss_mask, config.weighting_target
        log_probs = torch.log(out_probs)
        if wt == "mgan":
            ent = -(out_probs * log_probs).sum(-1)
            decay = float(np.float32(0.9) ** np.float32(state.epoch))
            reg = decay * L.masked_mean(ent, valid)
            if config.wt_mgan_compat:
                # the reference's literal computation (train.py:604-613;
                # PARITY.md deviation 7): all-ones targets, a loss scaled by
                # the valid count; the D branch cancels, so no D call
                n_valid = reduce.count(valid.sum().to(out_probs.dtype))
                return n_valid * L.masked_mean(-log_probs.mean(-1), valid) - reg
            _, branch, _ = D_mod.apply(
                state.d_params, state.d_state, d_spec, bv.in_xy, bv.in_dxdy,
                bv.gt_xy[None], bv.gt_dxdy[None], bv.ped_mask, valid, bv.patches,
                train=True)
            target = torch.softmax(branch[0], dim=-1).detach()
            return L.masked_mean(-(target * log_probs).sum(-1), valid) - reg
        s, p = bv.ped_mask.shape
        noise = sampling.global_noise(config.num_expectation_samples, s, p,
                                      config.noise_dim, z=dr["pm_z"])
        with torch.no_grad():  # the rollouts are targets only (steps.py:355)
            gen_abs = G_mod.decode_all(
                g_params, g_spec, bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1],
                enc_h, social_feats, noise, gather=True,
            ).abs  # (Ke,G,S,P,T,2), every generator
        if wt in ("l2", "endpoint"):
            if wt == "l2":  # mean over T (train.py:617)
                d = torch.linalg.vector_norm(gen_abs - bv.gt_xy[None, None], dim=-1).mean(-1)
            else:
                d = torch.linalg.vector_norm(
                    gen_abs[..., -1, :] - bv.gt_xy[None, None, :, :, -1, :], dim=-1)
            min_idx = torch.argmin(d.min(0).values, dim=0)  # (S,P): the closest generator
            return L.masked_mean(L.softmax_cross_entropy(logits, min_idx), valid)
        if wt == "ml":
            # Bayes posterior from the Normal log-likelihood (train.py:626-639)
            lp = L.normal_log_prob(gen_abs - bv.gt_xy[None, None], config.sigma).sum((-1, -2))
            gen_prob = torch.softmax(lp.mean(0), dim=0).movedim(0, -1)  # (S,P,G)
            return L.masked_mean(-(gen_prob * log_probs).sum(-1), valid)
        raise ValueError(f"Weighting target does not exist: {wt!r}")

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
        loss = pm_target_loss(state, bv, dr, g_params, enc_h, social_feats, logits,
                              out_probs)
        metrics["train/net_chooser_loss"] = loss.detach()
        grads = _grads(loss * config.pi_net_loss_weight, g_params)
        lr_g = scheduled_lr(config.g_lr, state.epoch, config.epochs)
        g_new, g_opt = tx_g.update(grads, state.g_opt, state.g_params, lr_g)
        return state.replace(g_params=g_new, g_opt=g_opt), metrics

    def prepare_draws(draws, dev):
        """The injected draws as tensors on ``dev``: the G and PM keys as
        given, the D step's split into one dict per update."""
        missing = [k for k in keys if k not in draws]
        if missing:
            raise KeyError(f"draws lack {missing}")
        t = lambda x: _as_tensor(x, dev, torch.float32)
        dr = {k: t(draws[k]) for k in ("g_uniforms", "g_z", "pm_z")}
        dr["g_labels"] = L.gan_labels(values=t(draws["g_labels"]), device=dev)
        if "g_noise" in keys:
            dr["g_noise"] = tree_map(t, draws["g_noise"])
        d_labels = t(draws["d_labels"]).reshape(units, 2)
        d_per = {k: t(draws[k]) for k in ("d_uniforms", "d_z", "d_alpha") if k in keys}
        d_noise = tree_map(t, draws["d_noise"]) if "d_noise" in keys else None
        units_dr = []
        for u in range(units):
            du = {"labels": L.gan_labels(values=d_labels[u], device=dev),
                  "uniforms": d_per["d_uniforms"][u], "z": d_per["d_z"][u]}
            if "d_alpha" in d_per:
                du["alpha"] = d_per["d_alpha"][u]
            if d_noise is not None:
                du["noise"] = tree_map(lambda x: x[u], d_noise)
            units_dr.append(du)
        return dr, units_dr

    def train_step(state: TrainState, batch, draws=None):
        """One train step on ``batch`` (``xy (S,P,20,2)``, ``ped_mask
        (S,P)``, ``patches (S,P,33,33,4)``, tensors or numpy arrays).
        ``draws`` injects every random number (``needed_draw_keys``, shapes
        as ``make_draws`` gives them); without it they come from
        ``state.generator``. Returns ``(new_state, metrics)``, the metrics
        as 0-d tensors under the JAX step's keys."""
        dev = state.generator.device
        batch = {k: _as_tensor(v, dev) for k, v in batch.items()}
        bv = batch_views(batch)
        s, p = bv.ped_mask.shape
        if draws is None:
            draws = make_draws(state.generator, config, s, p, state.g_params,
                               state.d_params)
        dr, d_units = prepare_draws(draws, dev)
        metrics = {}
        # D gating (abstract_train.py:136-138)
        do_d = config.num_gen_steps <= 1 or (
            state.step % config.num_gen_steps == 0 or state.epoch >= config.keep_gen_steps)
        d_backup = state.d_params
        if do_d:
            for u, du in enumerate(d_units):
                with span("mggan.train.d_step"):
                    state, m = d_step(state, bv, du)
                if u == 0:  # the unrolled D's rollback point and metrics
                    metrics.update(m)
                    d_backup = state.d_params
        else:
            metrics.update(skipped_d_metrics(state, dev))
        with span("mggan.train.g_step"):
            state, m = g_step(state, bv, dr)
        metrics.update(m)
        if config.weighting_target != "none":
            with span("mggan.train.pm_step"):
                state, m = pm_step(state, bv, dr)
            metrics.update(m)
        if units > 1:  # unrolled GAN: D back to its first update (abstract_train.py:151-162)
            state = state.replace(d_params=d_backup)
        if gan_type == "probgan" and state.step % 10 == 0:
            # the history's Polyak average every 10 steps (abstract_train.py:164-166)
            state = state.replace(d_state=D_mod.update_hist(state.d_params, state.d_state))
        return state.replace(step=state.step + 1), metrics

    return train_step


def build_split_train_step(config: Config, g_spec, d_spec):
    """The split train step (``mggan_tpu/training/steps.py::
    build_split_train_step``): ``build_train_step``'s step, after JAX's
    refusals of unrolling and ``num_gen_steps > 1``.

    JAX splits its step into D, G and PM programs only to compile the three
    in parallel; the port compiles no programs, so there is nothing to
    split, and the fused step runs the same updates in the same order. One
    difference stays: JAX's split step without a PM phase
    (``weighting_target="none"``) skips probgan's history average, which
    both fused steps run.
    """
    if config.num_unrolling_steps > 0 or config.num_gen_steps > 1:
        raise ValueError("split step supports the common ungated configuration; use the "
                         "fused build_train_step otherwise (num_unrolling_steps="
                         f"{config.num_unrolling_steps}, num_gen_steps={config.num_gen_steps})")
    return build_train_step(config, g_spec, d_spec)
