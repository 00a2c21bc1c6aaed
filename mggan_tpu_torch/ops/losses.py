"""GAN / L2 / PM losses over masked padded batches.

Counterpart of ``mggan_tpu/ops/losses.py``: every mean over "the batch" is
a masked mean over the valid agents of the padded ``(S, P)`` layout. Each
count over the batch goes through ``parallel/reduce.py::count``, so on a
data-parallel rank a loss is its share of the global loss (its numerator
over the global count); on one device that is the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mggan_tpu_torch.parallel import reduce

EPS_D = 1e-7  # discriminator output squash (discriminators.py:110,204)


def bce(pred, label):
    """Elementwise binary cross entropy on probabilities (torch BCELoss)."""
    return -(label * torch.log(pred) + (1.0 - label) * torch.log(1.0 - pred))


def gan_labels(generator=None, values=None, smoothness=0.1, device=None):
    """Smoothed scalar labels (utils.py:18-25): real ~ U(1-s, 1), fake ~ U(0, s).

    ``values`` injects ``(real, fake)``; otherwise both are drawn from
    ``generator``. Returns two 0-d float32 tensors.
    """
    if values is None:
        u = torch.rand(2, generator=generator, device=generator.device)
        values = (1.0 - smoothness + smoothness * u[0], smoothness * u[1])
    return tuple(torch.as_tensor(v, dtype=torch.float32, device=device)
                 for v in values)


def phi_losses(gan_obj: str):
    """The ``(phi_1, phi_2, phi_3)`` objective triple (abstract_train.py:61-85):
    D loss on real, D loss on fake, G adversarial loss, each mapping
    ``(scores, label_real, label_fake)`` to an elementwise loss. NS and MM
    take probabilities, LS and W the unbounded scores of ``unbound_output``."""
    if gan_obj == "NS":
        return (
            lambda d, lr, lf: bce(d, lr),
            lambda d, lr, lf: bce(d, lf),
            lambda d, lr, lf: bce(d, lr),
        )
    if gan_obj == "MM":
        return (
            lambda d, lr, lf: bce(d, lr),
            lambda d, lr, lf: bce(d, lf),
            lambda d, lr, lf: -bce(d, lf),
        )
    if gan_obj == "LS":
        return (
            lambda d, lr, lf: (d - lr) ** 2,
            lambda d, lr, lf: (d - lf) ** 2,
            lambda d, lr, lf: (d - lr) ** 2,
        )
    if gan_obj == "W":
        return (
            lambda d, lr, lf: -d,
            lambda d, lr, lf: d,
            lambda d, lr, lf: -d,
        )
    raise ValueError(f"Objective not supported: {gan_obj}")


def masked_mean(x, mask):
    """Mean of x over elements where mask is True (mask broadcastable to x)."""
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return (x * m).sum() / torch.clamp(reduce.count(m.sum()), min=1.0)


def min_scene_l2(pred_abs, gt_xy, loss_mask, ped_mask, loss_type: str):
    """Joint minimum-over-samples scene L2 loss (train.py:57-75).

    pred_abs ``(K, S, P, T, 2)``; gt_xy ``(S, P, T, 2)``; the summed scene
    minima are divided by the number of real agents (``ped_mask``), as the
    reference divides by its batch size. ``mse`` squares the distances.
    """
    d = torch.linalg.vector_norm(pred_abs - gt_xy[None], dim=-1)  # (K,S,P,T)
    if loss_type == "mse":
        d = d ** 2
    per_agent = d.sum(-1) * loss_mask[None]
    min_per_scene = per_agent.sum(-1).min(0).values  # (S,)
    b = torch.clamp(reduce.count(ped_mask.sum().to(pred_abs.dtype)), min=1.0)
    return min_per_scene.sum() / b


def count_reweighted_mean(loss, gen_idxs, num_gens, valid):
    """Each element divided by its generator's global sample count, then a
    masked mean (train.py:92-99). ``gen_idxs`` has ``loss``'s shape; invalid
    elements count neither in the counts nor in the mean."""
    v = torch.broadcast_to(valid, gen_idxs.shape).to(loss.dtype)
    onehot = F.one_hot(gen_idxs.long(), num_gens).to(loss.dtype) * v[..., None]
    counts = reduce.count(onehot.reshape(-1, num_gens).sum(0))
    w = 1.0 / torch.clamp(counts, min=1.0)
    elem_w = w[gen_idxs.long()] * v
    return (loss * elem_w).sum() / torch.clamp(reduce.count(v.sum()), min=1.0)


def softmax_cross_entropy(logits, labels_int):
    """CE matching ``F.cross_entropy(reduction='none')`` over the last axis."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels_int.long()[..., None])[..., 0]


def normal_log_prob(x, sigma):
    """log N(x; 0, sigma) elementwise (train.py:626-635)."""
    return -0.5 * (x / sigma) ** 2 - math.log(sigma) - 0.5 * math.log(2.0 * math.pi)
