"""Train state and optimizers (counterpart of ``mggan_tpu/training/state.py``).

The optimizer is written out on tensor trees and holds to the JAX
package's ``optax.chain(clip_by_global_norm(c), adamw(lr, b1=beta1,
b2=0.999, eps=1e-8, weight_decay=0.01))`` step for step:

* clipping scales by ``clip / norm`` only when ``norm >= clip`` (as
  ``(g / norm) * clip``), where ``torch.nn.utils.clip_grad_norm_`` would
  always scale by ``clip / (norm + 1e-6)``;
* every leaf moves on every update, a leaf with a zero gradient too (by its
  momentum and the weight decay), where ``torch.optim`` skips a parameter
  whose ``.grad`` is None;
* the bias corrections count the chain's own updates: the G chain advances
  twice per train step, in the G step and in the PM step.

Under generator parallelism the clip's norm adds the decoder slices'
squares over the model group (``parallel/reduce.py::global_norm``), so
every rank clips by the whole tree's norm; Adam itself is elementwise, on
the rank's slice.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.parallel import reduce
from mggan_tpu_torch.utils.pytree import tree_leaves, tree_map


@dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


@dataclass(frozen=True)
class Optimizer:
    """AdamW with decoupled weight decay behind a global-norm clip (no clip
    when ``clip`` is 0); ``lr`` is the default learning rate of ``update``."""

    lr: float
    beta1: float
    clip: float
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01

    def init(self, params) -> AdamState:
        zeros = lambda p: torch.zeros_like(p)
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, lr: float | None = None):
        """One step -> ``(new_params, new_state)``; inputs are not modified."""
        lr = self.lr if lr is None else lr
        if self.clip and self.clip > 0:
            norm = reduce.global_norm(grads)
            keep = norm < self.clip
            grads = tree_map(lambda g: torch.where(keep, g, (g / norm) * self.clip), grads)
        b1, b2 = self.beta1, self.beta2
        count = state.count + 1
        # optax evaluates decay**count in float32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g ** 2) + b2 * v, grads, state.nu)

        def step(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            return p + (-lr) * (u + self.weight_decay * p)

        return tree_map(step, params, mu, nu), AdamState(count, mu, nu)


def make_optimizer(lr: float, beta1: float, clip: float) -> Optimizer:
    """AdamW(lr, (beta1, 0.999), wd=0.01) with a global-norm clip
    (abstract_train.py:45-50; train.py:131-134)."""
    return Optimizer(lr=lr, beta1=beta1, clip=clip)


def optimizers(config: Config):
    return (make_optimizer(config.g_lr, config.beta1, config.clipping_threshold_g),
            make_optimizer(config.d_lr, config.beta1, config.clipping_threshold_d))


def scheduled_lr(base_lr: float, epoch: int, total_epochs: int) -> float:
    """CosineAnnealingLR stepped at each epoch end, eta_min=0
    (abstract_train.py:52-57, 198-200): during the 1-based epoch e the
    scheduler has stepped e-1 times."""
    e = max(epoch - 1, 0)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * e / total_epochs))


@dataclass
class TrainState:
    """Parameters, BN running statistics, the two optimizer states and the
    schedule, as the JAX ``TrainState``. ``generator`` draws the step's
    random numbers when the caller injects none."""

    g_params: dict
    g_state: dict
    d_params: dict
    d_state: dict
    g_opt: AdamState
    d_opt: AdamState
    generator: torch.Generator
    step: int = 0
    epoch: int = 0  # 1-based during training (abstract_train.py:110)
    l2_weight: float = 1.0
    # Best val/ADE so far (+inf before the first validation). Checkpointed,
    # so a resumed run cannot overwrite checkpoint_best with a worse model
    # (the reference re-tracks from scratch, abstract_train.py:106).
    best_val: float = math.inf

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_train_state(config: Config, g_pack, d_pack, seed: int = 0) -> TrainState:
    """The state at step 0 for the ``(params, state, spec)`` packs that
    ``factory.construct_gan`` returns; the draws come from a
    ``torch.Generator`` seeded with ``seed`` on the parameters' device."""
    g_params, g_state, _ = g_pack
    d_params, d_state, _ = d_pack
    tx_g, tx_d = optimizers(config)
    device = tree_leaves(g_params)[0].device
    return TrainState(
        g_params=g_params, g_state=g_state, d_params=d_params, d_state=d_state,
        g_opt=tx_g.init(g_params), d_opt=tx_d.init(d_params),
        generator=torch.Generator(device=device).manual_seed(seed),
        l2_weight=config.l2_loss_weight, best_val=math.inf,
    )
