"""Inference front-end (counterpart of ``mggan_tpu/eval/predict.py``).

Ported so far: the ``sampling`` strategy, PM-categorical sampling with the
fused-selection decode. The other six strategies come in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.models import generator as G_mod
from mggan_tpu_torch.models.factory import tree_to
from mggan_tpu_torch.ops import sampling
from mggan_tpu_torch.training.steps import batch_views

STRATEGIES = (
    "uniform_expected",
    "sampling",
    "expected",
    "rejection",
    "smart_expected",
    "smart_sampling",
    "uniform_sampling",
)
PORTED_STRATEGIES = ("sampling",)


def _as_tensor(x, device):
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


class Predictor:
    """Inference over a generator's ``(params, state)`` on one device."""

    def __init__(self, config: Config, g_spec, g_params, g_state, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.g_spec = g_spec
        self.g_params = tree_to(g_params, self.device)
        self.g_state = tree_to(g_state, self.device)

    def new_generator(self, seed: int) -> torch.Generator:
        """A generator on this predictor's device seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    @torch.inference_mode()
    def predict(self, batch, generator: torch.Generator | None = None, num=20,
                draws=None):
        """PM-net categorical sampling (train.py:259-289).

        ``batch``: dict with ``xy (S,P,20,2)``, ``ped_mask (S,P)`` and
        optional ``patches (S,P,33,33,4)``, as tensors or numpy arrays.
        Random numbers come from ``generator`` or, when ``draws`` is given,
        from ``draws["uniforms"] (num,S,P,G)`` (Gumbel uniforms) and
        ``draws["z"] (num,S,1,noise_dim)`` (per-scene noise).

        Returns ``(pred_abs, pred_rel, probs, gen_idxs)``: ``(num,S,P,12,2)``
        twice, ``(S,P,G)`` and int32 ``(S,P,num)``.
        """
        if generator is None and draws is None:
            raise ValueError("predict needs a torch.Generator or injected draws")
        draws = {} if draws is None else {k: _as_tensor(v, self.device)
                                          for k, v in draws.items()}
        batch = {k: _as_tensor(v, self.device) for k, v in batch.items()}
        spec = self.g_spec
        bv = batch_views(batch)
        enc_h, social_feats, _ = G_mod.encode(
            self.g_params, self.g_state, spec, bv.in_xy, bv.in_dxdy,
            bv.ped_mask, bv.patches,
        )
        logits = G_mod.pm_logits(self.g_params, spec, enc_h)
        gen_idxs = sampling.categorical(logits, num, generator=generator,
                                        uniforms=draws.get("uniforms"))
        s, p = bv.ped_mask.shape
        noise = sampling.global_noise(num, s, p, self.config.noise_dim,
                                      generator=generator, z=draws.get("z"))
        out = G_mod.decode_select(
            self.g_params, spec, bv.in_xy[:, :, -1], bv.in_dxdy[:, :, -1],
            enc_h, social_feats, noise, gen_idxs,
        )
        return out.abs, out.rel, torch.softmax(logits, -1), gen_idxs

    def get_predict_func(self, strategy: str):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy not in PORTED_STRATEGIES:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet (have {PORTED_STRATEGIES})"
            )
        return self.predict
