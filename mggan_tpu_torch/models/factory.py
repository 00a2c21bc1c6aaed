"""Model factory (counterpart of ``mggan_tpu/models/factory.py``).

Generator only: the discriminator belongs to the training slice.
"""

from __future__ import annotations

import torch

from mggan_tpu_torch.config import PRED_LEN, SCENE_DIM, Config
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.models import generator


def build_specs(config: Config) -> generator.GeneratorSpec:
    if config.experiment == "discrete":
        raise NotImplementedError("the discrete-latent generator is not ported yet")
    return generator.GeneratorSpec(
        z_size=config.noise_dim,
        encoder_h_dim=config.h_dim,
        decoder_h_dim=config.decoder_h_dim,
        social_feat_size=config.h_dim if config.n_social_modules > 0 else 0,
        num_gens=config.num_gens,
        pred_len=PRED_LEN,
        # multi_generator uses decoder_h_dim // 2 (model_factory.py:28)
        embedding_dim=int(config.decoder_h_dim // 2),
        inp_format=config.inp_format,
        pool_type=config.pool_type,
        scene_dim=SCENE_DIM,
        use_pinet=config.use_pinet,
    )


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def construct_model(config: Config, seed: int | None = None, device="cuda"):
    """Build ``(g_params, g_state, g_spec)`` with random weights.

    The weights are drawn on the CPU from ``torch.Generator`` seeded with
    ``seed`` (``config.seed`` when None), then moved to ``device``, so one
    seed gives the same model on every device.
    """
    dev = resolve_device(device)
    spec = build_specs(config)
    gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
    params, state = generator.init(spec, gen)
    return tree_to(params, dev), tree_to(state, dev), spec
