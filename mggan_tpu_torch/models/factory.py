"""Model factory (counterpart of ``mggan_tpu/models/factory.py``).

``build_specs``/``construct_model`` build the generator, which serving
needs alone; ``build_d_spec``/``construct_gan`` add the discriminator that
training needs.
"""

from __future__ import annotations

import torch

from mggan_tpu_torch.config import PRED_LEN, SCENE_DIM, Config
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.models import discriminator, generator
from mggan_tpu_torch.utils.pytree import tree_leaves


def build_specs(config: Config) -> generator.GeneratorSpec:
    """The generator's spec (factory.py:12-40): the PM-net unless
    ``weighting_target`` is none or the model is ``unconditional``, and for
    ``experiment="discrete"`` the one-decoder discrete-latent generator."""
    discrete = config.experiment == "discrete"
    return generator.GeneratorSpec(
        z_size=config.noise_dim,
        encoder_h_dim=config.h_dim,
        decoder_h_dim=config.decoder_h_dim,
        social_feat_size=config.h_dim if config.n_social_modules > 0 else 0,
        num_gens=config.num_gens,
        pred_len=PRED_LEN,
        # multi_generator uses decoder_h_dim // 2, discrete 16
        # (model_factory.py:28,57)
        embedding_dim=16 if discrete else int(config.decoder_h_dim // 2),
        inp_format=config.inp_format,
        pool_type=config.pool_type,
        scene_dim=SCENE_DIM,
        use_pinet=config.use_pinet,
        discrete=discrete,
    )


def build_d_spec(config: Config) -> discriminator.DiscriminatorSpec:
    """The discriminator's spec (factory.py:42-53): ``h_dim`` doubled, one
    head (five for probgan), unbounded scores for the W and LS objectives."""
    return discriminator.DiscriminatorSpec(
        h_dim=config.h_dim * 2,
        inp_format=config.inp_format,
        pred_len=PRED_LEN,
        num_discs=5 if config.gan_type == "probgan" else 1,
        num_gens=config.num_gens,
        gan_type=config.gan_type,
        global_disc=bool(config.global_disc),
        scene_dim=SCENE_DIM,
        pool_type=config.pool_type,
        unbound_output=config.gan_obj in ("W", "LS"),
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


def count_parameters(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def construct_gan(config: Config, seed: int | None = None, device="cuda"):
    """Build ``((g_params, g_state, g_spec), (d_params, d_state, d_spec))``
    with random weights, as the JAX ``construct_model`` does, and fill
    ``config.num_gen_parameters``. One CPU ``torch.Generator`` seeded with
    ``seed`` (``config.seed`` when None) draws the generator's weights, then
    the discriminator's."""
    dev = resolve_device(device)
    g_spec, d_spec = build_specs(config), build_d_spec(config)
    gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
    g_params, g_state = generator.init(g_spec, gen)
    d_params, d_state = discriminator.init(d_spec, gen)
    config.num_gen_parameters = count_parameters(g_params)
    print("G #parameters: ", config.num_gen_parameters)
    print("D #parameters: ", count_parameters(d_params))
    on = lambda t: tree_to(t, dev)
    return ((on(g_params), on(g_state), g_spec),
            (on(d_params), on(d_state), d_spec))
