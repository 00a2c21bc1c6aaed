"""The subset of ``mggan_tpu.config.Config`` that the ported slices read.

A copy, not an import: the port imports nothing of ``mggan_tpu``. Field
names and defaults match the JAX ``Config`` so ``Config.from_dict`` accepts
the JAX config's ``to_dict()`` output (keys the port does not read are
dropped), and so a ``meta_tags.csv`` that either package's
``ExperimentWriter`` wrote loads here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# Architecture constants fixed by the reference factory (model_factory.py:18-19).
PRED_LEN = 12
OBS_LEN = 8
SEQ_LEN = OBS_LEN + PRED_LEN
SCENE_DIM = 8 * 8
PATCH_HW = 33
PATCH_C = 4

EXPERIMENTS = ["multi_generator", "discrete"]
INP_FORMATS = ["rel", "abs", "abs_rel"]
POOL_TYPES = ["sways", "sgan"]
WEIGHTING_TARGETS = ["l2", "disc_scores", "endpoint", "mgan", "ml", "none"]
GAN_TYPES = ["probgan", "mgan", "infogan", "gan"]
GAN_OBJECTIVES = ["NS", "MM", "LS", "W"]
L2_LOSS_TYPES = ["none", "min_z", "min_g_z", "min_g_min_z", "mse"]
PATCH_INTERPS = ["nearest", "bilinear"]


@dataclass
class Config:
    name: str = "test"
    log_dir: str = "./logs/"
    dataset: str = "stanford_synthetic"
    experiment: str = "multi_generator"
    inp_format: str = "rel"
    pool_type: str = "sways"
    weighting_target: str = "ml"
    unconditional: bool = False
    n_social_modules: int = 1
    noise_dim: int = 8
    h_dim: int = 32
    decoder_h_dim: int = 32
    num_gens: int = 1
    seed: int = 145325
    # training (mggan_tpu/config.py:41-91)
    gan_type: str = "mgan"
    gan_obj: str = "NS"
    num_samples: int = 20
    num_expectation_samples: int = 1
    l2_loss_type: str = "min_g_z"
    l2_loss_weight: float = 1.0
    clf_loss_weight: float = 1.0
    pi_net_loss_weight: float = 1.0
    sigma: float = 1.0
    g_lr: float = 1e-3
    d_lr: float = 1e-3
    beta1: float = 0.5
    clipping_threshold_g: float = 500
    clipping_threshold_d: float = 100
    epochs: int = 500
    num_gen_steps: int = 1
    keep_gen_steps: int = 0
    num_unrolling_steps: int = 0
    global_disc: int = 1
    wt_mgan_compat: int = 1
    batch_size: int = 2
    # the train loop (mggan_tpu/config.py:41-135)
    augment: int = 1
    top_k_test: int = 20
    val_every: int = 1
    save_every: int = 5
    l2_decay_rate: float = 1.0
    checkpoint: Optional[str] = None
    # Pad width of the ped axis; 0 = derive from the dataset's widest scene.
    max_peds: int = 0
    # Keep the split's uint8 patches on the device and gather them per batch
    # there (data/patch_bank.py); 0 = host-side batch assembly.
    patch_bank: int = 1
    # Augmented-patch resampling: "nearest" (the reference's PIL resample
    # mode) or "bilinear".
    patch_interp: str = "nearest"
    # Multi-device and profiling settings: the loop raises for any but these
    # defaults (ROADMAP.md queue 1 items 13 and 15).
    dp: int = 1
    gp: int = 1
    slices: int = 1
    split_step: int = 0
    profile_dir: str = ""

    def __post_init__(self):
        for name, allowed in (
            ("experiment", EXPERIMENTS), ("inp_format", INP_FORMATS),
            ("pool_type", POOL_TYPES), ("weighting_target", WEIGHTING_TARGETS),
            ("gan_type", GAN_TYPES), ("gan_obj", GAN_OBJECTIVES),
            ("l2_loss_type", L2_LOSS_TYPES),
            ("patch_interp", PATCH_INTERPS),
        ):
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} not in {allowed}"
                )

    @property
    def use_pinet(self) -> bool:
        # model_factory.py:16
        return self.weighting_target != "none" and not self.unconditional

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def flagship_config(**kw) -> Config:
    """The flagship (``bench.py::_flagship_config``): mgan, 4 generators,
    ml PM target, h=32, NS objective."""
    return Config(num_gens=4, gan_type="mgan", weighting_target="ml",
                  h_dim=32, decoder_h_dim=32, **kw)
