"""The subset of ``mggan_tpu.config.Config`` that the ported slice reads.

A copy, not an import: the port imports nothing of ``mggan_tpu``. Field
names and defaults match the JAX ``Config`` so ``Config.from_dict`` accepts
the JAX config's ``to_dict()`` output (keys the port does not read are
dropped).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

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


@dataclass
class Config:
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

    def __post_init__(self):
        for name, allowed in (
            ("experiment", EXPERIMENTS), ("inp_format", INP_FORMATS),
            ("pool_type", POOL_TYPES), ("weighting_target", WEIGHTING_TARGETS),
        ):
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"{name}={getattr(self, name)!r} not in {allowed}"
                )

    @property
    def use_pinet(self) -> bool:
        # model_factory.py:16
        return self.weighting_target != "none" and not self.unconditional

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def flagship_config(**kw) -> Config:
    """The serving flagship (``bench.py::_flagship_config``): 4 generators,
    ml PM target, h=32. Its ``gan_type`` (mgan) shapes only the
    discriminator, which this slice does not build."""
    return Config(num_gens=4, weighting_target="ml", h_dim=32,
                  decoder_h_dim=32, **kw)
