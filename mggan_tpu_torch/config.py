"""The subset of ``mggan_tpu.config.Config`` that the ported slices read,
and the command-line surface of ``mggan_tpu.config.get_parser``.

A copy, not an import: the port imports nothing of ``mggan_tpu``. Field
names and defaults match the JAX ``Config`` so ``Config.from_dict`` accepts
the JAX config's ``to_dict()`` output (keys the port does not read are
dropped), and so a ``meta_tags.csv`` that either package's
``ExperimentWriter`` wrote loads here.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

from mggan_tpu_torch.parallel.pod import add_pod_args

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
DATASET_CHOICES = [
    "hotel",
    "eth",
    "zara1",
    "zara2",
    "univ",
    "social_stanford_synthetic",
    "stanford_synthetic",
    "stanford_synthetic_2",
    "stanford_synthetic_4",
    "stanford",
    "gofp",
    # the in-memory synthetic dataset of the tests and benchmarks
    "synthetic_memory",
]


@dataclass
class Config:
    name: str = "test"
    log_dir: str = "./logs/"
    dataset: str = "stanford_synthetic"
    gpus: str = "0"  # kept for CLI parity; the device is the CLI's --device
    workers: int = 0  # kept for CLI parity; the host pipeline is in-process
    # Where dataset files live (the reference hardcodes ./data/datasets/<name>).
    data_root: str = "./data/datasets"
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
    # probgan's SGHMC noise terms (mggan_tpu/config.py:86-89): the noise's
    # std and each loss's weight
    sghmc_alpha: float = 0.01
    g_noise_loss_lambda: float = 3e-2
    d_noise_loss_lambda: float = 3e-2
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
    # Data and generator parallelism (parallel/: slices * dp * gp ranks, the
    # stacked generators split over gp of them), the split step and the
    # profiler capture.
    dp: int = 1
    gp: int = 1
    slices: int = 1
    split_step: int = 0
    profile_dir: str = ""
    # The generator's parameter count, filled by models/factory.py
    # (model_factory.py:14-19); the evaluate CLI's "Generator params".
    num_gen_parameters: int = 0

    def __post_init__(self):
        # meta_tags.csv stores every value as text and reads numbers back as
        # numbers (gpus "0" -> 0): text fields are text again
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.type == "str" and value is not None and not isinstance(value, str):
                setattr(self, f.name, str(value))
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


# Flags of the JAX parser that the port accepts so JAX command lines carry
# over, but does not honour: away from these defaults they raise.
_UNREAD = "the JAX package parses it and reads it nowhere, so it would change nothing"
UNPORTED_FLAGS = {
    "debug": (False, _UNREAD),
    "d_hist_loss_lambda": (1.0, _UNREAD),
    "pallas_decoder": (1, "the port always runs its CUDA decoder kernels; there is no "
                          "scan path to select with --pallas_decoder 0"),
}


def get_parser() -> argparse.ArgumentParser:
    """Every flag of ``mggan_tpu.config.get_parser`` (the reference's
    config.py:4-135 plus the JAX package's extras), with the JAX defaults,
    and ``--device`` (default ``cuda``). ``--compilation_cache_dir`` is a
    JAX cache and is read by nothing here; the flags of ``UNPORTED_FLAGS``
    raise in ``config_from_args`` when set away from their defaults."""
    p = argparse.ArgumentParser()
    d = Config()
    p.add_argument("--name", type=str, default=d.name)
    p.add_argument("--log_dir", type=str, default=d.log_dir)
    p.add_argument("--dataset", type=str, default=d.dataset, choices=DATASET_CHOICES)
    p.add_argument("--gpus", type=str, default=d.gpus)
    p.add_argument("--workers", type=int, default=d.workers)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--beta1", type=float, default=d.beta1)
    p.add_argument("--l2_loss_weight", type=float, default=d.l2_loss_weight)
    p.add_argument("--clf_loss_weight", type=float, default=d.clf_loss_weight)
    p.add_argument("--pi_net_loss_weight", type=float, default=d.pi_net_loss_weight)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--clipping_threshold_d", type=float, default=d.clipping_threshold_d)
    p.add_argument("--clipping_threshold_g", type=float, default=d.clipping_threshold_g)
    p.add_argument("--num_gen_steps", type=int, default=d.num_gen_steps)
    p.add_argument("--inp_format", choices=INP_FORMATS, default=d.inp_format)
    p.add_argument("--keep_gen_steps", type=int, default=d.keep_gen_steps)
    p.add_argument("--top_k_test", type=int, default=d.top_k_test)
    p.add_argument("--val_every", type=int, default=d.val_every)
    p.add_argument("--save_every", type=int, default=d.save_every)
    p.add_argument("--num_unrolling_steps", type=int, default=d.num_unrolling_steps)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--n_social_modules", type=int, default=d.n_social_modules)
    p.add_argument("--g_lr", type=float, default=d.g_lr)
    p.add_argument("--d_lr", type=float, default=d.d_lr)
    p.add_argument("--sigma", type=float, default=d.sigma)
    p.add_argument("--gan_type", type=str, choices=GAN_TYPES, default=d.gan_type)
    p.add_argument("--experiment", type=str, choices=EXPERIMENTS, default=d.experiment)
    p.add_argument("--pool_type", type=str, default=d.pool_type)
    p.add_argument("--global_disc", type=int, default=d.global_disc)
    p.add_argument("--unconditional", action="store_true")
    p.add_argument("--augment", type=int, default=d.augment)
    p.add_argument("--noise_dim", type=int, default=d.noise_dim)
    p.add_argument("--h_dim", type=int, default=d.h_dim)
    p.add_argument("--decoder_h_dim", type=int, default=d.decoder_h_dim)
    p.add_argument("--num_samples", type=int, default=d.num_samples)
    p.add_argument("--num_expectation_samples", type=int,
                   default=d.num_expectation_samples)
    p.add_argument("--weighting_target", type=str, choices=WEIGHTING_TARGETS,
                   default=d.weighting_target)
    p.add_argument("--l2_loss_type", type=str, choices=L2_LOSS_TYPES, default=d.l2_loss_type)
    p.add_argument("--num_gens", type=int, default=d.num_gens)
    p.add_argument("--l2_decay_rate", type=float, default=d.l2_decay_rate)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--sghmc_alpha", type=float, default=d.sghmc_alpha)
    p.add_argument("--g_noise_loss_lambda", type=float, default=d.g_noise_loss_lambda)
    p.add_argument("--d_noise_loss_lambda", type=float, default=d.d_noise_loss_lambda)
    p.add_argument("--d_hist_loss_lambda", type=float, default=1.0)
    p.add_argument("--gan_obj", type=str, choices=GAN_OBJECTIVES, default=d.gan_obj)
    p.add_argument("--max_peds", type=int, default=d.max_peds)
    p.add_argument("--dp", type=int, default=d.dp)
    p.add_argument("--gp", type=int, default=d.gp)
    p.add_argument("--slices", type=int, default=d.slices)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--data_root", type=str, default=d.data_root)
    p.add_argument("--split_step", type=int, default=d.split_step)
    p.add_argument("--profile_dir", type=str, default=d.profile_dir)
    p.add_argument("--patch_bank", type=int, default=d.patch_bank)
    p.add_argument("--pallas_decoder", type=int, default=1)
    p.add_argument("--patch_interp", type=str, choices=PATCH_INTERPS, default=d.patch_interp)
    p.add_argument("--wt_mgan_compat", type=int, default=d.wt_mgan_compat)
    p.add_argument("--compilation_cache_dir", type=str, default="")
    # the launch-time pod flags (cli/train.py joins the pod from them)
    add_pod_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu: where the model runs")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    """The ``Config`` of parsed flags; raises ``NotImplementedError`` for a
    flag of ``UNPORTED_FLAGS`` set away from its default. Flags that are no
    ``Config`` field (``--device``, the pod flags, ...) are dropped."""
    for flag, (default, why) in UNPORTED_FLAGS.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(f"--{flag} {getattr(args, flag)}: {why}")
    return Config.from_dict(vars(args))
