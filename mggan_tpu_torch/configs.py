"""Named benchmark configurations (counterpart of ``mggan_tpu/configs.py``,
BASELINE.json "configs").

Each entry maps to CLI flags for ``python -m mggan_tpu_torch.cli.train``;
use ``get_benchmark_config(name)`` for a ready Config. Every name trains;
``mggan_dp_eth`` (dp=8, a global batch of 256 scenes, 32 a rank) trains
on 8 ranks: ``python -m torch.distributed.run --nproc_per_node 8 -m
mggan_tpu_torch.cli.train --dp 8 --batch_size 256 ...`` (``parallel/``).
"""

from __future__ import annotations

from mggan_tpu_torch.config import Config

BENCHMARK_CONFIGS = {
    # 1. Single-generator GAN, BIWI eth, no PM-net weighting.
    "single_gen_eth": dict(
        dataset="eth", num_gens=1, gan_type="gan", gan_obj="NS",
        weighting_target="none", inp_format="rel", pool_type="sways",
        batch_size=32, epochs=300,
    ),
    # 2. Multi-generator + PM-Network on BIWI splits.
    "mggan4_hotel": dict(
        dataset="hotel", num_gens=4, gan_type="mgan", weighting_target="ml",
        batch_size=32, epochs=300,
    ),
    "mggan4_univ": dict(
        dataset="univ", num_gens=4, gan_type="mgan", weighting_target="ml",
        batch_size=32, epochs=300,
    ),
    "mggan4_zara1": dict(
        dataset="zara1", num_gens=4, gan_type="mgan", weighting_target="ml",
        batch_size=32, epochs=300,
    ),
    # 3. Scene-attention variant on SDD.
    "mggan_sdd": dict(
        dataset="stanford", num_gens=4, gan_type="mgan",
        weighting_target="ml", batch_size=32, epochs=300,
    ),
    # 4. 8-generator MG-GAN for the full k=1..20 eval incl. GOFP transfer.
    "mggan8_gofp": dict(
        dataset="gofp", num_gens=8, gan_type="mgan", weighting_target="ml",
        batch_size=32, epochs=300,
    ),
    # 5. ICI data-parallel large-batch sweep entry (per-split; dp = shards).
    "mggan_dp_eth": dict(
        dataset="eth", num_gens=4, gan_type="mgan", weighting_target="ml",
        batch_size=256, dp=8, epochs=300,
    ),
}


def get_benchmark_config(name: str, **overrides) -> Config:
    base = dict(BENCHMARK_CONFIGS[name])
    base.update(overrides)
    return Config(name=name, **base)
