#!/usr/bin/env python
"""Convert the JAX package's orbax checkpoints into the PyTorch port's.

    python scripts/convert_orbax_checkpoint.py --version_dir <jax version dir> \
        --out_dir <dir>

Runs where JAX and orbax run (it imports ``mggan_tpu``), never on a machine
with the port alone. For every ``checkpoints/checkpoint_*`` store of the JAX
version dir it restores the ``TrainState`` with
``mggan_tpu.training.checkpoints.restore_checkpoint`` (so a checkpoint
saved before ``best_val`` existed restores with ``best_val = inf``), turns
its numpy trees into a port ``TrainState`` with
``mggan_tpu_torch.training.checkpoints.train_state_from_jax`` on the CPU
and writes it with the port's ``save_checkpoint``. The output is a port
version dir, ``<out_dir>/<experiment>/<name>/version_<V>/`` with the JAX
run's experiment, name and version, its ``meta_tags.csv`` and the
converted checkpoints under their JAX names, which
``mggan_tpu_torch.training.loop.Trainer.load_from_path`` resumes on the card
or the CPU. The JAX PRNG key does not carry over: the port's generator is
seeded from it (``jax_key_seed``), so the resumed run draws other random
numbers than the JAX run would.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import numpy as np
import optax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mggan_tpu.config import Config as JaxConfig  # noqa: E402
from mggan_tpu.models import factory as jax_factory  # noqa: E402
from mggan_tpu.training import checkpoints as jax_ckpt  # noqa: E402
from mggan_tpu.training.state import init_train_state as jax_init_train_state  # noqa: E402
from mggan_tpu.utils.logging import load_meta_tags  # noqa: E402

from mggan_tpu_torch.config import Config  # noqa: E402
from mggan_tpu_torch.models.factory import build_d_spec, build_specs  # noqa: E402
from mggan_tpu_torch.training import checkpoints as ckpt  # noqa: E402
from mggan_tpu_torch.utils.logging import ExperimentWriter  # noqa: E402


def adam_state(opt_state) -> dict:
    """``{"count", "mu", "nu"}`` of the one ``ScaleByAdamState`` inside an
    optax state (the clip + AdamW chain of ``mggan_tpu/training/state.py``)."""
    found = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    if len(found) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optimizer state, found "
                         f"{len(found)}")
    (adam,) = found
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return {"count": int(adam.count), "mu": to_np(adam.mu), "nu": to_np(adam.nu)}


def jax_arrays(state) -> dict:
    """The numpy trees of a JAX ``TrainState`` that ``train_state_from_jax``
    reads."""
    out = {k: jax.tree.map(np.asarray, getattr(state, k))
           for k in ("g_params", "g_state", "d_params", "d_state")}
    out.update(g_opt=adam_state(state.g_opt), d_opt=adam_state(state.d_opt),
               **{k: np.asarray(getattr(state, k))
                  for k in ("step", "epoch", "l2_weight", "best_val", "rng")})
    return out


def convert(version_dir, out_dir) -> Path:
    """Convert every checkpoint of the JAX ``version_dir``; returns the
    port version dir written under ``out_dir``."""
    version_dir = Path(version_dir)
    tags = load_meta_tags(version_dir / "meta_tags.csv")
    jcfg = JaxConfig.from_dict(tags)
    # the structure to restore into, shapes only (no weights are computed)
    abstract = jax.eval_shape(
        lambda key: jax_init_train_state(jcfg, *jax_factory.construct_model(jcfg, key), key),
        jax.random.PRNGKey(0))
    cfg = Config.from_dict(jcfg.to_dict())
    g_spec, d_spec = build_specs(cfg), build_d_spec(cfg)
    writer = ExperimentWriter(out_dir, version_dir.parent.parent.name, version_dir.parent.name,
                              version=int(version_dir.name.split("_")[1]), config=cfg,
                              tensorboard=False)
    names = sorted(p.name for p in (version_dir / "checkpoints").iterdir()
                   if p.name.startswith("checkpoint_"))
    if not names:
        raise FileNotFoundError(f"no checkpoints in {version_dir / 'checkpoints'}")
    for name in names:
        state = jax_ckpt.restore_checkpoint(version_dir / "checkpoints", abstract, name)
        arrays = jax_arrays(state)
        port_state = ckpt.train_state_from_jax(arrays, cfg, g_spec, d_spec, device="cpu")
        ckpt.save_checkpoint(writer.checkpoint_dir, port_state, name,
                             generator_seed=ckpt.jax_key_seed(arrays["rng"]))
        print(f"{version_dir / 'checkpoints' / name} -> {writer.checkpoint_dir / name} "
              f"(step {port_state.step}, epoch {port_state.epoch}, best_val "
              f"{port_state.best_val})")
    return writer.dir


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--version_dir", required=True,
                        help="a JAX version dir (meta_tags.csv, checkpoints/)")
    parser.add_argument("--out_dir", required=True,
                        help="root of the port version dir to write")
    args = parser.parse_args(argv)
    return convert(args.version_dir, args.out_dir)


if __name__ == "__main__":
    main()
