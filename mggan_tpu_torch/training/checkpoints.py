"""Checkpoints of the whole ``TrainState`` (counterpart of
``mggan_tpu/training/checkpoints.py``; reference: torch .pth save/load,
abstract_train.py:235-296).

A checkpoint is one ``torch.save`` file, ``<ckpt_dir>/<name>``, holding a
plain dict that ``torch.load(weights_only=True)`` reads: the parameter and
BatchNorm-state trees, both Adam states (count, mu, nu), step, epoch, the
decayed l2 weight, ``best_val`` and the state of the step's random
generator. So resuming is exact (the reference restarts the epoch at 0).
Tensors are saved where they live and restore onto the ``TrainState``
given as the model, so a checkpoint saved on the card restores onto the
card and one saved on the CPU onto the CPU. Reference-format ``.pth``
checkpoints go in and out through ``cli/convert.py``.

The JAX package's orbax checkpoints come in through
``train_state_from_jax``, which builds a ``TrainState`` from the numpy
trees of a JAX ``TrainState``; ``scripts/convert_orbax_checkpoint.py``
restores the orbax store with the JAX package, where JAX runs, and writes
the result with ``save_checkpoint``. The JAX PRNG key cannot carry over
(JAX's threefry and torch's generators are different streams): the port's
generator is seeded with ``jax_key_seed(key)``, the key's two uint32 words
as one 64-bit integer, so a converted run draws other random numbers than
the JAX run would have. Such a checkpoint stores that seed in place of a
generator state, so it resumes on the card and on the CPU alike.
"""

from __future__ import annotations

from pathlib import Path

import torch

import numpy as np

from mggan_tpu_torch.config import Config
from mggan_tpu_torch.device import resolve_device
from mggan_tpu_torch.models.factory import build_d_spec, build_specs
from mggan_tpu_torch.models.weights import discriminator_from_jax, generator_from_jax
from mggan_tpu_torch.training.state import AdamState, TrainState
from mggan_tpu_torch.utils.logging import checkpoint_epochs
from mggan_tpu_torch.utils.pytree import tree_items, tree_map

FORMAT = "mggan_tpu_torch.TrainState/1"
TREES = ("g_params", "g_state", "d_params", "d_state")


def _opt_dict(opt: AdamState) -> dict:
    return {"count": opt.count, "mu": opt.mu, "nu": opt.nu}


def save_checkpoint(ckpt_dir, state: TrainState, name: str, generator_seed=None):
    """Write ``state`` to ``<ckpt_dir>/<name>`` (replacing the file).
    ``generator_seed``: ``state.generator`` is fresh from
    ``manual_seed(generator_seed)`` (a converted JAX state); the file keeps
    the seed in place of the generator's state, and a restore seeds a
    generator on its own device."""
    path = Path(ckpt_dir) / name
    blob = {
        "format": FORMAT,
        **{k: getattr(state, k) for k in TREES},
        "g_opt": _opt_dict(state.g_opt),
        "d_opt": _opt_dict(state.d_opt),
        "step": int(state.step),
        "epoch": int(state.epoch),
        "l2_weight": float(state.l2_weight),
        "best_val": float(state.best_val),
        "generator_device": str(state.generator.device),
        "generator": state.generator.get_state(),
    }
    if generator_seed is not None:
        blob.update(generator_device=None, generator=None, generator_seed=int(generator_seed))
    tmp = path.with_name(path.name + ".tmp")
    torch.save(blob, tmp)
    tmp.replace(path)


def _like(saved, like, what):
    """``saved`` moved onto the devices and dtypes of the same-shaped tree
    ``like``; raises ``KeyError`` if the two trees differ in their paths."""
    got = [p for p, _ in tree_items(saved)]
    want = [p for p, _ in tree_items(like)]
    if got != want:
        raise KeyError(f"checkpoint {what} has paths {sorted(set(got) ^ set(want))[:4]} "
                       "that the model does not share")
    return tree_map(lambda s, l: s.to(device=l.device, dtype=l.dtype), saved, like)


def restore_checkpoint(ckpt_dir, like_state: TrainState, name: str) -> TrainState:
    """The ``TrainState`` saved as ``<ckpt_dir>/<name>``, on the devices of
    ``like_state`` (whose trees must have the same paths). The generator's
    state only restores onto a generator of the device type it was saved
    from (a CPU and a CUDA generator hold different states): restored on
    the other type, the state's ``generator`` is None, so the state
    evaluates but does not resume training (``Trainer.train_epoch``
    raises)."""
    blob = torch.load(Path(ckpt_dir) / name, map_location="cpu", weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{Path(ckpt_dir) / name} is not a {FORMAT} checkpoint")
    gen_dev = like_state.generator.device
    generator = None
    if blob.get("generator_seed") is not None:
        generator = torch.Generator(device=gen_dev).manual_seed(blob["generator_seed"])
    elif torch.device(blob["generator_device"]).type == gen_dev.type:
        generator = torch.Generator(device=gen_dev)
        generator.set_state(blob["generator"])
    opt = lambda k, like: AdamState(blob[k]["count"], _like(blob[k]["mu"], like.mu, k),
                                    _like(blob[k]["nu"], like.nu, k))
    return TrainState(
        **{k: _like(blob[k], getattr(like_state, k), k) for k in TREES},
        g_opt=opt("g_opt", like_state.g_opt), d_opt=opt("d_opt", like_state.d_opt),
        generator=generator, step=blob["step"], epoch=blob["epoch"],
        l2_weight=blob["l2_weight"], best_val=blob["best_val"],
    )


def resolve_checkpoint_name(ckpt_dir, checkpoint="best") -> str:
    """``"best"`` | ``"latest"`` | an epoch -> the file name
    (abstract_train.py:250-263): ``best`` falls back to ``latest`` when no
    best checkpoint was written."""
    ckpt_dir = Path(ckpt_dir)
    if checkpoint == "best":
        if (ckpt_dir / "checkpoint_best").exists():
            return "checkpoint_best"
        checkpoint = "latest"
    if checkpoint == "latest":
        epochs = checkpoint_epochs(ckpt_dir)
        if not epochs:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        return f"checkpoint_{max(epochs)}"
    return f"checkpoint_{int(checkpoint)}"


def jax_key_seed(key) -> int:
    """The port generator's seed for a JAX PRNG key (``uint32[2]``): its two
    words as one 64-bit integer, ``(key[0] << 32) | key[1]``."""
    words = np.asarray(key, dtype=np.uint32).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a JAX PRNG key has two uint32 words, got shape {words.shape}")
    return (int(words[0]) << 32) | int(words[1])


def train_state_from_jax(arrays, config: Config, g_spec, d_spec, device="cuda") -> TrainState:
    """A port ``TrainState`` from the numpy trees of a JAX ``TrainState``.

    ``arrays`` holds ``g_params``, ``g_state``, ``d_params`` and ``d_state``
    (nested dicts of numpy arrays, the JAX layout, which the port keeps);
    ``g_opt`` and ``d_opt`` as ``{"count", "mu", "nu"}``, the
    ``scale_by_adam`` state inside optax's clip + AdamW chain (the
    ``mu``/``nu`` trees shaped like the parameters); ``step``, ``epoch``,
    ``l2_weight``, ``best_val`` and the PRNG key ``rng``, which seeds the
    port's generator by ``jax_key_seed``. ``config`` is the JAX run's
    (``Config.from_dict`` of its ``to_dict()``); the specs must be those
    ``models/factory.py`` builds from it.
    """
    if g_spec != build_specs(config) or d_spec != build_d_spec(config):
        raise ValueError("g_spec / d_spec were not built from config")
    dev = resolve_device(device)
    g_params, g_state = generator_from_jax(arrays["g_params"], arrays["g_state"], g_spec, dev)
    d_params, d_state = discriminator_from_jax(arrays["d_params"], arrays["d_state"], d_spec,
                                               dev)

    def opt(key, params):
        o = arrays[key]
        like = lambda tree, what: _like(tree_map(lambda x: torch.as_tensor(
            np.ascontiguousarray(x, dtype=np.float32)), tree), params, f"{key}.{what}")
        return AdamState(int(o["count"]), like(o["mu"], "mu"), like(o["nu"], "nu"))

    return TrainState(
        g_params=g_params, g_state=g_state, d_params=d_params, d_state=d_state,
        g_opt=opt("g_opt", g_params), d_opt=opt("d_opt", d_params),
        generator=torch.Generator(device=dev).manual_seed(jax_key_seed(arrays["rng"])),
        step=int(arrays["step"]), epoch=int(arrays["epoch"]),
        l2_weight=float(np.float32(arrays["l2_weight"])),
        best_val=float(np.float32(arrays["best_val"])),
    )
