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
card and one saved on the CPU onto the CPU. The JAX package's orbax format
waits for ROADMAP.md queue 1 item 12 (b); reference-format ``.pth``
checkpoints go in and out through ``cli/convert.py``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from mggan_tpu_torch.training.state import AdamState, TrainState
from mggan_tpu_torch.utils.logging import checkpoint_epochs
from mggan_tpu_torch.utils.pytree import tree_items, tree_map

FORMAT = "mggan_tpu_torch.TrainState/1"
TREES = ("g_params", "g_state", "d_params", "d_state")


def _opt_dict(opt: AdamState) -> dict:
    return {"count": opt.count, "mu": opt.mu, "nu": opt.nu}


def save_checkpoint(ckpt_dir, state: TrainState, name: str):
    """Write ``state`` to ``<ckpt_dir>/<name>`` (replacing the file)."""
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
    if torch.device(blob["generator_device"]).type == gen_dev.type:
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
