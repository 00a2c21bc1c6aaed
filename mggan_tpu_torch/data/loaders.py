"""Loader factory (counterpart of ``mggan_tpu/data/loaders.py``; reference
``get_dataloader``, data_loaders.py:10-100).

Returns one ``PaddedBatcher`` over a ``SceneDataset``. Ported: the
in-memory ``synthetic_memory`` dataset. Real datasets (the reference
release layout, ``parsing`` / ``registry`` / ``homography``), per-process
sharding and the device patch bank raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

from __future__ import annotations

from mggan_tpu_torch.data.batcher import PaddedBatcher
from mggan_tpu_torch.data.synthetic import make_synthetic_dataset

SYNTHETIC_WINDOWS = {"train": 48, "val": 16, "test": 16}
SYNTHETIC_SEEDS = {"train": 0, "val": 1, "test": 2}


def get_dataset(dataset: str, phase: str):
    """The ``SceneDataset`` of ``dataset``'s ``phase``. ``synthetic_memory``
    is made anew on every call (the JAX package caches it per phase)."""
    if dataset == "synthetic_memory":
        return make_synthetic_dataset(num_windows=SYNTHETIC_WINDOWS[phase],
                                      seed=SYNTHETIC_SEEDS[phase])
    raise NotImplementedError(
        f"dataset {dataset!r}: parsing the reference release layout "
        "(data/parsing.py, registry.py, homography.py) is not ported yet "
        "(ROADMAP.md queue 1); use 'synthetic_memory'")


def get_dataloader(dataset: str, phase: str, batch_size=8, shuffle=False,
                   max_peds=None, seed=0, patch_bank=False, shard_by_process=False):
    """A ``PaddedBatcher`` over ``get_dataset(dataset, phase)``, the JAX
    signature's ported arguments (augmentation runs on the device, in the
    train step; the CLI's ``workers``, ``split`` and ``data_root`` wait for
    the real datasets)."""
    if phase not in ("train", "val", "test"):
        raise ValueError(f"phase must be train, val or test, got {phase!r}")
    if patch_bank:
        raise NotImplementedError(
            "the device patch bank (data/patch_bank.py) is not ported yet "
            "(ROADMAP.md queue 1 item 9)")
    if shard_by_process:
        raise NotImplementedError(
            "per-process window shards (data/elastic.py) are not ported yet "
            "(ROADMAP.md queue 1 item 13)")
    return PaddedBatcher(get_dataset(dataset, phase), batch_size=batch_size,
                         max_peds=max_peds, shuffle=shuffle, seed=seed)
