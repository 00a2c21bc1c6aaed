"""Loader factory (counterpart of ``mggan_tpu/data/loaders.py``; reference
``get_dataloader``, data_loaders.py:10-100).

Returns one ``PaddedBatcher`` over a ``SceneDataset``, with the split's
patches in a device patch bank when asked and the budget allows. Ported:
the in-memory ``synthetic_memory`` dataset. Real datasets (the reference
release layout, ``parsing`` / ``registry`` / ``homography``) and
per-process sharding raise ``NotImplementedError`` naming their ROADMAP.md
item.
"""

from __future__ import annotations

from mggan_tpu_torch.data.batcher import PaddedBatcher
from mggan_tpu_torch.data.patch_bank import maybe_build_bank
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


def get_dataloader(dataset: str, phase: str, augment=False, batch_size=8,
                   shuffle=False, max_peds=None, seed=0, patch_bank=False,
                   shard_by_process=False, device="cuda"):
    """A ``PaddedBatcher`` over ``get_dataset(dataset, phase)``, the JAX
    signature's ported arguments (the CLI's ``workers``, ``split`` and
    ``data_root`` wait for the real datasets).

    ``augment`` marks the loader's batches for augmentation
    (``loader.augment``), forced off for val and test
    (data_loaders.py:21-23); the augmentation itself runs on the device, in
    the Trainer. ``patch_bank`` keeps the split's patches on
    ``device`` (``data/patch_bank.py``) when they fit the global budget;
    ``device`` is read by nothing else.
    """
    if phase not in ("train", "val", "test"):
        raise ValueError(f"phase must be train, val or test, got {phase!r}")
    if shard_by_process:
        raise NotImplementedError(
            "per-process window shards (data/elastic.py) are not ported yet "
            "(ROADMAP.md queue 1 item 13)")
    ds = get_dataset(dataset, phase)
    bank = None
    if patch_bank:
        resolved_max = max_peds or max((len(t) for t in ds.trajectories), default=1)
        bank = maybe_build_bank(ds, resolved_max, device=device)
    return PaddedBatcher(ds, batch_size=batch_size, max_peds=max_peds, shuffle=shuffle,
                         seed=seed, patch_bank=bank,
                         augment=bool(augment) and phase == "train")
