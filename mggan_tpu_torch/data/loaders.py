"""Loader factory (counterpart of ``mggan_tpu/data/loaders.py``; reference
``get_dataloader``, data_loaders.py:10-100).

Returns one ``PaddedBatcher`` over a ``SceneDataset``, with the split's
patches in a device patch bank when asked and the budget allows. Datasets:
the in-memory ``synthetic_memory`` and every dataset of the reference
release layout (``data/parsing.py``). Per-process sharding raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from mggan_tpu_torch.data import parsing
from mggan_tpu_torch.data.batcher import PaddedBatcher
from mggan_tpu_torch.data.patch_bank import maybe_build_bank
from mggan_tpu_torch.data.synthetic import make_synthetic_dataset

SYNTHETIC_WINDOWS = {"train": 48, "val": 16, "test": 16}
SYNTHETIC_SEEDS = {"train": 0, "val": 1, "test": 2}

# per-dataset patch-image scaling (data_loaders.py:30-87)
SCALING_SMALL = {
    "stanford_synthetic": 1.2,
    "stanford_synthetic_2": 1.2,
    "social_stanford_synthetic": 1.2,
    "stanford": 0.7,
    "eth": 0.5,
    "hotel": 0.5,
    "zara1": 0.5,
    "zara2": 0.5,
    "univ": 0.5,
    "gofp": 0.5,
}


def get_dataset(dataset: str, phase: str, data_root="./data/datasets", split=None):
    """The ``SceneDataset`` of ``dataset``'s ``phase``: ``synthetic_memory``
    made anew on every call (the JAX package caches it per phase), or the
    files under ``data_root/<dataset>/<phase>``, filtered to the ``upper``
    or ``lower`` split when one is asked."""
    if dataset == "synthetic_memory":
        return make_synthetic_dataset(num_windows=SYNTHETIC_WINDOWS[phase],
                                      seed=SYNTHETIC_SEEDS[phase])
    ds = parsing.load_scene_dataset(dataset, phase, data_root=data_root)
    if split in ("upper", "lower"):
        ds = parsing.filter_split(ds, split)
    return ds


def get_dataloader(dataset: str, phase: str, augment=False, batch_size=8, workers=0,
                   shuffle=False, split=None, max_peds=None, data_root="./data/datasets",
                   seed=0, patch_bank=False, shard_by_process=False, device="cuda"):
    """A ``PaddedBatcher`` over ``get_dataset(dataset, phase, data_root,
    split)``, with the JAX signature's single-process arguments.
    ``workers`` is accepted for CLI parity and read by nothing, as in the
    JAX package.

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
    ds = get_dataset(dataset, phase, data_root=data_root, split=split)
    bank = None
    if patch_bank:
        resolved_max = max_peds or max((len(t) for t in ds.trajectories), default=1)
        bank = maybe_build_bank(ds, resolved_max, device=device)
    return PaddedBatcher(ds, batch_size=batch_size, max_peds=max_peds, shuffle=shuffle,
                         seed=seed, patch_bank=bank,
                         augment=bool(augment) and phase == "train")
