"""Loader factory (counterpart of ``mggan_tpu/data/loaders.py``; reference
``get_dataloader``, data_loaders.py:10-100).

Returns one ``PaddedBatcher`` over a ``SceneDataset``, with the split's
patches in a device patch bank when asked and the budget allows. Datasets:
the in-memory ``synthetic_memory`` and every dataset of the reference
release layout (``data/parsing.py``). For data-parallel training a loader
holds its node's windows (``shard_by_process``) and yields one rank's
scene rows of each batch (``grid``).
"""

from __future__ import annotations

from mggan_tpu_torch.data import elastic, parsing
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
                   seed=0, patch_bank=False, shard_by_process=False, process_index=None,
                   process_count=None, device="cuda", grid=None):
    """A ``PaddedBatcher`` over ``get_dataset(dataset, phase, data_root,
    split)``, with the JAX signature's arguments. ``workers`` is accepted
    for CLI parity and read by nothing, as in the JAX package.

    ``augment`` marks the loader's batches for augmentation
    (``loader.augment``), forced off for val and test
    (data_loaders.py:21-23); the augmentation itself runs on the device, in
    the Trainer. ``patch_bank`` keeps the split's patches on
    ``device`` (``data/patch_bank.py``) when they fit the global budget.

    ``shard_by_process``: this node loads only its window shard
    (``elastic.shard_windows``) and runs the nodes' lockstep batch count,
    with ``max_peds`` resolved from the whole split first, so every node
    pads to one shape. ``process_index`` / ``process_count`` default to
    the live pod's (``parallel/pod.py``). ``grid`` (a data-parallel rank's
    ``parallel.mesh.Grid``): each batch yields this rank's scene rows, and
    its bank lives on ``grid.device`` with the budget shared by the ranks
    on that device.
    """
    if phase not in ("train", "val", "test"):
        raise ValueError(f"phase must be train, val or test, got {phase!r}")
    ds = get_dataset(dataset, phase, data_root=data_root, split=split)
    num_batches = None
    if shard_by_process:
        if process_index is None or process_count is None:
            from mggan_tpu_torch.parallel import pod

            process_index, process_count = pod.process_index(), pod.process_count()
        global_windows = len(ds)
        if max_peds is None:
            # the padded ped axis from the whole split, before sharding:
            # per-shard widths would give the nodes different shapes
            max_peds = max((len(t) for t in ds.trajectories), default=1)
        ds = elastic.shard_windows(ds, process_index, process_count)
        num_batches = elastic.lockstep_batches(global_windows, process_count, batch_size)
    shard, sharing = None, 1
    if grid is not None:
        device, sharing = grid.device, grid.ranks_per_device
        shard = (grid.node_shard, grid.node_shards)
    bank = None
    if patch_bank:
        resolved_max = max_peds or max((len(t) for t in ds.trajectories), default=1)
        bank = maybe_build_bank(ds, resolved_max, device=device, sharing=sharing)
    return PaddedBatcher(ds, batch_size=batch_size, max_peds=max_peds, shuffle=shuffle,
                         seed=seed, patch_bank=bank, num_batches=num_batches,
                         augment=bool(augment) and phase == "train", shard=shard)
