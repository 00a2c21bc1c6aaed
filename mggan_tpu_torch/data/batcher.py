"""Padded-batch assembly (counterpart of ``mggan_tpu/data/batcher.py``;
replaces torch DataLoader + ``seq_collate_scene``, data_loaders.py:92-100 /
trajectories_scene.py:40-78).

Windows (scenes) are batched along a scene axis and peds are padded to a
fixed ``max_peds``, so every batch has the same ``(S, P, ...)`` shape.
Scenes stay atomic (a scene never straddles a batch), mirroring
``seq_start_end``. The last partial batch is padded with empty, masked
scenes (the reference uses ``drop_last=False``). Batches are numpy arrays
on the host, but for ``big_patches`` when a device patch bank
(``data/patch_bank.py``) gathers them on the device instead.

For data-parallel training (``parallel/``) a batcher runs a fixed number
of batches an epoch (``num_batches``: the nodes' lockstep count,
``data/elastic.py``; a short shard pads all-masked batches whose
``window_idx`` is -1) and may keep one rank's rows of each batch
(``shard``).
"""

from __future__ import annotations

import numpy as np

from mggan_tpu_torch.data.dataset import BIG_PATCH, SEQ_LEN, SceneDataset


class PaddedBatcher:
    def __init__(
        self,
        ds: SceneDataset,
        batch_size: int,
        max_peds: int | None = None,
        shuffle: bool = False,
        seed: int = 0,
        patch_bank=None,
        num_batches: int | None = None,
        augment: bool = False,
        shard: tuple[int, int] | None = None,
    ):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        # Epoch order is a pure function of (seed, epoch), as in the JAX
        # package, so a resumed run replays the batch stream of an
        # uninterrupted one: the Trainer pins the epoch with set_epoch();
        # standalone iteration advances the counter itself.
        self.seed = seed
        self._epoch = 0
        # Lockstep across nodes (data/elastic.py): this many batches an
        # epoch, trailing all-masked empty batches where the node's shard
        # runs short.
        self.num_batches = num_batches
        # shard=(index, count): each batch padded with empty scenes to a
        # multiple of count, and only the index-th of count equal row
        # blocks assembled: a data-parallel rank's scenes (parallel/dp.py)
        self.shard = shard
        # Whether the Trainer augments this loader's batches (on the device).
        self.augment = augment
        # With a bank the host assembles no patch array; make_batch attaches
        # the bank's gather instead (dispatched from the prefetch thread).
        self.patch_bank = patch_bank
        self.include_patches = patch_bank is None and ds.big_patches is not None

        sizes = [len(t) for t in ds.trajectories]
        data_max = max(sizes) if sizes else 1
        self.max_peds = max_peds or data_max
        if data_max > self.max_peds:
            raise ValueError(
                f"dataset has a scene with {data_max} peds > max_peds="
                f"{self.max_peds}; raise --max_peds"
            )
        if patch_bank is not None and patch_bank.max_peds != self.max_peds:
            raise ValueError(f"patch bank of {patch_bank.max_peds} peds for a "
                             f"batcher of {self.max_peds}")

        # Scene extent in meters for augmentation (width, height).
        self._wh_m = {}
        for name, info in ds.images.items():
            h, w = info["small"].shape[:2]
            self._wh_m[name] = (w / ds.px_per_meter, h / ds.px_per_meter)

    def __len__(self):
        data_batches = (len(self.ds) + self.batch_size - 1) // self.batch_size
        if self.num_batches is None:
            return data_batches
        if self.num_batches < data_batches:
            raise ValueError(f"num_batches={self.num_batches} < the shard's {data_batches} "
                             "batches: the lockstep count must cover the shard")
        return self.num_batches

    def num_windows(self):
        return len(self.ds)

    @property
    def rows(self) -> int:
        """Scene rows of each batch this loader yields."""
        if self.shard is None:
            return self.batch_size
        return -(-self.batch_size // self.shard[1])

    def set_epoch(self, epoch: int):
        """Pin the shuffle order of the next ``__iter__`` to ``epoch`` (the
        contract of torch's ``DistributedSampler.set_epoch``)."""
        self._epoch = int(epoch)

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            epoch_rng = np.random.RandomState(
                (self.seed * 1_000_003 + self._epoch) % (2**31 - 1)
            )
            epoch_rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        for i in range(0, len(order), bs):
            yield self.make_batch(order[i : i + bs])
        if self.num_batches is not None:
            for _ in range(-(-len(order) // bs), len(self)):
                yield self.make_batch(np.zeros((0,), np.int64))

    def make_batch(self, idxs):
        ds, p = self.ds, self.max_peds
        if self.shard is not None:
            lo = self.shard[0] * self.rows
            idxs = idxs[lo : lo + self.rows]
        s = self.rows  # the last batch is padded with empty scenes
        xy = np.zeros((s, p, SEQ_LEN, 2), np.float32)
        ped_mask = np.zeros((s, p), bool)
        wh_m = np.ones((s, 2), np.float32)
        scale = np.ones((s,), np.float32)
        window_idx = np.full((s,), -1, np.int64)
        if self.include_patches:
            big = np.zeros((s, p, BIG_PATCH, BIG_PATCH, 3), np.uint8)
        for row, wi in enumerate(idxs):
            traj = ds.trajectories[wi]
            n = len(traj)
            xy[row, :n] = traj
            ped_mask[row, :n] = True
            wh_m[row] = self._wh_m[ds.scene_names[wi]]
            scale[row] = ds.eval_scaling(wi)
            window_idx[row] = wi
            if self.include_patches:
                big[row, :n] = ds.big_patches[wi]
        batch = {
            "xy": xy,
            "ped_mask": ped_mask,
            "wh_m": wh_m,
            "scale": scale,
            "window_idx": window_idx,
        }
        if self.include_patches:
            batch["big_patches"] = big
        elif self.patch_bank is not None:
            batch["big_patches"] = self.patch_bank.gather(window_idx)
        return batch
