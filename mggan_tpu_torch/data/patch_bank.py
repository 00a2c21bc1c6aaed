"""Device-resident patch bank (counterpart of ``mggan_tpu/data/patch_bank.py``):
the replacement for host-side patch batch assembly.

The reference collates per-ped image crops into every batch on the host
(trajectories_scene.py:40-78): at bench.py's train batch that is 29.5 MB of
uint8 zeroing and copying per batch, then a copy of it to the card. Instead
the whole split's uint8 big patches are laid out once as a dense
``(windows, max_peds * 49 * 49 * 3)`` tensor in device memory; each batch
gathers its rows by window index on the device and only trajectories
(~100 KB) cross from the host. The gather is dispatched from the prefetch
thread (``data/prefetch.py``); its window index crosses through pinned
memory without blocking (``device.host_to_device``), so the thread enqueues
the gather while the previous step runs instead of waiting for it.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from mggan_tpu_torch.data.dataset import BIG_PATCH, SceneDataset
from mggan_tpu_torch.device import host_to_device, resolve_device

# Combined budget of all live banks. The Trainer keeps the train and val
# banks resident together and ``test()`` adds a third, so the budget is
# global: a split that would push the total past it falls back to host
# assembly in ``PaddedBatcher``. 8 GiB is a tenth of
# an H100's 80 GB.
DEFAULT_MAX_BYTES = 8 << 30

_LIVE_BANKS = weakref.WeakSet()


def live_bank_bytes() -> int:
    """Bytes held on the device by the banks still alive."""
    return sum(b.nbytes for b in _LIVE_BANKS)


def bank_nbytes(num_windows: int, max_peds: int) -> int:
    return num_windows * max_peds * BIG_PATCH * BIG_PATCH * 3


class DevicePatchBank:
    """Dense per-window patch storage on ``device``.

    ``gather(window_idx)`` returns ``(S, P, 49, 49, 3)`` uint8 on the
    device, equal bit for bit to the host-assembled ``big_patches`` batch
    (padded ped rows and ``window_idx == -1`` pad scenes are zero).
    """

    def __init__(self, ds: SceneDataset, max_peds: int, device="cuda"):
        n = len(ds.trajectories)
        dense = np.zeros((n, max_peds, BIG_PATCH, BIG_PATCH, 3), np.uint8)
        for wi, patches in enumerate(ds.big_patches):
            dense[wi, : len(patches)] = patches
        self.device = resolve_device(device)
        self.arr = torch.from_numpy(dense.reshape(n, -1)).to(self.device)
        self.nbytes = self.arr.numel()
        self.max_peds = max_peds

    def gather(self, window_idx) -> torch.Tensor:
        idx = host_to_device(np.asarray(window_idx, np.int64), self.device)
        rows = self.arr.index_select(0, idx.clamp(min=0))
        rows.masked_fill_((idx < 0)[:, None], 0)
        return rows.reshape(idx.shape[0], self.max_peds, BIG_PATCH, BIG_PATCH, 3)


def maybe_build_bank(ds: SceneDataset, max_peds: int, max_bytes: int = DEFAULT_MAX_BYTES,
                     device="cuda", sharing: int = 1):
    """A bank when the split has patches and it fits the rest of the global
    budget; otherwise None (the caller keeps host assembly).

    Data-parallel ranks each bank the windows their node holds (the whole
    split on one node, the node's ``elastic.shard_windows`` shard on
    several) on their own device, and gather only their own scene rows
    (``PaddedBatcher(shard=...)``). ``sharing`` ranks hold such a bank on
    one device, so the budget counts each byte ``sharing`` times.
    """
    if ds.big_patches is None:
        return None
    need = bank_nbytes(len(ds.trajectories), max_peds) + live_bank_bytes()
    if need * sharing > max_bytes:
        return None
    bank = DevicePatchBank(ds, max_peds, device=device)
    _LIVE_BANKS.add(bank)
    return bank
