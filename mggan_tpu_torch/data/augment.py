"""Batched augmentation and patch finishing on the device (counterpart of
``mggan_tpu/data/augment.py``).

The host stops at a per-ped 49x49 uint8 "big patch" crop around the last
observed position; the device turns it into the model's 33x33x4 patch.
Ported: the eval half, the identity transform (``identity_patches``,
``augment_batch(train=False)``). The train half (random flip + rotation of
trajectories and patches, ``augment_trajectories`` / ``finish_patches``)
raises naming ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

import numpy as np
import torch

from mggan_tpu_torch.data.dataset import BIG_MARGIN, MARGIN, PATCH
from mggan_tpu_torch.device import resolve_device


def identity_patches(big_patches):
    """uint8 ``(S,P,49,49,3)`` -> model patches ``(S,P,33,33,4)`` float32:
    the centre 33x33 crop, normalised to [-1, 1) (``-1 + raw * 2/256``,
    BaseTrajectories.py:283) with the one-hot centre channel appended."""
    s, p = big_patches.shape[:2]
    off = BIG_MARGIN - MARGIN
    rgb = big_patches[:, :, off : off + PATCH, off : off + PATCH].float()
    rgb = -1.0 + rgb * 2.0 / 256.0
    pos = torch.zeros((s, p, PATCH, PATCH, 1), dtype=torch.float32,
                      device=big_patches.device)
    pos[:, :, MARGIN, MARGIN, 0] = 1.0
    return torch.cat([rgb, pos], dim=-1)


def _on(x, device):
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))).to(device)


def augment_batch(batch, train: bool, device="cuda"):
    """Trajectories and finished model patches of a loader batch, as
    tensors on ``device``.

    ``batch``: ``xy (S,P,20,2)``, ``big_patches (S,P,49,49,3)`` uint8 or
    absent, and the loader's other keys, as numpy arrays or tensors. The
    uint8 big patches cross to the device and are finished there. With
    ``train=False`` the transform is the identity; ``train=True`` is not
    ported yet.
    """
    if train:
        raise NotImplementedError(
            "train-time augmentation (augment_trajectories, finish_patches) "
            "is not ported yet (ROADMAP.md queue 1 item 9)")
    device = resolve_device(device)
    out = {k: _on(v, device) for k, v in batch.items() if v is not None}
    big = out.pop("big_patches", None)
    if big is not None:
        out["patches"] = identity_patches(big)
    return out
