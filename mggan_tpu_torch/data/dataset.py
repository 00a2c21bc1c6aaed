"""In-memory windowed scene dataset (counterpart of
``mggan_tpu/data/dataset.py``; reference ``TrajectoryDatasetEval``,
trajectories_scene.py:81-371).

A ``SceneDataset`` holds one entry per *window* (a scene snapshot of
``SEQ_LEN = 20`` frames): the trajectories of all peds fully present in the
window, the scene name, and a uint8 "big patch" per ped, a
``(BIG_PATCH, BIG_PATCH, 3)`` crop of the half-resolution scene image
centred on the ped's last observed position. The big patch is the support
a rotated 33x33 window needs (``data/augment.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mggan_tpu_torch import native
from mggan_tpu_torch.config import OBS_LEN, SEQ_LEN  # SEQ_LEN: the data modules read it here

MARGIN = 16  # margin_in = margin_out = 16 (data_loaders.py:33-34)
PATCH = 2 * MARGIN + 1  # 33
# Big-patch radius: must cover a 33x33 crop under any rotation:
# ceil(16 * sqrt(2)) = 23 -> radius 24, side 49.
BIG_MARGIN = 24
BIG_PATCH = 2 * BIG_MARGIN + 1


@dataclasses.dataclass
class SceneDataset:
    """Windowed dataset in padded-ready form."""

    dataset_name: str
    # list of (n_peds, 20, 2) float32; futures may be NaN (GOFP is_active)
    trajectories: list
    scene_names: list  # scene id per window
    # scene -> {"ratio": float, "small": HxWx3 uint8 half-res image}
    images: dict
    # list of (n_peds, 49, 49, 3) uint8 big patches (or None -> zeros)
    big_patches: Optional[list] = None
    format: str = "meter"
    # pixels-per-meter of the small image (BIWI: 2 px/m)
    px_per_meter: float = 2.0
    ped_ids: Optional[list] = None

    def __len__(self):
        return len(self.trajectories)

    @property
    def seq_start_end(self):
        ends = np.cumsum([len(t) for t in self.trajectories])
        starts = np.concatenate([[0], ends[:-1]])
        return list(zip(starts.tolist(), ends.tolist()))

    @property
    def obs_traj(self):
        return np.concatenate(self.trajectories)[:, :OBS_LEN]

    @property
    def pred_traj(self):
        return np.concatenate(self.trajectories)[:, OBS_LEN:]

    def eval_scaling(self, window_idx: int) -> float:
        """Per-scene metric rescaling for pixel datasets (evaluation.py:57-61)."""
        if self.dataset_name in ("stanford", "gofp"):
            return 1.0 / self.images[self.scene_names[window_idx]]["ratio"]
        return 1.0


def extract_big_patches(small_img: np.ndarray, centers_px: np.ndarray) -> np.ndarray:
    """Crop (49,49,3) uint8 windows around integer pixel centres.

    ``ImageFeatures_small``'s integer-truncated centre and zero-padded
    out-of-bounds crop (BaseTrajectories.py:254-277), with the larger
    support on-device rotation needs, through the native crop
    (``native.extract_patches``; its plain version is
    ``native.extract_patches_reference``).
    """
    centers = np.stack([centers_px[:, 0].astype(np.int64),
                        centers_px[:, 1].astype(np.int64)], axis=1)
    return native.extract_patches(small_img, centers, BIG_MARGIN)
