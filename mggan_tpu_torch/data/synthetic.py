"""Synthetic in-memory dataset for tests and benchmarks (counterpart of
``mggan_tpu/data/synthetic.py``).

Multi-ped scenes with smooth, goal-directed trajectories plus a random
scene image, in the ``SceneDataset`` form the real loaders produce, so the
eval stack runs without any files on disk. The same arguments give the
same arrays as the JAX package's copy (one ``numpy.random.RandomState``,
drawn in the same order).
"""

from __future__ import annotations

import numpy as np

from mggan_tpu_torch.config import OBS_LEN
from mggan_tpu_torch.data.dataset import SEQ_LEN, SceneDataset, extract_big_patches


def make_synthetic_dataset(
    num_windows=64,
    max_peds=6,
    seed=0,
    img_size=96,
    px_per_meter=2.0,
    nan_future_frac=0.0,
    num_scenes=2,
) -> SceneDataset:
    rng = np.random.RandomState(seed)
    images = {}
    for s in range(num_scenes):
        img = rng.randint(0, 255, (img_size, img_size, 3), np.uint8)
        images[f"scene{s}"] = {"ratio": 1.0, "small": img}

    trajs, names, patches = [], [], []
    extent = img_size / px_per_meter  # scene extent in meters
    for w in range(num_windows):
        n = rng.randint(1, max_peds + 1)
        start = rng.uniform(0.2 * extent, 0.8 * extent, (n, 2))
        vel = rng.uniform(-1, 1, (n, 2)) * 0.4
        steps = np.arange(SEQ_LEN)[None, :, None]
        xy = start[:, None] + vel[:, None] * steps
        xy = xy + rng.normal(0, 0.03, xy.shape).cumsum(1)
        xy = xy.astype(np.float32)
        if nan_future_frac > 0:
            drop = rng.rand(n) < nan_future_frac
            xy[drop, OBS_LEN:] = np.nan
        scene = f"scene{w % num_scenes}"
        trajs.append(xy)
        names.append(scene)
        centers_px = xy[:, OBS_LEN - 1] * px_per_meter
        patches.append(extract_big_patches(images[scene]["small"], centers_px))

    return SceneDataset(
        dataset_name="synthetic_memory",
        trajectories=trajs,
        scene_names=names,
        images=images,
        big_patches=patches,
        format="meter",
        px_per_meter=px_per_meter,
        ped_ids=[np.arange(len(t)) for t in trajs],
    )
