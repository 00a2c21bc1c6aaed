"""Sphere-union manifold Precision/Recall (counterpart of
``mggan_tpu/eval/manifold.py``; reference manifold.py:8-77,
evaluation.py:30-40,101-156).

The manifold around a set of trajectories uses a per-timestep radius
ramping linearly from radius/T to radius over the prediction horizon. A
test trajectory is inside iff at every timestep it lies within the radius
of ANY construction trajectory. The membership tests are vectorised numpy
on the host. The plotting methods (``get_polygons``, ``plot_manifold``)
import matplotlib when called; ``get_polygons`` unions the circles with
shapely where it is installed and otherwise returns them without a union,
as the JAX package does.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class Manifold:
    def __init__(self, construct_set: np.ndarray, radius: float):
        """construct_set: (num_samples, pred_len, 2)."""
        self.data = np.asarray(construct_set)
        pred_len = self.data.shape[1]
        self.radius = np.linspace(radius / pred_len, radius, pred_len, endpoint=True)

    def compute_inside(self, test_data: np.ndarray) -> np.ndarray:
        """(n, pred_len, 2) -> (n,) bool."""
        test = np.asarray(test_data)
        # (n, m, T) pairwise per-step distances
        d = np.linalg.norm(test[:, None] - self.data[None], axis=-1)
        cond = d < self.radius[None, None]
        return cond.any(1).all(1)

    def compute_metric(self, test_data: np.ndarray) -> float:
        inside = self.compute_inside(test_data)
        return float(inside.sum()) / len(test_data)

    def get_polygons(self, time):
        """Circle polygons of the manifold at timestep(s) ``time``
        (manifold.py:79-95). With shapely installed this returns their
        unary union (reference-exact); without it, the polygons without a
        union (the same fill, edges also drawn on interior seams)."""
        import matplotlib.patches as patches

        if not isinstance(time, list):
            time = [time]
        polys = []
        for t in time:
            for idx in range(self.data.shape[0]):
                endpoint = self.data[idx, t]
                circle = patches.CirclePolygon((endpoint[0], endpoint[1]), self.radius[t])
                verts = circle.get_path().vertices
                polys.append(circle.get_patch_transform().transform(verts))
        try:
            from shapely.geometry import Polygon
            from shapely.ops import unary_union
        except ImportError:
            return polys
        union = unary_union([Polygon(p) for p in polys])
        geoms = getattr(union, "geoms", [union])
        return [np.array(g.exterior.coords) for g in geoms]

    def plot_manifold(self, time, color="r", axes=None, border_only=False):
        """Matplotlib rendering (manifold.py:20-58). ``border_only``: the
        manifold's cross-sections at ``time`` (a step or a list) as filled
        polygons with Reds-colormap borders; otherwise final-radius circles
        around each endpoint (``time`` unread)."""
        import matplotlib.patches as patches
        import matplotlib.pyplot as plt

        if axes is None:
            _, axes = plt.subplots()
        if border_only:
            times = time if isinstance(time, list) else [time]
            cmap = plt.get_cmap("Reds", len(times) + 2)
            for i, t in enumerate(times):
                for poly in self.get_polygons(t):
                    axes.add_patch(patches.Polygon(np.asarray(poly), facecolor="none",
                                                   edgecolor=cmap(i), lw=3))
                    axes.add_patch(patches.Polygon(np.asarray(poly), facecolor=cmap(i),
                                                   edgecolor="none", lw=3, alpha=0.5,
                                                   zorder=1))
        else:
            for idx in range(self.data.shape[0]):
                endpoint = self.data[idx, -1]
                axes.add_artist(plt.Circle(tuple(endpoint), self.radius[-1], color=color,
                                           fill=False))
                axes.scatter(endpoint[0], endpoint[1])
        return axes


def get_same_obs_indices(ds):
    """Group dataset agent indices whose whole-scene observations are
    identical (GOFP repeats scenes with alternative futures;
    evaluation.py:30-40)."""
    obs = ds.obs_traj
    groups = defaultdict(list)
    for scene_idx, (start, end) in enumerate(ds.seq_start_end):
        key = (
            tuple(np.round(obs[start:end].reshape(-1), 6).tolist()),
            ds.scene_names[scene_idx],
        )
        groups[key].append(list(range(start, end)))
    return list(groups.values())


def evaluate_precision_recall(ds, all_preds, manifold_radius, n_preds_list):
    """Precision / Recall@k over same-observation groups
    (evaluation.py:101-156).

    Args:
        all_preds: (pred_len, num_samples, n_agents, 2), the reference's
            prediction layout.
    Returns dict {"Precision": float, "Recall k=K": float, ...}.

    The numbers of the JAX package's version, which builds a ``Manifold``
    per k: here one table of per-step distances between an agent group's
    ground truths and its samples serves Precision and every Recall@k (a
    running "any" over the samples gives each k's manifold).
    """
    gt = ds.pred_traj  # (n_agents, T, 2)
    num_preds = max(n_preds_list)
    same_scene_groups = get_same_obs_indices(ds)
    ok = ~np.isnan(gt).any(-1).any(-1)
    radius = Manifold(gt[:1], manifold_radius).radius  # (T,)

    # -> (n_agents, num_samples, pred_len, 2)
    preds = np.transpose(all_preds, (2, 1, 0, 3))

    sums = defaultdict(lambda: np.zeros(2))
    for group in same_scene_groups:
        for same_ped in zip(*group):
            # the sorted agents with a full future (np.intersect1d's result)
            idxs = np.array(sorted(i for i in set(same_ped) if ok[i]), np.int64)
            if len(idxs) == 0:
                continue
            gt_samples = gt[idxs]  # (m, T, 2)
            cur = preds[idxs].reshape(-1, *preds.shape[2:])  # (C, T, 2)
            # near[j, i, t]: sample i within the step-t radius of truth j
            near = np.linalg.norm(gt_samples[:, None] - cur[None], axis=-1) < radius
            inside = near[:, :num_preds].any(0).all(-1)  # samples in the GT manifold
            sums["Precision"] += (float(inside.sum()) / len(inside), 1.0)
            covered = np.logical_or.accumulate(near, axis=1)  # any over samples < k
            last = [min(k, len(cur)) - 1 for k in n_preds_list]
            counts = covered[:, last].all(-1).sum(0)  # truths inside, per k
            for k, c in zip(n_preds_list, counts.tolist()):
                sums[f"Recall k={k}"] += (float(c) / len(gt_samples), 1.0)
    return {k: v[0] / v[1] for k, v in sums.items() if v[1] > 0}


def get_oracle_preds(ds, num_preds, seed=0):
    """Oracle baseline: sample GT futures of same-obs peers
    (evaluation.py:81-98)."""
    rng = np.random.RandomState(seed)
    gt = ds.pred_traj
    n, pred_len, _ = gt.shape
    preds = np.zeros((n, num_preds, pred_len, 2))
    for group in get_same_obs_indices(ds):
        for same_ped in zip(*group):
            for ped in same_ped:
                pick = rng.choice(same_ped, size=num_preds)
                preds[ped] = gt[pick]
    return preds.transpose(2, 1, 0, 3)
