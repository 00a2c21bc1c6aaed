"""Trajectory tools (counterpart of ``mggan_tpu/utils/trajectory_tools.py``;
reference utils.py:10-31, 86-94, 168-199, 251-375): 4D state
augmentation, gradient-norm logging, the SGHMC noise helpers, LaTeX tables
and pseudo-multi-modal ground-truth mining. ``get_traj_4d``,
``pandas_to_latex`` and ``get_similar_trajectories`` are host numpy (the
table one takes a pandas ``DataFrame`` its caller built), copied rather
than imported, as the port imports nothing of the JAX package."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from mggan_tpu_torch.parallel import reduce
from mggan_tpu_torch.utils.pytree import tree_items, tree_map


def get_traj_4d(obsv_p: np.ndarray, pred_p=None):
    """Positions -> positions + velocities (utils.py:86-94).

    obsv_p: (B, T, 2). Velocity of step 0 repeats step 1's.
    """
    obsv_v = np.diff(obsv_p, axis=1)
    obsv_v = np.concatenate([obsv_v[:, :1], obsv_v], axis=1)
    if pred_p is None:
        return obsv_p, obsv_v
    prev = np.concatenate([obsv_p[:, -1:], pred_p[:, :-1]], axis=1)
    pred_v = pred_p - prev
    return obsv_p, obsv_v, pred_p, pred_v


class GradNormLogger:
    """Per-module gradient-norm accumulation from the train step's
    ``gradnorm/<prefix>/<module>`` metrics (the top-level keys of the grad
    tree play the modules' part)."""

    def __init__(self):
        self.grad_norms = defaultdict(list)

    def update_scalars(self, module: str, values):
        """Append per-step norms already computed for one module (the train
        step's ``gradnorm/<prefix>/<module>`` metrics); NaN sentinels of
        skipped D steps are dropped, as the reference appends nothing on a
        skipped iteration."""
        vals = [float(v) for v in values]
        self.grad_norms[module].extend(v for v in vals if not np.isnan(v))

    def reset(self):
        self.grad_norms = defaultdict(list)

    def write(self, writer, global_step):
        """Emit per-module gradient histograms to the writer's TensorBoard
        backend, if it has one (utils.py:195-199), and reset."""
        tb = getattr(writer, "_tb", None)
        if tb is not None:
            for module, vals in self.grad_norms.items():
                tb.add_histogram(f"gradient_histograms/{module}", np.array(vals),
                                 global_step)
        self.reset()


def sghmc_noise_like(params):
    """Zero buffers matching the parameter tree (utils.py:28-31)."""
    return tree_map(torch.zeros_like, params)


def noise_loss(params, normals, alpha: float):
    """SGHMC noise loss ``sum_p <p, n_p>``, ``n_p = alpha * normals_p``
    (utils.py:10-15). ``normals`` is a tree shaped like ``params`` of
    standard normals (JAX draws one per leaf from ``split(key, n_leaves)``
    in leaf order); the leaves add in ``tree_items`` order, JAX's order.
    Under generator parallelism the ``decoders`` slices' terms are summed
    over the model group (``parallel/reduce.py::leaf_sum``)."""
    flat = dict(tree_items(normals))
    return reduce.leaf_sum(params, lambda path, p: (p * (flat[path] * alpha)).sum())


def pandas_to_latex(df_table, index=True, multicolumn=False, **kwargs) -> str:
    """DataFrame -> LaTeX with cmidrule separators under multi-column
    headers (utils.py:251-273)."""
    latex = df_table.to_latex(multicolumn=multicolumn, index=index, **kwargs)
    if multicolumn:
        lines = latex.splitlines()
        insert_at = 3
        for j, _ in enumerate(df_table.columns.levels[:-1]):
            codes = np.array(df_table.columns.codes[j])
            breaks = np.nonzero(codes[:-1] != codes[1:])[0].tolist()
            rule = ""
            for start, end in zip([-1] + breaks, breaks + [len(codes) - 1]):
                if end - start > 1:
                    rule += f"\\cmidrule(l){{{start + 2}-{end + 1}}} "
            lines.insert(insert_at, rule)
            insert_at += j + 2
        latex = "\n".join(lines)
    return latex


def get_similar_trajectories(ds, distance_threshold: float, direction_threshold: float,
                             speed_threshold: float, radius: float = 2.0,
                             filter_hist_colliding: bool = False):
    """Mine pseudo-multi-modal ground truth (utils.py:276-375): for each
    trajectory, find same-scene trajectories whose last observed position,
    heading and speed are similar; shift their futures to the query's frame;
    optionally drop futures that would collide with scene peers.

    Returns {traj_idx: (m, pred_len, 2) candidate futures}.
    """
    obs = ds.obs_traj  # (N, 8, 2)
    gt = ds.pred_traj  # (N, 12, 2)
    obs_rel = np.diff(obs, axis=1)
    framerate = 1.0 / 0.4
    ped_ids = np.concatenate(ds.ped_ids) if ds.ped_ids is not None else np.arange(len(obs))
    mask = np.isnan(gt).any(-1).any(-1)

    scene_to_idxs = defaultdict(list)
    idx_to_others = {}
    for i, (start, end) in enumerate(ds.seq_start_end):
        scene_to_idxs[ds.scene_names[i]].extend(range(start, end))
        for j in range(start, end):
            idx_to_others[j] = [k for k in range(start, end) if k != j]

    last_v = obs_rel[:, -1]
    speed_len = np.linalg.norm(last_v, axis=1, keepdims=True)
    direction = last_v / (speed_len + 1e-7)

    out = {}
    for i, (start, end) in enumerate(ds.seq_start_end):
        for idx in range(start, end):
            if idx in out or mask[idx]:
                continue
            cand = np.array(scene_to_idxs[ds.scene_names[i]])
            cand = cand[~mask[cand]]
            d = np.linalg.norm(obs[idx, -1][None] - obs[cand, -1], axis=-1)
            cand = cand[d < distance_threshold]
            if not np.isclose(speed_len[idx], 0.0):
                cos = direction[cand] @ direction[idx]
                cand = cand[cos > direction_threshold]
            dv = np.abs(speed_len[idx] - speed_len[cand, 0]) * framerate
            cand = cand[dv < speed_threshold]

            cand_ped_ids = ped_ids[cand]
            for sim in cand:
                # one (closest) trajectory per distinct ped id
                keep = [sim]
                others = cand[cand_ped_ids != ped_ids[sim]]
                other_ids = cand_ped_ids[cand_ped_ids != ped_ids[sim]]
                for pid in np.unique(other_ids):
                    group = others[other_ids == pid]
                    dd = np.linalg.norm(obs[sim, -1][None] - obs[group, -1], axis=-1)
                    keep.append(group[np.argmin(dd)])
                keep = np.array(keep)
                offset = obs[keep, -1] - obs[sim, -1]
                futures = gt[keep] - offset[:, None]
                if filter_hist_colliding and idx_to_others[sim]:
                    collide = np.zeros(len(futures), bool)
                    for other in idx_to_others[sim]:
                        d2 = np.linalg.norm(futures - gt[other][None], axis=-1)
                        collide |= (d2 < radius).any(1)
                    futures = futures[~collide]
                out[sim] = futures
    return out
