"""Trajectory, scene and manifold plots (counterpart of
``mggan_tpu/viz.py``; reference visualization.py:6-249).

matplotlib on the host, imported inside each function, so the package
imports where matplotlib is not installed; the plots need it. Arrays may
be numpy arrays or tensors on any device (``_np`` brings them to the
host). Per-generator colouring follows the reference's colouring of
samples by the generator that drew them.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """``x`` as a numpy array (a tensor is detached and copied to the host)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def re_im(img):
    """Undo the [-1, 1) patch normalisation for display
    (BaseTrajectories.py:18-20)."""
    return (_np(img) + 1.0) / 2.0


_GEN_COLORS = [
    "tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple",
    "tab:brown", "tab:pink", "tab:gray", "tab:olive", "tab:cyan",
]


def plot_trajectories(obs, gt=None, preds=None, gen_idxs=None, ax=None,
                      scene_img=None, px_per_meter=None, legend=True):
    """Plot one agent's observation, ground truth, and prediction samples.

    Args:
        obs:  (obs_len, 2) observed trajectory (meters).
        gt:   optional (pred_len, 2) ground-truth future.
        preds: optional (k, pred_len, 2) prediction samples.
        gen_idxs: optional (k,) generator index per sample for coloring.
        scene_img: optional HxWx3 image drawn underneath (with
            ``px_per_meter`` to register coordinates).
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    scale = 1.0
    if scene_img is not None:
        ax.imshow(_np(scene_img))
        scale = px_per_meter or 1.0

    obs = _np(obs) * scale
    ax.plot(obs[:, 0], obs[:, 1], "k-o", ms=2, lw=2, label="observed")
    if preds is not None:
        preds = _np(preds) * scale
        gen_idxs = None if gen_idxs is None else _np(gen_idxs)
        seen = set()
        for k in range(len(preds)):
            g = int(gen_idxs[k]) if gen_idxs is not None else 0
            color = _GEN_COLORS[g % len(_GEN_COLORS)]
            label = f"gen {g}" if (legend and g not in seen) else None
            seen.add(g)
            full = np.concatenate([obs[-1:], preds[k]], 0)
            ax.plot(full[:, 0], full[:, 1], "-", color=color, alpha=0.6,
                    lw=1, label=label)
    if gt is not None:
        gt = _np(gt) * scale
        full = np.concatenate([obs[-1:], gt], 0)
        ax.plot(full[:, 0], full[:, 1], "g--", lw=2, label="ground truth")
    if legend:
        ax.legend(loc="best", fontsize=7)
    ax.set_aspect("equal")
    return ax


def plot_trajectories_by_idxs(obs, gt, preds, color_idxs, ax=None):
    """Color samples by an arbitrary integer label (e.g. manifold membership;
    reference visualization usage in evaluation.py:137-141)."""
    return plot_trajectories(obs, gt, preds, gen_idxs=color_idxs, ax=ax)


def plot_scene(batch, window, preds=None, gen_idxs=None, ax=None):
    """Plot all agents of one padded-batch window.

    batch: dict with xy (S,P,20,2), ped_mask; window: scene row index.
    preds: optional (k,P,pred_len,2).
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    xy = _np(batch["xy"][window])
    mask = _np(batch["ped_mask"][window])
    for p in np.where(mask)[0]:
        plot_trajectories(
            xy[p, :8],
            xy[p, 8:] if np.isfinite(xy[p, 8:]).all() else None,
            None if preds is None else preds[:, p],
            gen_idxs,
            ax=ax,
            legend=(p == 0),
        )
    return ax


def plot_trajectories_by_idxs_img(history=None, gt=None, preds=None,
                                  idxs=None, img=None, scale=20.0, ax=None,
                                  lw=3, ls="-", plot_hist=True,
                                  hist_color="k"):
    """One agent's predictions colored by integer index over an optional
    scene image (reference visualization.py:109-207).

    Args:
        history: (obs_len, 2); gt: (pred_len, 2); preds: (k, pred_len, 2).
        idxs: (k,) integer labels; samples with the same label share a
            tab10 color.
        img: optional HxWx3 underlay; ``scale`` converts meters to its
            pixels (the reference's px-per-meter ``scale=20.0`` default).
    """
    import matplotlib.pyplot as plt
    import matplotlib.patheffects as mpe

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 10))
    if img is not None:
        img = _np(img)
        ax.imshow(img, alpha=1)
        height, width = img.shape[:2]
        ax.set_ylim(height, 0)
        ax.set_xlim(0, width)
    else:
        ax.set_aspect("equal", adjustable="datalim")

    outline = mpe.withStroke(linewidth=lw + 2, foreground="black")
    cmap = plt.get_cmap("tab10")
    history = None if history is None else _np(history)
    if preds is not None:
        preds = _np(preds)
        idxs = np.zeros(len(preds), int) if idxs is None else _np(idxs)
        for idx in np.unique(idxs):
            group = preds[idxs == idx]
            if history is not None:  # prepend last observed point
                last = np.repeat(history[-1][None, None], len(group), axis=0)
                group = np.concatenate([last, group], axis=1)
            group = group * scale
            color = cmap(int(idx))
            for pred in group:
                ax.plot(pred[:, 0], pred[:, 1], color=color, linewidth=lw,
                        path_effects=[outline], zorder=1)
                ax.scatter(pred[-1:, 0], pred[-1:, 1], color=np.array([color]),
                           s=lw * 20, zorder=2, edgecolor="black")
    if gt is not None and not np.isnan(_np(gt)).any():
        g = _np(gt)
        if history is not None:
            g = np.concatenate([history[-1][None], g])
        g = g * scale
        ax.plot(g[:, 0], g[:, 1], "k", zorder=5)
        ax.plot(g[-1, 0], g[-1, 1], "ko", zorder=6)
    if history is not None and plot_hist:
        h = history * scale
        ax.plot(h[:, 0], h[:, 1], hist_color, linewidth=lw, zorder=3, ls=ls)
        ax.scatter(h[-1:, 0], h[-1:, 1], c=hist_color, s=lw * 15, zorder=4,
                   path_effects=[outline])
    return ax


def plot_trajectories_by_idxs_scene(ds, index, preds=None, idxs=None,
                                    image_type="small", ax=None, lw=3):
    """All agents of one dataset window plotted by-index over the scene's
    pyramid image, meters registered to the level's pixels (reference
    ``plot_trajectories_by_idxs_scene``, visualization.py:210-239 — there
    the caller passes img+scale; here they come from the dataset pyramid).

    Args:
        ds: SceneDataset; index: window index.
        preds: optional (P, k, pred_len, 2) samples per agent (meters).
        idxs: optional (P, k) integer color labels (e.g. generator ids).
        image_type: "scaled" | "small" | "tiny" pyramid level.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 10))
    entry = ds.images[ds.scene_names[index]]
    if image_type not in entry:
        raise ValueError(f"'{image_type}' not a valid image_type")
    img = entry[image_type]
    if "m_per_px" in entry:
        m_per_px = entry["m_per_px"][image_type]
    else:
        m_per_px = (1.0 / ds.px_per_meter) * (
            entry["small"].shape[0] / img.shape[0]
        )
    scale = 1.0 / m_per_px

    traj = _np(ds.trajectories[index])  # (P, 20, 2)
    for p in range(len(traj)):
        plot_trajectories_by_idxs_img(
            history=traj[p, :8],
            gt=traj[p, 8:],
            preds=None if preds is None else preds[p],
            idxs=None if idxs is None else idxs[p],
            img=img if p == 0 else None,
            scale=scale,
            ax=ax,
            lw=lw,
        )
    return ax


def plot_manifold_with_preds(manifold, preds, obs=None, ax=None):
    """Overlay a GT manifold with prediction samples colored by membership."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    manifold.plot_manifold(time=None, axes=ax)
    preds = _np(preds)
    inside = manifold.compute_inside(preds)
    for i, p in enumerate(preds):
        ax.plot(p[:, 0], p[:, 1], "-", lw=1,
                color="tab:green" if inside[i] else "tab:red", alpha=0.7)
    if obs is not None:
        obs = _np(obs)
        ax.plot(obs[:, 0], obs[:, 1], "k-", lw=2)
    return ax


def plot_scene_window(ds, index, modes=("in", "gt"), image_type="small",
                      ax=None):
    """Debug plot of one dataset window over its scene-image pyramid level
    (reference BaseTrajectories.plot, BaseTrajectories.py:160-253).

    ds: SceneDataset; index: window index; image_type: "scaled" | "small" |
    "tiny" (pyramid levels of data/parsing.py::build_image_entry).
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    entry = ds.images[ds.scene_names[index]]
    if image_type not in entry:
        raise ValueError(f"'{image_type}' not a valid image_type")
    img = entry[image_type]
    # meters -> pixels of the chosen level (BaseTrajectories.py:168-183).
    # The per-level scales are recorded by build_image_entry; datasets built
    # elsewhere (e.g. synthetic) fall back to the small-image registration.
    if "m_per_px" in entry:
        m_per_px = entry["m_per_px"][image_type]
    else:
        m_per_px = {"small": 1.0 / ds.px_per_meter}.get(image_type)
        if m_per_px is None:  # scaled/tiny: by resolution ratio vs small
            small = entry["small"]
            m_per_px = (1.0 / ds.px_per_meter) * small.shape[0] / img.shape[0]
    scale = 1.0 / m_per_px

    ax.imshow(img)
    traj = _np(ds.trajectories[index]) * scale
    for ped in traj:
        if "in" in modes:
            ax.plot(ped[:8, 0], ped[:8, 1], color="black", marker="o",
                    markersize=2)
        if "gt" in modes and np.isfinite(ped[8:]).all():
            ax.plot(ped[7:, 0], ped[7:, 1], color="red", marker="o",
                    markersize=2)
    return ax
