"""File ingestion: txt parsing, windowing, image pyramid, big-patch crops
(counterpart of ``mggan_tpu/data/parsing.py``).

The reference's eager per-file Python windowing
(trajectories_scene.py:125-201, BaseTrajectories.py:70-155) becomes
vectorised numpy: the 20-frame sliding windows and the full-presence filter
come from a presence matrix instead of per-ped loops. The native host ops
(``mggan_tpu_torch/native``) parse numeric files, compute the keep matrix
and crop the patches. Neither pandas nor OpenCV is needed: delimited rows
with strings go through ``data/table.py``, and the scene images through
``data/image_io.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mggan_tpu_torch import native
from mggan_tpu_torch.config import OBS_LEN
from mggan_tpu_torch.data import image_io, registry, table
from mggan_tpu_torch.data.dataset import SEQ_LEN, SceneDataset, extract_big_patches


def _subsample(out: np.ndarray, info: registry.DatasetInfo) -> np.ndarray:
    """Keep frames with ``frame % round(framerate * 0.4) == 0`` and renumber
    them (BaseTrajectories.py:145-147)."""
    if info.framerate is None:
        return out
    step = int(round(info.framerate * 0.4))
    out = out[out[:, 0] % step == 0].copy()
    out[:, 0] = out[:, 0] // step
    return out


def _load_txt_native(path, info: registry.DatasetInfo):
    """The C++ tokenizer's path for fully numeric files (BIWI, GOFP); None
    when the dataset filters rows on a string column (SDD) or the file has
    non-numeric tokens."""
    if info.row_filters:
        return None
    flat = native.parse_numeric_txt(path)
    ncol = len(info.data_columns)
    if flat is None or len(flat) % ncol != 0:
        return None
    arr = flat.reshape(-1, ncol)
    cols = {c: i for i, c in enumerate(info.data_columns)}
    take = [cols["frame"], cols["ID"], cols["x"], cols["y"]]
    if "is_active" in cols:
        take.append(cols["is_active"])
    return _subsample(arr[:, take], info)


def load_txt(path: Path, info: registry.DatasetInfo) -> np.ndarray:
    """-> float64 array with columns (frame, ID, x, y[, is_active]).

    Applies row filters (SDD label/lost), frame subsampling for datasets with
    a framerate, and the BIWI y/x column swap (the registry names the BIWI
    file's columns (frame, ID, y, x)).
    """
    fast = _load_txt_native(path, info)
    if fast is not None:
        return fast
    cols = table.read_table(path, info.delim, names=info.data_columns)
    keep = np.ones(len(next(iter(cols.values()), ())), bool)
    for col, val in info.row_filters.items():
        if col in cols:
            keep &= table.equals(cols[col], val)
    names = ["frame", "ID", "x", "y"] + (["is_active"] if "is_active" in cols else [])
    out = np.stack([np.asarray(cols[c][keep], np.float64) for c in names], axis=1)
    return _subsample(out, info)


def window_scene(data: np.ndarray, skip: int = 1, seq_len: int = SEQ_LEN,
                 inclusive: bool = False):
    """Slide ``seq_len``-frame (default 20) windows; keep peds present in all
    consecutive frames (trajectories_scene.py:149-181).

    Args:
        data: (rows, 4|5) (frame, ID, x, y[, is_active]).
        seq_len: window length; ``seq_len=OBS_LEN`` yields observation-only
            windows (no futures in the file).
        inclusive: count windows as ``floor((F-L)/skip)+1`` (so a file with
            exactly ``seq_len`` frames yields one window) and, when ``F-L``
            is not a multiple of ``skip``, append one clamped window at
            start ``F-L``, so the window ending at the newest frame is always
            produced. The default ``ceil((F-L)/skip)`` reproduces the
            reference's training-window count (trajectories_scene.py:156),
            which drops that final window.

    Returns:
        list of (xy (n, seq_len, 2) float32 [NaN future if inactive],
        ped_ids (n,)).
    """
    if len(data) == 0:
        return []
    frames = np.unique(data[:, 0])
    ids = np.unique(data[:, 1])
    fi = np.searchsorted(frames, data[:, 0])
    pi = np.searchsorted(ids, data[:, 1])

    nf, np_ = len(frames), len(ids)
    pos = np.full((np_, nf, 2), np.nan, np.float32)
    active = np.ones((np_, nf), bool)
    pos[pi, fi] = data[:, 2:4]
    if data.shape[1] == 5:
        active[pi, fi] = data[:, 4] != 0
    present = np.zeros((np_, nf), bool)
    present[pi, fi] = True

    if nf < seq_len:
        num_seq = 0
    elif inclusive:
        num_seq = (nf - seq_len) // skip + 1
    else:
        num_seq = int(np.ceil((nf - seq_len) / skip))
    if num_seq <= 0:
        return []

    starts = np.arange(num_seq) * skip
    keep = native.window_presence(present, seq_len, skip)[:num_seq].astype(bool)
    # inclusive + skip > 1: one clamped final start at F-L when the strided
    # grid misses it, so the newest-frame window is always produced
    if inclusive and (nf - seq_len) % skip != 0:
        starts = np.append(starts, nf - seq_len)
        tail = present[:, nf - seq_len:].all(axis=1)
        keep = np.concatenate([keep, tail[None]], axis=0)

    # consecutive-frame requirement: window frames must be contiguous ints
    gapsum = np.concatenate([[0], np.cumsum(np.diff(frames) != 1)])

    out = []
    for w, start in enumerate(starts):
        if gapsum[start + seq_len - 1] != gapsum[start]:
            continue
        if not keep[w].any():
            continue
        sel = np.where(keep[w])[0]
        xy = pos[sel, start: start + seq_len].copy()
        inactive = ~active[sel, start: start + seq_len].all(axis=1)
        xy[inactive, OBS_LEN:] = np.nan  # trajectories_scene.py:171-175
        out.append((xy, ids[sel].astype(np.int64)))
    return out


def build_image_entry(img: np.ndarray, info: registry.DatasetInfo, ratio: float):
    """Scene-image pyramid entry (BaseTrajectories.py:70-121): rescale to the
    canonical ``img_scaling`` m/px 'scaled' image, then to the patch
    ('small') image at ``scaling_small`` m/px and the debug ('tiny') image
    at ``scaling_tiny`` m/px."""
    if info.homography != "none":
        scale_factor = ratio / info.img_scaling
        new_size = (int(round(img.shape[1] * scale_factor)),
                    int(round(img.shape[0] * scale_factor)))
        scaled = image_io.resize_area(img, new_size)
    else:
        scale_factor = 1.0
        scaled = img

    def down(src, m_per_px):
        f = info.img_scaling / m_per_px
        size = (max(int(round(src.shape[1] * f)), 1), max(int(round(src.shape[0] * f)), 1))
        return image_io.resize_area(src, size)

    return {
        "ratio": ratio,
        "scale_factor": scale_factor,
        "scaled": scaled,
        "small": down(scaled, info.scaling_small),
        "tiny": down(scaled, info.scaling_tiny),
        "m_per_px": {"scaled": info.img_scaling, "small": info.scaling_small,
                     "tiny": info.scaling_tiny},
    }


def load_scene_dataset(name: str, phase: str, data_root="./data/datasets",
                       skip: int = 1) -> SceneDataset:
    """Full ingestion for one dataset/phase directory.

    Directory layout (reference README + experiments.py): txt files named
    ``<phase>_<scene>.txt`` (anything before the first underscore is
    dropped, trajectories_scene.py:135) and scene images ``<scene>.jpg``
    (``<scene>-op.jpg`` occupancy variants are skipped).
    """
    info = registry.get_info(name)
    d = registry.phase_dir(data_root, name, phase)
    if not d.is_dir():
        raise FileNotFoundError(
            f"dataset dir {d} not found — download the reference data release "
            f"into {Path(data_root) / name}"
        )

    ratios = {}
    if info.homography == "sdd_csv":
        ratios = registry.load_sdd_ratios(data_root, name)
    elif info.homography == "gofp_table":
        ratios = dict(registry.GOFP_RATIOS)

    images = {}
    for img_path in sorted(d.glob("*.jpg")):
        scene = img_path.stem
        if scene.endswith("-op"):
            continue  # occupancy variants unused (load_occupancy=False)
        images[scene] = build_image_entry(image_io.read_rgb(img_path), info,
                                          ratios.get(scene, 1.0))
    if not images:
        raise AssertionError(f"No valid images in folder {d}")

    trajs, names, ped_ids, patch_list = [], [], [], []
    for txt in sorted(d.glob("*.txt")):
        scene = "_".join(txt.stem.split("_")[1:]) or txt.stem
        if scene not in images:
            continue
        entry = images[scene]
        for xy, pids in window_scene(load_txt(txt, info), skip=skip):
            xy_m = xy.copy()
            if info.scale:
                xy_m *= entry["scale_factor"]  # scale_func
            if info.norm2meters:
                xy_m *= info.img_scaling  # scale2meters
            trajs.append(xy_m)
            names.append(scene)
            ped_ids.append(pids)
            centers = xy_m[:, OBS_LEN - 1] / info.scaling_small
            patch_list.append(extract_big_patches(entry["small"], centers))

    return SceneDataset(
        dataset_name=name,
        trajectories=trajs,
        scene_names=names,
        images=images,
        big_patches=patch_list,
        format="meter" if (info.fmt == "meter" or info.norm2meters) else info.fmt,
        px_per_meter=1.0 / info.scaling_small,
        ped_ids=ped_ids,
    )


def filter_split(ds: SceneDataset, split: str) -> SceneDataset:
    """Upper/lower intersection filter for the synthetic SDD sets
    (data_loaders.py:40-64): keep windows where any ped's position at the
    first prediction step has y > 16 (lower) / <= 16 (upper)."""
    keep = []
    for i, traj in enumerate(ds.trajectories):
        y8 = traj[:, OBS_LEN, 1]
        sel = (y8 > 16.0) if split == "lower" else (y8 <= 16.0)
        if np.any(sel):
            keep.append(i)
    return SceneDataset(
        dataset_name=ds.dataset_name,
        trajectories=[ds.trajectories[i] for i in keep],
        scene_names=[ds.scene_names[i] for i in keep],
        images=ds.images,
        big_patches=[ds.big_patches[i] for i in keep] if ds.big_patches else None,
        format=ds.format,
        px_per_meter=ds.px_per_meter,
        ped_ids=[ds.ped_ids[i] for i in keep] if ds.ped_ids else None,
    )
