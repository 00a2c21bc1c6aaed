"""BIWI homography matrices and world<->pixel warp utilities (counterpart
of ``mggan_tpu/data/homography.py``, copied: numpy only).

Reference: ``mggan/data_utils/experiments.py`` — the per-scene 3x3 ``H``
matrices on the BiWi dataset classes (experiments.py:376-473) and the
``world2pixel`` / ``warp_obstacle`` helpers (experiments.py:88-150). They
are data tooling (unused by train/eval — BIWI images pass through unscaled,
BaseTrajectories.py:93-96) but part of the reference's surface.

Differences from the reference, by design:
* transforms are vectorized (one matmul) instead of per-row loops;
* image warping (``warp_image``) is a numpy bilinear inverse-map instead of
  ``cv2.warpPerspective`` (cv2 is not a dependency here).
"""

from __future__ import annotations

import numpy as np

# 3x3 pixel->world homographies (experiments.py:376-473, verbatim constants).
BIWI_HOMOGRAPHY = {
    "eth": np.array(
        [
            [2.8128700e-02, 2.0091900e-03, -4.6693600e00],
            [8.0625700e-04, 2.5195500e-02, -5.0608800e00],
            [3.4555400e-04, 9.2512200e-05, 4.6255300e-01],
        ]
    ),
    "hotel": np.array(
        [
            [1.1048200e-02, 6.6958900e-04, -3.3295300e00],
            [-1.5966000e-03, 1.1632400e-02, -5.3951400e00],
            [1.1190700e-04, 1.3617400e-05, 5.4276600e-01],
        ]
    ),
    "univ": np.array(
        [
            [0.032529736503653, -0.000730604859308, -7.969749046103707],
            [0.000883577230612, 0.026589331317173, -8.754694531864281],
            [0.001039809003515, 0.000025010101498, 1.007920696981254],
        ]
    ),
    "zara1": np.array(
        [
            [-2.59600906e-02, -4.14338866e-07, 7.83994785e00],
            [-1.08705701e-03, 2.16676796e-02, 5.56418836e00],
            [6.05674393e-07, -8.00267888e-08, 1.00000000e00],
        ]
    ),
    "zara2": np.array(
        [
            [-2.5956517e-02, -5.1572804e-18, 7.8388681e00],
            [-1.0953874e-03, 2.1664330e-02, -1.0032272e01],
            [1.9540125e-20, 4.2171410e-19, 1.0000000e00],
        ]
    ),
}


def apply_homography(points: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Projective transform of (..., 2) points: [x y 1] @ H^T, dehomogenized
    (vectorized form of experiments.py:88-97's per-row loop)."""
    pts = np.asarray(points, np.float64)
    ones = np.ones(pts.shape[:-1] + (1,))
    homo = np.concatenate([pts, ones], axis=-1) @ np.asarray(h).T
    return homo[..., :2] / homo[..., 2:3]


def pixel_to_world(points_px: np.ndarray, scene: str) -> np.ndarray:
    """Pixel -> world meters via the scene's H (the stored direction)."""
    return apply_homography(points_px, BIWI_HOMOGRAPHY[scene])


def world_to_pixel(points_m: np.ndarray, scene: str) -> np.ndarray:
    """World meters -> pixel via H^-1 (experiments.py:88-97 world2pixel)."""
    return apply_homography(points_m, np.linalg.inv(BIWI_HOMOGRAPHY[scene]))


def warp_image(
    img: np.ndarray,
    h: np.ndarray,
    out_wh: tuple[int, int],
    border_value: float = 255.0,
) -> np.ndarray:
    """Perspective-warp ``img`` by homography ``h`` into (W, H) output.

    Equivalent role to ``cv2.warpPerspective`` in the reference's
    ``warp_obstacle`` (experiments.py:99-150): output pixel (x, y) samples
    the source at H^-1 (x, y, 1), bilinear, out-of-bounds = border_value.
    """
    w, hh = out_wh
    ys, xs = np.mgrid[0:hh, 0:w].astype(np.float64)
    src = apply_homography(
        np.stack([xs.ravel(), ys.ravel()], axis=-1), np.linalg.inv(h)
    )
    sx, sy = src[:, 0], src[:, 1]

    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    ih, iw = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < ih) & (xx >= 0) & (xx < iw)
        vals = img[np.clip(yy, 0, ih - 1), np.clip(xx, 0, iw - 1)]
        return np.where(inside[:, None], vals, border_value)

    out = (
        tap(y0, x0) * (1 - fx) * (1 - fy)
        + tap(y0, x0 + 1) * fx * (1 - fy)
        + tap(y0 + 1, x0) * (1 - fx) * fy
        + tap(y0 + 1, x0 + 1) * fx * fy
    )
    out = out.reshape(hh, w, -1)
    return out[..., 0] if out.shape[-1] == 1 else out
