"""What the JAX parser takes from OpenCV (``mggan_tpu/data/parsing.py``):
reading a scene JPEG as RGB and resizing it with ``INTER_AREA``.

``resize_area`` is numpy and repeats OpenCV's ``resize(...,
interpolation=INTER_AREA)`` on uint8 images step for step, in its three
regimes (``imgproc/src/resize.cpp``):
  * both factors integers (source = k x destination): box sums, rounded as
    OpenCV rounds them (``(sum + 2) >> 2`` for 2 x 2, else ``sum * (1/k^2)``
    in float32, half to even);
  * any other downscale: per-axis area weights (``computeResizeAreaTab``),
    a row pass then a column pass accumulated in float32 in OpenCV's order;
  * an upscale on either axis: the bilinear fixed-point path with
    INTER_AREA's coefficients (11-bit weights, OpenCV's rounding of the
    column pass).

``read_rgb`` decodes a JPEG with OpenCV where ``cv2`` imports (the JAX
package's own call, so the bytes are the same), else with nvJPEG from the
CUDA toolkit on the card, through the small shim
``native/src/nvjpeg_decode.cpp`` (built with g++ at first use into
``mggan_tpu_torch/_build/``). With neither it raises. ``decoder()`` names
the decoder that ``read_rgb`` uses.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from pathlib import Path

import numpy as np

from mggan_tpu_torch import native

COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


# ------------------------------------------------------------------ resize --
def _area_tab(ssize: int, dsize: int, scale: float):
    """``computeResizeAreaTab``: (destination, source, weight) triples in
    OpenCV's order (by destination, then source)."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tab


def _accumulate(src: np.ndarray, tab, dsize: int, axis: int) -> np.ndarray:
    """Sum ``src`` along ``axis`` into ``dsize`` slots with the table's
    weights in float32, each slot's terms added in the table's order (the
    j-th term of every slot in pass j)."""
    src = np.moveaxis(src, axis, 0)
    out = np.zeros((dsize,) + src.shape[1:], np.float32)
    by_slot = {}
    for d, s, w in tab:
        by_slot.setdefault(d, []).append((s, w))
    for j in range(max(len(v) for v in by_slot.values())):
        d = np.array([k for k, v in by_slot.items() if len(v) > j])
        s = np.array([by_slot[k][j][0] for k in d])
        w = np.array([by_slot[k][j][1] for k in d], np.float32)
        term = src[s] * w.reshape((-1,) + (1,) * (src.ndim - 1))
        out[d] = term if j == 0 else out[d] + term
    return np.moveaxis(out, 0, axis)


def _round_u8(x: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>(float)``: round half to even, then clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _linear_coefs(ssize: int, dsize: int, clamp_last: bool):
    """INTER_AREA's bilinear coefficients on an axis of the upscaling path
    (``resize``'s ``area_mode`` branch): source index and the two 11-bit
    weights. ``clamp_last``: the last source column takes the whole weight
    (OpenCV clamps columns so, and only clamps the row index)."""
    inv_scale = dsize / ssize
    scale = 1.0 / inv_scale
    sx = np.empty(dsize, np.int64)
    alpha = np.empty((dsize, 2), np.int32)
    for dx in range(dsize):
        s = math.floor(dx * scale)
        f = np.float32((dx + 1) - (s + 1) * inv_scale)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if clamp_last and s >= ssize - 1:
            s, f = ssize - 1, np.float32(0.0)
        sx[dx] = s
        c0 = np.float32(1.0) - f
        alpha[dx] = (np.rint(c0 * np.float32(COEF_SCALE)), np.rint(f * np.float32(COEF_SCALE)))
    return sx, alpha


def _resize_linear_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    sx, ax = _linear_coefs(sw, w, True)
    sy, ay = _linear_coefs(sh, h, False)
    src = img.astype(np.int32)  # every product below fits in 32 bits
    # the row pass: where the right tap lies outside the image OpenCV takes
    # the one clamped pixel at full weight (dx >= xmax)
    nxt = np.minimum(sx + 1, sw - 1)
    edge = sx + 1 >= sw
    a0 = np.where(edge, COEF_SCALE, ax[:, 0])
    a1 = np.where(edge, 0, ax[:, 1])
    rows = src[:, sx] * a0[None, :, None] + src[:, nxt] * a1[None, :, None]  # (sh, w, 3)
    r0 = rows[sy]
    r1 = rows[np.minimum(sy + 1, sh - 1)]
    b0 = ay[:, 0][:, None, None]
    b1 = ay[:, 1][:, None, None]
    # VResizeLinear<uchar>: ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2
    out = (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for an
    (H, W) or (H, W, C) uint8 image; ``size`` is (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8 images, got {img.dtype}")
    w, h = int(size[0]), int(size[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"resize_area: bad size {size}")
    gray = img.ndim == 2 or img.shape[2] == 1  # OpenCV returns one channel as (H, W)
    if img.ndim == 2:
        img = img[..., None]
    sh, sw = img.shape[:2]
    if (w, h) == (sw, sh):
        out = img.copy()
    elif w > sw or h > sh:
        out = _resize_linear_area(img, w, h)
    else:
        scale_x, scale_y = sw / w, sh / h
        kx, ky = round(scale_x), round(scale_y)
        if kx == scale_x and ky == scale_y:
            box = img.reshape(h, ky, w, kx, -1).astype(np.int64).sum((1, 3))
            if (kx, ky) == (2, 2):
                out = ((box + 2) >> 2).astype(np.uint8)
            else:
                out = _round_u8(box.astype(np.float32) * np.float32(1.0 / (kx * ky)))
        else:
            src = img.astype(np.float32)
            rows = _accumulate(src, _area_tab(sw, w, scale_x), w, 1)
            out = _round_u8(_accumulate(rows, _area_tab(sh, h, scale_y), h, 0))
    return out[..., 0] if gray else out


# ------------------------------------------------------------------ decode --
def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def decode_cv2(path) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("cv2 does not import")
    img = cv2.imread(str(path))
    if img is None:
        raise OSError(f"cv2 could not read {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


@functools.cache
def _nvjpeg_lib() -> ctypes.CDLL:
    """The nvJPEG shim, built and loaded at first use."""
    inc, libdir = CUDA_HOME / "include", CUDA_HOME / "lib64"
    if not (inc / "nvjpeg.h").is_file():
        raise RuntimeError(f"nvjpeg.h not found under {inc}")
    path = native.build_library(
        native.SRC_DIR / "nvjpeg_decode.cpp", cflags=(f"-I{inc}",),
        ldflags=(f"-L{libdir}", "-lnvjpeg", f"-Wl,-rpath,{libdir}"))
    lib = ctypes.CDLL(str(path))
    lib.mggan_jpeg_size.restype = ctypes.c_int
    lib.mggan_jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mggan_jpeg_decode_rgb.restype = ctypes.c_int
    lib.mggan_jpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_void_p]
    return lib


def decode_nvjpeg(path) -> np.ndarray:
    """Decode a baseline JPEG to (H, W, 3) uint8 RGB with nvJPEG on the
    card; the pixels come back to the host."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("nvJPEG needs a CUDA card; torch.cuda.is_available() is False")
    lib = _nvjpeg_lib()
    data = Path(path).read_bytes()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.mggan_jpeg_size(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise OSError(f"nvjpegGetImageInfo failed on {path} with status {rc}")
    out = torch.empty((h.value, w.value, 3), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream(out.device)
    rc = lib.mggan_jpeg_decode_rgb(data, len(data), out.data_ptr(), 3 * w.value,
                                   stream.cuda_stream)
    if rc != 0:
        raise OSError(f"nvjpegDecode failed on {path} with status {rc}")
    stream.synchronize()
    return out.cpu().numpy()


def decoder() -> str:
    """The decoder ``read_rgb`` uses: "cv2" where cv2 imports, else
    "nvjpeg" where the nvJPEG shim builds and a card is there; raises with
    both reasons otherwise."""
    if _cv2() is not None:
        return "cv2"
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is False")
        _nvjpeg_lib()
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"no JPEG decoder: cv2 does not import, and nvjpeg is not "
                           f"usable ({e})") from e
    return "nvjpeg"


def read_rgb(path) -> np.ndarray:
    """A scene image as (H, W, 3) uint8 RGB (see the module note)."""
    return decode_cv2(path) if decoder() == "cv2" else decode_nvjpeg(path)
