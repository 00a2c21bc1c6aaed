"""The port's native host-side data ops (counterpart of
``mggan_tpu/native/__init__.py``), bound with ctypes.

``src/host_ops.cpp`` (a copy of the JAX package's source) is compiled with
g++ at first use into ``mggan_tpu_torch/_build/``, never next to the source
and never at import. A failed build or load raises: unlike the JAX package,
the port does not drop silently to numpy. The numpy version of each op
stays beside its binding as the plain reference (``*_reference``): the
tests and ``chip_smoke.py`` compare with it, and the data path never calls
it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# No -march=native: a library built on one host may be loaded on another.
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path(src: Path, cflags=(), ldflags=()) -> Path:
    """Where ``build_library`` puts ``src``'s library: the name carries a
    hash of the source and the flags, so a changed source is rebuilt."""
    key = src.read_bytes() + " ".join((*GXX_FLAGS, *cflags, *ldflags)).encode()
    return BUILD_DIR / f"lib{src.stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_library(src: Path, cflags=(), ldflags=()) -> Path:
    """Compile ``src`` with g++ into ``BUILD_DIR`` unless its library is
    there already, and return the library's path.

    Concurrent builds each write a temporary file and rename it into
    place. A failed build raises with g++'s output.
    """
    lib = library_path(src, cflags, ldflags)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; {src.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, *cflags, str(src), "-o", str(tmp), *ldflags],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The host-op library, built and loaded at first use."""
    lib = ctypes.CDLL(str(build_library(SRC_DIR / "host_ops.cpp")))
    u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
    lib.parse_numeric_txt.restype = ctypes.c_int64
    lib.parse_numeric_txt.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_int64]
    lib.extract_patches.restype = None
    lib.extract_patches.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
                                    ctypes.c_int64, ctypes.c_int64, u8p]
    lib.window_presence.restype = ctypes.c_int64
    lib.window_presence.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, u8p]
    return lib


# ------------------------------------------------------- parse_numeric_txt --
def parse_numeric_txt(path):
    """Every number of a whitespace-, tab- or comma-delimited text file, in
    order, as a 1D float64 array; None when the file holds a non-numeric
    token (the caller then reads it as a delimited table)."""
    size = Path(path).stat().st_size
    # a value takes at least two bytes (one digit and one delimiter), but
    # for the last
    max_vals = max(size // 2 + 16, 64)
    out = np.empty(max_vals, np.float64)
    n = load().parse_numeric_txt(str(path).encode(),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_vals)
    if n == -2:
        return None
    if n < 0:
        raise OSError(f"parse_numeric_txt({path}) failed with code {n}")
    return out[:n]


_DELIMS = re.compile(r"[ \t,\n\r]+")


def parse_numeric_txt_reference(path):
    """The plain version of ``parse_numeric_txt`` (Python's ``float`` for
    C's ``strtod``: decimal and exponent forms, inf and nan)."""
    vals = []
    for tok in _DELIMS.split(Path(path).read_bytes().decode("latin-1")):
        if not tok:
            continue
        if "_" in tok:  # float() takes digit separators, strtod does not
            return None
        try:
            vals.append(float(tok))
        except ValueError:
            return None
    return np.asarray(vals, np.float64)


# --------------------------------------------------------- extract_patches --
def extract_patches(img: np.ndarray, centers: np.ndarray, margin: int) -> np.ndarray:
    """(H, W, 3) uint8 + (n, 2) integer (x, y) centres -> (n, side, side, 3)
    uint8 crops, side = 2 * margin + 1, zero outside the image."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"extract_patches takes an (H, W, 3) image, got {img.shape}")
    cx = np.ascontiguousarray(centers[:, 0], np.int64)
    cy = np.ascontiguousarray(centers[:, 1], np.int64)
    side = 2 * margin + 1
    out = np.empty((len(cx), side, side, 3), np.uint8)
    u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
    load().extract_patches(img.ctypes.data_as(u8p), img.shape[0], img.shape[1],
                           cx.ctypes.data_as(i64p), cy.ctypes.data_as(i64p), len(cx),
                           margin, out.ctypes.data_as(u8p))
    return out


def extract_patches_reference(img: np.ndarray, centers: np.ndarray, margin: int) -> np.ndarray:
    """The plain version of ``extract_patches`` (the JAX package's numpy
    crop loop, ``mggan_tpu/data/dataset.py``)."""
    h, w = img.shape[:2]
    side = 2 * margin + 1
    cx = centers[:, 0].astype(np.int64)
    cy = centers[:, 1].astype(np.int64)
    out = np.zeros((len(cx), side, side, 3), np.uint8)
    for i in range(len(cx)):
        x0, y0 = cx[i] - margin, cy[i] - margin
        sx0, sy0 = max(x0, 0), max(y0, 0)
        sx1, sy1 = min(x0 + side, w), min(y0 + side, h)
        if sx1 > sx0 and sy1 > sy0:
            out[i, sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


# --------------------------------------------------------- window_presence --
def num_windows(frames: int, seq_len: int, skip: int) -> int:
    return (frames - seq_len) // skip + 1 if frames >= seq_len else 0


def window_presence(present: np.ndarray, seq_len: int, skip: int = 1) -> np.ndarray:
    """(P, F) presence -> (num_windows, P) uint8: 1 where ped p is present in
    all ``seq_len`` frames of the window starting at frame ``w * skip``."""
    present = np.ascontiguousarray(present, np.uint8)
    p, f = present.shape
    keep = np.zeros((num_windows(f, seq_len, skip), p), np.uint8)
    if len(keep):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        load().window_presence(present.ctypes.data_as(u8p), p, f, seq_len, skip,
                               keep.ctypes.data_as(u8p))
    return keep


def window_presence_reference(present: np.ndarray, seq_len: int, skip: int = 1) -> np.ndarray:
    """The plain version of ``window_presence`` (prefix sums in numpy)."""
    p, f = present.shape
    starts = np.arange(num_windows(f, seq_len, skip)) * skip
    cs = np.concatenate([np.zeros((p, 1), np.int64), np.cumsum(present, 1)], axis=1)
    return ((cs[:, starts + seq_len] - cs[:, starts]) == seq_len).T.astype(np.uint8)
