"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``mggan_tpu_torch/csrc/*.cu`` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library name carries a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so a changed source or header is rebuilt
and an unchanged one is reused. Builds happen at first
use, never at import, into ``mggan_tpu_torch/_build/`` (listed in
``.gitignore``); all sources compile in parallel, one nvcc each. A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of mggan_tpu_torch cannot be built")


def library_path(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; return {stem: path}.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<library>.log``.
    """
    built = {src.stem: library_path(src) for src in sources()}
    todo = [(src, built[src.stem]) for src in sources() if not built[src.stem].exists()]
    if not todo:
        return built
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=fh, stderr=subprocess.STDOUT,
            )
        jobs.append((src, lib, tmp, log, proc))
    failed = []
    for src, lib, tmp, log, proc in jobs:
        if proc.wait() == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src.name}:\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return built


def build_log(stem: str) -> str:
    """nvcc's report for the current build of ``csrc/<stem>.cu``."""
    log = library_path(CSRC_DIR / f"{stem}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(stem: str) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu``, building it if needed."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        _loaded[stem] = lib
    return lib


def warps_per_sm(stem: str, query: str, variant: int, smem_bytes: int) -> int:
    """Resident warps per SM of a kernel variant of ``csrc/<stem>.cu`` at
    ``smem_bytes`` of shared memory a block, from the library's ``query``
    function (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = getattr(load(stem), query)
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    warps = ctypes.c_int(0)
    rc = fn(variant, smem_bytes, ctypes.byref(warps))
    if rc:
        raise RuntimeError(f"{query}({variant}, {smem_bytes}) failed with CUDA error {rc}")
    return warps.value
