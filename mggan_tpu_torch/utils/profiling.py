"""Profiler capture (counterpart of ``mggan_tpu/utils/profiling.py``; the
reference has none, only tqdm bars).

``trace`` runs ``torch.profiler`` and writes a Chrome trace (open it in
Perfetto or ``chrome://tracing``); name a region in it with
``torch.profiler.record_function``. JAX's ``StepTimer`` and ``annotate``
have no counterpart, as nothing in either package calls them, and
neither has ``enable_compilation_cache``: the port compiles no programs
(its kernels are built once by nvcc into ``mggan_tpu_torch/_build``), so
``--compilation_cache_dir`` is dropped by the port's parser
(``config.py``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with CPU activity, and CUDA activity where a card
    is present, and write the Chrome trace into ``log_dir`` as
    ``trace_<time_ns>.json`` when the block ends. Yields the profiler;
    ``prof.trace_path`` names the file once the block has ended. Work the
    block queued on the card is traced once it has run: synchronise before
    the block ends."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = log_dir / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))

