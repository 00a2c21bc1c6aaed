"""Profiler capture and named spans (counterpart of
``mggan_tpu/utils/profiling.py``; the reference has none, only tqdm bars).

``trace`` runs ``torch.profiler`` and writes a Chrome trace (open it in
Perfetto or ``chrome://tracing``). ``span`` names a stage of the program
in such a trace, JAX's ``annotate``: the inference path's stages
(``mggan.predict`` and, under it, ``mggan.inputs``,
``mggan.traj_encoder``, ``mggan.scene_cnn``, ``mggan.social``,
``mggan.pm``, ``mggan.decoder_h0``, ``mggan.rollout``) and the train
loop's (``mggan.train.feed``, ``mggan.train.device_batch``,
``mggan.train.d_step``, ``mggan.train.g_step``, ``mggan.train.pm_step``).
A span is a host range only: the device operations the ops under it
launch are tied to it through the profiler's correlation of each launch
with its op, so the trace's device rows hold device work alone. Without
a profiler a span costs one flag test and calls no dispatcher op, so
nothing of it enters a ``torch.export`` program. JAX's ``StepTimer`` has
no counterpart, as nothing in either package calls it, and neither has
``enable_compilation_cache``: the port compiles no programs (its kernels
are built once by nvcc into ``mggan_tpu_torch/_build``), so
``--compilation_cache_dir`` is dropped by the port's parser
(``config.py``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the block ``name`` in a running profiler's
    trace; with no profiler running, a shared null context.

    The range is a host record function of ``RecordScope::FUNCTION``
    (``torch.profiler.record_function``'s user scope would add a device
    annotation row, which a reader of the device rows would take for
    device work)."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


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

