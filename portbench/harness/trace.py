"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler`` session
over a fixed number of steps or calls inside the window, and what the
per-layer metrics read from it.

The device is busy where at least one device operation runs: the union of
the operations' intervals, so two that overlap count once. An idle gap is
named by the innermost host operation that was running at its midpoint.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Tracer:
    """Profiles calls ``skip`` to ``skip + units - 1`` of a wrapped
    callable, from a synchronize before the first to one after the last."""

    def __init__(self, skip: int, units: int, device):
        self.skip, self.units, self.device = skip, units, device
        self.calls = 0
        self.prof = None
        self.window_s = None
        self.args = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, fn):
        def traced(*args, **kwargs):
            i = self.calls
            self.calls += 1
            if i == self.skip:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                self._sync()
                self.prof = profile(activities=acts)
                self.prof.__enter__()
                self._t0 = time.perf_counter()
            if self.skip <= i < self.skip + self.units:
                self.args.append(args)
            out = fn(*args, **kwargs)
            if i == self.skip + self.units - 1:
                self._sync()
                self.window_s = time.perf_counter() - self._t0
                self.prof.__exit__(None, None, None)
            return out

        return traced

    def reading(self):
        """The stretch's summary, or None when the window ended first."""
        if self.window_s is None:
            return None
        return summarize(self.prof, self.window_s)


def _merge(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def summarize(prof, window_s: float) -> dict:
    """Device operations (name, start, end in microseconds), their busy
    union, the window, the ten largest operations by time and the ten
    longest idle gaps by the host operation they fell in."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            device.append((ev.name, *span))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.name, *span))
    merged = _merge([(s, e) for _, s, e in device])
    busy_us = sum(e - s for s, e in merged)
    by_name = defaultdict(float)
    for name, s, e in device:
        by_name[name] += (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    if merged and host:
        first = min(s for _, s, _ in host)
        last = max(e for _, _, e in host)
        edges = [first] + [x for s, e in merged for x in (s, e)] + [max(last, merged[-1][1])]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        inside = [(e - s, name) for name, s, e in host if s <= mid <= e]
        named.append([min(inside)[1] if inside else "(no host operation)", length / 1e6])
    return {"device": device, "busy_s": busy_us / 1e6, "window_s": window_s,
            "device_ops": [[name[:120], secs] for name, secs in top], "idle_gaps": named}
