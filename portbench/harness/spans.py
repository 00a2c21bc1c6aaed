"""Each device operation and each idle gap of a traced stretch, tied to the
program's span that caused it (``mggan_tpu_torch/utils/profiling.py::span``,
host ranges named ``mggan.*``).

A device operation belongs to the host operation that launched it: the
profiler links the two (``links``: the operation's ``id``, its CUDA
correlation, to that host operation's ``id``). From there it belongs to the innermost span
above that operation (``cpu_parent``) and to every span above that one.
Where the link reaches no host operation, the launch call itself (the
runtime event, ``cudaLaunchKernel`` and its kin, with the operation's
``id``) is placed in the innermost span that holds its start: by time
alone, as the profiler numbers a runtime event's thread by the system's
count and a host operation's by its own. What neither finds belongs to no
span. The device rows that ``torch.profiler.record_function`` adds for its
user annotations are not device work and are left out.

An idle gap lies between two intervals of the busy union (or before the
first or after the last, up to the stretch's host events, as
``trace.summarize`` counts them). It belongs to the innermost span that
holds its midpoint, and to every span above that one, or to none.
Times are in seconds.
"""

from __future__ import annotations

from collections import defaultdict

NONE = "(none)"


def _is_runtime(ev) -> bool:
    """A call into CUDA's runtime or its lower API (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return ev.name.startswith("cu")


def _merge(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def union_s(intervals) -> float:
    """The seconds the union of ``intervals`` (microseconds) covers."""
    return sum(e - s for s, e in _merge(intervals)) / 1e6


def _innermost(candidates, t):
    """The shortest of ``candidates`` that holds the time ``t``, or None."""
    best = None
    for ev in candidates:
        s, e = ev.time_range.start, ev.time_range.end
        if s <= t <= e:
            if best is None or e - s < best.time_range.end - best.time_range.start:
                best = ev
    return best


def links(prof) -> dict:
    """Each device operation's ``id`` to the ``id`` of the host operation
    that launched it, from the profiler's raw results: a ``FunctionEvent``
    carries the link itself only from PyTorch 2.13 on."""
    from torch.autograd import DeviceType

    return {ev.correlation_id(): ev.linked_correlation_id()
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA and ev.linked_correlation_id() > 0}


def attribute(events, linked: dict, prefix: str = "mggan.") -> dict:
    """The stretch's ``events`` (``prof.events()``) by span, each device
    operation's host operation found through ``linked`` (``links``).

    Returns ``device``: ``(name, start, end, spans)`` for each device
    operation, ``spans`` the names of the spans it belongs to, innermost
    first (empty for none); ``busy_s``; ``spans``: for each span name its
    ``device_s`` (the union of its operations' intervals, those of the
    spans under it included), ``self_device_s`` (those it holds innermost
    alone), ``host_s`` (its host ranges' total) and ``count`` (its
    instances); ``idle_by_span``: the idle seconds each span holds (those of
    the spans under it included), and under ``NONE`` those outside every
    span; ``gaps``: ``(seconds, start, spans)`` for every idle gap, longest
    first."""
    from torch.autograd import DeviceType

    host = [ev for ev in events if ev.device_type == DeviceType.CPU]
    device = [ev for ev in events
              if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation]
    marks = [ev for ev in host if ev.name.startswith(prefix)]
    ops = {ev.id: ev for ev in host if not _is_runtime(ev)}
    launches = {ev.id: ev for ev in host if _is_runtime(ev)}

    def chain(ev):
        """The names of the spans at and above the host event ``ev``."""
        names = []
        while ev is not None:
            if ev.name.startswith(prefix):
                names.append(ev.name)
            ev = ev.cpu_parent
        return tuple(names)

    placed = []
    for ev in device:
        op = ops.get(linked[ev.id]) if ev.id in linked else None
        if op is not None:
            names = chain(op)
        else:
            launch = launches.get(ev.id)
            mark = None if launch is None else _innermost(marks, launch.time_range.start)
            names = chain(mark) if mark is not None else ()
        placed.append((ev.name, ev.time_range.start, ev.time_range.end, names))

    spans = {}
    for ev in marks:
        rec = spans.setdefault(ev.name, {"device_s": 0.0, "self_device_s": 0.0,
                                         "host_s": 0.0, "count": 0})
        rec["host_s"] += (ev.time_range.end - ev.time_range.start) / 1e6
        rec["count"] += 1
    inclusive, own = defaultdict(list), defaultdict(list)
    for _, s, e, names in placed:
        if names:
            own[names[0]].append((s, e))
        for name in set(names):
            inclusive[name].append((s, e))
    for name, rec in spans.items():
        rec["device_s"] = union_s(inclusive[name])
        rec["self_device_s"] = union_s(own[name])

    merged = _merge([(s, e) for _, s, e, _ in placed])
    gaps, idle = [], defaultdict(float)
    if merged and host:
        first = min(ev.time_range.start for ev in host)
        last = max(max(ev.time_range.end for ev in host), merged[-1][1])
        edges = [first] + [x for s, e in merged for x in (s, e)] + [last]
        for i in range(0, len(edges) - 1, 2):
            start, length = edges[i], edges[i + 1] - edges[i]
            if length <= 0:
                continue
            mark = _innermost(marks, start + length / 2)
            names = chain(mark) if mark is not None else ()
            gaps.append((length / 1e6, start, names))
            for name in set(names) or (NONE,):
                idle[name] += length / 1e6
    gaps.sort(key=lambda g: -g[0])
    return {"device": placed, "busy_s": sum(e - s for s, e in merged) / 1e6,
            "spans": spans, "idle_by_span": dict(idle), "gaps": gaps}


def name_gaps(events, gaps, top: int = 10) -> list:
    """The ``top`` longest of ``attribute``'s ``gaps``, each named by its
    innermost span and the innermost host operation at its midpoint
    (``"mggan.inputs / aten::to"``), beside its seconds."""
    from torch.autograd import DeviceType

    host = [ev for ev in events if ev.device_type == DeviceType.CPU]
    out = []
    for seconds, start, names in gaps[:top]:
        op = _innermost(host, start + seconds * 1e6 / 2)
        out.append([f"{names[0] if names else NONE} / "
                    f"{op.name if op is not None else '(no host operation)'}", seconds])
    return out
