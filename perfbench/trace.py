"""The benchmark's own profiler window and the reduction of its events
to what the per-layer metrics read. The reduction is a copy of the
program's `annotation_split` / `device_events` arithmetic over the raw
Kineto events (seconds to read, where `prof.events()` takes minutes),
kept here so that a change to the program's copy cannot move the
yardstick. No Chrome trace is written."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

# a device idle gap shorter than this is not labelled in the breakdown
MIN_GAP_NS = 2_000


@contextlib.contextmanager
def profiled():
    """A torch.profiler window over the body (CPU activity, and CUDA
    where there is a card). Yields the profiler; read it after the
    body."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def raw_events(prof) -> List[tuple]:
    """(device event?, annotation?, name, start ns, duration ns,
    correlation id, linked correlation id, device index) of every Kineto
    event of a finished window."""
    from torch.autograd import DeviceType

    return [(e.device_type() != DeviceType.CPU, e.is_user_annotation(), e.name(),
             e.start_ns(), e.duration_ns(), e.correlation_id(), e.linked_correlation_id(),
             e.device_index())
            for e in prof.profiler.kineto_results.events()]


def device_events(events) -> List[Tuple[str, int, int, int]]:
    """(name, start ns, duration ns, device) of every kernel, copy and
    set the device ran, without the device-side spans of annotations."""
    return [(e[2], e[3], e[4], e[7]) for e in events if e[0] and not e[1]]


def host_ranges(events) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of the program's annotation ranges on the
    host, by start."""
    return sorted((e[3], e[3] + e[4], e[2]) for e in events
                  if not e[0] and e[1] and e[6] == 0)


def annotation_split(events) -> Dict[str, Dict[str, float]]:
    """Per annotation name: the number of ranges and the host and device
    milliseconds under them. A kernel counts under every range open on
    the host when the operator that launched it started."""
    ranges, op_start, kernels = [], {}, []
    for dev, ann, name, start, dur, corr, linked, _ in events:
        if dev:
            if not ann:
                kernels.append((linked, dur))
        elif linked == 0:
            op_start[corr] = start
            if ann:
                ranges.append((start, start + dur, name))
    out = {name: {"count": 0, "host_ms": 0.0, "device_ms": 0.0} for _, _, name in ranges}
    for start, end, name in ranges:
        out[name]["count"] += 1
        out[name]["host_ms"] += (end - start) / 1e6
    ranges.sort()
    launches = sorted((op_start[c], dur) for c, dur in kernels if c in op_start)
    open_ranges, i = [], 0
    for t, dur in launches:
        while i < len(ranges) and ranges[i][0] <= t:
            open_ranges.append(ranges[i])
            i += 1
        open_ranges = [r for r in open_ranges if r[1] >= t]
        for _, _, name in open_ranges:
            out[name]["device_ms"] += dur / 1e6
    return out


def busy_intervals(dev_events, device) -> List[Tuple[int, int]]:
    """The union of one device's event intervals, as sorted disjoint
    (start, end) pairs in ns."""
    out: List[List[int]] = []
    for a, b in sorted((s, s + d) for _, s, d, dv in dev_events if dv == device):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(intervals) -> int:
    return sum(b - a for a, b in intervals)


def top_device_ops(dev_events, n=10):
    """[name, seconds] of the n device operations with the most time,
    summed over launches and devices."""
    by_name: Dict[str, int] = {}
    for name, _, dur, _ in dev_events:
        by_name[name] = by_name.get(name, 0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], ns / 1e9] for name, ns in top]


def idle_gaps_by_range(intervals, ranges, window, n=10):
    """[range name, seconds] of the device's idle time inside `window`
    (start, end ns), each gap charged to the innermost program range
    open on the host when it began ("(outside any range)" if none); the
    n names with the most."""
    w0, w1 = window
    gaps = []
    prev = w0
    for a, b in intervals:
        if a > prev:
            gaps.append((prev, min(a, w1)))
        prev = max(prev, b)
    if prev < w1:
        gaps.append((prev, w1))
    gaps = [(a, b) for a, b in gaps if b - a >= MIN_GAP_NS]
    by_name: Dict[str, int] = {}
    open_ranges: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in gaps:
        while i < len(ranges) and ranges[i][0] <= a:
            open_ranges.append(ranges[i])
            i += 1
        open_ranges = [r for r in open_ranges if r[1] > a]
        name = open_ranges[-1][2] if open_ranges else "(outside any range)"
        by_name[name] = by_name.get(name, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]
