"""Tracing and profiling (the counterpart of tpurt/utils/profiling.py).

- `trace(log_dir)`: a torch.profiler run (CPU activity, and the card's
  when there is one) that writes a Chrome trace (`*.json`) into
  `log_dir`; open it in Perfetto or chrome://tracing.
- `annotate(name)`: a named range in that trace
  (`torch.profiler.record_function`), and an NVTX range once the process
  has a CUDA context. The integrator opens them under tpurt's own
  `jax.named_scope` names, and one `wave{k}` range per pass of its host
  wave loop, so a trace splits a sample's host and device time by
  integrator phase and by wave.
- `KernelTimer`: wall-clock phase timers that wait for the card.
- `render_stats`: one timed and ray-counted progressive sample.

tpurt's `enable_compilation_cache` configures XLA's persistent cache and
has no counterpart: the port's kernels are built once per checkout by
nvcc (kernels/cudalib.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the body; the Chrome trace is written to
    `log_dir/trace_<pid>_<time>.json` when the body ends. Yields the
    profiler, for `annotation_split` and `device_events` after the body."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in profiler traces (tpurt's TraceAnnotation); also
    an NVTX range when the process has a CUDA context. Costs a few
    microseconds when no profiler runs."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@dataclasses.dataclass
class PhaseStat:
    calls: int = 0
    seconds: float = 0.0


def _wait_for(obj) -> None:
    """Wait for the card to finish the work behind every CUDA tensor in
    `obj` (a tensor, or a tuple, list or dict of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _wait_for(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _wait_for(v)


class KernelTimer:
    """Wall-clock phase timers: `with timer.phase("intersect"): ...`.
    With `block_on`, waits for the card to finish that result before
    reading the clock, so a timing is execution time, not launch time."""

    def __init__(self):
        self.stats: Dict[str, PhaseStat] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            st = self.stats.setdefault(name, PhaseStat())
            st.calls += 1
            st.seconds += time.perf_counter() - t0

    def report(self) -> str:
        lines = []
        for name, st in sorted(self.stats.items(), key=lambda kv: -kv[1].seconds):
            lines.append(f"{name:24s} {st.seconds:9.3f}s over {st.calls} calls "
                         f"({st.seconds / max(st.calls, 1) * 1e3:8.2f} ms/call)")
        return "\n".join(lines)

    def mrays_per_sec(self, name: str, rays: float) -> float:
        st = self.stats.get(name)
        if not st or st.seconds == 0:
            return 0.0
        return rays / st.seconds / 1e6


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_stats(renderer, sample_index: int = 0) -> Dict[str, float]:
    """One timed and ray-counted progressive sample on `renderer` (a
    tpurt_torch.renderer.Renderer), outside its accumulation. Waits for
    the card before starting and before stopping the clock. Returns
    {seconds, rays_logical, rays_physical, mrays_per_sec,
    mrays_per_sec_logical, fold_efficiency}, fold_efficiency =
    physical / logical."""
    from tpurt_torch.integrator.wavefront import render_sample_stats
    from tpurt_torch.kernels import cudalib

    cfg = renderer.config
    _sync(renderer.device)
    t0 = time.perf_counter()
    _, rays = render_sample_stats(
        renderer.device_scene, renderer.bvh, renderer.camera, sample_index,
        width=cfg.width, height=cfg.height, cfg=cfg, has_alpha=renderer.has_alpha,
        tex_flags=renderer.tex_flags, chunk_rows=cfg.chunk_rows)
    _sync(renderer.device)
    dt = time.perf_counter() - t0
    cudalib.check_kernel_errors(renderer.device)
    logical, physical = rays.logical, rays.physical
    return {
        "seconds": dt,
        "rays_logical": logical,
        "rays_physical": physical,
        "mrays_per_sec": physical / dt / 1e6 if dt > 0 else 0.0,
        "mrays_per_sec_logical": logical / dt / 1e6 if dt > 0 else 0.0,
        "fold_efficiency": physical / logical if logical else 0.0,
    }


def _raw_events(prof):
    """The profiler's Kineto events as (device event?, annotation?, name,
    start ns, duration ns, correlation id, linked correlation id).
    Reading them takes seconds where `prof.events()` takes minutes to
    build its tree of a sample's ~1M host events."""
    from torch.autograd import DeviceType

    return [(e.device_type() != DeviceType.CPU, e.is_user_annotation(), e.name(),
             e.start_ns(), e.duration_ns(), e.correlation_id(), e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()]


def device_events(prof):
    """(name, start ns, duration ns) of every kernel, copy and set the
    card ran during a finished `trace`, without the device-side spans the
    profiler draws for annotations."""
    return [(name, start, dur) for dev, ann, name, start, dur, _, _ in _raw_events(prof)
            if dev and not ann]


def annotation_split(prof) -> Dict[str, Dict[str, float]]:
    """From a finished `trace`: per annotation name, the number of ranges
    and the host and device milliseconds under them, summed over the
    ranges. A kernel counts under every range open on the host when the
    operator (or annotation) that launched it started."""
    ranges, op_start, kernels = [], {}, []
    for dev, ann, name, start, dur, corr, linked in _raw_events(prof):
        if dev:
            if not ann:
                kernels.append((linked, dur))
        elif linked == 0:  # an operator or annotation of the host program
            op_start[corr] = start
            if ann:
                ranges.append((start, start + dur, name))
    out = {name: {"count": 0, "host_ms": 0.0, "device_ms": 0.0}
           for _, _, name in ranges}
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
