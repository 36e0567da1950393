"""Tracing and profiling (the counterpart of tpurt/utils/profiling.py).

- `trace(log_dir)`: a torch.profiler run (CPU activity, and the card's
  when there is one) that writes a Chrome trace (`*.json`) into
  `log_dir`; open it in Perfetto or chrome://tracing.
- `annotate(name)`: a named range in that trace
  (`torch.profiler.record_function`) while a profiler runs; with none
  running it costs one flag check. Under
  `torch.autograd.profiler.emit_nvtx()` every such range is also an NVTX
  range, for Nsight. The integrator opens them under tpurt's own
  `jax.named_scope` names, and one `wave{k}` range per pass of its host
  wave loop, so a trace splits a sample's host and device time by
  integrator phase and by wave. The renderer adds `launch`,
  `set_camera`, `accumulate` and `tonemap`; the wave loop `camera_rays`,
  and in the alpha loops one `alpha_retrace.pass` / `occl_recheck.pass`
  a re-trace pass and an empty `alpha_cap` where a loop ends at its pass
  cap with hits still rejected (tested only while a profiler runs, at
  its own `sync.alpha_cap` site);
  the traversal `ray_sort` and `ray_unsort`; the mesh `shard_reduce`.
- `host_sync(site)`: a `sync.<site>` range around each point where the
  host waits for the device (a `nonzero`, an `.item()`, a copy between
  host and device, an event wait). Sync ranges are leaves, so a trace
  tells the host's waits from its issue by site.
- `audit_syncs()`: the cross-check of those ranges against PyTorch's
  sync debug mode on a card.
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


_profiler_enabled = torch.autograd._profiler_enabled


class annotate(contextlib.ContextDecorator):
    """A named range in profiler traces (tpurt's TraceAnnotation), as a
    `with` block or a decorator. With no profiler running (torch.profiler,
    or emit_nvtx) it opens nothing: one flag check."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def _recreate_cm(self):  # each decorated call opens its own range
        return annotate(self.name)

    def __enter__(self):
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def host_sync(site: str):
    """`with host_sync(site):` around the one call at which the host
    waits for the device: a `sync.<site>` range while a profiler runs, as
    `annotate`. It adds no host read and no device op, and nothing opens
    inside it."""
    return annotate("sync." + site)


SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def audit_syncs():
    """The cross-check of the `sync.*` ranges on a card: over the body,
    under a CPU profiler (the ranges open only while one runs) and
    `torch.cuda.set_sync_debug_mode("warn")`, every call PyTorch warns
    synchronises the host with the device is tallied against the range
    open when it warned. Yields a dict filled when the body ends:
    `ranges` {sync range: [syncs warned in each]}, and `outside`, the code
    line (file:line in the package, or the outermost caller's) of each
    sync warned outside any `sync.*` range. The mode does not warn at an
    event wait (`cudaEventSynchronize`, `sync.pacer`)."""
    import traceback
    import warnings

    from torch.profiler import ProfilerActivity, profile

    rf = torch.autograd.profiler.record_function
    enter, leave = rf.__enter__, rf.__exit__
    out = {"ranges": {}, "outside": []}
    stack = []  # [name, syncs warned] of each open range, innermost last

    def _enter(self):
        stack.append([self.name, 0])
        return enter(self)

    def _exit(self, *exc):
        name, n = stack.pop()
        if name.startswith("sync."):
            out["ranges"].setdefault(name, []).append(n)
        return leave(self, *exc)

    def _show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return shown(message, category, filename, lineno, file, line)
        if stack and stack[-1][0].startswith("sync."):
            stack[-1][1] += 1
            return None
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "tpurt_torch" in f.filename and not f.filename.endswith("profiling.py")]
        f = frames[-1] if frames else traceback.extract_stack()[0]
        out["outside"].append(f"{os.path.relpath(f.filename)}:{f.lineno}")
        return None

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = _show
        rf.__enter__, rf.__exit__ = _enter, _exit
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                yield out
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            rf.__enter__, rf.__exit__ = enter, leave


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
