#!/usr/bin/env python3
"""Smoke run of the tpurt_torch port on one NVIDIA card.

    python3 chip_smoke.py

Runs, in order, with one JSON line per phase (`phase`, `seconds`, ...):

  device   card name, power limit, torch version; no card is an error
  build    nvcc the four CUDA sources (wide_traverse.cu, rope_traverse.cu,
           wide_octet.cu, wide_stepcost.cu) and g++ the native host core,
           all at once; ptxas's registers, stack frame and spills for each
           instantiation of K1/K2, K3/K4, K5 and K6
  scene    write the bench's Sponza-like scene (~215k triangles), load it,
           build the renderer at 1920x1080 on the card (its wide tables and
           K1/K2's card tables), time each host step
  kernels  hold K1 (closest hit: 65,536 camera rays, 65,536 bounce rays with
           cell masks) and K2 (occlusion: 65,536 shadow rays to the three
           lights) against their plain PyTorch versions on the same inputs:
           0 rays with different t bits, prim or flag (the same walk
           order); CUDA-event timings of both. Then K3 (rope closest hit)
           and K4 (rope occlusion) on the same three batches, over the rope
           card tables of the same G=8 TriBVH with the mask column, against
           their plain versions over the rope rows (0 rays with different t
           bits, prim, u, v or blocked: the same walk order), and across: K3
           against K1 (same cell rejection) and K4 against K2 (tables without
           masks, once with every hit definite and once with none), equal t,
           prim only on ties, blocked equal. Then K1/K2 over 8-ary tables of
           the same tree on the same three batches, against their plain
           versions by the same rule (K1 also against the 16-ary K1: equal t,
           prim only on ties), timed in turns with the plain versions and
           with the 16-ary kernels; the two-pass near trace
           (kernel_bench.near_pass) on the bounce batch's rays that hit,
           r0 at the 85th percentile of their t: no overflow, and t the
           single pass's bit for bit; then `python -m
           tpurt_torch.kernel_bench --arity 8 --near 0.1` through its
           main(), its record on the phase's line: where no ray overflowed
           the second pass, the two-pass t must be the single pass's bit
           for bit
  render   Renderer.render at 1920x1080: 1 warm-up and 2 timed samples
           (each sample's physical ray count kept for `bench`),
           with the kernel launch counters zeroed just before; NaN pixels
           must be 0, the mean radiance > 0; the PNG goes to smoke_out/.
           The warm-up sample keeps the inputs and kernel outputs of the
           first camera wave, bounce wave, alpha re-trace, shadow wave and
           shadow re-trace it launches; after the timed samples each is
           held against the plain version with the rule of `kernels`, and
           K1/K2 are timed on each (whole-frame waves: ns per ray and the
           bound from the plain version's test counts)
  trace    utils.profiling.trace (torch.profiler, CPU and CUDA activities,
           a Chrome trace file) over one more sample of the same render:
           its wall seconds, the device's busy share (the union of the
           device's kernel, copy and set intervals over the wall time), K1
           and K2 launches, device ms and share of the sample, the ten
           kernels with the most device time, and the host and device ms
           under each of the integrator's annotations (tpurt's scope names
           and one wave{k} range per pass of the host wave loop) summed
           over the sample, with the ranges per sample and the host cost
           of one range outside the profiler; no K1 or K2 in the trace, or
           no annotation, fails the phase
  rope     the rope path: Renderer(..., bvh=build_triangle_bvh(tri, 8)) on
           the same scene, camera and lights, 1 warm-up and 2 timed samples
           with every launch counter zeroed just before; K3 must launch, K1,
           K2 and K4 must not; the image against the `render` phase's (same
           seed and samples) by RMSE, bound ROPE_VS_WIDE_RMSE. Then
           torch.profiler over one more rope sample (K3's launches, device ms
           and share of the sample, the device's busy share; K3 traced as
           often as counted). The warm-up keeps the first camera wave, shadow
           wave (traced as closest hits), bounce wave and alpha re-trace; each
           is held against rope.traverse_plain (0 rays with different t bits,
           prim, u, v or blocked) and K3 is timed on it (ns per ray and the
           bound of the plain walk's steps). Then K4's own path,
           rope.occlusion_packets on the frame's 2,073,600 shadow rays
           (camera hits to the lights), counted, held against the plain walk
           the same way and timed
  octet    K5, the multi-walk kernel: against octet_plain at 8 walks on the
           three 65,536-ray batches of `kernels` and at 2 and 4 walks on the
           camera batch, t, prim and flag bit-equal (the same walk order);
           against K1 (t bit-equal, prim only on ties, pending where prim
           agrees) and against K2 over tables without masks (blocked equal
           with every hit definite, the closest hit with none), with K5
           and K1/K2 timed in turns (K5's bound is K1/K2's on the same
           rays, since the function is theirs; the union walk's own tests
           give union_bound_ms beside it). Then the render path at full size:
           Renderer(config=RenderConfig(kernel=KernelPolicy(octet_closest=8,
           octet_occlusion=8))), 1 warm-up and 2 timed samples with every
           launch counter zeroed just before; K5 must launch, K1 and K2 must
           not; 0 NaN pixels; the image within ROPE_VS_WIDE_RMSE of the
           `render` phase's; the warm-up's first camera, bounce and shadow
           waves held against octet_plain, and K5 timed on each in turns with
           K1/K2 on the same rays (whole-frame waves: ns per ray, the
           function's bound from traverse_plain's counts and the union
           walk's from octet_plain's). Each K5 case records its launch
           (wide.octet_warp_per_walk: the 65,536-ray batches take one block
           per walk, the whole-frame waves one warp per walk)
  stepcost K6, the step-cost instrument: against stepcost_plain on the bounce
           batch (without cell masks) at the longest K1 walk of the batch,
           in every configuration kernel_bench times, t, prim and acc
           bit-equal; with every phase on, t and prim equal K1's. Then
           `python -m tpurt_torch.kernel_bench --stepcost 256` through its
           main() on the bench's batch (491,520 rays), with the launch
           counters zeroed just before; the first K6 launch of each
           configuration in that run is kept and held against
           stepcost_plain on the same inputs, t, prim and acc bit-equal;
           the table is printed as one JSON line. The K6 row of the
           kernels line is this run's full configuration
  lbvh     the device LBVH: _build_triangle_bvh_device on the card's
           triangles of the bench scene (cold and warm seconds, with a sync,
           beside the native SAH build's and the same function's on the
           CPU), every array equal to the CPU run's, validate_lbvh, wide
           tables packed from it; K1 on the 65,536 camera rays over them
           against K1 over the native tables (t equal, prim only on ties;
           both timed in turns); then the render through those tables, 1
           warm-up and 2 timed samples, launch counters zeroed just before:
           K1 and K2 launch and nothing else, 0 NaN pixels, the image within
           ROPE_VS_WIDE_RMSE of the `render` phase's; s/sample and launches
           beside the `render` phase's; three samples of each of the two
           renderers in turns, and one device-LBVH sample under
           torch.profiler (K1/K2 device ms, the device's busy share)
  golden   the box golden (64x48, 8 spp) rendered on the card, RMSE against
           tests/goldens/box_64x48_8spp.npz (fail above 1e-3)
  oracle   the brute-force oracle against the production wave loop on the
           card, tests/test_oracle_parity.py's three cases at 64x48: the box
           in exact mode (8 spp, relative RMSE < 0.01), the box folded (48
           spp, relative mean difference < 0.02, relative RMSE < 0.08), the
           alpha-tested mini Sponza in exact mode (4 spp, relative RMSE <
           0.01, has_alpha); the oracle's images on the card, production
           launching K1 and K2; seconds per sample of both in each case
  cache    the scene cache on the bench scene in a fresh directory: a
           cold Renderer.from_gltf (seconds of load, build, pack, save), a
           warm one, every DeviceScene and BVH array of the warm renderer
           equal to the cold one's (card tables and bounds included), one
           sample of each, bit-equal; then a `tri` artifact (a renderer
           built with bvh=<TriBVH, G=8>, saved under the scene's key): its
           warm renderer takes the rope path, launches K3 and neither K1
           nor K2, and gives the cold rope renderer's image bit for bit
  viewer   viewer.serve(block=False) on the card with the box at 160x120:
           frames advance, a key move resets the accumulation and moves
           the camera, /frame.png is a PNG, stop() returns within 10 s and
           joins the render worker; K1/K2 launch
  shard    tpurt_torch.parallel on the bench renderer at 1920x1080 with
           the mesh over the one card four times: a 4x1 (tile) launch of
           sample 0 equal bit for bit to the single-device render in
           270-row bands, with equal ray counts; a 2x2 launch against the
           mean of the single-device samples 0 and 1 (median |diff| <
           1e-5, equal ray counts); three ShardedRenderer steps on a 1x2
           mesh; K1/K2 launches and seconds per launch beside the
           `render` phase's s/sample
  recovery a child process (chip_smoke.py --recovery SCENE): the bench
           renderer at 1920x1080, the peak memory of a whole-frame sample
           and of one in 540-row bands, an unconstrained 2-spp render;
           then set_per_process_memory_fraction between the two peaks and
           the same 2-spp render with chunk_rows=0, which must retry at
           least one real torch.cuda.OutOfMemoryError, end with fewer
           than 1080 rows per band and lie within RMSE 1e-5 of the
           unconstrained render (bit equality printed); both peaks, the
           fraction, the retries and the seconds. No fraction between the
           peaks fails the phase
  cli      the user entry point, `python -m tpurt_torch.cli`, as child
           processes from the repo root, on the same scene file with the
           bench's camera and lights at 1920x1080, sharing a fresh scene
           cache (A starts cold and saves it, the rest start warm): A
           renders 4 spp with a checkpoint every 2 spp, --save-accum,
           --validate and --debug-nans; B renders 2 spp into a checkpoint
           that C resumes to 4 spp; C's accumulation must be A's bit for
           bit and the PNGs must exist. Then `info` (its triangle count
           must be the glTF's, 215,284, which the device scene pads to the
           scene phase's 215,296), a 2-frame --orbit and a --trace run at
           640x480 (the trace file must exist), `render --shard 1x1` at
           640x480, 2 spp, whose accumulation must be the same render's
           without --shard bit for bit, and `view` at 320x240 on a free
           port: /, /frame.png, /status, then /key?k=w must move the
           camera's position only and /look?dx=80&dy=-40 its direction
           only (/camera); SIGINT ends it with exit code 0. Each
           process's seconds and A's s/sample
  bench    `python -m tpurt_torch.bench` as a child process with
           BENCH_SAMPLES=3: its last line must be a final record with
           samples_done >= 1, value > 0 and rmse_vs_golden < 1e-5, and its
           physical rays must be the ones Renderer.last_stats counted for
           the same samples (1..3) in `render` and `trace`; the record is
           printed on the phase's line

Then it prints the card's name and power limit as nvidia-smi gives them,
the {"kernels": [...]} line (K1-K6; K1-K3 with their whole-frame waves
and their share of a traced sample, K1/K2 with their arity-8,
device-LBVH, cache, viewer and shard runs, K3 with its warm `tri`
start), and last {"ok": true, "device": {...}}. The smoke turns the
scene cache off (TPURT_SCENE_CACHE_DIR=0) except where a phase sets up
its own. A watchdog ends the run with exit code 1, naming the phase it
was in, after 600 seconds, and kills a child process it is waiting for. Needs
torch with CUDA, numpy, nvcc and g++; no JAX, no Pillow, no prebuilt
artefact.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

DEADLINE_S = 600
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")

# bench.py's Sponza-like scene, camera and lights
SCENE_KW = dict(columns=12, foliage=96, stacks=8, segments=28, rings=20)
CAMERA = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHTS = [((-8.0, -5.0, -2.0), 0.1, (0.8, 0.6, 0.6), 500.0),
          ((8.0, -5.0, -2.5), 0.1, (0.4, 0.7, 0.6), 500.0),
          ((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)]
WIDTH, HEIGHT = 1920, 1080
N_RAYS = 65536
REPS = 5
# kernel_bench --stepcost: steps per ray, and K6's phase switches
BENCH_STEPS = 256
PHASES = ("do_box", "do_extract", "do_push", "do_leaf")

# rope vs wide render of the same frame: the two paths run the same
# arithmetic and differ only where an exact-t tie picks another triangle
ROPE_VS_WIDE_RMSE = 1e-5

_state = {"phase": "start", "child": None}


def emit(obj):
    print(json.dumps(obj), flush=True)


def watchdog():
    child = _state["child"]
    if child is not None:
        child.kill()
    emit({"error": "deadline", "phase": _state["phase"], "seconds": DEADLINE_S})
    sys.stdout.flush()
    os._exit(1)


def run_entry(argv, env=None, timeout=240):
    """Run `python -m <argv>` from the repo root as a child process (the
    watchdog kills it at the deadline); returns (exit code, stdout,
    stderr, seconds)."""
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))
    _state["child"] = child
    try:
        out, err = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        out, err = child.communicate()
        raise RuntimeError(f"{' '.join(argv[:2])} did not end within {timeout} s: "
                           f"{err[-1500:]}")
    finally:
        _state["child"] = None
    return child.returncode, out, err, round(time.perf_counter() - t0, 3)


class Phase:
    def __init__(self, name):
        self.name = name
        self.info = {}

    def __enter__(self):
        _state["phase"] = self.name
        self.t0 = time.perf_counter()
        return self.info

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": round(time.perf_counter() - self.t0, 3),
                  **self.info})
        return False


def cuda_ms(fn):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def compare(kind, k, p):
    """Kernel (t, prim, flag) against plain (t, prim, flag): counts of exact
    agreement, exact-t ties, and anything else."""
    import torch

    tk, pk, fk = k
    tp, pp, fp = p
    prim_eq = pk == pp
    t_eq = tk.view(torch.int32) == tp.view(torch.int32)
    ties = ~prim_eq & t_eq
    flag_bad = prim_eq & ((fk > 0.5) != (fp > 0.5))
    if kind == "occlusion":
        flag_bad = (fk > 0.5) != (fp > 0.5)
    bad = (prim_eq & ~t_eq) | (~prim_eq & ~t_eq) | flag_bad
    hit = prim_eq & (pk >= 0)
    err = float((tk[hit] - tp[hit]).abs().max()) if bool(hit.any()) else 0.0
    return {"rays": int(tk.numel()), "prim_agree": int(prim_eq.sum()),
            "ties": int(ties.sum()), "flag_set": int((fk > 0.5).sum()),
            "mismatch": int(bad.sum()), "max_abs_err": err}


def compare_exact(k, p):
    """Kernel against plain version when both walk in the same order:
    rays where any output differs, floats compared by their bits ((t,
    prim, flag) of K1/K2/K5/K6, (t, prim, u, v, blocked) of K3/K4)."""
    import torch

    bits = (lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x)
    bad = torch.zeros(k[0].shape, dtype=torch.bool, device=k[0].device)
    for a, b in zip(k, p):
        bad |= bits(a) != bits(b)
    hit = k[1] >= 0
    err = float((k[0][hit] - p[0][hit]).abs().max()) if bool(hit.any()) else 0.0
    return {"rays": int(k[0].numel()), "mismatch": int(bad.sum()), "max_abs_err": err,
            "flag_set": int((k[-1] != 0).sum()) if k[-1].dtype == torch.float32 else None}


# the templates of K1/K2 and of K3/K4, each <Occlusion, Masks>
WALKS = {"wide_walk": ("K1", "K2"), "rope_walk": ("K3", "K4")}
# K6's <DoBox, DoExtract, DoPush, DoLeaf> of each kernel_bench configuration
STEPCOST_TEMPLATES = {(1, 1, 1, 1): "full", (1, 1, 1, 0): "-leaf", (1, 1, 0, 0): "-push",
                      (1, 0, 0, 0): "-extract", (0, 0, 0, 0): "-box"}


def template_resources(report, template, label):
    """ptxas's report of a source keyed by instantiation of `template`:
    label(args) names the instantiation from its bool and int template
    arguments."""
    out = {}
    for name, res in report.items():
        m = re.search(template + r"I((?:L[bi]\d+E)+)E", name)
        if m:
            out[label(tuple(int(x) for x in re.findall(r"L[bi](\d+)E", m.group(1))))] = res
    return out


def kernel_of(kernel_name):
    """'K1'-'K4' for a traced wide_walk or rope_walk kernel (demangled or
    not), else None."""
    for walk, ids in WALKS.items():
        m = re.search(walk + r"(?:<|ILb)(true|false|1|0)", kernel_name)
        if m is not None:
            return ids[m.group(1) in ("true", "1")]
    return None


def trace_summary(prof, wall_s, kernels):
    """From a torch.profiler run over one sample: the device's busy share
    (the union of its kernel, copy and set intervals over the wall time),
    the launches, device ms and share of the sample of each of `kernels`
    (ids of kernel_of), and the ten kernels with the most device time."""
    from tpurt_torch.utils.profiling import device_events

    events = device_events(prof)
    if not events:
        raise RuntimeError("the trace holds no device activity")
    busy_ns, end = 0, None
    for a, b in sorted((start, start + dur) for _, start, dur in events):
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    by_name = {}
    for name, _, dur in events:
        acc = by_name.setdefault(name, [0, 0])
        acc[0] += 1
        acc[1] += dur
    total_ns = sum(v[1] for v in by_name.values())
    out = {"device_events": len(events), "device_busy_share": busy_ns / (wall_s * 1e9),
           "device_busy_ms": busy_ns / 1e6, "device_event_ms": total_ns / 1e6}
    for k in kernels:
        sel = [v for name, v in by_name.items() if kernel_of(name) == k]
        ms = sum(v[1] for v in sel) / 1e6
        out[k] = {"launches": sum(v[0] for v in sel), "device_ms": ms,
                  "share_of_sample": ms / (wall_s * 1e3)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    out["top_kernels"] = [{"name": name[:120], "count": v[0], "device_ms": v[1] / 1e6,
                           "share_of_device": v[1] / total_ns} for name, v in top]
    return out


def annotation_cost_us(n=20000):
    """Host microseconds of one empty `annotate` range with no profiler
    running (the record_function and NVTX calls), median of 5 runs of n."""
    from tpurt_torch.utils.profiling import annotate

    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with annotate("cost"):
                pass
        runs.append((time.perf_counter() - t0) / n * 1e6)
    return median(runs)


def annotation_table(prof, wall_s):
    """The trace's annotations: per integrator scope and per wave{k} of
    the host wave loop, the ranges, host ms and device ms summed over the
    sample, and the scope with the most host time."""
    from tpurt_torch.utils.profiling import annotation_split

    split = annotation_split(prof)
    waves = {k: v for k, v in split.items() if re.fullmatch(r"wave\d+", k)}
    scopes = {k: v for k, v in split.items() if k not in waves}
    if not waves or not scopes:
        raise RuntimeError(f"the trace holds no integrator annotations: {sorted(split)}")
    ranges = sum(v["count"] for v in split.values())
    cost_us = annotation_cost_us()
    return {"ranges_per_sample": ranges, "range_cost_us": cost_us,
            "ranges_ms_per_sample": ranges * cost_us / 1e3, "scopes": scopes,
            "waves": dict(sorted(waves.items(), key=lambda kv: int(kv[0][4:]))),
            "waves_host_ms": sum(v["host_ms"] for v in waves.values()),
            "waves_device_ms": sum(v["device_ms"] for v in waves.values()),
            "sample_ms": wall_s * 1e3,
            "most_host_ms": max(scopes, key=lambda k: scopes[k]["host_ms"])}


def profiled_step(rr, checks):
    """One rr.step() under torch.profiler (CPU and CUDA activities), the
    launch counters zeroed just before: (trace_summary of `checks`'
    kernels, the counted launches, wall seconds, the attempts discarded).
    `checks` maps kernel ids (kernel_of) to counter names, and each traced
    count must equal its counter. A trace that misses a launch the
    counters saw has lost device records and is discarded: the step is
    traced once more, and both counts of the lost attempt are returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    discarded = []
    for _ in range(2):
        zero_launch_counts()
        done = rr.sample_count
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rr.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        traced = launch_counts()
        if rr.sample_count != done + 1:
            raise RuntimeError(f"the traced step rendered {rr.sample_count - done} samples")
        summary = trace_summary(prof, wall, tuple(checks))
        del prof
        lost = {k: {"traced": summary[k]["launches"], "counted": traced[m]}
                for k, m in checks.items() if summary[k]["launches"] != traced[m]}
        if not lost:
            return summary, traced, wall, discarded
        discarded.append(lost)
    raise RuntimeError(f"kernels traced against launches counted, in both traces: {discarded}")


def timed_kernel(kern):
    """Median CUDA-event ms of REPS runs of `kern`."""
    return median([cuda_ms(kern)[0] for _ in range(REPS)])


def zero_launch_counts():
    from tpurt_torch.kernels import wide
    from tpurt_torch.kernels.experimental import rope

    for counts in (wide.LAUNCHES, rope.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts():
    from tpurt_torch.kernels import wide
    from tpurt_torch.kernels.experimental import rope

    return {**wide.LAUNCHES, **rope.LAUNCHES}


def timed_pair(kern, plain):
    """Median CUDA-event ms of the kernel and of its plain version, REPS
    each, in turns: plain, kernel, kernel, plain, ..."""
    k_ms, p_ms = [], []
    for i in range(REPS):
        order = (plain, kern) if i % 2 == 0 else (kern, plain)
        for fn in order:
            ms, _ = cuda_ms(fn)
            (p_ms if fn is plain else k_ms).append(ms)
    return median(k_ms), median(p_ms)


def cli_phase(info, scene, triangles, padded, work, platform="cuda", res="1920x1080",
              small_res="640x480"):
    """`python -m tpurt_torch.cli` on `scene` with the bench's camera and
    lights: A renders 4 spp with a checkpoint every 2 (--validate,
    --debug-nans, --save-accum); B renders 2 spp into another checkpoint
    and C resumes it to 4: C's accumulation must be A's, bit for bit, and
    every PNG must exist. Then `info` (its triangle count must be the
    scene's `triangles`, which the device scene pads to `padded`, a
    multiple of 128), a 2-frame --orbit, a --trace run whose Chrome trace
    must exist, `render --shard 1x1` at 640x480 whose accumulation must be
    the same render's without --shard, bit for bit, and `view`
    (view_process). The children share a fresh scene cache: A starts cold
    and saves it, the others start warm. Records each process's seconds
    and the s/sample A printed."""
    import numpy as np

    base = ["tpurt_torch.cli", "--platform", platform]
    look = ["--camera", "{},{},{}:{}:{}".format(*CAMERA[0], *CAMERA[1:])]
    look += ["--light={},{},{}:{}:{},{},{}:{}".format(*pos, rad, *rgb, power)
             for pos, rad, rgb, power in LIGHTS]
    ck_a, ck_b = os.path.join(work, "a.npz"), os.path.join(work, "b.npz")
    acc_a, acc_c = os.path.join(work, "a_acc.npz"), os.path.join(work, "c_acc.npz")
    png = {k: os.path.join(OUT_DIR, f"cli_{k}.png") for k in "abc"}
    runs = {
        "a": [*base, "render", scene, "--res", res, *look, "--spp", "4", "-o", png["a"],
              "--checkpoint", ck_a, "--checkpoint-every", "2", "--save-accum", acc_a,
              "--validate", "--debug-nans"],
        "b": [*base, "render", scene, "--res", res, *look, "--spp", "2", "-o", png["b"],
              "--checkpoint", ck_b],
        "c": [*base, "render", scene, "--res", res, *look, "--spp", "4", "-o", png["c"],
              "--checkpoint", ck_b, "--save-accum", acc_c],
        "info": [*base, "info", scene],
        "orbit": [*base, "render", scene, "--res", small_res, *look, "--spp", "1",
                  "-o", os.path.join(work, "orbit"), "--orbit", "0,-4,0:3:0.5:2"],
        "trace": [*base, "render", scene, "--res", small_res, *look, "--spp", "1",
                  "-o", os.path.join(work, "trace.png"), "--trace",
                  os.path.join(work, "trace")],
    }
    acc_shard, acc_plain = (os.path.join(work, f"{k}_acc.npz") for k in ("shard", "plain"))
    for name, acc, extra in (("shard", acc_shard, ["--shard", "1x1"]), ("plain", acc_plain, [])):
        runs[name] = [*base, "render", scene, "--res", small_res, *look, "--spp", "2",
                      "-o", os.path.join(work, f"{name}.png"), "--save-accum", acc, *extra]
    env = {"TPURT_SCENE_CACHE_DIR": os.path.join(work, "cli_cache")}
    seconds, outs = {}, {}
    for name, argv in runs.items():
        rc, out, err, secs = run_entry(argv, env=env)
        seconds[name], outs[name] = secs, out
        if rc != 0:
            raise RuntimeError(f"cli {name} exited with {rc}: {err[-1500:]}")
    view_process(info, scene, look, env, platform)
    seconds["view"] = info["view"]["seconds"]
    info.update(process_seconds=seconds)
    sh, pl = np.load(acc_shard), np.load(acc_plain)
    info["shard_1x1"] = dict(sample_count=int(sh["sample_count"]),
                             bit_equal=sh["accum"].tobytes() == pl["accum"].tobytes(),
                             sharded="sharding over mesh tile=1 x spp=1" in outs["shard"])
    if not info["shard_1x1"]["bit_equal"] or not info["shard_1x1"]["sharded"] or \
            int(sh["sample_count"]) != 2 or int(pl["sample_count"]) != 2:
        raise RuntimeError(f"render --shard 1x1 against the plain render: {info['shard_1x1']}")
    m = re.search(r"\(([0-9.]+) s/sample\)", outs["a"])
    info["a_seconds_per_sample"] = float(m.group(1)) if m else None
    if "scene validation: ok" not in outs["a"] or "no non-finite pixels" not in outs["a"]:
        raise RuntimeError(f"cli a: validation or NaN report missing: {outs['a'][-800:]}")
    if "resumed at 2 spp" not in outs["c"]:
        raise RuntimeError(f"cli c did not resume at 2 spp: {outs['c'][-800:]}")
    a, c = np.load(acc_a), np.load(acc_c)
    info.update(a_sample_count=int(a["sample_count"]), c_sample_count=int(c["sample_count"]),
                resumed_bit_equal=a["accum"].tobytes() == c["accum"].tobytes(),
                resumed_max_abs_diff=float(np.abs(a["accum"] - c["accum"]).max()))
    if not info["resumed_bit_equal"] or int(a["sample_count"]) != 4 \
            or int(c["sample_count"]) != 4:
        raise RuntimeError("the resumed render is not the uninterrupted one: "
                           f"{info['resumed_max_abs_diff']}")
    missing = [p for p in png.values() if not os.path.exists(p)]
    m = re.search(r"triangles:\s+(\d+)", outs["info"])
    info["info_triangles"] = int(m.group(1)) if m else None
    frames = sorted(os.listdir(os.path.join(work, "orbit")))
    traces = [f for f in os.listdir(os.path.join(work, "trace")) if f.endswith(".json")]
    info.update(orbit_frames=frames, trace_files=traces,
                pngs=[os.path.relpath(p, ROOT) for p in png.values()])
    info["device_scene_triangles"] = padded
    if missing or info["info_triangles"] != triangles or -(-triangles // 128) * 128 != padded or \
            frames != ["frame_0000.png", "frame_0001.png"] or len(traces) != 1:
        raise RuntimeError(f"cli outputs: missing {missing}, info triangles "
                           f"{info['info_triangles']} (scene {triangles}), frames {frames}, "
                           f"traces {traces}")
    shutil.rmtree(os.path.join(work, "trace"))


def bench_phase(info, sample_physical, env):
    """`python -m tpurt_torch.bench` with `env`: its last line must be a
    final record (no `provisional`) with samples_done >= 1, value > 0,
    rmse_vs_golden < 1e-5 and, for samples 1..samples_done, the physical
    rays the renderer counted for the same samples (`sample_physical`)."""
    rc, out, err, secs = run_entry(["tpurt_torch.bench"], env=env)
    lines = out.strip().splitlines()
    if rc != 0 or not lines:
        raise RuntimeError(f"bench exited with {rc}: {err[-1500:]}")
    rec = json.loads(lines[-1])
    info.update(process_seconds=secs, env=env, record=rec,
                card_line=next((x for x in err.splitlines() if "card:" in x), None))
    done = rec.get("samples_done") or 0
    want = sum(sample_physical[i] for i in range(1, done + 1)) if done else None
    info["renderer_physical"] = want
    if rec.get("provisional") or done < 1 or not rec.get("value", 0) > 0 or \
            rec.get("rmse_vs_golden") is None or not rec["rmse_vs_golden"] < 1e-5:
        raise RuntimeError(f"bench record: {rec}")
    if rec["rays_traced_physical"] != want:
        raise RuntimeError(f"bench counted {rec['rays_traced_physical']} physical rays in "
                           f"samples 1..{done}, the renderer {want}")


# tests/test_oracle_parity.py's cases: (name, spp, fold_bsdf_mis, bounds)
ORACLE_SIZE = (64, 48)
ORACLE_CASES = (("box_exact", 8, False, {"rel_rmse": 0.01}),
                ("box_folded", 48, True, {"rel_mean": 0.02, "rel_rmse": 0.08}),
                ("alpha_exact", 4, False, {"rel_rmse": 0.01}))


def oracle_phase(info, dev, work, size=ORACLE_SIZE, cases=ORACLE_CASES):
    """The brute-force oracle against the production wave loop on `dev`,
    with tests/test_oracle_parity.py's scenes, cameras, lights, sample
    counts and bounds: relative RMSE (and, folded, the relative mean
    difference) of the two averaged images. The oracle's images must lie
    on `dev` and production must launch K1 and K2. Records each case's
    seconds per sample of both."""
    import numpy as np
    import torch

    from tpurt_torch.camera import Camera
    from tpurt_torch.config import RenderConfig, SphereLight
    from tpurt_torch.integrator.oracle import render_sample_oracle
    from tpurt_torch.integrator.wavefront import render_sample
    from tpurt_torch.renderer import Renderer
    from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene

    w, h = size
    box = Renderer.from_gltf(
        write_box_scene(os.path.join(work, "oracle_box.gltf")),
        config=RenderConfig(width=w, height=h, max_samples=64, fold_bsdf_mis=False),
        camera=Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45),
        lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)], device=dev)
    alpha = Renderer.from_gltf(
        write_sponza_like_scene(os.path.join(work, "oracle_mini.gltf"), columns=1, foliage=6,
                                stacks=1, segments=8, rings=6),
        config=RenderConfig(width=w, height=h, max_samples=8, fold_bsdf_mis=False),
        camera=Camera.from_angles([0.0, -4.0, 0.0], 0.7, -0.1),
        lights=[SphereLight((0.0, -6.0, 0.0), 0.3, (0.9, 0.9, 0.7), 300.0)], device=dev)
    if not alpha.has_alpha:
        raise RuntimeError("the alpha scene has no alpha-tested triangle")

    def average(render, spp):
        acc = np.zeros((h, w, 3))
        t0 = time.perf_counter()
        for s in range(spp):
            img = render(s)
            if img.device.type != dev.type:
                raise RuntimeError(f"an image came back on {img.device}, not {dev}")
            acc += img[..., :3].cpu().numpy()
        return acc / spp, (time.perf_counter() - t0) / spp

    out = {}
    for name, spp, fold, bounds in cases:
        r = alpha if name.startswith("alpha") else box
        cfg = dataclasses.replace(r.config, fold_bsdf_mis=fold)
        zero_launch_counts()
        prod, prod_s = average(lambda s: render_sample(
            r.device_scene, r.bvh, r.camera, s, width=w, height=h, cfg=cfg,
            has_alpha=r.has_alpha, tex_flags=r.tex_flags), spp)
        launches = launch_counts()
        orac, orac_s = average(lambda s: render_sample_oracle(
            r.device_scene, r.camera, s, width=w, height=h, cfg=cfg), spp)
        got = {"rel_rmse": float(np.sqrt(((prod - orac) ** 2).mean())) / float(orac.mean()),
               "rel_mean": abs(float(prod.mean() - orac.mean())) / float(orac.mean())}
        out[name] = dict(spp=spp, fold_bsdf_mis=fold, triangles=int(r.device_scene.tri_pos.shape[0]),
                         has_alpha=r.has_alpha, oracle_s_per_sample=orac_s,
                         production_s_per_sample=prod_s, launches=launches,
                         oracle_mean=float(orac.mean()), production_mean=float(prod.mean()),
                         bounds=bounds, **{k: got[k] for k in bounds})
        if min(launches["closest"], launches["occlusion"]) <= 0:
            raise RuntimeError(f"{name}: production did not launch K1 and K2: {launches}")
        if not np.isfinite(orac).all() or not orac.mean() > 0:
            raise RuntimeError(f"{name}: oracle image not finite and positive")
        for k, bound in bounds.items():
            if not got[k] < bound:
                raise RuntimeError(f"{name}: production against the oracle, {k} {got[k]} "
                                   f"(bound {bound})")
    info.update(size=list(size), cases=out)


def _leaves(prefix, x):
    """(name, value) of every tensor, array or number inside `x`, walking
    NamedTuples and dataclasses."""
    if hasattr(x, "_fields"):
        for k in x._fields:
            yield from _leaves(f"{prefix}.{k}", getattr(x, k))
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(f"{prefix}.{f.name}", getattr(x, f.name))
    else:
        yield prefix, x


def differing_leaves(a, b):
    """Names of the leaves of `a` and `b` that differ in dtype, shape or
    any bit ([] when all are equal)."""
    import numpy as np
    import torch

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    la, lb = list(_leaves("", a)), list(_leaves("", b))
    if [n for n, _ in la] != [n for n, _ in lb]:
        return ["<fields>"]
    bad = []
    for (name, x), (_, y) in zip(la, lb):
        x, y = host(x), host(y)
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            bad.append(name)
    return bad


def cache_phase(info, dev, path, cfg, camera, lights, work):
    """The scene cache on the bench scene `path`, in a fresh directory: a
    cold Renderer.from_gltf (its seconds split into load, build, pack and
    save), a warm one (seconds), every DeviceScene and BVH array of the
    warm renderer equal to the cold one's, one sample of each with equal
    accumulations. Then a `tri` artifact, saved under the scene's key from
    a renderer built with bvh=<TriBVH, G=8>: its warm renderer must take
    the rope path, launch K3 and neither K1 nor K2, and give the cold rope
    renderer's image, bit for bit. The cache is off again afterwards."""
    import torch

    from tpurt_torch.bvh.lbvh import build_triangle_bvh
    from tpurt_torch.kernels import wide
    from tpurt_torch.kernels.experimental import rope
    from tpurt_torch.renderer import Renderer
    from tpurt_torch.scene import cache as scache
    from tpurt_torch.scene.device import build_device_scene
    from tpurt_torch.scene.gltf import camera_for_render, load_gltf

    cdir = os.path.join(work, "scene_cache")
    os.environ["TPURT_SCENE_CACHE_DIR"] = cdir

    def start():
        t0 = time.perf_counter()
        rr = Renderer.from_gltf(path, config=cfg, camera=camera, lights=lights, device=dev)
        torch.cuda.synchronize()
        return rr, round(time.perf_counter() - t0, 3)

    def one_sample(rr):
        zero_launch_counts()
        rr.render(1)
        return launch_counts()

    try:
        cold, cold_s = start()
        files = os.listdir(cdir)
        if len(files) != 1 or not files[0].endswith(".npz"):
            raise RuntimeError(f"the cold start left {files} in the cache")
        warm, warm_s = start()
        if set(warm.timings) != {"cache_load_s"} or not isinstance(warm.bvh, wide.WideKernelBVH):
            raise RuntimeError(f"the second start was not a warm wide start: {warm.timings}")
        differ = (differing_leaves(cold.device_scene, warm.device_scene)
                  + differing_leaves(cold.bvh, warm.bvh) + differing_leaves(cold.camera,
                                                                            warm.camera))
        one_sample(cold)
        launches = one_sample(warm)
        info.update(cold_s=cold_s, warm_s=warm_s,
                    cold_timings={k: round(v, 3) for k, v in cold.timings.items()},
                    warm_timings={k: round(v, 3) for k, v in warm.timings.items()},
                    artifact_mb=round(os.path.getsize(os.path.join(cdir, files[0])) / 2**20, 2),
                    arrays_differ=differ, sample_bit_equal=torch.equal(cold.accum, warm.accum),
                    warm_launches=launches)
        if differ or not info["sample_bit_equal"]:
            raise RuntimeError(f"the warm start is not the cold one: arrays {differ}, "
                               f"sample bit-equal {info['sample_bit_equal']}")
        if min(launches["closest"], launches["occlusion"]) <= 0:
            raise RuntimeError(f"the warm wide sample did not launch K1 and K2: {launches}")
        del cold, warm

        t0 = time.perf_counter()
        sd = load_gltf(path)
        ds = build_device_scene(sd, lights=lights, device=dev)
        tribvh = build_triangle_bvh(ds.tri_pos.cpu().numpy(), group_size=8, device=dev)
        rope_cold = Renderer(ds, config=cfg, camera=camera, device=dev, bvh=tribvh)
        key = scache.scene_cache_key([path], lights, wide.ARITY, scache.backend_name(dev))
        scache.save_artifacts(os.path.join(cdir, key + ".npz"), rope_cold.device_scene,
                              rope_cold.bvh, camera=camera_for_render(sd.camera))
        tri_cold_s = round(time.perf_counter() - t0, 3)
        rope_warm, tri_warm_s = start()
        if not isinstance(rope_warm.bvh, rope.KernelBVH):
            raise RuntimeError(f"the tri artifact loaded as a {type(rope_warm.bvh).__name__}")
        one_sample(rope_cold)
        tri_launches = one_sample(rope_warm)
        tri_differ = (differing_leaves(rope_cold.bvh.tribvh, rope_warm.bvh.tribvh)
                      + differing_leaves(rope_cold.bvh.card, rope_warm.bvh.card))
        info.update(tri_cold_build_and_save_s=tri_cold_s, tri_warm_s=tri_warm_s,
                    tri_arrays_differ=tri_differ,
                    tri_sample_bit_equal=torch.equal(rope_cold.accum, rope_warm.accum),
                    tri_warm_launches=tri_launches)
        if tri_launches["rope_closest"] <= 0 or tri_launches["closest"] or \
                tri_launches["occlusion"] or tri_differ or not info["tri_sample_bit_equal"]:
            raise RuntimeError(f"the tri artifact's warm start: launches {tri_launches}, arrays "
                               f"{tri_differ}, sample bit-equal {info['tri_sample_bit_equal']}")
    finally:
        os.environ["TPURT_SCENE_CACHE_DIR"] = "0"


def viewer_phase(info, dev, work):
    """viewer.serve(block=False) on the card with a small renderer of the
    box: frames must advance, a key move must reset the accumulation and
    move the camera, /frame.png must be a PNG, and stop() must return
    within 10 s with the render worker joined."""
    import urllib.request

    import numpy as np

    from tpurt_torch import viewer
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import RenderConfig, SphereLight
    from tpurt_torch.renderer import Renderer
    from tpurt_torch.scene.procedural import write_box_scene

    r = Renderer.from_gltf(write_box_scene(os.path.join(work, "viewer_box.gltf")),
                           config=RenderConfig(width=160, height=120, max_samples=1 << 20),
                           camera=Camera.from_angles([1.5, 1.2, 2.0],
                                                     float(np.arctan2(-1.5, -2.0)), -0.45),
                           lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)],
                           device=dev)
    zero_launch_counts()
    server, state, stop = viewer.serve(r, "127.0.0.1", 0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stopped = False
    try:
        def get(p):
            return urllib.request.urlopen(base + p, timeout=30).read()

        def wait_for(n, limit=30.0):
            t0 = time.perf_counter()
            while r.sample_count < n and time.perf_counter() - t0 < limit:
                time.sleep(0.02)
            return r.sample_count

        t0 = time.perf_counter()
        first = wait_for(1)
        t1 = time.perf_counter()
        before = wait_for(first + 16)
        rate = (before - first) / max(time.perf_counter() - t1, 1e-9)
        pos = r.camera.position.cpu().numpy().copy()
        get("/key?k=w")
        after_key = r.sample_count
        moved = not np.allclose(pos, r.camera.position.cpu().numpy())
        png = get("/frame.png")
        again = wait_for(after_key + 4)
        info.update(first_frame_s=round(t1 - t0, 3), frames_before_key=before,
                    samples_per_s=round(rate, 2), count_after_key=after_key,
                    camera_moved=moved, count_later=again, png_bytes=len(png),
                    status=get("/status").decode(), generation=state.gen)
        t0 = time.perf_counter()
        stop()
        stopped = True
        info["stop_s"] = round(time.perf_counter() - t0, 3)
    finally:
        if not stopped:
            stop()
    info["launches"] = launch_counts()
    alive = any(t.name == viewer.WORKER_NAME for t in threading.enumerate())
    if first < 1 or before < first + 16 or not moved or after_key >= before or \
            again < after_key + 4 or png[:4] != b"\x89PNG" or info["stop_s"] > 10 or alive:
        raise RuntimeError(f"viewer: {info}, worker alive {alive}")
    if min(info["launches"]["closest"], info["launches"]["occlusion"]) <= 0:
        raise RuntimeError(f"the viewer's frames did not launch K1 and K2: {info['launches']}")


def shard_phase(info, dev, r, render_s_per_sample):
    """tpurt_torch.parallel on the bench renderer `r` (1920x1080) with the
    mesh over the one card four times: a 4x1 tile launch of sample 0
    against the single-device render in 270-row bands (bit for bit, equal
    ray counts); a 2x2 launch against the mean of the single-device
    samples 0 and 1 (tpurt's bound, median |diff| < 1e-5; equal ray
    counts); three ShardedRenderer steps on a 1x2 mesh. K1/K2 launches
    and seconds per launch beside the `render` phase's s/sample."""
    import numpy as np
    import torch

    from tpurt_torch.integrator.wavefront import render_sample_stats
    from tpurt_torch.parallel import ShardedRenderer, make_mesh, render_sample_stats_sharded
    from tpurt_torch.renderer import Renderer

    cfg = r.config
    kw = dict(width=cfg.width, height=cfg.height, cfg=cfg, has_alpha=r.has_alpha,
              tex_flags=r.tex_flags)

    def sharded(n_tile, n_spp):
        zero_launch_counts()
        t0 = time.perf_counter()
        out = render_sample_stats_sharded(r.device_scene, r.bvh, r.camera, 0,
                                          make_mesh(n_tile, n_spp, devices=[dev] * 4), **kw)
        torch.cuda.synchronize()
        return out, round(time.perf_counter() - t0, 3), launch_counts()

    (tiles, delivered, stats), tile_s, tile_launches = sharded(4, 1)
    ref, ref_stats = render_sample_stats(r.device_scene, r.bvh, r.camera, 0,
                                         chunk_rows=cfg.height // 4, **kw)
    tile_equal = torch.equal(tiles, ref)
    del tiles, ref

    (mixed, delivered22, stats22), mixed_s, mixed_launches = sharded(2, 2)
    acc, total = None, np.zeros(2, np.float64)
    for s in (0, 1):
        img, st = render_sample_stats(r.device_scene, r.bvh, r.camera, s, **kw)
        acc = img if acc is None else acc + img
        total += (st.logical, st.physical)
    mean = acc / 2
    diff = (mixed[..., :3] - mean[..., :3]).abs().flatten()
    med = float(diff.median())
    mixed_equal = torch.equal(mixed, mean)
    del mixed, mean, acc, diff

    sr_r = Renderer(r.device_scene, config=cfg, camera=r.camera, device=dev, bvh=r.bvh)
    sr = ShardedRenderer(sr_r, make_mesh(1, 2, devices=[dev] * 2))
    zero_launch_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        sr.step()
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    steps_launches = launch_counts()
    nan_px = int(torch.isnan(sr_r.accum).any(dim=-1).sum())
    info.update(tile_4x1=dict(seconds=tile_s, delivered=delivered, bit_equal_banded=tile_equal,
                              rays_equal=stats == ref_stats, rays_physical=stats.physical,
                              launches=tile_launches),
                mixed_2x2=dict(seconds=mixed_s, delivered=delivered22, median_abs_diff=med,
                               bit_equal=mixed_equal,
                               rays_equal=(stats22.logical, stats22.physical) == tuple(total),
                               launches=mixed_launches),
                sharded_renderer_1x2=dict(steps=3, sample_count=sr_r.sample_count,
                                          seconds_per_launch=round(steps_s / 3, 3),
                                          nan_pixels=nan_px, launches=steps_launches),
                render_phase_seconds_per_sample=render_s_per_sample)
    if not tile_equal or stats != ref_stats or delivered != 1:
        raise RuntimeError(f"4x1 tiles against the banded render: {info['tile_4x1']}")
    if not med < 1e-5 or not info["mixed_2x2"]["rays_equal"] or delivered22 != 2:
        raise RuntimeError(f"2x2 against the mean of samples 0 and 1: {info['mixed_2x2']}")
    if sr_r.sample_count != 6 or nan_px:
        raise RuntimeError(f"ShardedRenderer: {info['sharded_renderer_1x2']}")
    for name in ("tile_4x1", "mixed_2x2", "sharded_renderer_1x2"):
        got = info[name]["launches"]
        if min(got["closest"], got["occlusion"]) <= 0:
            raise RuntimeError(f"{name} did not launch K1 and K2: {got}")


RECOVERY_BAND = 540


def recovery_child(path):
    """The `recovery` phase's child process (chip_smoke.py --recovery
    SCENE): the bench renderer at 1920x1080 with chunk_rows=0; the peak
    memory of one whole-frame sample and of one in 540-row bands; an
    unconstrained 2-spp render; then the process's memory fraction set
    between the two peaks and the same 2-spp render again, which must
    retry at least one real torch.cuda.OutOfMemoryError. Prints one JSON
    line and exits 0, or prints the error and exits 1."""
    import numpy as np
    import torch

    from tpurt_torch import film
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import RenderConfig, SphereLight
    from tpurt_torch.integrator.wavefront import render_sample_stats
    from tpurt_torch.renderer import Renderer

    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_samples=2, chunk_rows=0)
    r = Renderer.from_gltf(path, config=cfg, camera=Camera.from_angles(*CAMERA),
                           lights=[SphereLight(*x) for x in LIGHTS], device=dev, cache=False)
    kw = dict(width=WIDTH, height=HEIGHT, cfg=cfg, has_alpha=r.has_alpha, tex_flags=r.tex_flags)

    def peak(chunk_rows):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        render_sample_stats(r.device_scene, r.bvh, r.camera, 0, chunk_rows=chunk_rows, **kw)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev))

    resident = torch.cuda.memory_allocated(dev)
    full_alloc, full_reserved = peak(0)
    band_alloc, band_reserved = peak(RECOVERY_BAND)
    t0 = time.perf_counter()
    ref = r.render(2).clone()
    ref_s = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(dev).total_memory
    out = dict(resident_bytes=resident, full_frame_peak_bytes=full_alloc,
               full_frame_peak_reserved_bytes=full_reserved,
               band_peak_bytes=band_alloc, band_peak_reserved_bytes=band_reserved,
               band_rows=RECOVERY_BAND, total_bytes=total, unconstrained_2spp_s=round(ref_s, 3))
    # the limit sits between the band's reserved peak and the whole
    # frame's allocated peak: the band fits, the whole frame cannot
    if not band_reserved < full_alloc:
        raise RuntimeError(f"no memory fraction separates the two peaks: the {RECOVERY_BAND}-row "
                           f"band reserves {band_reserved} bytes, the whole frame allocates "
                           f"{full_alloc}: {out}")
    limit = (band_reserved + full_alloc) // 2
    fraction = limit / total
    retries = []
    recover = r._recover_launch_failure

    def counted(err):
        retries.append(type(err).__name__)
        recover(err)

    r._recover_launch_failure = counted
    r.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(fraction, dev)
    t0 = time.perf_counter()
    got = r.render(2)
    out.update(limit_bytes=limit, fraction=fraction, retries=retries,
               constrained_2spp_s=round(time.perf_counter() - t0, 3),
               chunk_rows_at_end=r._chunk_rows_now, sample_count=r.sample_count,
               rmse=film.rmse(got, ref), bit_equal=torch.equal(got, ref),
               nan_pixels=int(torch.isnan(got).any(dim=-1).sum()))
    if "OutOfMemoryError" not in retries or not r._chunk_rows_now < HEIGHT or \
            r.sample_count != 2 or not out["rmse"] < 1e-5 or out["nan_pixels"]:
        raise RuntimeError(f"the constrained render did not recover as required: {out}")
    emit({"recovery": out})


def recovery_phase(info, path):
    """Run recovery_child in a process of its own, so that the memory
    fraction it sets ends with it; its JSON line goes on the phase's."""
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--recovery", path],
                             cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             env=dict(os.environ, PYTHONPATH=ROOT))
    _state["child"] = child
    try:
        out, err = child.communicate(timeout=240)
    finally:
        _state["child"] = None
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    rec = next((x["recovery"] for x in lines if "recovery" in x), None)
    info.update(process_seconds=round(time.perf_counter() - t0, 3),
                retry_lines=[x for x in err.splitlines() if "launch failed" in x])
    if child.returncode != 0 or rec is None:
        raise RuntimeError(f"the recovery child exited with {child.returncode}: "
                           f"{(lines[-1] if lines else out[-800:])} {err[-1500:]}")
    info.update(rec)


def view_process(info, scene, look, env, platform="cuda"):
    """`python -m tpurt_torch.cli view` on `scene` at 320x240 on a free
    port, as a child process: /, /frame.png (a PNG), /status, then
    /key?k=w must move the camera's position and not its direction, and
    /look?dx=80&dy=-40 its direction and not its position. SIGINT ends
    it; it must exit 0."""
    import signal
    import urllib.request

    argv = [sys.executable, "-m", "tpurt_torch.cli", "--platform", platform, "view", scene,
            "--res", "320x240", "--port", "0", *look]
    t0 = time.perf_counter()
    child = subprocess.Popen(argv, cwd=ROOT, text=True, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, env=dict(os.environ, PYTHONPATH=ROOT, **env))
    _state["child"] = child
    err = ""
    try:
        line = child.stdout.readline()  # printed once the server listens
        m = re.search(r"http://([0-9.]+):([0-9]+)/", line)
        if not m:
            child.kill()
            raise RuntimeError(f"view printed {line!r}: {child.communicate()[1][-1500:]}")
        base = f"http://{m.group(1)}:{m.group(2)}"

        def get(p):
            return urllib.request.urlopen(base + p, timeout=60).read()

        up_s = round(time.perf_counter() - t0, 3)
        page, png, status = get("/"), get("/frame.png"), get("/status").decode()
        cams = [json.loads(get("/camera"))]
        for p in ("/key?k=w", "/look?dx=80&dy=-40"):
            get(p)
            cams.append(json.loads(get("/camera")))
    finally:
        if child.returncode is None:
            child.send_signal(signal.SIGINT)
            try:
                err = child.communicate(timeout=60)[1]
            except subprocess.TimeoutExpired:
                child.kill()
                err = child.communicate()[1]
        _state["child"] = None
    moved = [{k: a[k] != b[k] for k in ("position", "direction")}
             for a, b in zip(cams[:-1], cams[1:])]
    info["view"] = dict(seconds=round(time.perf_counter() - t0, 3), listening_s=up_s,
                        png_bytes=len(png), status=status, after_key=moved[0],
                        after_look=moved[1], exit_code=child.returncode)
    if b"tpurt" not in page or png[:4] != b"\x89PNG" or "spp" not in status or \
            moved != [{"position": True, "direction": False},
                      {"position": False, "direction": True}] or child.returncode != 0:
        raise RuntimeError(f"cli view: {info['view']} {err[-1500:]}")


def lbvh_phase(info, r, scene, camera, lights, kb, o_cam, d_cam, wide_img, wide_render):
    """The device LBVH on the bench scene: _build_triangle_bvh_device on
    the card's triangles (cold and warm seconds beside the native SAH
    build's and the CPU run's), every array equal to the CPU run's,
    validate_lbvh, wide tables packed from it, K1 over them on the camera
    batch against K1 over the native tables `kb` (t bit-equal, prim only on
    ties; both timed in turns), then the render through those tables:
    1 warm-up and 2 timed samples, launch counters zeroed just before,
    K1/K2 launched and nothing else, 0 NaN pixels, RMSE against the wide
    render's image `wide_img` within ROPE_VS_WIDE_RMSE; then three samples
    of each renderer in turns, and one device-LBVH sample traced. Returns
    the render's launch counts."""
    import numpy as np
    import torch

    from tpurt_torch import film, native
    from tpurt_torch.bvh import lbvh
    from tpurt_torch.kernels import cudalib, wide
    from tpurt_torch.renderer import Renderer

    dev = r.device
    ds = r.device_scene
    tri_np = ds.tri_pos.cpu().numpy()
    g = wide.pick_group_size_wide(tri_np.shape[0])
    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    built = timed("device_build_cold_s", lambda: lbvh._build_triangle_bvh_device(
        ds.tri_pos, g, device=dev))
    again = timed("device_build_warm_s", lambda: lbvh._build_triangle_bvh_device(
        ds.tri_pos, g, device=dev))
    if not native.available():
        raise RuntimeError(f"native library unavailable: {native.unavailable_reason()}")
    sah = timed("native_sah_build_s", lambda: lbvh.build_triangle_bvh(tri_np, g, device=dev))
    cpu = timed("device_build_on_cpu_s", lambda: lbvh._build_triangle_bvh_device(
        tri_np, g, device="cpu"))
    differ = {}
    for name, a, b in [("tri_order", built.tri_order, cpu.tri_order)] + [
            (f, getattr(built.bvh, f), getattr(cpu.bvh, f)) for f in lbvh.LBVH._fields]:
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            bad = np.nonzero((a != b).reshape(-1))[0] if a.shape == b.shape else []
            differ[name] = {"differing": len(bad), "first": int(bad[0]) if len(bad) else None,
                            "card": str(a.dtype), "cpu": str(b.dtype)}
    repeat_equal = all(getattr(built.bvh, f).tobytes() == getattr(again.bvh, f).tobytes()
                       for f in lbvh.LBVH._fields)
    grouped = tri_np[built.tri_order].reshape(-1, g, 3, 3)
    timed("validate_s", lambda: lbvh.validate_lbvh(built.bvh, grouped.min(axis=(1, 2)),
                                                   grouped.max(axis=(1, 2))))
    kb_dev = timed("pack_s", lambda: wide.make_wide_kernel_bvh(
        built, tri_np, tri_alpha_mask=ds.tri_alpha_mask if r.has_alpha else None,
        tri_alpha_opaque=ds.tri_alpha_opaque if r.has_alpha else None, device=dev))
    info.update(group=g, leaves=built.bvh.num_leaves, sah_leaves=sah.bvh.num_leaves,
                differs_from_cpu=differ, repeat_equal=repeat_equal,
                wide_nodes=int(kb_dev.node_rows.shape[1]), sah_wide_nodes=int(kb.node_rows.shape[1]),
                depth_bound=kb_dev.depth_bound, sah_depth_bound=kb.depth_bound)
    if differ:
        raise RuntimeError(f"the device build on the card differs from its CPU run: {differ} "
                           "(each step is elementwise, a gather, min/max, a stable sort or a "
                           "unique-index scatter, so the two must agree)")
    if not repeat_equal:
        raise RuntimeError("two device builds of the same triangles differ")

    n = o_cam.shape[0]
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    far = torch.full((n,), 1e9, dtype=torch.float32, device=dev)
    kw = dict(occlusion=False, all_definite=False, cell_masks=False)

    def k1_dev():
        return wide.traverse_cuda(kb_dev, o_cam, d_cam, z, far, **kw)

    def k1_sah():
        return wide.traverse_cuda(kb, o_cam, d_cam, z, far, **kw)

    cmp = compare("closest", k1_dev(), k1_sah())
    cudalib.check_kernel_errors(dev)
    dev_ms, sah_ms = timed_pair(k1_dev, k1_sah)
    info["k1_camera_vs_sah"] = dict(cmp, ms=dev_ms, sah_ms=sah_ms)
    if cmp["mismatch"]:
        raise RuntimeError(f"K1 over the device-built tables against the native tables: {cmp}")

    t0 = time.perf_counter()
    rl = Renderer(scene, config=r.config, camera=camera, lights=lights, device=dev, bvh=kb_dev)
    seconds["renderer_s"] = time.perf_counter() - t0
    zero_launch_counts()
    rl.render(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rl.render(3)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = launch_counts()
    img = rl.accum.cpu().numpy()
    nan_px = int(np.isnan(img).any(axis=-1).sum())
    rmse_wide = film.rmse(img, wide_img)
    info.update(step_seconds={k: round(v, 3) for k, v in seconds.items()},
                seconds_per_sample=round(timed_s / 2, 3), launches=launches, nan_pixels=nan_px,
                rmse_vs_wide=rmse_wide, rmse_bound=ROPE_VS_WIDE_RMSE, wide_render=wide_render)

    # s/sample of the two trees in turns (wide render, device-LBVH render,
    # three each), then one device-LBVH sample under the profiler: K1/K2's
    # device ms and the busy share, beside the `trace` phase's
    turns = {"sah": [], "device_lbvh": []}
    for _ in range(3):
        for name, rr in (("sah", r), ("device_lbvh", rl)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rr.step()
            torch.cuda.synchronize()
            turns[name].append(time.perf_counter() - t0)
    info["seconds_per_sample_in_turns"] = {k: median(v) for k, v in turns.items()}
    info["sample_seconds_in_turns"] = turns
    summary, traced, wall, discarded = profiled_step(rl, {"K1": "closest", "K2": "occlusion"})
    info["trace"] = dict(sample_wall_s=wall, launches=traced, discarded_traces=discarded,
                         **summary)
    others = sum(v for k, v in launches.items() if k not in ("closest", "occlusion"))
    if min(launches["closest"], launches["occlusion"]) <= 0 or others:
        raise RuntimeError(f"the device-LBVH render did not launch K1 and K2 alone: {launches}")
    if nan_px or not rmse_wide <= ROPE_VS_WIDE_RMSE:
        raise RuntimeError(f"device-LBVH image: {nan_px} NaN pixels, RMSE {rmse_wide} against "
                           f"the wide render (bound {ROPE_VS_WIDE_RMSE})")
    return launches


def main():
    _state["t0"] = time.perf_counter()
    # no scene cache unless a phase sets one up: every start is cold
    os.environ["TPURT_SCENE_CACHE_DIR"] = "0"
    timer = threading.Timer(DEADLINE_S, watchdog)
    timer.daemon = True
    timer.start()

    import torch

    if not torch.cuda.is_available():
        emit({"error": "no CUDA device: torch.cuda.is_available() is false"})
        return 2
    with Phase("device") as info:
        # fails outside a checkout of the repo
        from tpurt_torch.bench import card_name_and_power

        smi = card_name_and_power()
        info.update(name=torch.cuda.get_device_name(0), nvidia_smi=smi,
                    torch=torch.__version__, cuda=torch.version.cuda,
                    count=torch.cuda.device_count())

    import numpy as np

    from tpurt_torch import film, kernel_bench, native
    from tpurt_torch.bvh.lbvh import build_triangle_bvh
    from tpurt_torch.bvh.traverse import _octant_morton_key
    from tpurt_torch.camera import Camera, camera_rays_for_rows
    from tpurt_torch.config import KernelPolicy, RenderConfig, SphereLight
    from tpurt_torch.kernels import cudalib, wide
    from tpurt_torch.kernels.bsdf import _cross, _dot, _normalize
    from tpurt_torch.kernels.experimental import rope
    from tpurt_torch.kernels.intersect import intersect_spheres
    from tpurt_torch.renderer import Renderer
    from tpurt_torch.scene.gltf import load_gltf
    from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene
    from tpurt_torch.kernel_bench import PEAK_BYTES, PEAK_F32, rope_bound
    from tpurt_torch.kernel_bench import traversal_bound as bound

    dev = torch.device("cuda", 0)

    with Phase("build") as info:
        times, errors = {}, []

        def run(name, fn):
            t0 = time.perf_counter()
            try:
                fn(force=True)
            except Exception as e:  # reported below; the phase fails
                errors.append(f"{name}: {e}")
            times[name] = round(time.perf_counter() - t0, 3)

        def nvcc(name):
            return lambda force: cudalib.build(name, force=force)

        threads = [threading.Thread(target=run, args=(f"nvcc_{name}", nvcc(name)))
                   for name in ("wide_traverse", "rope_traverse", "wide_octet", "wide_stepcost")]
        threads.append(threading.Thread(target=run, args=("gxx_native", native.build)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError("; ".join(errors))
        info.update(times)
        for key, source, walk in (("k1_k2_ptxas", "wide_traverse", "wide_walk"),
                                  ("k3_k4_ptxas", "rope_traverse", "rope_walk")):
            info[key] = template_resources(cudalib.kernel_resources(source), walk,
                                           lambda a, ids=WALKS[walk]: f"{ids[a[0]]} masks={a[1]}")
            if len(info[key]) != 4:
                raise RuntimeError(f"ptxas reported {sorted(info[key])} for {walk}")
        info["k5_ptxas"] = template_resources(
            cudalib.kernel_resources("wide_octet"), "octet_walk",
            lambda a: f"{('K5 closest', 'K5 occlusion')[a[0]]} masks={a[1]} "
                      f"{'one warp per walk' if a[2] > 1 else 'one block per walk'}")
        info["k6_ptxas"] = template_resources(cudalib.kernel_resources("wide_stepcost"),
                                              "wide_stepcost", STEPCOST_TEMPLATES.get)
        if len(info["k5_ptxas"]) != 8 or \
                sorted(info["k6_ptxas"]) != sorted(STEPCOST_TEMPLATES.values()):
            raise RuntimeError(f"ptxas reported {sorted(info['k5_ptxas'])} for K5 and "
                               f"{sorted(info['k6_ptxas'])} for K6")
        ptxas = dict(info)

    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory()
    lights = [SphereLight(*x) for x in LIGHTS]
    camera = Camera.from_angles(*CAMERA)
    with Phase("scene") as info:
        t0 = time.perf_counter()
        path = write_sponza_like_scene(os.path.join(tmp.name, "sponza.gltf"), **SCENE_KW)
        write_s = time.perf_counter() - t0
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_samples=1024)
        r = Renderer.from_gltf(path, config=cfg, camera=camera, lights=lights, device=dev,
                               cache=False)
        kb = r.bvh
        info.update(triangles=int(r.device_scene.tri_pos.shape[0]),
                    wide_nodes=int(kb.node_rows.shape[1]),
                    leaves=int(kb.tri_rows.shape[0]),
                    leaf_row_floats=int(kb.tri_rows.shape[1]),
                    stack_bound=kb.stack_bound, depth_bound=kb.depth_bound,
                    table_mb=round((kb.node_rows.numel() + kb.tri_rows.numel()) * 4 / 2**20, 2),
                    card_table_mb=round((kb.card.nodes.numel() + kb.card.leaves.numel()) * 4
                                        / 2**20, 2),
                    has_alpha=r.has_alpha, scene_write_s=round(write_s, 3),
                    **{k: round(v, 3) for k, v in r.timings.items()})

    kernel_rows = []
    with Phase("kernels") as info:
        rs = np.random.RandomState(7)
        o_all, d_all, _ = camera_rays_for_rows(r.camera, 0, HEIGHT, WIDTH, HEIGHT,
                                               cfg.tan_half_fov, 0, cfg.seed, device=dev)
        # a coherent 256 x 256 pixel window at the image centre, row-major
        rows = torch.arange(HEIGHT // 2 - 128, HEIGHT // 2 + 128, device=dev)
        cols = torch.arange(WIDTH // 2 - 128, WIDTH // 2 + 128, device=dev)
        pick = (rows[:, None] * WIDTH + cols[None, :]).reshape(-1)
        o_cam = o_all[pick].contiguous()
        d_cam = d_all[pick].contiguous()
        zeros = torch.zeros(N_RAYS, dtype=torch.float32, device=dev)
        far = torch.full((N_RAYS,), 1e9, dtype=torch.float32, device=dev)
        ds = r.device_scene

        # the camera hits seed the bounce and shadow batches
        t_c, p_c, _ = wide.traverse_plain(kb.node_rows, kb.tri_rows, o_cam, d_cam, zeros,
                                          far, group=kb.group_size, arity=kb.arity,
                                          occlusion=False, all_definite=False,
                                          cell_masks=False)
        hit = p_c >= 0
        tri = ds.tri_pos[torch.clamp(p_c, min=0).long()]
        nrm = _normalize(_cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
        nrm = torch.where((_dot(nrm, d_cam) > 0)[:, None], -nrm, nrm)
        p_hit = torch.where(hit[:, None], o_cam + t_c[:, None] * d_cam, o_cam)
        org = (p_hit + 0.01 * torch.where(hit[:, None], nrm, torch.zeros_like(nrm))).contiguous()
        rnd = torch.from_numpy(rs.randn(N_RAYS, 3).astype(np.float32)).to(dev)
        rnd = _normalize(rnd)
        d_b = torch.where((hit & (_dot(rnd, nrm) < 0))[:, None], -rnd, rnd).contiguous()
        lp = torch.tensor([l.position for l in lights], dtype=torch.float32, device=dev)
        lp = lp[torch.arange(N_RAYS, device=dev) % len(lights)]
        d_s = _normalize(lp - org).contiguous()
        s_hit, s_t, _ = intersect_spheres(org, d_s, ds.lights, zeros, 1e9)
        t_lim = torch.where(s_hit, s_t, far).contiguous()

        # secondary batches go in the octant-Morton order the main path
        # sorts them into
        every = torch.ones(N_RAYS, dtype=torch.bool, device=dev)
        ob = torch.argsort(_octant_morton_key(kb, org, d_b, every), stable=True)
        os_ = torch.argsort(_octant_morton_key(kb, org, d_s, every), stable=True)
        cases = [("camera", "closest", o_cam, d_cam, far, False),
                 ("bounce", "closest", org[ob].contiguous(), d_b[ob].contiguous(), far, True),
                 ("shadow", "occlusion", org[os_].contiguous(), d_s[os_].contiguous(),
                  t_lim[os_].contiguous(), False)]
        results = {}
        for name, mode, o, d, tl, masks in cases:
            occl = mode == "occlusion"
            kw = dict(occlusion=occl, all_definite=not r.has_alpha, cell_masks=masks)

            def kern():
                return wide.traverse_cuda(kb, o, d, zeros, tl, **kw)

            stats = {}

            def plain(stats=stats):
                return wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, zeros, tl,
                                           group=kb.group_size, arity=kb.arity,
                                           stats=stats, **kw)

            out_k = kern()
            out_p = plain()
            cudalib.check_kernel_errors(dev)
            cmp = compare_exact(out_k, out_p)
            b_ms, b_by, ops, nbytes = bound(stats, N_RAYS, kb.tri_rows.shape[1],
                                            kb.group_size)
            k_ms, p_ms = timed_pair(kern, plain)
            results[name] = dict(mode=mode, ms=k_ms, plain_ms=p_ms,
                                 bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
                                 node_visits_per_ray=float(stats["node_visits"].float().mean()),
                                 leaf_visits_per_ray=float(stats["leaf_visits"].float().mean()),
                                 box_tests_per_ray=float(stats["box_tests"].float().mean()),
                                 **cmp)
        info.update(cases=results)
        bad = sum(v["mismatch"] for v in results.values())
        if bad:
            raise RuntimeError(f"K1/K2 against the plain version: {bad} rays differ")
        if results["bounce"]["flag_set"] == 0:
            raise RuntimeError("no pending hit in the bounce batch: cell masks not exercised")

        def entry(name, replaces, names, res=results, source="tpurt_torch/csrc/wide_traverse.cu"):
            sel = [res[c] for c in names]
            by_ops = sum(x["ops"] for x in sel) / PEAK_F32
            by_bytes = sum(x["bytes"] for x in sel) / PEAK_BYTES
            return {"name": name, "route": "cuda",
                    "source": source,
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": max(x["max_abs_err"] for x in sel),
                    "ms": sum(x["ms"] for x in sel),
                    "plain_ms": sum(x["plain_ms"] for x in sel),
                    "bound_ms": max(by_ops, by_bytes) * 1e3,
                    "bound_by": "operations" if by_ops >= by_bytes else "bytes",
                    "library_ms": None, "rays": N_RAYS * len(sel), "cases": names}

        kernel_rows = [
            entry("K1 wide closest hit", "tpurt/kernels/pallas_wide.py:1500", ["camera", "bounce"]),
            entry("K2 wide occlusion", "tpurt/kernels/pallas_wide.py:1500", ["shadow"]),
        ]

        # ---- K3 / K4 over the rope tables of the same tree, mask column on
        tri_np = ds.tri_pos.cpu().numpy()
        rk = rope.make_kernel_bvh(kb.tribvh, tri_np, ds.tri_alpha_mask, device=dev)
        if not rk.use_masks:
            raise RuntimeError("the rope tables carry no mask column: masks not exercised")
        ones = torch.ones(N_RAYS, dtype=torch.bool, device=dev)
        rope_results = {}
        for name, mode, o, d, tl, _ in cases:
            kw = dict(occlusion=mode == "occlusion", all_definite=not r.has_alpha)

            def kern():
                return rope.traverse_cuda(rk, o, d, zeros, tl, ones, **kw)

            stats = {}

            def plain(stats=stats):
                return rope.traverse_plain(rk.node_rows, rk.tri_rows, o, d, zeros, tl, ones,
                                           n_internal=rk.n_internal, group=rk.group_size,
                                           stats=stats, **kw)

            out_k = kern()
            out_p = plain()
            cudalib.check_kernel_errors(dev)
            cmp = compare_exact(out_k, out_p)
            b_ms, b_by, ops, nbytes = rope_bound(stats, N_RAYS, rk.tri_rows.shape[1],
                                                 rk.group_size)
            k_ms, p_ms = timed_pair(kern, plain)
            rope_results[name] = dict(mode=mode, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                      bound_by=b_by, ops=ops, bytes=nbytes,
                                      steps_per_ray=float(stats["node_visits"].float().mean()),
                                      leaf_tests_per_ray=float(stats["leaf_visits"].float().mean()),
                                      **cmp)
        info.update(rope_cases=rope_results)

        # across: K3 against K1 with the same cell rejection; K4 against K2
        # over tables without masks, where the answer does not depend on the
        # walk's order (every hit definite: the blocked set; none definite:
        # the closest hit below t_limit)
        across = {}
        for name, _, o, d, _, _ in cases[:2]:
            t1, p1, _, _, _ = wide.traverse_packets(kb, o, d, zeros, 1e9, ones, cell_masks=True)
            t3, p3, _, _ = rope.traverse_packets(rk, o, d, zeros, 1e9, ones)
            across[f"K3_vs_K1_{name}"] = compare("closest", (t3, p3, zeros), (t1, p1, zeros))
        _, _, o, d, tl, _ = cases[2]
        kb0 = wide.make_wide_kernel_bvh(kb.tribvh, tri_np, device=dev)
        rk0 = rope.make_kernel_bvh(kb.tribvh, tri_np, device=dev)
        for alpha in (False, True):
            b2, t2, p2, _, _ = wide.occlusion_packets(kb0, o, d, zeros, tl, ones, alpha)
            b4, t4, p4, _, _ = rope.occlusion_packets(rk0, o, d, zeros, tl, ones, alpha)
            f2, f4 = b2.float(), b4.float()
            if alpha:  # no hit definite: nothing blocks, the closest hit is the answer
                across["K4_vs_K2_none_definite"] = compare("occlusion", (t4, p4, f4), (t2, p2, f2))
            else:
                across["K4_vs_K2_all_definite"] = {
                    "rays": N_RAYS, "blocked": int(b4.sum()),
                    "mismatch": int((b2 != b4).sum()), "max_abs_err": 0.0}
        cudalib.check_kernel_errors(dev)
        info.update(rope_across=across)
        bad = (sum(v["mismatch"] for v in rope_results.values())
               + sum(v["mismatch"] for v in across.values()))
        if bad:
            raise RuntimeError(f"K3/K4 against the plain walk (and across): {bad} rays differ")
        if rope_results["shadow"]["flag_set"] == 0:
            raise RuntimeError("no blocked ray in the K4 shadow batch")
        kernel_rows += [
            entry("K3 rope closest hit", "tpurt/kernels/experimental/pallas_traverse.py:215",
                  ["camera", "bounce"], rope_results, "tpurt_torch/csrc/rope_traverse.cu"),
            entry("K4 rope occlusion", "tpurt/kernels/experimental/pallas_traverse.py:451",
                  ["shadow"], rope_results, "tpurt_torch/csrc/rope_traverse.cu"),
        ]
        for row in kernel_rows[2:]:
            row["max_abs_err"] = max([row["max_abs_err"]]
                                     + [v["max_abs_err"] for v in across.values()])

        # ---- K1/K2 over 8-ary tables of the same tree, against their plain
        # versions and timed in turns with them and with the 16-ary tables
        kb8 = wide.make_wide_kernel_bvh(
            kb.tribvh, tri_np, tri_alpha_mask=ds.tri_alpha_mask if r.has_alpha else None,
            tri_alpha_opaque=ds.tri_alpha_opaque if r.has_alpha else None, arity=8, device=dev)
        arity8 = {}
        for name, mode, o, d, tl, masks in cases:
            kw = dict(occlusion=mode == "occlusion", all_definite=not r.has_alpha,
                      cell_masks=masks)

            def kern8(o=o, d=d, tl=tl, kw=kw):
                return wide.traverse_cuda(kb8, o, d, zeros, tl, **kw)

            def kern16(o=o, d=d, tl=tl, kw=kw):
                return wide.traverse_cuda(kb, o, d, zeros, tl, **kw)

            stats = {}

            def plain8(o=o, d=d, tl=tl, kw=kw, stats=stats):
                return wide.traverse_plain(kb8.node_rows, kb8.tri_rows, o, d, zeros, tl,
                                           group=kb8.group_size, arity=8, stats=stats, **kw)

            out_k = kern8()
            out_p = plain8()
            cudalib.check_kernel_errors(dev)
            cmp = compare_exact(out_k, out_p)
            if mode == "closest":  # the same function at either arity
                cmp["vs_arity16"] = compare("closest", out_k, kern16())
            b_ms, b_by, ops, nbytes = bound(stats, N_RAYS, kb8.tri_rows.shape[1],
                                            kb8.group_size)
            k_ms, p_ms = timed_pair(kern8, plain8)
            k8_ms, k16_ms = timed_pair(kern8, kern16)
            arity8[name] = dict(mode=mode, ms=k_ms, plain_ms=p_ms, in_turns_ms=k8_ms,
                                arity16_in_turns_ms=k16_ms, bound_ms=b_ms, bound_by=b_by,
                                ops=ops, bytes=nbytes,
                                box_tests_per_ray=float(stats["box_tests"].float().mean()),
                                node_visits_per_ray=float(stats["node_visits"].float().mean()),
                                **cmp)
        cudalib.check_kernel_errors(dev)
        info.update(arity8_cases=arity8, arity8_wide_nodes=int(kb8.node_rows.shape[1]),
                    arity8_depth_bound=kb8.depth_bound)
        bad = sum(v["mismatch"] + v.get("vs_arity16", {}).get("mismatch", 0)
                  for v in arity8.values())
        if bad:
            raise RuntimeError(f"K1/K2 over 8-ary tables against the plain version: {bad} "
                               "rays differ")
        for row, names in ((kernel_rows[0], ("camera", "bounce")), (kernel_rows[1], ("shadow",))):
            sel = [arity8[c] for c in names]
            row["arity8"] = {"ms": sum(x["ms"] for x in sel),
                             "plain_ms": sum(x["plain_ms"] for x in sel),
                             "in_turns_ms": sum(x["in_turns_ms"] for x in sel),
                             "arity16_in_turns_ms": sum(x["arity16_in_turns_ms"] for x in sel),
                             "bound_ms": max(sum(x["ops"] for x in sel) / PEAK_F32,
                                             sum(x["bytes"] for x in sel) / PEAK_BYTES) * 1e3,
                             "rays": N_RAYS * len(sel), "mismatch": 0,
                             "max_abs_err": max(x["max_abs_err"] for x in sel)}
        # the two-pass near trace without overflow: the bounce batch's rays
        # that hit (in sort order, a whole number of packets), r0 at the
        # 85th percentile of their t, so 15% go to the second pass; t must
        # be the single pass's bit for bit
        _, _, o, d, _, _ = cases[1]
        t1, p1, _ = wide.traverse_cuda(kb8, o, d, zeros, far, occlusion=False,
                                       all_definite=False, cell_masks=False)
        sel = torch.nonzero(p1 >= 0)[:, 0]
        sel = sel[:sel.numel() // 1024 * 1024]
        r0 = float(torch.quantile(t1[sel].double(), 0.85))
        t2, p2, nmiss, capn = kernel_bench.near_pass(kb8, o[sel].contiguous(),
                                                     d[sel].contiguous(), r0, cfg.t_max)
        cudalib.check_kernel_errors(dev)
        near = {"rays": int(sel.numel()), "r0": r0, "misses": int(nmiss), "capn": capn,
                "overflow": int(nmiss) > capn,
                "t_bit_equal": bool(torch.equal(t2.view(torch.int32),
                                                t1[sel].view(torch.int32))),
                "prim_agree": float((p2 == p1[sel]).float().mean())}
        info["near2_without_overflow"] = near
        if near["overflow"] or not near["t_bit_equal"] or not near["misses"]:
            raise RuntimeError(f"two-pass near trace against the single pass: {near}")
        del kb8

        # kernel_bench at arity 8 with the two-pass near trace, through its
        # entry point; where no ray overflowed the second pass, the two-pass
        # t must be the single pass's bit for bit
        rec = kernel_bench.main(["--arity", "8", "--near", "0.1", "--reps", str(REPS)])
        cudalib.check_kernel_errors(dev)
        info["kernel_bench_arity8_near"] = rec
        if rec["arity"] != 8 or not (rec["near2_overflow"] or rec["near2_t_bit_equal"]):
            raise RuntimeError(f"kernel_bench --arity 8 --near 0.1: arity {rec['arity']}, "
                               f"overflow {rec['near2_overflow']}, t bit-equal "
                               f"{rec['near2_t_bit_equal']}")

    with Phase("render") as info:
        # during the warm-up sample, keep the first launch of each kind of
        # wave (inputs and kernel outputs) to hold against the plain version
        # below, outside the timed samples
        captured = {}
        launch = wide.traverse_cuda

        def capture(kbvh, o, d, t_min, t_limit, **kw):
            out = launch(kbvh, o, d, t_min, t_limit, **kw)
            retrace = bool((t_min != 0).any())
            if kw["occlusion"]:
                name = "shadow_retrace" if retrace else "shadow_wave"
            elif retrace:
                name = "alpha_retrace"
            else:
                name = "bounce_wave" if "camera_wave" in captured else "camera_wave"
            if name not in captured:
                captured[name] = ((o.clone(), d.clone(), t_min.clone(), t_limit.clone()),
                                  kw, tuple(x.clone() for x in out))
            return out

        zero_launch_counts()
        wide.traverse_cuda = capture
        try:
            t0 = time.perf_counter()
            r.render(1)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
        finally:
            wide.traverse_cuda = launch
        r0 = r.rays.physical
        sample_physical = {}  # sample index -> Renderer.last_stats.physical
        t0 = time.perf_counter()
        while r.sample_count < 3:
            r.step()
            sample_physical[r.sample_count - 1] = r.last_stats.physical
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
        launches = launch_counts()
        rays = r.rays.physical - r0
        accum = r.accum
        nan_px = int(torch.isnan(accum).any(dim=-1).sum())
        red = int(((accum[..., 0] == 1) & (accum[..., 1] == 0) & (accum[..., 2] == 0)).sum())
        mean = float(accum[..., :3].mean())
        png_path = os.path.join(OUT_DIR, "sponza_1080p_3spp.png")
        r.save_png(png_path)
        info.update(warmup_s=round(warm, 3), seconds_per_sample=round(timed / 2, 3),
                    rays_physical_2spp=rays, mrays_per_s=round(rays / timed / 1e6, 3),
                    launches=launches, nan_pixels=nan_px, nan_red_pixels=red,
                    mean_radiance=mean, png=os.path.relpath(png_path, ROOT),
                    peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))
        if min(launches["closest"], launches["occlusion"]) <= 0 or launches["rope_closest"] \
                or launches["rope_occlusion"]:
            raise RuntimeError(f"the wide render did not launch K1 and K2 alone: {launches}")
        if nan_px or not mean > 0.0:
            raise RuntimeError(f"bad image: {nan_px} NaN pixels, mean {mean}")
        kernel_rows[0]["launches"] = launches["closest"]
        kernel_rows[1]["launches"] = launches["occlusion"]
        wide_render = {"seconds_per_sample": info["seconds_per_sample"],
                       "launches": {k: launches[k] for k in ("closest", "occlusion")}}

        # each captured wave against the plain version, then K1/K2 timed on
        # it: the main path's own shapes (whole-frame waves)
        t0 = time.perf_counter()
        main_cases = {}
        for name, (args, kw, out_k) in captured.items():
            stats = {}
            p_ms, out_p = cuda_ms(lambda args=args, kw=kw, stats=stats: wide.traverse_plain(
                kb.node_rows, kb.tri_rows, *args, group=kb.group_size, arity=kb.arity,
                stats=stats, **kw))
            row = compare_exact(out_k, out_p)
            del out_p
            n = int(args[0].shape[0])
            ms = timed_kernel(lambda args=args, kw=kw: wide.traverse_cuda(kb, *args, **kw))
            b_ms, b_by, _, _ = bound(stats, n, kb.tri_rows.shape[1], kb.group_size)
            main_cases[name] = dict(row, ms=ms, ns_per_ray=ms * 1e6 / n, plain_ms=p_ms,
                                    bound_ms=b_ms, bound_by=b_by)
        cudalib.check_kernel_errors(dev)
        info.update(main_path_cases=main_cases,
                    main_path_check_s=round(time.perf_counter() - t0, 3))
        for want in ("camera_wave", "bounce_wave", "shadow_wave"):
            if want not in main_cases:
                raise RuntimeError(f"the render launched no {want}: {sorted(main_cases)}")
        bad = sum(v["mismatch"] for v in main_cases.values())
        if bad:
            raise RuntimeError(f"main-path K1/K2 against the plain version: {bad} rays differ")
        for row, modes in ((kernel_rows[0], ("camera_wave", "bounce_wave", "alpha_retrace")),
                           (kernel_rows[1], ("shadow_wave", "shadow_retrace"))):
            waves = {m: main_cases[m] for m in modes if m in main_cases}
            row["max_abs_err"] = max([row["max_abs_err"]]
                                     + [v["max_abs_err"] for v in waves.values()])
            row["main_path_rays_checked"] = sum(v["rays"] for v in waves.values())
            row["main_path_waves"] = {m: {k: v[k] for k in ("rays", "ms", "ns_per_ray",
                                                          "bound_ms", "bound_by", "plain_ms")}
                                      for m, v in waves.items()}

    with Phase("trace") as info:
        # one more sample of the same render under the profiler, through
        # utils.profiling.trace (a Chrome trace) and the integrator's
        # annotations
        from tpurt_torch.utils import profiling

        zero_launch_counts()
        done = r.sample_count
        torch.cuda.synchronize()
        trace_dir = os.path.join(tmp.name, "trace")
        with profiling.trace(trace_dir) as prof:
            t0 = time.perf_counter()
            r.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = launch_counts()
        if r.sample_count != done + 1:
            raise RuntimeError(f"the traced step rendered {r.sample_count - done} samples")
        sample_physical[done] = r.last_stats.physical
        trace_files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        if len(trace_files) != 1:
            raise RuntimeError(f"profiling.trace wrote {trace_files}")
        summary = trace_summary(prof, wall, ("K1", "K2"))
        info.update(sample_wall_s=wall, launches=launches,
                    trace_file_mb=round(os.path.getsize(os.path.join(
                        trace_dir, trace_files[0])) / 2**20, 1),
                    annotations=annotation_table(prof, wall), **summary)
        del prof
        shutil.rmtree(trace_dir)
        for k, mode in (("K1", "closest"), ("K2", "occlusion")):
            if summary[k]["launches"] == 0:
                raise RuntimeError(f"the trace of a sample shows no {k} kernel")
            if summary[k]["launches"] != launches[mode]:
                raise RuntimeError(f"{k}: {summary[k]['launches']} kernels traced, "
                                   f"{launches[mode]} launches counted")
        for row, k in ((kernel_rows[0], "K1"), (kernel_rows[1], "K2")):
            row["trace_per_sample"] = summary[k]

    with Phase("rope") as info:
        wide_img = accum.cpu().numpy()
        del captured, accum
        t0 = time.perf_counter()
        scene = load_gltf(path)
        tri = r.device_scene.tri_pos.cpu().numpy()
        rr = Renderer(scene, config=cfg, camera=camera, lights=lights, device=dev,
                      bvh=build_triangle_bvh(tri, group_size=8))
        setup_s = time.perf_counter() - t0
        if not isinstance(rr.bvh, rope.KernelBVH):
            raise RuntimeError(f"bvh=<TriBVH> did not take the rope path: {type(rr.bvh)}")
        # during the warm-up sample keep the K3 launch of the first camera
        # wave, the first shadow wave (traced as closest hits), the first
        # bounce wave (the first fresh trace with spheres) and the first
        # alpha re-trace (t_min > 0)
        import tpurt_torch.bvh.traverse as traverse_mod

        captured, wanted = {}, []
        scene_walk, launch = traverse_mod.intersect_scene, rope.traverse_cuda

        def walk(bvh, tri_pos, lights_, o, d, t_min, t_max, include_spheres=True, active=None):
            if bool((t_min != 0).any()):
                name = "alpha_retrace"
            elif include_spheres:
                name = "bounce_wave"
            else:
                name = "shadow_wave" if "camera_wave" in captured else "camera_wave"
            wanted.append(None if name in captured else name)
            try:
                return scene_walk(bvh, tri_pos, lights_, o, d, t_min, t_max,
                                  include_spheres=include_spheres, active=active)
            finally:
                wanted.pop()

        def capture(kbvh, o, d, t_min, t_limit, active, **kw):
            out = launch(kbvh, o, d, t_min, t_limit, active, **kw)
            if wanted and wanted[-1] and wanted[-1] not in captured:
                captured[wanted[-1]] = ((o.clone(), d.clone(), t_min.clone(), t_limit.clone(),
                                         active.clone()), kw, tuple(x.clone() for x in out))
            return out

        zero_launch_counts()
        traverse_mod.intersect_scene, rope.traverse_cuda = walk, capture
        try:
            t0 = time.perf_counter()
            rr.render(1)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
        finally:
            traverse_mod.intersect_scene, rope.traverse_cuda = scene_walk, launch
        r0 = rr.rays.physical
        t0 = time.perf_counter()
        rr.render(3)
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
        launches = launch_counts()
        rays = rr.rays.physical - r0
        img = rr.accum.cpu().numpy()
        nan_px = int(np.isnan(img).any(axis=-1).sum())
        rmse_wide = film.rmse(img, wide_img)
        png_path = os.path.join(OUT_DIR, "sponza_1080p_3spp_rope.png")
        rr.save_png(png_path)
        info.update(setup_s=round(setup_s, 3), warmup_s=round(warm, 3),
                    seconds_per_sample=round(timed / 2, 3), rays_physical_2spp=rays,
                    rays_per_sample=rays / 2, mrays_per_s=round(rays / timed / 1e6, 3),
                    launches=launches, nan_pixels=nan_px, rmse_vs_wide=rmse_wide,
                    rmse_bound=ROPE_VS_WIDE_RMSE, png=os.path.relpath(png_path, ROOT),
                    card_table_mb=round(sum(x.numel() for x in (
                        rr.bvh.card.boxes, rr.bvh.card.links, rr.bvh.card.tris)) * 4 / 2**20, 2),
                    peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))
        if launches["rope_closest"] <= 0 or launches["rope_occlusion"] or launches["closest"] \
                or launches["occlusion"]:
            raise RuntimeError(f"the rope render did not launch K3 alone: {launches}")
        if nan_px or not rmse_wide <= ROPE_VS_WIDE_RMSE:
            raise RuntimeError(f"rope image: {nan_px} NaN pixels, RMSE {rmse_wide} against "
                               f"the wide render (bound {ROPE_VS_WIDE_RMSE})")
        kernel_rows[2]["launches"] = launches["rope_closest"]

        # one more rope sample under the profiler
        summary, traced, wall, discarded = profiled_step(rr, {"K3": "rope_closest"})
        info.update(trace=dict(sample_wall_s=wall, launches=traced, discarded_traces=discarded,
                               **summary))
        if summary["K3"]["launches"] == 0:
            raise RuntimeError("the trace of a rope sample shows no K3 kernel")
        kernel_rows[2]["trace_per_sample"] = summary["K3"]

        # each captured wave against the plain walk, then K3 timed on it:
        # the rope render's own shapes (whole-frame waves)
        t0 = time.perf_counter()
        rt = rr.bvh
        main_cases = {}

        def wave_case(kbvh, args, kw, out_k, ids=False):
            """out_k against the plain walk on the same inputs (prim as
            original ids when `ids`), the kernel's median time and the
            bound of the plain walk's steps."""
            stats = {}
            p_ms, out_p = cuda_ms(lambda: rope.traverse_plain(
                kbvh.node_rows, kbvh.tri_rows, *args, n_internal=kbvh.n_internal,
                group=kbvh.group_size, stats=stats, **kw))
            if ids:
                out_p = (out_p[0], rope.original_ids(kbvh, out_p[1])) + tuple(out_p[2:])
            row = compare_exact(out_k, out_p)
            del out_p
            n = int(args[0].shape[0])
            ms = timed_kernel(lambda: rope.traverse_cuda(kbvh, *args, **kw))
            b_ms, b_by, _, _ = rope_bound(stats, n, kbvh.tri_rows.shape[1], kbvh.group_size)
            return dict(row, ms=ms, ns_per_ray=ms * 1e6 / n, plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=b_by,
                        steps_per_ray=float(stats["node_visits"].float().mean()),
                        leaf_tests_per_ray=float(stats["leaf_visits"].float().mean()))

        for name, (args, kw, out_k) in captured.items():
            main_cases[name] = wave_case(rt, args, kw, out_k)
        if sorted(main_cases) != ["alpha_retrace", "bounce_wave", "camera_wave", "shadow_wave"]:
            raise RuntimeError(f"the rope render's waves were not captured: {sorted(main_cases)}")

        # K4's own path: rope.occlusion_packets on the frame's shadow rays,
        # from the camera wave's hits to the lights in turn, masks on
        (o_c, d_c, _, _, _), _, (t_c, s_c, _, _, _) = captured["camera_wave"]
        del captured
        n = o_c.shape[0]
        hit = s_c >= 0
        p_hit = o_c + torch.where(hit, t_c, torch.zeros_like(t_c))[:, None] * d_c
        org = (p_hit - 0.01 * d_c).contiguous()
        lp = torch.tensor([l.position for l in lights], dtype=torch.float32, device=dev)
        d_s = _normalize(lp[torch.arange(n, device=dev) % len(lights)] - org).contiguous()
        z = torch.zeros(n, dtype=torch.float32, device=dev)
        s_hit, s_t, _ = intersect_spheres(org, d_s, ds.lights, z, 1e9)
        t_lim = torch.where(s_hit, s_t, torch.full_like(s_t, 1e9)).contiguous()
        act = hit.contiguous()
        zero_launch_counts()
        out_k = rope.occlusion_packets(rk, org, d_s, z, t_lim, act, True)
        torch.cuda.synchronize()
        harness = launch_counts()
        if harness["rope_occlusion"] <= 0 or sum(harness.values()) != harness["rope_occlusion"]:
            raise RuntimeError(f"rope.occlusion_packets did not launch K4 alone: {harness}")
        kernel_rows[3]["launches"] = harness["rope_occlusion"]
        blocked_k, t_k, p_k, u_k, v_k = out_k
        main_cases["k4_shadow_frame"] = wave_case(
            rk, (org, d_s, z, t_lim, act), dict(occlusion=True, all_definite=False),
            (t_k, p_k, u_k, v_k, blocked_k.float()), ids=True)
        cudalib.check_kernel_errors(dev)
        info.update(main_path_cases=main_cases, k4_launches=harness["rope_occlusion"],
                    main_path_check_s=round(time.perf_counter() - t0, 3))
        bad = sum(v["mismatch"] for v in main_cases.values())
        if bad:
            raise RuntimeError(f"rope main-path K3/K4 against the plain walk: {bad} rays differ")
        if main_cases["k4_shadow_frame"]["flag_set"] == 0:
            raise RuntimeError("no blocked ray in K4's frame-shadow run")
        for row, modes in ((kernel_rows[2], ("camera_wave", "bounce_wave", "shadow_wave",
                                             "alpha_retrace")),
                           (kernel_rows[3], ("k4_shadow_frame",))):
            row["max_abs_err"] = max([row["max_abs_err"]]
                                     + [main_cases[m]["max_abs_err"] for m in modes])
            row["main_path_rays_checked"] = sum(main_cases[m]["rays"] for m in modes)
            row["main_path_waves"] = {m: {k: main_cases[m][k] for k in (
                "rays", "ms", "ns_per_ray", "bound_ms", "bound_by", "plain_ms")} for m in modes}

    with Phase("octet") as info:
        by_name = {c[0]: c for c in cases}
        octet_results, across5 = {}, {}
        for name, walks in (("camera", 8), ("bounce", 8), ("shadow", 8), ("camera", 2),
                            ("camera", 4)):
            _, mode, o, d, tl, masks = by_name[name]
            occl = mode == "occlusion"
            kw = dict(occlusion=occl, all_definite=not r.has_alpha, cell_masks=masks)

            def kern5(o=o, d=d, tl=tl, walks=walks, kw=kw):
                return wide.octet_cuda(kb, o, d, zeros, tl, walks=walks, **kw)

            def kern1(o=o, d=d, tl=tl, kw=kw):
                return wide.traverse_cuda(kb, o, d, zeros, tl, **kw)

            stats = {}
            out_k = kern5()
            p_ms, out_p = cuda_ms(lambda: wide.octet_plain(
                kb.node_rows, kb.tri_rows, o, d, zeros, tl, group=kb.group_size,
                arity=kb.arity, walks=walks, stats=stats, **kw))
            cudalib.check_kernel_errors(dev)
            row = compare_exact(out_k, out_p)
            if not occl:
                across5[f"K5_{walks}_vs_K1_{name}"] = compare("closest", out_k, kern1())
            k_ms, k1_ms = timed_pair(kern5, kern1)
            cudalib.check_kernel_errors(dev)
            # bound_ms: the function's (K1/K2's on the same rays); the union
            # walk's tests give union_bound_ms, union_ops and union_bytes
            u_ms, _, ops, nbytes = bound(stats, N_RAYS, kb.tri_rows.shape[1], kb.group_size)
            octet_results[f"{name}_{walks}"] = dict(
                mode=mode, walks=walks, warp_per_walk=wide.octet_warp_per_walk(N_RAYS, walks),
                ms=k_ms, k1_ms=k1_ms, plain_ms=p_ms,
                bound_ms=results[name]["bound_ms"], bound_by=results[name]["bound_by"],
                union_bound_ms=u_ms, union_ops=ops, union_bytes=nbytes,
                box_tests_per_ray=float(stats["box_tests"].float().mean()),
                k1_box_tests_per_ray=results[name]["box_tests_per_ray"],
                walk_node_steps=float(stats["node_visits"].float().mean()),
                walk_leaf_steps=float(stats["leaf_visits"].float().mean()), **row)
        # K5 against K2 over tables without masks, where the answer does not
        # depend on the walk's order
        _, _, o, d, tl, _ = by_name["shadow"]
        for alpha in (False, True):
            b2, t2, p2, _, _ = wide.occlusion_packets(kb0, o, d, zeros, tl, ones, alpha)
            b5, t5, p5, _, _ = wide.occlusion_packets(kb0, o, d, zeros, tl, ones, alpha, octet=8)
            if alpha:
                across5["K5_vs_K2_none_definite"] = compare(
                    "occlusion", (t5, p5, b5.float()), (t2, p2, b2.float()))
            else:
                across5["K5_vs_K2_all_definite"] = {
                    "rays": N_RAYS, "blocked": int(b5.sum()),
                    "mismatch": int((b2 != b5).sum()), "max_abs_err": 0.0}
        cudalib.check_kernel_errors(dev)
        info.update(cases=octet_results, across=across5)
        bad = (sum(v["mismatch"] for v in octet_results.values())
               + sum(v["mismatch"] for v in across5.values()))
        if bad:
            raise RuntimeError(f"K5 mismatches: {bad}")
        if octet_results["bounce_8"]["flag_set"] == 0 or octet_results["shadow_8"]["flag_set"] == 0:
            raise RuntimeError("K5 set no pending or blocked flag: masks not exercised")

        # the render path through K5
        t0 = time.perf_counter()
        octet_cfg = dataclasses.replace(cfg, kernel=KernelPolicy(octet_closest=8,
                                                                 octet_occlusion=8))
        ro = Renderer(scene, config=octet_cfg, camera=camera, lights=lights, device=dev, bvh=kb)
        setup_s = time.perf_counter() - t0
        captured = {}
        launch5 = wide.octet_cuda

        def capture5(kbvh, o, d, t_min, t_limit, **kw):
            out = launch5(kbvh, o, d, t_min, t_limit, **kw)
            if not bool((t_min != 0).any()):
                name = ("shadow_wave" if kw["occlusion"] else
                        "bounce_wave" if "camera_wave" in captured else "camera_wave")
                if name not in captured:
                    captured[name] = ((o.clone(), d.clone(), t_min.clone(), t_limit.clone()),
                                      kw, tuple(x.clone() for x in out))
            return out

        zero_launch_counts()
        wide.octet_cuda = capture5
        try:
            t0 = time.perf_counter()
            ro.render(1)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
        finally:
            wide.octet_cuda = launch5
        r0 = ro.rays.physical
        t0 = time.perf_counter()
        ro.render(3)
        torch.cuda.synchronize()
        timed = time.perf_counter() - t0
        launches = launch_counts()
        rays = ro.rays.physical - r0
        img = ro.accum.cpu().numpy()
        nan_px = int(np.isnan(img).any(axis=-1).sum())
        rmse_wide = film.rmse(img, wide_img)
        png_path = os.path.join(OUT_DIR, "sponza_1080p_3spp_octet8.png")
        ro.save_png(png_path)
        info.update(render_setup_s=round(setup_s, 3), warmup_s=round(warm, 3),
                    seconds_per_sample=round(timed / 2, 3), rays_physical_2spp=rays,
                    mrays_per_s=round(rays / timed / 1e6, 3), launches=launches,
                    nan_pixels=nan_px, rmse_vs_wide=rmse_wide, rmse_bound=ROPE_VS_WIDE_RMSE,
                    png=os.path.relpath(png_path, ROOT),
                    peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))
        others = sum(v for k, v in launches.items() if not k.startswith("octet_"))
        if min(launches["octet_closest"], launches["octet_occlusion"]) <= 0 or others:
            raise RuntimeError(f"the octet render did not launch K5 alone: {launches}")
        if nan_px or not rmse_wide <= ROPE_VS_WIDE_RMSE:
            raise RuntimeError(f"octet image: {nan_px} NaN pixels, RMSE {rmse_wide} against "
                               f"the wide render (bound {ROPE_VS_WIDE_RMSE})")
        # each captured wave against octet_plain, then K5 and K1/K2 timed on
        # it in turns: the main path's own shapes (whole-frame waves)
        t0 = time.perf_counter()
        main_cases = {}
        for name, (args, kw, out_k) in captured.items():
            stats, k1_stats = {}, {}
            p_ms, out_p = cuda_ms(lambda args=args, kw=kw, stats=stats: wide.octet_plain(
                kb.node_rows, kb.tri_rows, *args, group=kb.group_size, arity=kb.arity,
                stats=stats, **kw))
            row = compare_exact(out_k, out_p)
            del out_p
            k1_kw = {k: v for k, v in kw.items() if k != "walks"}
            wide.traverse_plain(kb.node_rows, kb.tri_rows, *args, group=kb.group_size,
                                arity=kb.arity, stats=k1_stats, **k1_kw)
            ms, k1_ms = timed_pair(lambda args=args, kw=kw: wide.octet_cuda(kb, *args, **kw),
                                   lambda args=args, kw=k1_kw: wide.traverse_cuda(kb, *args, **kw))
            n = int(args[0].shape[0])
            b_ms, b_by, _, _ = bound(k1_stats, n, kb.tri_rows.shape[1], kb.group_size)
            u_ms, u_by, _, _ = bound(stats, n, kb.tri_rows.shape[1], kb.group_size)
            main_cases[name] = dict(row, warp_per_walk=wide.octet_warp_per_walk(n, kw["walks"]),
                                    ms=ms, ns_per_ray=ms * 1e6 / n, k1_ms=k1_ms,
                                    k1_ns_per_ray=k1_ms * 1e6 / n, plain_ms=p_ms,
                                    bound_ms=b_ms, bound_by=b_by, union_bound_ms=u_ms,
                                    union_bound_by=u_by)
        del captured
        cudalib.check_kernel_errors(dev)
        info.update(main_path_cases=main_cases,
                    main_path_check_s=round(time.perf_counter() - t0, 3))
        if sorted(main_cases) != ["bounce_wave", "camera_wave", "shadow_wave"]:
            raise RuntimeError(f"the octet render's waves were not captured: {sorted(main_cases)}")
        bad = sum(v["mismatch"] for v in main_cases.values())
        if bad:
            raise RuntimeError(f"octet main-path kernel/plain mismatches: {bad}")
        sel = [octet_results[c] for c in ("camera_8", "bounce_8", "shadow_8")]
        # the bound of the function K5 computes, K1/K2's contract, is K1/K2's
        # on the same rays; the union walk's own tests (each ray tests every
        # entry its walk pops) stand beside it as union_bound_ms
        k12 = [results[c] for c in ("camera", "bounce", "shadow")]
        by_ops = sum(x["ops"] for x in k12) / PEAK_F32
        by_bytes = sum(x["bytes"] for x in k12) / PEAK_BYTES
        union_ms = max(sum(x["union_ops"] for x in sel) / PEAK_F32,
                       sum(x["union_bytes"] for x in sel) / PEAK_BYTES) * 1e3
        kernel_rows.append({
            "name": "K5 wide multi-walk (8 walks)", "route": "cuda",
            "source": "tpurt_torch/csrc/wide_octet.cu",
            "replaces": "tpurt/kernels/pallas_wide.py:1434",
            "launches": launches["octet_closest"] + launches["octet_occlusion"],
            "max_abs_err": max([x["max_abs_err"] for x in octet_results.values()]
                               + [v["max_abs_err"] for v in across5.values()]
                               + [v["max_abs_err"] for v in main_cases.values()]),
            "ms": sum(x["ms"] for x in sel), "plain_ms": sum(x["plain_ms"] for x in sel),
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": None, "rays": N_RAYS * len(sel),
            "k1_k2_ms": sum(x["k1_ms"] for x in sel), "union_bound_ms": union_ms,
            "main_path_rays_checked": sum(v["rays"] for v in main_cases.values()),
            "main_path_waves": {m: {k: v[k] for k in (
                "rays", "warp_per_walk", "ms", "ns_per_ray", "k1_ms", "k1_ns_per_ray", "bound_ms",
                "bound_by", "union_bound_ms", "plain_ms")} for m, v in main_cases.items()},
            "ptxas": ptxas["k5_ptxas"]})

    with Phase("stepcost") as info:
        _, _, o, d, _, _ = by_name["bounce"]
        k1_stats = {}
        t1, p1, _ = wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, zeros, far,
                                        group=kb.group_size, arity=kb.arity, occlusion=False,
                                        all_definite=False, cell_masks=False, stats=k1_stats)
        steps = int((k1_stats["node_visits"] + k1_stats["leaf_visits"]).max())
        step_results = {}
        for cname, toggles in wide.STEPCOST_CONFIGS:
            def kern6(toggles=toggles):
                return wide.stepcost_cuda(kb, o, d, zeros, far, steps=steps, **toggles)

            stats = {}
            out_k = kern6()
            p_ms, out_p = cuda_ms(lambda: wide.stepcost_plain(
                kb.node_rows, kb.tri_rows, o, d, zeros, far, group=kb.group_size,
                arity=kb.arity, steps=steps, stats=stats, **toggles))
            torch.cuda.synchronize()
            row = compare_exact(out_k, out_p)
            b_ms, b_by, ops, nbytes = bound(stats, N_RAYS, kb.tri_rows.shape[1], kb.group_size)
            step_results[cname] = dict(ms=timed_kernel(kern6), plain_ms=p_ms, bound_ms=b_ms,
                                       bound_by=b_by, ops=ops, bytes=nbytes, **row)
            if cname == "full":
                t6, p6, _ = out_k
                full_vs_k1 = {"rays": N_RAYS,
                              "mismatch": int(((t6.view(torch.int32) != t1.view(torch.int32))
                                               | (p6 != p1)).sum()),
                              "max_abs_err": 0.0}
        cudalib.check_kernel_errors(dev)
        info.update(steps=steps, cases=step_results, full_vs_k1=full_vs_k1)
        bad = sum(v["mismatch"] for v in step_results.values()) + full_vs_k1["mismatch"]
        if bad:
            raise RuntimeError(f"K6 mismatches: {bad}")
        # kernel_bench's step-cost table through its entry point; the first
        # K6 launch of each configuration is kept and, after the run, held
        # against stepcost_plain on the same inputs, bit for bit
        launch6, bench_cases = wide.stepcost_cuda, {}

        def capture6(kbvh, o, d, t_min, t_limit, **kw):
            out = launch6(kbvh, o, d, t_min, t_limit, **kw)
            cname = next(c for c, tg in wide.STEPCOST_CONFIGS
                         if all(kw.get(k, True) == tg.get(k, True) for k in PHASES))
            if cname not in bench_cases:
                bench_cases[cname] = (kbvh, (o.clone(), d.clone(), t_min.clone(),
                                             t_limit.clone()), kw, tuple(x.clone() for x in out))
            return out

        zero_launch_counts()
        wide.stepcost_cuda = capture6
        try:
            table = kernel_bench.main(["--stepcost", str(BENCH_STEPS), "--reps", str(REPS),
                                       "--json", os.path.join(OUT_DIR,
                                                              "kernel_bench_stepcost256.json")])
            torch.cuda.synchronize()
        finally:
            wide.stepcost_cuda = launch6
        bench_launches = launch_counts()
        cudalib.check_kernel_errors(dev)
        emit({"kernel_bench": table})
        info.update(kernel_bench_launches=bench_launches)
        if bench_launches["stepcost"] <= 0:
            raise RuntimeError(f"kernel_bench --stepcost launched no K6: {bench_launches}")
        if sorted(bench_cases) != sorted(c for c, _ in wide.STEPCOST_CONFIGS):
            raise RuntimeError(f"kernel_bench's K6 launches were not captured: "
                               f"{sorted(bench_cases)}")
        t0 = time.perf_counter()
        bench_checks, full_stats = {}, {}
        for cname, (kbvh, args, kw, out_k) in bench_cases.items():
            if kw["steps"] != BENCH_STEPS:
                raise RuntimeError(f"kernel_bench ran K6 at {kw['steps']} steps")
            p_ms, out_p = cuda_ms(lambda: wide.stepcost_plain(
                kbvh.node_rows, kbvh.tri_rows, *args, group=kbvh.group_size,
                arity=kbvh.arity, stats=full_stats if cname == "full" else None, **kw))
            bench_checks[cname] = dict(plain_ms=p_ms, **compare_exact(out_k, out_p))
            del out_p
        n_bench = int(table["stepcost_rays"])
        full_kb = bench_cases["full"][0]
        b_ms, b_by, ops, nbytes = bound(full_stats, n_bench, full_kb.tri_rows.shape[1],
                                        full_kb.group_size)
        del bench_cases
        info.update(kernel_bench_cases=bench_checks,
                    kernel_bench_check_s=round(time.perf_counter() - t0, 3))
        bad = sum(v["mismatch"] for v in bench_checks.values())
        if bad:
            raise RuntimeError(f"K6 mismatches on kernel_bench's batch: {bad}")
        kernel_rows.append({
            "name": "K6 wide step-cost instrument", "route": "cuda",
            "source": "tpurt_torch/csrc/wide_stepcost.cu",
            "replaces": "tpurt/kernels/pallas_wide.py:1384",
            "launches": bench_launches["stepcost"],
            "max_abs_err": max(v["max_abs_err"] for v in
                               list(step_results.values()) + list(bench_checks.values())),
            "ms": table["stepcost_full_ms"], "plain_ms": bench_checks["full"]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "rays": n_bench,
            "steps": BENCH_STEPS, "config": "full",
            "main_path_rays_checked": sum(v["rays"] for v in bench_checks.values()),
            "ptxas": ptxas["k6_ptxas"]})

    with Phase("lbvh") as info:
        lb_launches = lbvh_phase(info, r, scene, camera, lights, kb, o_cam, d_cam, wide_img,
                                 wide_render)
        for row, mode in ((kernel_rows[0], "closest"), (kernel_rows[1], "occlusion")):
            row["device_lbvh"] = {"launches": lb_launches[mode],
                                  "seconds_per_sample": info["seconds_per_sample"]}
        kernel_rows[0]["device_lbvh"]["camera_65536"] = info["k1_camera_vs_sah"]

    with Phase("golden") as info:
        box = write_box_scene(os.path.join(tmp.name, "box.gltf"))
        cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
        rb = Renderer.from_gltf(box, config=RenderConfig(width=64, height=48, max_samples=8),
                                camera=cam, device=dev,
                                lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)])
        img = rb.render(8).cpu().numpy()
        golden = np.load(os.path.join(ROOT, "tests", "goldens", "box_64x48_8spp.npz"))["accum"]
        err = film.rmse(img, golden)
        info.update(rmse=err, within_1e_5=err < 1e-5)
        if not err < 1e-3:
            raise RuntimeError(f"box golden RMSE {err} above 1e-3")

    with Phase("oracle") as info:
        oracle_phase(info, dev, tmp.name)

    with Phase("cache") as info:
        cache_phase(info, dev, path, cfg, camera, lights, tmp.name)
        for row, mode in ((kernel_rows[0], "closest"), (kernel_rows[1], "occlusion")):
            row["cache_warm_sample_launches"] = info["warm_launches"][mode]
        kernel_rows[2]["cache_tri_warm_sample_launches"] = info["tri_warm_launches"]["rope_closest"]

    with Phase("viewer") as info:
        viewer_phase(info, dev, tmp.name)
        for row, mode in ((kernel_rows[0], "closest"), (kernel_rows[1], "occlusion")):
            row["viewer_launches"] = info["launches"][mode]

    with Phase("shard") as info:
        shard_phase(info, dev, r, wide_render["seconds_per_sample"])
        for row, mode in ((kernel_rows[0], "closest"), (kernel_rows[1], "occlusion")):
            row["shard_launches"] = {k: info[k]["launches"][mode] for k in
                                     ("tile_4x1", "mixed_2x2", "sharded_renderer_1x2")}

    torch.cuda.empty_cache()  # the child below measures the card's memory
    with Phase("recovery") as info:
        recovery_phase(info, path)

    torch.cuda.empty_cache()  # the entry points below run in processes of their own
    with Phase("cli") as info:
        cli_phase(info, path, scene.triangle_count, int(ds.tri_pos.shape[0]), tmp.name)

    with Phase("bench") as info:
        left = DEADLINE_S - (time.perf_counter() - _state["t0"])
        bench_phase(info, sample_physical,
                    {"BENCH_SAMPLES": "3", "BENCH_DEADLINE_S": str(int(min(240, left - 60)))})

    tmp.cleanup()
    print(card_name_and_power(), flush=True)
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    timer.cancel()
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--recovery"]:
            code = recovery_child(sys.argv[2]) or 0
        else:
            code = main()
    except Exception as e:  # any failing phase fails the run
        emit({"error": f"{type(e).__name__}: {e}", "phase": _state["phase"]})
        code = 1
    sys.stdout.flush()
    os._exit(code)
