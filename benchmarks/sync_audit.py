#!/usr/bin/env python3
"""Where tpurt_torch's host waits for the card, per benchmark cell.

    python3 benchmarks/sync_audit.py [--cells a,b] [--seed N]

Needs a CUDA card. For each cell of BENCHMARK.json (default: every
one-card cell), built as perfbench's harness builds it (configuration,
traffic, render settings, scene cache under perfbench/_cache/):

1. set-up and one warm-up launch (offline) or frame (interactive);
2. `audit`: one launch (step, drain) or frame (camera set, step,
   tonemap, 8-bit frame, drain) under utils/profiling.audit_syncs
   (CPU profiler on, torch.cuda.set_sync_debug_mode("warn")): per
   `sync.*` range the syncs PyTorch warned in it, and the code line of
   every sync warned outside one;
3. `untraced_ms`: the traffic's profiled units (`profile_launches` or
   `profile_frames`) on the host clock, ending with a drain and a device
   synchronise, per sample or frame; twice, around step 4, the second
   time with each `host_sync` timed on the host clock (`untraced_sites`:
   per site its syncs and host ms per sample or frame, with no profiler
   running);
4. `traced`: the same units in the benchmark's profiled window
   (perfbench.harness.profile_window): ms per sample or frame, and per
   `sync.*` site its ranges and host ms per sample or frame, with the
   per-layer readers' values.

Before the cells: the card and its power limit, whether the profiler
flag (`torch.autograd._profiler_enabled`) is on under torch.profiler and
under emit_nvtx, and chip_smoke.annotation_cost_us with a CUDA context.
One JSON line per result on standard output, also written to
chiprun_out/sync_audit.jsonl. No JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import harness  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "sync_audit.jsonl")
DEVICE = "cuda:0"


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def profiler_flags() -> dict:
    from torch.autograd import _profiler_enabled
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        under_profile = _profiler_enabled()
    with torch.autograd.profiler.emit_nvtx():
        under_nvtx = _profiler_enabled()
    return {"off": _profiler_enabled(), "torch_profiler": under_profile,
            "emit_nvtx": under_nvtx}


def build(name: str, seed: int):
    """(spec, renderer, stepper, frame, sync, unit count, interactive) of
    a cell, as harness.run_cell builds them."""
    spec = harness.cell_spec(name)
    config, traffic = spec["config"], spec["traffic"]
    os.environ["TPURT_SCENE_CACHE_DIR"] = os.path.join(harness.CACHE, "scene_cache")
    from tpurt_torch import film
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import SphereLight
    from tpurt_torch.renderer import Renderer

    dev = torch.device(DEVICE)
    gltf, _ = harness.scene_files(config)
    cam = config["camera"]
    lights = [SphereLight(tuple(x["position"]), x["radius"], tuple(x["color"]), x["intensity"])
              for x in config["lights"]]
    r = Renderer.from_gltf(gltf, config=harness.render_config(spec, seed),
                           camera=Camera.from_angles(cam["position"], cam["phi"], cam["theta"]),
                           lights=lights, device=dev,
                           cache=bool(traffic.get("scene_cache", config.get("scene_cache",
                                                                            True))))
    interactive = traffic["kind"] == "interactive"
    poses = harness.fly_poses(config, traffic, seed) if interactive else None

    def frame(i):
        pos, phi, theta = poses[i % len(poses)]
        r.set_camera(Camera.from_angles(pos, phi, theta))
        r.step()
        return film.to_srgb8(r.tonemapped())[..., :3]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    units = int(traffic["profile_frames"] if interactive else traffic["profile_launches"])
    return spec, r, r, frame, sync, units, interactive


def audit(r, stepper, frame, interactive, i) -> dict:
    from tpurt_torch.utils import profiling

    with profiling.audit_syncs() as a:
        if interactive:
            frame(i)
        else:
            stepper.step()
        r.drain()
    sites = {}
    for name, per_range in sorted(a["ranges"].items()):
        sites[name] = {"ranges": len(per_range), "syncs_warned": sum(per_range),
                       "ranges_not_one": sum(1 for n in per_range if n != 1)}
    ranges = sum(v["ranges"] for v in sites.values())
    warned = sum(v["syncs_warned"] for v in sites.values()) + len(a["outside"])
    return {"sites": sites, "ranges": ranges, "syncs_warned": warned,
            "outside": a["outside"]}


def untraced_ms(r, stepper, frame, sync, units, interactive, i0) -> float:
    sync()
    t0 = time.perf_counter()
    for i in range(units):
        if interactive:
            frame(i0 + i)
        else:
            stepper.step()
    r.drain()
    sync()
    per = units if interactive else units * r.config.spp_per_launch
    return (time.perf_counter() - t0) * 1e3 / per


def timed_sites(fn, per):
    """fn() with each `sync.*` range of utils/profiling.host_sync timed
    on the host clock instead of opened in a profiler (host_sync looks
    `annotate` up when called, so patching it reaches every site).
    Returns (fn's result, {site: {count, host_ms}} per `per` units)."""
    from tpurt_torch.utils import profiling

    acc = {}

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            a = acc.setdefault(name, [0, 0.0])
            a[0] += 1
            a[1] += time.perf_counter() - t0

    annotate = profiling.annotate
    profiling.annotate = timed
    try:
        out = fn()
    finally:
        profiling.annotate = annotate
    return out, {k: {"count": n / per, "host_ms": s * 1e3 / per}
                 for k, (n, s) in sorted(acc.items())}


def run_cell(name: str, seed: int, out) -> None:
    t0 = time.perf_counter()
    spec, r, stepper, frame, sync, units, interactive = build(name, seed)
    if interactive:
        frame(0)
    else:
        stepper.step()
    r.drain()
    sync()
    rec = {"cell": name, "setup_s": time.perf_counter() - t0,
           "audit": audit(r, stepper, frame, interactive, 1)}
    sync()
    before = untraced_ms(r, stepper, frame, sync, units, interactive, 2)
    ctx = harness.profile_window(spec, r, stepper, frame, sync, [DEVICE], dict(r.timings),
                                 2 + units if interactive else None)
    per = ctx["frames"] if interactive else ctx["samples"]
    after, timed = timed_sites(
        lambda: untraced_ms(r, stepper, frame, sync, units, interactive, 2 + 2 * units), per)
    ann = ctx["annotations"]
    sites = {k: {"count": v["count"] / per, "host_ms": v["host_ms"] / per}
             for k, v in sorted(ann.items()) if k.startswith("sync.")}
    rec["untraced_ms"] = [before, after]
    rec["untraced_sites"] = timed
    rec["traced"] = {"units": per, "ms": ctx["window_s"] * 1e3 / per,
                     "busy_ms": ctx["busy_s"] * 1e3 / per,
                     "launch_host_ms": ann.get("launch", {}).get("host_ms", 0.0) / per,
                     "sync_sites": sites,
                     "idle_gaps": ctx["breakdown"]["idle_gaps"],
                     "metrics": {m["name"]: harness.metric_reader(m["name"])(ctx)
                                 for m in spec["per_layer"]}}
    emit(rec, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default="")
    p.add_argument("--seed", type=int, default=2 ** 31 + 12345)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_audit: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cells = ([c for c in args.cells.split(",") if c] if args.cells else
             [w["name"] for w in bench["workloads"] if int(w["chips"]) == 1])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as out:
        torch.zeros(1, device="cuda")  # a CUDA context, as in a render
        import chip_smoke

        emit({"card": harness.card_and_power(), "torch": torch.__version__,
              "profiler_flag": profiler_flags(),
              "annotation_cost_us": chip_smoke.annotation_cost_us()}, out)
        for name in cells:
            run_cell(name, args.seed, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
