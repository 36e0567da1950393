"""One run of one benchmark cell: set-up, the measured window, the
profiled window (with --trace 1), the check of what the window produced
against the plain reference, and the result line.

Everything a cell is made of is found by name:

- the cell (`workloads` in BENCHMARK.json) names a configuration and a
  traffic mix;
- `configs/<config>.json`: the scene (a writer under `scenes/`, with its
  parameters), camera, lights and render settings;
- `traffic/<traffic>.json`: the kind of loop (`offline`: one camera,
  progressive launches; `interactive`: a camera move, one launch and the
  8-bit frame on the host, per frame), resolution, samples per launch,
  the device mesh, how long to profile and how much to check;
- `checks/<cell>.json`: the limit of each number the check compares;
- `metrics/<metric>.py`: one reader per per-layer metric.

The program (tpurt_torch) is imported inside the functions that drive
it; the reference (reference/pathtrace.py) never imports it.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpurt")


# ---- the cell's files ---------------------------------------------------------------

def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str, root: str = ROOT) -> dict:
    """The cell's `workloads` entry and its configuration, traffic, check
    limits and per-layer metrics, read from the files that name them."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return {"cell": cell,
            "config": load_json(HERE, "configs", cell["config"] + ".json"),
            "traffic": load_json(HERE, "traffic", cell["traffic"] + ".json"),
            "check": load_json(HERE, "checks", name + ".json"),
            "end_to_end": end_to_end, "per_layer": per_layer,
            "run_seconds": bench["run_seconds"]}


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---- the scene files ------------------------------------------------------------------

def scene_paths(config: dict, cache_dir: str = CACHE):
    """(glTF path for the program, npz path of the reference's arrays) of
    the configuration's scene. The names hold a digest of what writes
    the files: the writer's name and parameters, its own source
    (`scenes/<writer>.py`) and the shared `scenes/gltf_writer.py`, the
    only module of the benchmark a writer may import. A changed writer
    writes new files; another configuration's new writer renames none."""
    h = hashlib.sha256(json.dumps([config["scene"], config["scene_params"]],
                                  sort_keys=True).encode())
    for fname in (config["scene"] + ".py", "gltf_writer.py"):
        with open(os.path.join(HERE, "scenes", fname), "rb") as f:
            h.update(f.read())
    stem = os.path.join(cache_dir, "scenes", f"{config['name']}-{h.hexdigest()[:16]}")
    return stem + ".gltf", stem + ".npz"


def scene_files(config: dict, cache_dir: str = CACHE):
    """`scene_paths`, written by the configuration's scene writer on
    first use."""
    gltf, npz = scene_paths(config, cache_dir)
    stem = os.path.splitext(gltf)[0]
    if not (os.path.isfile(gltf) and os.path.isfile(npz)):
        os.makedirs(os.path.dirname(stem), exist_ok=True)
        mod = importlib.import_module(f"perfbench.scenes.{config['scene']}")
        builder = mod.build(**config["scene_params"])
        arrays = builder.arrays()
        tmp = f"{stem}.{os.getpid()}.tmp"
        builder.write(tmp)
        with open(tmp + ".npz", "wb") as f:
            np.savez(f, **_arrays_to_dict(arrays))
        os.replace(tmp + ".npz", npz)
        os.replace(tmp, gltf)
    return gltf, npz


def _arrays_to_dict(arrays) -> dict:
    out = {k: v for k, v in vars(arrays).items() if k != "textures"}
    for i, (img, filt, ws, wt, srgb) in enumerate(arrays.textures):
        out[f"tex{i}"] = img
        out[f"tex{i}_state"] = np.array([filt, ws, wt, int(srgb)], np.int64)
    return out


def load_arrays(npz: str):
    from perfbench.scenes.gltf_writer import SceneArrays

    data = np.load(npz)
    n = sum(1 for k in data.files if k.startswith("tex") and k.endswith("_state"))
    textures = [(data[f"tex{i}"], *(int(x) for x in data[f"tex{i}_state"][:3]),
                 bool(data[f"tex{i}_state"][3])) for i in range(n)]
    fields = {k: data[k] for k in SceneArrays.__dataclass_fields__ if k != "textures"}
    return SceneArrays(textures=textures, **fields)


# ---- helpers ----------------------------------------------------------------------------

def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def card_and_power() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else "unknown"


def fly_poses(config: dict, traffic: dict, seed: int):
    """The interactive cell's camera loop: `poses` positions on an
    ellipse of `radius` (x, z) through the configuration's camera, the
    yaw swinging by `yaw_swing`, one pose per frame. Every seed walks
    the same closed loop: the seed sets where it starts and which way it
    goes."""
    cam = config["camera"]
    path = traffic["path"]
    n = int(path["poses"])
    rx, rz = path["radius"]
    px, py, pz = cam["position"]
    poses = []
    for k in range(n):
        a = 2.0 * math.pi * k / n
        pos = [px + rx * (math.cos(a) - 1.0), py, pz + rz * math.sin(a)]
        poses.append((pos, cam["phi"] + path["yaw_swing"] * math.sin(a), cam["theta"]))
    start = seed % n
    step = 1 if (seed // n) % 2 == 0 else -1
    return [poses[(start + step * i) % n] for i in range(n)]


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end_values(frame_ms, samples: int, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window: for frames, the 85th
    percentile of every frame's milliseconds and the frames completed a
    second; else the samples per pixel completed a second."""
    if frame_ms is not None:
        out = {"frame_ms_p85": percentile(frame_ms, 85),
               "frames_per_s": len(frame_ms) / window_s}
    else:
        out = {"samples_per_s": samples / window_s}
    out["setup_s"] = setup_s
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def render_config(spec: dict, seed: int):
    """The program's RenderConfig: the traffic's size and samples per
    launch, the seed, and every field of the cell's `render` settings
    (check.render_settings; lists become tuples)."""
    from perfbench import check
    from tpurt_torch.config import RenderConfig

    traffic = spec["traffic"]
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in check.render_settings(spec).items()}
    return RenderConfig(width=int(traffic["width"]), height=int(traffic["height"]),
                        max_samples=1 << 30, seed=int(seed),
                        spp_per_launch=int(traffic.get("spp_per_launch", 1)), **fields)


def quiet_host(on_card: bool) -> None:
    """Before the window: collect and freeze what set-up left, keep the
    collector off, and on a card run hold the main thread on the last
    core it may use (no migrations; the program's helper threads keep
    theirs)."""
    gc.collect()
    gc.freeze()
    gc.disable()
    if on_card and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


# ---- the run ------------------------------------------------------------------------------

def run_cell(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
             devices: Optional[List[str]] = None, control: bool = False) -> dict:
    """Run one cell. `devices` defaults to the cell's cards; the tests
    pass CPU devices. With `control`, the record also holds the bfloat16
    control's reading (control.py). Returns the result record."""
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    chips = int(cell["chips"])
    if devices is None:
        devices = [f"cuda:{i}" for i in range(chips)]
    on_card = devices[0].startswith("cuda")
    cache_dir = spec.get("cache_dir", CACHE)
    os.environ["TPURT_SCENE_CACHE_DIR"] = os.path.join(cache_dir, "scene_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache_dir, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache_dir, "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    from tpurt_torch import film
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import SphereLight
    from tpurt_torch.renderer import Renderer

    dev0 = torch.device(devices[0])

    def sync():
        if on_card:
            for d in devices:
                torch.cuda.synchronize(torch.device(d))

    gltf, npz = scene_files(config, cache_dir)
    rcfg = render_config(spec, seed)
    lights = [SphereLight(tuple(l["position"]), l["radius"], tuple(l["color"]), l["intensity"])
              for l in config["lights"]]
    cam = config["camera"]
    r = Renderer.from_gltf(gltf, config=rcfg,
                           camera=Camera.from_angles(cam["position"], cam["phi"], cam["theta"]),
                           lights=lights, device=dev0,
                           cache=bool(traffic.get("scene_cache", config.get("scene_cache",
                                                                            True))))
    timings = dict(r.timings)
    mesh = traffic.get("mesh")
    stepper = r
    if mesh:
        from tpurt_torch.parallel.shard import ShardedRenderer, make_mesh
        stepper = ShardedRenderer(r, make_mesh(int(mesh["tile"]), int(mesh["spp"]),
                                               devices=devices))
    interactive = traffic["kind"] == "interactive"
    poses = fly_poses(config, traffic, seed) if interactive else None
    frames: List[np.ndarray] = []
    frame_poses: List[int] = []

    def frame(i):
        pos, phi, theta = poses[i % len(poses)]
        r.set_camera(Camera.from_angles(pos, phi, theta))
        r.step()
        return film.to_srgb8(r.tonemapped())[..., :3]

    # warm-up: one launch (or frame) of the cell's own shapes
    if interactive:
        frame(0)
    else:
        stepper.step()
    r.drain()
    sync()
    if not interactive:
        r.reset()
    for d in devices:
        if on_card:
            torch.cuda.reset_peak_memory_stats(torch.device(d))
    quiet_host(on_card)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({json.dumps(timings)})")

    # the measured window
    frame_ms: List[float] = []
    launch_s: List[float] = []
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    if interactive:
        i = 0
        while True:
            ts = time.perf_counter()
            img = frame(i)
            te = time.perf_counter()
            frame_ms.append((te - ts) * 1e3)
            frames.append(img)
            frame_poses.append(i % len(poses))
            i += 1
            if te - t0 >= seconds:
                break
        t1 = te
        r.drain()
    else:
        launches = 0
        tl = t0
        while True:
            stepper.step()
            launches += 1
            te = time.perf_counter()
            launch_s.append(te - tl)
            tl = te
            if te - t0 >= seconds:
                break
        r.drain()
        sync()
        t1 = time.perf_counter()
    window_s = t1 - t0
    log(f"the window took {time.process_time() - cpu0:.1f} s of this process's CPU time")
    if launch_s:
        k = min(5, len(launch_s))
        log(f"launch s: first {k} {sum(launch_s[:k]) / k:.3f}, last {k} "
            f"{sum(launch_s[-k:]) / k:.3f}, median {percentile(launch_s, 50):.3f}")
    log(f"the window left {gc.collect()} unreachable objects")
    gc.unfreeze()
    gc.enable()
    samples_in_window = r.sample_count
    peak = max((torch.cuda.max_memory_allocated(torch.device(d)) for d in devices),
               default=0) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)

    metrics: Dict[str, dict] = {}
    if interactive:
        log(f"window {window_s:.3f} s: {len(frame_ms)} frames, median "
            f"{percentile(frame_ms, 50):.1f} ms, p85 {percentile(frame_ms, 85):.1f} ms")
        attempted = len(frame_ms)
    else:
        log(f"window {window_s:.3f} s: {samples_in_window} samples, "
            f"{r.rays.physical / window_s / 1e6:.3f} Mrays/s physical")
        attempted = launches
    values = end_to_end_values(frame_ms if interactive else None, samples_in_window,
                               window_s, setup_s)

    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        ctx = profile_window(spec, r, stepper, frame, sync, devices, timings,
                             len(frames) if interactive else None)
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
        breakdown = ctx["breakdown"]
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    # what the window produced, then the program's state freed
    from perfbench import check

    produced = check.collect(spec, r, seed, frames, frame_poses, poses)
    del r, stepper
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    arrays = load_arrays(npz)
    numbers, ref = check.compare(spec, produced, arrays, seed, dev0)
    log(f"check took {time.perf_counter() - t_check:.1f} s")
    correct = all(n["value"] <= n["limit"] for n in numbers.values())
    out = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["control"] = {"mismatch_share": check.control_share(spec, produced, arrays, seed,
                                                                dev0, ref)}
    out["check"] = numbers
    return out


class ForbiddenImport(RuntimeError):
    pass


def profile_window(spec, r, stepper, frame, sync, devices, timings, next_frame):
    """Profile a short steady window (traffic `profile_launches`
    launches, or `profile_frames` frames) and reduce it for the readers."""
    from perfbench import trace as T

    traffic = spec["traffic"]
    interactive = traffic["kind"] == "interactive"
    units = int(traffic["profile_frames"] if interactive else traffic["profile_launches"])
    rays0 = r.rays.physical
    samples0 = r.sample_count
    with T.profiled() as prof:
        with torch.profiler.record_function("perfbench_window"):
            t0 = time.perf_counter()
            if interactive:
                rays = 0.0
                for i in range(units):
                    frame(next_frame + i)
                    rays += r.rays.physical
            else:
                for _ in range(units):
                    stepper.step()
            r.drain()
            sync()
            window_s = time.perf_counter() - t0
    events = T.raw_events(prof)
    dev_events = T.device_events(events)
    ranges = T.host_ranges(events)
    win = [(a, b) for a, b, name in ranges if name == "perfbench_window"]
    window = win[0] if win else (0, 0)
    idx = sorted({e[3] for e in dev_events}) or [0]
    per_dev = {i: T.busy_intervals(dev_events, i) for i in idx}
    busy_s = sum(T.busy_ns(v) for v in per_dev.values()) / len(devices) / 1e9
    gaps: Dict[str, float] = {}  # idle seconds by host range, mean over the cards
    for v in per_dev.values():
        for name, s in T.idle_gaps_by_range(v, ranges, window, n=1000):
            gaps[name] = gaps.get(name, 0.0) + s / len(devices)
    breakdown = {"device_ops": T.top_device_ops(dev_events),
                 "idle_gaps": [[k, v] for k, v in sorted(gaps.items(),
                                                          key=lambda kv: -kv[1])[:10]]}
    samples = (units * r.config.spp_per_launch if interactive
               else r.sample_count - samples0)
    return {"events": events, "device_events": dev_events, "ranges": ranges,
            "annotations": T.annotation_split(events), "samples": samples,
            "frames": units if interactive else 0,
            "rays_physical": rays if interactive else r.rays.physical - rays0,
            "window_s": window_s, "busy_s": busy_s, "devices": len(devices),
            "timings": timings, "breakdown": breakdown, "on_card": bool(dev_events)}
