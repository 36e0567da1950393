"""Benchmark harness of the port (the counterpart of the top-level
bench.py): physical Mrays/s on the bench's Sponza-like interior.

    python -m tpurt_torch.bench                    # on the card
    BENCH_FORCE_CPU=1 python -m tpurt_torch.bench  # the small CPU config
    python -m tpurt_torch.bench --device cpu       # the same

Prints JSON records on stdout; the LAST line is the headline:
{"metric", "value" (physical Mrays/s), "unit", "vs_baseline",
"rays_traced_physical", "rays_logical", "mrays_per_sec_logical",
"seconds", "samples_done", "bands_timed", "time_to_1024spp_s",
"rmse_vs_golden", "note"?, "provisional"?}, plus "sample_seconds"
(each timed sample's seconds) and "device". `vs_baseline` is null: the
port has no baseline on the card, and the TPU's figure is none.

The card config is bench.py's: `write_sponza_like_scene(columns=12,
foliage=96, stacks=8, segments=28, rings=20)` (215,296 triangles),
1920x1080, bench.py's camera and three sphere lights. The CPU config,
only when asked for, is bench.py's fallback: 320x240, `columns=2,
foliage=8`, 2 samples in 120-row bands. Without a card and without
`--device cpu` or BENCH_FORCE_CPU=1 the harness exits non-zero.

Knobs (environment): BENCH_SAMPLES (timed samples, default 8),
BENCH_BAND_ROWS (rows per launch, default 1080: whole frames),
BENCH_SPP_PER_LAUNCH (default 1), BENCH_DEADLINE_S (default 900).

Robustness kept from bench.py: a watchdog thread prints the best record
so far and exits 0 at the deadline, even if the main thread is stuck; a
provisional record is printed after every timed unit (band); the warmup
unit is timed, and its record is marked as such in `note`; the loop
stops early when the deadline nears. The third north-star metric,
`rmse_vs_golden`, is the box golden (64x48, 8 spp) rendered on the
run's device against tests/goldens/box_64x48_8spp.npz.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "box_64x48_8spp.npz")

CARD = dict(width=1920, height=1080,
            scene_kw=dict(columns=12, foliage=96, stacks=8, segments=28, rings=20))
CPU = dict(width=320, height=240, scene_kw=dict(columns=2, foliage=8), samples=2,
           band_rows=120, spp_per_launch=1)
CAMERA = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHTS = [((-8.0, -5.0, -2.0), 0.1, (0.8, 0.6, 0.6), 500.0),
          ((8.0, -5.0, -2.5), 0.1, (0.4, 0.7, 0.6), 500.0),
          ((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)]
# seconds kept free at the end of the run: stop timing below STOP_MARGIN_S,
# skip the golden below GOLDEN_MARGIN_S
STOP_MARGIN_S = 20.0
GOLDEN_MARGIN_S = 30.0


def _log(msg: str, t0: float) -> None:
    print(f"[bench] t={time.perf_counter() - t0:6.1f}s {msg}", file=sys.stderr, flush=True)


class Best:
    """Best-so-far record shared with the watchdog. Starts as a zero-value
    record, so a deadline before the first timed unit still prints a
    parseable line."""

    def __init__(self, metric: str):
        self.lock = threading.Lock()
        self.record = {"metric": metric, "value": 0.0, "unit": "Mrays/s",
                       "vs_baseline": None,
                       "note": "deadline hit before the first timed unit completed"}

    def update(self, record):
        with self.lock:
            self.record = record

    def merge(self, **kv):
        with self.lock:
            self.record.update(kv)

    def emit(self, final=False):
        with self.lock:
            rec = dict(self.record)
            if final:
                rec.pop("provisional", None)
            else:
                rec.setdefault("provisional", True)
            print(json.dumps(rec), flush=True)


def _watchdog(best: Best, deadline_s: float, t0: float) -> None:
    remaining = deadline_s - (time.perf_counter() - t0)
    if remaining > 0:
        time.sleep(remaining)
    _log(f"internal deadline {deadline_s:.0f}s hit; emitting best-so-far", t0)
    best.emit(final=True)
    os._exit(0)  # the main thread may be stuck inside a launch


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    first card."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else "unknown"


def golden_rmse(device) -> float:
    """The box golden config (64x48, 8 spp, fixed seed) rendered on
    `device`, RMSE against the checked-in golden."""
    from tpurt_torch import film
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import RenderConfig, SphereLight
    from tpurt_torch.renderer import Renderer
    from tpurt_torch.scene.procedural import write_box_scene

    golden = np.load(GOLDEN)["accum"]
    with tempfile.TemporaryDirectory() as tmp:
        path = write_box_scene(os.path.join(tmp, "box.gltf"))
        cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
        r = Renderer.from_gltf(
            path, config=RenderConfig(width=64, height=48, max_samples=8), camera=cam,
            lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)], device=device,
            cache=False)
        return film.rmse(r.render(8), golden)


def run(device, width, height, scene_kw, samples, band_rows, spp_per_launch, deadline_s,
        *, metric=None, best=None, t0=None):
    """Render `samples` timed samples (plus one warmup unit) of the bench
    scene at width x height on `device`, in bands of `band_rows` rows,
    `spp_per_launch` samples per launch; print a record after every
    timed unit and the final record last. Returns the final record."""
    import torch

    from tpurt_torch.camera import Camera
    from tpurt_torch.config import RenderConfig, SphereLight
    from tpurt_torch.integrator.wavefront import render_rows_stats
    from tpurt_torch.kernels import cudalib
    from tpurt_torch.renderer import Renderer
    from tpurt_torch.runtime.device import resolve_device
    from tpurt_torch.scene.procedural import write_sponza_like_scene

    t0 = time.perf_counter() if t0 is None else t0
    dev = resolve_device(device)
    metric = metric or f"sponza_like_{width}x{height}_mrays_per_sec"
    best = best or Best(metric)

    def remaining():
        return deadline_s - (time.perf_counter() - t0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        _log(f"card: {card_name_and_power()}", t0)
    cfg = RenderConfig(width=width, height=height, max_samples=1024, chunk_rows=band_rows,
                       spp_per_launch=spp_per_launch)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_sponza_like_scene(os.path.join(tmp, "bench_sponza.gltf"), **scene_kw)
        _log("procedural scene written", t0)
        r = Renderer.from_gltf(path, config=cfg, camera=Camera.from_angles(*CAMERA),
                               lights=[SphereLight(*x) for x in LIGHTS], device=dev,
                               cache=False)
    sync()
    _log(f"scene and tables ready ({r.device_scene.num_triangles} triangles); "
         "timing the warmup unit (first launches included)", t0)

    n_bands = -(-height // band_rows)

    def run_band(sample_idx, row, rows):
        t = time.perf_counter()
        _, rays = render_rows_stats(r.device_scene, r.bvh, r.camera, sample_idx, row,
                                    rows=rows, width=width, height=height, cfg=cfg,
                                    has_alpha=r.has_alpha, tex_flags=r.tex_flags)
        sync()
        dt = time.perf_counter() - t
        cudalib.check_kernel_errors(dev)
        return rays, dt

    def mk_record(physical, logical, secs, bands, samples_done, sample_secs, note=None):
        mrays = physical / secs / 1e6 if secs > 0 else 0.0
        # projected wall time of 1024 accumulated samples at full size:
        # each timed band delivers spp_per_launch samples of its rows
        s_per_sample = secs / (bands * spp_per_launch) * n_bands if bands else None
        rec = {
            "metric": metric,
            "value": mrays,
            "unit": "Mrays/s",
            "vs_baseline": None,
            "rays_traced_physical": physical,
            "rays_logical": logical,
            "mrays_per_sec_logical": logical / secs / 1e6 if secs > 0 else 0.0,
            "seconds": secs,
            "samples_done": samples_done,
            "bands_timed": bands,
            "time_to_1024spp_s": 1024.0 * s_per_sample if s_per_sample else None,
            "rmse_vs_golden": None,
            "sample_seconds": list(sample_secs),
            "device": str(dev),
        }
        if note:
            rec["note"] = note
        return rec

    # warmup: the first launches (kernel builds and loads, allocator
    # growth), timed and marked, so a deadline in the timed loop still
    # leaves a nonzero record
    rays_w, dt_w = run_band(0, 0, min(band_rows, height))
    best.update(mk_record(rays_w.physical, rays_w.logical, dt_w, 1, 0, [],
                          note="warmup unit, includes first-launch costs"))
    best.emit()
    _log(f"warmup done in {dt_w:.2f}s ({rays_w.physical / dt_w / 1e6:.3f} Mrays/s); timing", t0)

    secs = physical = logical = 0.0
    done_samples = bands = 0
    sample_secs = []
    for s in range(1, samples + 1):
        s_secs = 0.0
        for row in range(0, height, band_rows):
            rays, dt = run_band(s, row, min(band_rows, height - row))
            secs += dt
            s_secs += dt
            physical += rays.physical
            logical += rays.logical
            bands += 1
            best.update(mk_record(physical, logical, secs, bands, done_samples, sample_secs,
                                  note=f"partial: {bands} bands"))
            best.emit()
            if remaining() < STOP_MARGIN_S:
                _log("deadline margin reached; stopping early", t0)
                best.emit(final=True)
                return dict(best.record)
        sample_secs.append(s_secs)
        done_samples = s * spp_per_launch
        best.update(mk_record(physical, logical, secs, bands, done_samples, sample_secs))
        _log(f"sample batch {s} done: {physical / 1e6:.1f} Mrays physical in {secs:.2f}s "
             f"({physical / secs / 1e6:.3f} Mrays/s)", t0)
        if s < samples and remaining() < 1.3 * secs / s + STOP_MARGIN_S:
            _log("not enough time left for another sample; stopping", t0)
            break
    best.emit()  # the final throughput, before the golden

    if remaining() > GOLDEN_MARGIN_S:
        t = time.perf_counter()
        err = golden_rmse(dev)
        best.merge(rmse_vs_golden=err)
        _log(f"golden rmse={err:.3e} in {time.perf_counter() - t:.1f}s", t0)
    else:
        _log("skipping the golden rmse (deadline)", t0)
    best.emit(final=True)
    return dict(best.record)


def main(argv=None) -> int:
    from tpurt_torch.runtime.device import DeviceNotFound, resolve_device

    t0 = time.perf_counter()
    p = argparse.ArgumentParser(prog="python -m tpurt_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; exits non-zero without a card) or cpu, the "
                        "small CPU config (as BENCH_FORCE_CPU=1)")
    args = p.parse_args(argv)
    on_cpu = args.device == "cpu" or os.environ.get("BENCH_FORCE_CPU") == "1"
    try:
        dev = resolve_device("cpu" if on_cpu else "cuda")
    except DeviceNotFound as e:
        print(f"tpurt_torch.bench: DeviceNotFound: {e}; pass --device cpu or set "
              "BENCH_FORCE_CPU=1 for the CPU config", file=sys.stderr)
        return 1
    deadline_s = float(os.environ.get("BENCH_DEADLINE_S", "900"))
    if on_cpu:
        conf = dict(CPU)
    else:
        conf = dict(CARD, samples=int(os.environ.get("BENCH_SAMPLES", "8")),
                    band_rows=int(os.environ.get("BENCH_BAND_ROWS", "1080")),
                    spp_per_launch=int(os.environ.get("BENCH_SPP_PER_LAUNCH", "1")))
    metric = (f"sponza_like_{conf['width']}x{conf['height']}_mrays_per_sec"
              + ("_cpu" if on_cpu else ""))
    best = Best(metric)
    threading.Thread(target=_watchdog, args=(best, deadline_s, t0), daemon=True).start()
    run(dev, deadline_s=deadline_s, metric=metric, best=best, t0=t0, **conf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
