"""Traversal-kernel microbenchmark on the card (the counterpart of
benchmarks/kernel_bench.py).

    python -m tpurt_torch.kernel_bench [--reps 5] [--json out.json]
        [--rows 256] [--row0 400] [--group G] [--nosort] [--octet N]
        [--stepcost K] [--device cuda] [--scene scene.gltf]

Times the wide kernels on the three ray batches that set frame time, on
the bench's Sponza-like interior (215,296 triangles) seen by the bench
camera: 256 rows of the 1920x1080 frame from row 400 (491,520 rays),
packed in 1024-pixel tiles, as benchmarks/kernel_bench.py builds them:

- coherent camera rays (closest hit);
- incoherent bounce rays: uniform directions from the camera hits,
  sorted by the octant-Morton key as the integrator sorts them
  (`--nosort` also times them unsorted);
- occlusion rays from the camera hits toward light 2, bounded by its
  distance, sorted the same way.

Each time is the median of `--reps` CUDA-event timings after one
warm-up, of the kernel wrapper alone (u/v not recomputed). `--octet N`
times the multi-walk kernel K5 with N walks per 1024 rays in place of
K1/K2. `--stepcost K` runs the step-cost instrument K6 on the sorted
bounce batch: exactly K steps per ray, once per configuration (full,
-leaf, -push, -extract, -box, each dropping one phase more), and prints
each one's ms and ns per ray-step and the per-phase differences.
`--group G` rebuilds the triangle BVH at leaf size G first.

tpurt's TPU step variants (`--dual`, `--pair`, `--descend`, `--sup`,
`--race-sup`) and its collapse-mode race are TPU mechanism and are not
offered; `--arity` and `--near` are not ported yet. The run is on the
card unless `--device cpu` is given (the plain versions then run, and
the times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.bvh.traverse import _octant_morton_key, _sort_rays
from tpurt_torch.camera import Camera, camera_rays_for_rows
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator.wavefront import tile_pack, tile_shape
from tpurt_torch.kernels import wide
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_sponza_like_scene

# the scene, camera and lights of bench.py and benchmarks/kernel_bench.py
SCENE_KW = dict(columns=12, foliage=96, stacks=8, segments=28, rings=20)
CAMERA = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHTS = (SphereLight((-8.0, -5.0, -2.0), 0.1, (0.8, 0.6, 0.6), 500.0),
          SphereLight((8.0, -5.0, -2.5), 0.1, (0.4, 0.7, 0.6), 500.0),
          SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0))
WIDTH, HEIGHT = 1920, 1080


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpurt_torch.kernel_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None, help="write the results here")
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--row0", type=int, default=400)
    ap.add_argument("--group", type=int, default=0,
                    help="rebuild the triangle BVH at this leaf group size "
                         "(0 = the renderer's choice)")
    ap.add_argument("--nosort", action="store_true",
                    help="also time the incoherent batch unsorted")
    ap.add_argument("--octet", type=int, default=0, choices=(0,) + wide.OCTET_WALKS,
                    help="time the multi-walk kernel K5 with N walks per "
                         "1024 rays in place of K1/K2")
    ap.add_argument("--stepcost", type=int, default=0,
                    help="run the step-cost instrument K6 at this many "
                         "steps per ray (e.g. 256)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scene", default=None,
                    help="glTF scene to load instead of writing the bench's "
                         "Sponza-like interior")
    return ap


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them (the
    device type off the card)."""
    if device.type != "cuda":
        return device.type
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else torch.cuda.get_device_name(device)


def load_renderer(scene_path, device) -> Renderer:
    """The renderer of the bench scene (written to a temporary directory
    unless `scene_path` names a glTF) at 1920x1080 on `device`."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    camera = Camera.from_angles(*CAMERA)
    if scene_path is not None:
        return Renderer.from_gltf(scene_path, config=cfg, camera=camera, lights=LIGHTS,
                                  device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_sponza_like_scene(os.path.join(tmp, "bench_sponza.gltf"), **SCENE_KW)
        return Renderer.from_gltf(path, config=cfg, camera=camera, lights=LIGHTS,
                                  device=device)


def rebuild_group(r: Renderer, group: int) -> wide.WideKernelBVH:
    """The wide tables of a triangle BVH with leaves of `group` triangles."""
    ds = r.device_scene
    tri = ds.tri_pos.cpu().numpy()
    return wide.make_wide_kernel_bvh(build_triangle_bvh(tri, group_size=group), tri,
                                     tri_alpha_mask=ds.tri_alpha_mask if r.has_alpha else None,
                                     tri_alpha_opaque=ds.tri_alpha_opaque if r.has_alpha else None,
                                     device=r.device)


def bench_batches(r: Renderer, kbvh: wide.WideKernelBVH, rows: int = 256, row0: int = 400,
                  seed: int = 7) -> dict:
    """The three ray batches of benchmarks/kernel_bench.py on `kbvh`'s
    device: `camera` (o, d), `bounce` (o, d) sorted, `bounce_unsorted`
    (o, d), `shadow` (o, d, t_limit) sorted. Bounce directions are
    uniform, from numpy's RandomState(seed)."""
    cfg = r.config
    dev = kbvh.node_rows.device
    o, d, _ = camera_rays_for_rows(r.camera, row0, rows, cfg.width, cfg.height,
                                   cfg.tan_half_fov, 1, cfg.seed, device=dev)
    ts = tile_shape(rows, cfg.width)
    if ts is not None:
        o, d = (tile_pack(x, 1, rows, cfg.width, *ts).contiguous() for x in (o, d))
    n = o.shape[0]
    t_min = torch.zeros(n, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    t, prim, _, _ = wide.traverse_packets(kbvh, o, d, t_min, cfg.t_max, active, need_uv=False)
    hitp = o + torch.where(prim >= 0, t, torch.ones_like(t))[:, None] * d

    dirs = torch.from_numpy(np.random.RandomState(seed).randn(n, 3).astype(np.float32)).to(dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    ob = (hitp + 0.01 * dirs).contiguous()
    _, (obs, dbs) = _sort_rays(_octant_morton_key(kbvh, ob, dirs, active), (ob, dirs))

    lc = torch.tensor(LIGHTS[2].position, dtype=torch.float32, device=dev)
    to_l = lc[None, :] - hitp
    dist = torch.linalg.norm(to_l, dim=-1)
    dl = to_l / torch.clamp(dist, min=1e-9)[:, None]
    oo = hitp + 0.01 * dl
    _, (oos, dls, tl) = _sort_rays(_octant_morton_key(kbvh, oo, dl, active), (oo, dl, dist))
    c = (lambda *xs: tuple(x.contiguous() for x in xs))
    return {"camera": c(o, d), "bounce": c(obs, dbs), "bounce_unsorted": c(ob, dirs),
            "shadow": c(oos, dls, tl)}


def median_ms(fn, reps: int, device: torch.device) -> float:
    """Median time of `fn` over `reps` runs after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(max(reps, 1)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def stepcost_table(kbvh: wide.WideKernelBVH, o, d, steps: int, reps: int,
                   t_max: float = RenderConfig().t_max) -> dict:
    """K6 at `steps` steps per ray, once per STEPCOST_CONFIGS entry: each
    configuration's ms and ns per ray-step, and each phase's ns per
    ray-step (the difference of two neighbouring configurations)."""
    dev = o.device
    n = o.shape[0]
    t_min = torch.zeros(n, dtype=torch.float32, device=dev)
    t_limit = torch.full((n,), float(np.float32(t_max)), dtype=torch.float32, device=dev)
    out, ms = {}, {}
    for name, toggles in wide.STEPCOST_CONFIGS:
        ms[name] = median_ms(lambda: wide.stepcost_packets(kbvh, o, d, t_min, t_limit,
                                                           steps=steps, **toggles),
                             reps, dev)
        out[f"stepcost_{name}_ms"] = ms[name]
        out[f"stepcost_{name}_ns_per_ray_step"] = ms[name] * 1e6 / (steps * n)
    names = [name for name, _ in wide.STEPCOST_CONFIGS]
    for a, b, phase in zip(names[:-1], names[1:], ("leaf", "push", "extract", "box")):
        out[f"stepcost_{phase}_ns"] = (ms[a] - ms[b]) * 1e6 / (steps * n)
    out["stepcost_looppop_ns"] = ms["-box"] * 1e6 / (steps * n)
    out["stepcost_steps"] = steps
    out["stepcost_rays"] = n
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    r = load_renderer(args.scene, args.device)
    dev = r.device
    kbvh = r.bvh
    if not isinstance(kbvh, wide.WideKernelBVH):
        raise RuntimeError(f"the scene took the rope path ({type(kbvh).__name__}); "
                           "kernel_bench times the wide kernels")
    if args.group and kbvh.group_size != args.group:
        kbvh = rebuild_group(r, args.group)
        print(f"rebuilt the tables at G={kbvh.group_size}: W={kbvh.node_rows.shape[1]}")
    tris = int(r.device_scene.tri_pos.shape[0])
    kernels = f"K5 octet={args.octet}" if args.octet else "K1/K2"
    print(f"scene: {tris} tris, G={kbvh.group_size}, kernels {kernels}, "
          f"device {card_name(dev)}", flush=True)
    b = bench_batches(r, kbvh, args.rows, args.row0)
    n = b["camera"][0].shape[0]
    print(f"rays: {n}", flush=True)
    t_min = torch.zeros(n, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    t_max = r.config.t_max

    def closest(o, d):
        return wide.traverse_packets(kbvh, o, d, t_min, t_max, active, octet=args.octet,
                                     need_uv=False)

    def occlusion():
        o, d, tl = b["shadow"]
        return wide.occlusion_packets(kbvh, o, d, t_min, tl, active, r.has_alpha,
                                      octet=args.octet, need_uv=False)

    results = {"device": card_name(dev), "kernels": kernels, "rays": n, "triangles": tris,
               "group": kbvh.group_size}
    timed = [("coherent_closest", lambda: closest(*b["camera"])),
             ("incoherent_closest", lambda: closest(*b["bounce"]))]
    if args.nosort:
        timed.append(("incoherent_nosort_closest", lambda: closest(*b["bounce_unsorted"])))
    timed.append(("occlusion", occlusion))
    for name, fn in timed:
        ms = median_ms(fn, args.reps, dev)
        results[f"{name}_ms"] = ms
        results[f"{name}_mrays"] = n / ms / 1e3
    if args.stepcost:
        table = stepcost_table(kbvh, *b["bounce"], args.stepcost, args.reps, t_max)
        for name, _ in wide.STEPCOST_CONFIGS:
            print(f"stepcost {name:9s}: {table[f'stepcost_{name}_ms']:9.3f} ms "
                  f"({table[f'stepcost_{name}_ns_per_ray_step']:8.4f} ns/ray-step)")
        print("phase costs (ns/ray-step):")
        for phase in ("leaf", "push", "extract", "box", "looppop"):
            print(f"  {phase:9s} {table[f'stepcost_{phase}_ns']:8.4f}")
        results.update(table)
    for k, v in results.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
