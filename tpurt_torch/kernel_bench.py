"""Traversal-kernel microbenchmark on the card (the counterpart of
benchmarks/kernel_bench.py).

    python -m tpurt_torch.kernel_bench [--reps 5] [--json out.json]
        [--rows 256] [--row0 400] [--group G] [--arity A] [--nosort]
        [--octet N] [--near FRAC] [--stepcost K] [--rope] [--device cuda]
        [--scene scene.gltf]

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
warm-up, of the kernel wrapper alone (u/v not recomputed). Beside each
batch's time stands its bound (`traversal_bound`): the least time the
card could take for the box and triangle tests that the plain version
counts on the same rays. `--octet N`
times the multi-walk kernel K5 with N walks per 1024 rays in place of
K1/K2, and sets the union walk's own bound (`union_bound`) beside the
function's. `--stepcost K` runs the step-cost instrument K6 on the sorted
bounce batch: exactly K steps per ray, once per configuration (full,
-leaf, -push, -extract, -box, each dropping one phase more), and prints
each one's ms and ns per ray-step and the per-phase differences.
`--group G` rebuilds the triangle BVH at leaf size G first, and
`--arity A` (8 or 16) the wide tables at A slots per node. `--near FRAC`
also times tpurt's two-pass, distance-bounded closest trace on the
sorted bounce batch: K1 up to r0 = FRAC x the root box's diagonal, then
the misses, moved to the front by a stable key into the first
max(1024, ceil(n/4 / 1024) x 1024) lanes, again with t_min = r0 (1 -
1e-6), and the results put back in ray order; it prints
`near2_closest_ms`, `near2_closest_mrays`, `near2_miss_frac`,
`near2_prim_agree` (prim against the single pass) and `near2_overflow`
(more misses than lanes), and `near2_t_bit_equal`, which must hold
unless it overflowed. `--rope`
also times the rope kernels over the rope tables of a G = 8 triangle BVH
of the scene, as the rope render builds them (no mask column, rays not
sorted): K3 on the camera, unsorted bounce and unsorted shadow rays (the
rope render traces shadow rays as closest hits) and K4 on the shadow
rays bounded by the light's distance, each beside its bound
(`rope_bound`). With `--rows 1080 --row0 0` every batch is a whole frame
(2,073,600 rays). The rope timings call only `rope.make_kernel_bvh`,
`rope._traverse` and `rope.traverse_plain`, so this file can time an
older tree's rope kernels too (run it with that tree's package first on
the path).

tpurt's TPU step variants (`--dual`, `--pair`, `--descend`, `--sup`,
`--race-sup`) and its collapse-mode race are TPU mechanism and are not
offered. The run is on the card unless `--device cpu` is given (the
plain versions then run, and the times are the CPU's).
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
from tpurt_torch.bvh.traverse import _octant_morton_key, _sort_rays, _unsort
from tpurt_torch.camera import Camera, camera_rays_for_rows
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator.wavefront import tile_pack, tile_shape
from tpurt_torch.kernels import wide
from tpurt_torch.kernels.experimental import rope
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_sponza_like_scene

# the scene, camera and lights of bench.py and benchmarks/kernel_bench.py
SCENE_KW = dict(columns=12, foliage=96, stacks=8, segments=28, rings=20)
CAMERA = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHTS = (SphereLight((-8.0, -5.0, -2.0), 0.1, (0.8, 0.6, 0.6), 500.0),
          SphereLight((8.0, -5.0, -2.5), 0.1, (0.4, 0.7, 0.6), 500.0),
          SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0))
WIDTH, HEIGHT = 1920, 1080
ROPE_GROUP = 8  # the leaf size of the smoke's rope render

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# float operations of one traversal step, counted from the kernel source:
# per child box 6 sub + 6 mul + 6 min/max + 6 reductions + 1 compare; per
# triangle ~60 (edges, cross products, det, reciprocal, u, v, t, tests)
OPS_PER_BOX = 25
OPS_PER_TRIANGLE = 60


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
    ap.add_argument("--arity", type=int, default=0, choices=(0, 8, 16),
                    help="rebuild the wide tables at this branching factor "
                         "(0 = the renderer's, 16)")
    ap.add_argument("--near", type=float, default=0.0,
                    help="also time the two-pass distance-bounded closest trace "
                         "with r0 = NEAR x the scene's diagonal (e.g. 0.1)")
    ap.add_argument("--nosort", action="store_true",
                    help="also time the incoherent batch unsorted")
    ap.add_argument("--octet", type=int, default=0, choices=(0,) + wide.OCTET_WALKS,
                    help="time the multi-walk kernel K5 with N walks per "
                         "1024 rays in place of K1/K2")
    ap.add_argument("--stepcost", type=int, default=0,
                    help="run the step-cost instrument K6 at this many "
                         "steps per ray (e.g. 256)")
    ap.add_argument("--rope", action="store_true",
                    help="also time K3/K4 over the rope tables of a G=8 "
                         "triangle BVH of the scene")
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


def rebuild(r: Renderer, group: int = 0, arity: int = 0) -> wide.WideKernelBVH:
    """The renderer's wide tables rebuilt: the triangle BVH at leaves of
    `group` triangles (0 keeps the renderer's), the tables at `arity`
    slots per node (0: wide.ARITY)."""
    ds = r.device_scene
    tri = ds.tri_pos.cpu().numpy()
    tribvh = r.bvh.tribvh
    if group and group != tribvh.group_size:
        tribvh = build_triangle_bvh(tri, group_size=group, device=r.device)
    return wide.make_wide_kernel_bvh(tribvh, tri,
                                     tri_alpha_mask=ds.tri_alpha_mask if r.has_alpha else None,
                                     tri_alpha_opaque=ds.tri_alpha_opaque if r.has_alpha else None,
                                     arity=arity or wide.ARITY, device=r.device)


def bench_batches(r: Renderer, kbvh: wide.WideKernelBVH, rows: int = 256, row0: int = 400,
                  seed: int = 7) -> dict:
    """The three ray batches of benchmarks/kernel_bench.py on `kbvh`'s
    device: `camera` (o, d), `bounce` (o, d) sorted, `bounce_unsorted`
    (o, d), `shadow` (o, d, t_limit) sorted, `shadow_unsorted` (o, d,
    t_limit). Bounce directions are uniform, from numpy's
    RandomState(seed)."""
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
            "shadow": c(oos, dls, tl), "shadow_unsorted": c(oo, dl, dist)}


def traversal_bound(stats: dict, n: int, row_width: int, group: int) -> tuple:
    """Least time for the work a batch of `n` rays needed, from the stats
    of wide.traverse_plain on it: the larger of the float operations (the
    box and triangle tests it counted) over the f32 peak and the bytes over
    the memory rate (rays read once, results written once, each node and
    leaf row read once). Returns (ms, "operations" or "bytes", operations,
    bytes)."""
    ops = (float(stats["box_tests"].sum()) * OPS_PER_BOX
           + float(stats["leaf_visits"].sum()) * group * OPS_PER_TRIANGLE)
    nbytes = (n * (32 + 12) + stats["node_rows_read"] * 128 * 4
              + stats["leaf_rows_read"] * row_width * 4)
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def union_bound(kbvh: wide.WideKernelBVH, o, d, t_min, t_limit, *, walks: int,
                occlusion: bool, all_definite: bool) -> tuple:
    """traversal_bound of the multi-walk union K5 walks: from the stats of
    wide.octet_plain on the same rays, where every ray of a walk tests
    every entry its walk pops. Returns what traversal_bound returns."""
    stats = {}
    wide.octet_plain(kbvh.node_rows, kbvh.tri_rows, o, d, t_min, t_limit,
                     group=kbvh.group_size, arity=kbvh.arity, walks=walks, occlusion=occlusion,
                     all_definite=all_definite, cell_masks=False, stats=stats)
    return traversal_bound(stats, o.shape[0], kbvh.tri_rows.shape[1], kbvh.group_size)


def rope_bound(stats: dict, n: int, row_width: int, group: int) -> tuple:
    """traversal_bound for the rope walk, from the stats of
    rope.traverse_plain: one box test per step, G triangle tests per leaf
    whose box is hit; rays read once (o, d, t_min, t_limit, active: 33 B)
    and results written once (t, prim, u, v, blocked: 20 B), each 32 B
    node row and each leaf row read once."""
    ops = (float(stats["node_visits"].sum()) * OPS_PER_BOX
           + float(stats["leaf_visits"].sum()) * group * OPS_PER_TRIANGLE)
    nbytes = (n * (33 + 20) + stats["node_rows_read"] * 8 * 4
              + stats["leaf_rows_read"] * row_width * 4)
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def rope_batches(b: dict, t_max: float) -> list:
    """(name, o, d, t_limit, occlusion) of the rope timings: the rope
    render sorts no rays, and traces shadow rays as closest hits (K3) up
    to t_max; K4 takes them bounded by the light's distance."""
    o = b["camera"][0]
    far = torch.full((o.shape[0],), float(np.float32(t_max)), dtype=torch.float32,
                     device=o.device)
    return [("rope_camera", *b["camera"], far, False),
            ("rope_bounce", *b["bounce_unsorted"], far, False),
            ("rope_shadow_closest", *b["shadow_unsorted"][:2], far, False),
            ("rope_shadow_occlusion", *b["shadow_unsorted"], True)]


def rope_timings(r: Renderer, b: dict, reps: int) -> dict:
    """K3/K4 over the rope tables of a G = ROPE_GROUP triangle BVH of the
    scene on the rope batches: ms, ns per ray and the bound of each."""
    dev = r.device
    tri = r.device_scene.tri_pos.cpu().numpy()
    rk = rope.make_kernel_bvh(build_triangle_bvh(tri, group_size=ROPE_GROUP), tri, device=dev)
    out = {"rope_group": rk.group_size, "rope_nodes": int(rk.node_rows.shape[1])}
    for name, o, d, t_limit, occlusion in rope_batches(b, r.config.t_max):
        n = o.shape[0]
        t_min = torch.zeros(n, dtype=torch.float32, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        kw = dict(occlusion=occlusion, all_definite=True)
        stats = {}
        rope.traverse_plain(rk.node_rows, rk.tri_rows, o, d, t_min, t_limit, active,
                            n_internal=rk.n_internal, group=rk.group_size, stats=stats, **kw)
        ms = median_ms(lambda: rope._traverse(rk, o, d, t_min, t_limit, active, **kw),
                       reps, dev)
        bound_ms, bound_by, _, _ = rope_bound(stats, n, rk.tri_rows.shape[1], rk.group_size)
        out[f"{name}_rays"] = n
        out[f"{name}_ms"] = ms
        out[f"{name}_ns_per_ray"] = ms * 1e6 / n
        out[f"{name}_bound_ms"] = bound_ms
        out[f"{name}_bound_by"] = bound_by
        out[f"{name}_steps_per_ray"] = float(stats["node_visits"].float().mean())
        out[f"{name}_leaf_tests_per_ray"] = float(stats["leaf_visits"].float().mean())
    return out


def near_pass(kbvh: wide.WideKernelBVH, o, d, r0: float, t_max: float):
    """tpurt's two-pass closest trace (benchmarks/kernel_bench.py:219):
    K1 with t_limit = r0; the misses, moved to the front by a stable key,
    take the first `capn` lanes of a second K1 pass from t_min = r0 (1 -
    1e-6); its results go back to ray order. Exact unless more than
    `capn` rays miss. Returns (t, prim, misses, capn)."""
    n = o.shape[0]
    dev = o.device
    capn = max(1024, (n // 4 + 1023) // 1024 * 1024)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    t1, p1, _, _ = wide.traverse_packets(kbvh, o, d, torch.zeros(n, dtype=torch.float32,
                                                                  device=dev),
                                         r0, active, need_uv=False)
    miss = p1 < 0
    key = torch.where(miss, torch.arange(n, device=dev), torch.full_like(p1, 0x7FFFFFFF,
                                                                         dtype=torch.int64))
    order, (os_, ds_, ms) = _sort_rays(key, (o, d, miss))
    t2, p2, _, _ = wide.traverse_packets(
        kbvh, os_[:capn], ds_[:capn],
        torch.full((capn,), r0 * (1.0 - 1e-6), dtype=torch.float32, device=dev),
        t_max, ms[:capn], need_uv=False)
    pad = n - capn
    t2 = torch.cat([t2, torch.full((pad,), float(np.float32(t_max)), dtype=torch.float32,
                                   device=dev)])
    p2 = torch.cat([p2, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    t2, p2 = _unsort(order, (t2, p2))
    return torch.where(miss, t2, t1), torch.where(miss, p2, p1), miss.sum(), capn


def near_timings(kbvh: wide.WideKernelBVH, o, d, frac: float, reps: int,
                 t_max: float) -> dict:
    """near_pass with r0 = frac x the root box's diagonal on (o, d),
    timed and held against the single K1 pass: the records of tpurt's
    `--near`, plus r0, the overflow and whether t is bit-equal."""
    n = o.shape[0]
    dev = o.device
    lo, hi = kbvh.root_bounds()
    r0 = frac * float(torch.linalg.norm(hi - lo))
    t, p, nmiss, capn = near_pass(kbvh, o, d, r0, t_max)
    t1, p1, _, _ = wide.traverse_packets(kbvh, o, d, torch.zeros(n, dtype=torch.float32,
                                                                 device=dev),
                                         t_max, torch.ones(n, dtype=torch.bool, device=dev),
                                         need_uv=False)
    nmiss = int(nmiss)
    ms = median_ms(lambda: near_pass(kbvh, o, d, r0, t_max), reps, dev)
    out = {"near2_r0": r0, "near2_capn": capn, "near2_closest_ms": ms,
           "near2_closest_mrays": n / ms / 1e3, "near2_miss_frac": nmiss / n,
           "near2_prim_agree": float((p == p1).float().mean()),
           "near2_overflow": nmiss > capn,
           "near2_t_bit_equal": bool(torch.equal(t.view(torch.int32), t1.view(torch.int32)))}
    print(f"near2: r0={r0:.2f} miss_frac={nmiss / n:.3f} overflow={out['near2_overflow']} "
          f"prim_agree={out['near2_prim_agree']:.4f}", flush=True)
    return out


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
    if (args.group and kbvh.group_size != args.group) or (args.arity and
                                                          kbvh.arity != args.arity):
        kbvh = rebuild(r, args.group, args.arity)
        print(f"rebuilt the wide tables at arity {kbvh.arity}, G={kbvh.group_size}: "
              f"W={kbvh.node_rows.shape[1]}")
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

    far = torch.full((n,), float(np.float32(t_max)), dtype=torch.float32, device=dev)
    results = {"device": card_name(dev), "kernels": kernels, "rays": n, "triangles": tris,
               "group": kbvh.group_size, "arity": kbvh.arity}
    timed = [("coherent_closest", *b["camera"], far, False),
             ("incoherent_closest", *b["bounce"], far, False)]
    if args.nosort:
        timed.append(("incoherent_nosort_closest", *b["bounce_unsorted"], far, False))
    timed.append(("occlusion", *b["shadow"], True))
    for name, o, d, t_limit, occlusion in timed:
        if occlusion:
            ms = median_ms(lambda: wide.occlusion_packets(
                kbvh, o, d, t_min, t_limit, active, r.has_alpha, octet=args.octet,
                need_uv=False), args.reps, dev)
        else:
            ms = median_ms(lambda: wide.traverse_packets(
                kbvh, o, d, t_min, t_max, active, octet=args.octet, need_uv=False),
                args.reps, dev)
        stats = {}
        wide.traverse_plain(kbvh.node_rows, kbvh.tri_rows, o, d, t_min, t_limit,
                            group=kbvh.group_size, arity=kbvh.arity, occlusion=occlusion,
                            all_definite=not r.has_alpha, cell_masks=False, stats=stats)
        bound_ms, bound_by, _, _ = traversal_bound(stats, n, kbvh.tri_rows.shape[1],
                                                   kbvh.group_size)
        results[f"{name}_ms"] = ms
        results[f"{name}_mrays"] = n / ms / 1e3
        results[f"{name}_bound_ms"] = bound_ms
        results[f"{name}_bound_by"] = bound_by
        if args.octet:
            u_ms, u_by, _, _ = union_bound(kbvh, o, d, t_min, t_limit, walks=args.octet,
                                           occlusion=occlusion, all_definite=not r.has_alpha)
            results[f"{name}_union_bound_ms"] = u_ms
            results[f"{name}_union_bound_by"] = u_by
    if args.near > 0:
        results.update(near_timings(kbvh, *b["bounce"], args.near, args.reps, t_max))
    if args.rope:
        results.update(rope_timings(r, b, args.reps))
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
