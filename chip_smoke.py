#!/usr/bin/env python3
"""Smoke run of the tpurt_torch port on one NVIDIA card.

    python3 chip_smoke.py

Runs, in order, with one JSON line per phase (`phase`, `seconds`, ...):

  device   card name, power limit, torch version; no card is an error
  build    nvcc the four CUDA sources (wide_traverse.cu, rope_traverse.cu,
           wide_octet.cu, wide_stepcost.cu) and g++ the native host core,
           all at once
  scene    write the bench's Sponza-like scene (~215k triangles), load it,
           build the renderer at 1920x1080 on the card, time each host step
  kernels  hold K1 (closest hit: 65,536 camera rays, 65,536 bounce rays with
           cell masks) and K2 (occlusion: 65,536 shadow rays to the three
           lights) against their plain PyTorch versions on the same inputs:
           t bit-equal wherever prim agrees, prim different only on exact-t
           ties, pending and blocked equal; CUDA-event timings of both.
           Then K3 (rope closest hit) and K4 (rope occlusion) on the same
           three batches, over the rope tables of the same G=8 TriBVH with
           the mask column, against their plain versions by the same rule
           (u, v bit-equal too), and across: K3 against K1 (same cell
           rejection) and K4 against K2 (tables without masks, once with
           every hit definite and once with none), equal t, prim only on
           ties, blocked equal
  render   Renderer.render at 1920x1080: 1 warm-up and 2 timed samples,
           with the kernel launch counters zeroed just before; NaN pixels
           must be 0, the mean radiance > 0; the PNG goes to smoke_out/.
           The warm-up sample keeps the inputs and kernel outputs of the
           first camera wave, bounce wave, alpha re-trace, shadow wave and
           shadow re-trace it launches; after the timed samples each is
           held against the plain version with the rule of `kernels`
  rope     the rope path: Renderer(..., bvh=build_triangle_bvh(tri, 8)) on
           the same scene, camera and lights, 1 warm-up and 2 timed samples
           with every launch counter zeroed just before; K3 must launch, K1,
           K2 and K4 must not. The warm-up's first camera and bounce waves
           are held against rope.traverse_plain; the image against the
           `render` phase's (same seed and samples) by RMSE, bound
           ROPE_VS_WIDE_RMSE. Then K4's own path, rope.occlusion_packets on
           the frame's 2,073,600 shadow rays (camera hits to the lights),
           counted and held against the plain version
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
           waves held against octet_plain
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
  golden   the box golden (64x48, 8 spp) rendered on the card, RMSE against
           tests/goldens/box_64x48_8spp.npz (fail above 1e-3)

Then it prints the card's name and power limit as nvidia-smi gives them,
the {"kernels": [...]} line (K1-K6), and last {"ok": true, "device":
{...}}. A watchdog ends the run with exit code 1, naming the phase it was
in, after 600 seconds. Needs torch with CUDA, numpy, nvcc and g++; no JAX, no
Pillow, no prebuilt artefact.
"""

import dataclasses
import json
import os
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

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# float operations of one traversal step, counted from the kernel source:
# per child box 6 sub + 6 mul + 6 min/max + 6 reductions + 1 compare; per
# triangle ~60 (edges, cross products, det, reciprocal, u, v, t, tests)
OPS_PER_BOX = 25
OPS_PER_TRIANGLE = 60
# rope vs wide render of the same frame: the two paths run the same
# arithmetic and differ only where an exact-t tie picks another triangle
ROPE_VS_WIDE_RMSE = 1e-5

_state = {"phase": "start"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def watchdog():
    emit({"error": "deadline", "phase": _state["phase"], "seconds": DEADLINE_S})
    sys.stdout.flush()
    os._exit(1)


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


def nvidia_smi():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else "unknown"


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


def compare_rope(kind, k, p):
    """compare() for the rope kernels' (t, prim, u, v, blocked), with u and
    v bit-equal wherever prim agrees."""
    import torch

    out = compare(kind, (k[0], k[1], k[4]), (p[0], p[1], p[4]))
    same = k[1] == p[1]
    uv_bad = same & ((k[2].view(torch.int32) != p[2].view(torch.int32))
                     | (k[3].view(torch.int32) != p[3].view(torch.int32)))
    out["mismatch"] += int(uv_bad.sum())
    return out


def rope_bound(stats, n, row_width, group):
    """bound() for the rope walk: one box test per step, G triangle tests
    per leaf whose box is hit; rays read once (o, d, t_min, t_limit,
    active: 33 B) and results written once (20 B), each 32 B node row
    and each leaf row read once."""
    ops = (float(stats["node_visits"].sum()) * OPS_PER_BOX
           + float(stats["leaf_visits"].sum()) * group * OPS_PER_TRIANGLE)
    nbytes = (n * (33 + 20) + stats["node_rows_read"] * 8 * 4
              + stats["leaf_rows_read"] * row_width * 4)
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def compare_exact(k, p):
    """Kernel against plain version when both walk in the same order:
    rays where t (bits), prim or the flag differ."""
    import torch

    bad = ((k[0].view(torch.int32) != p[0].view(torch.int32)) | (k[1] != p[1])
           | (k[2].view(torch.int32) != p[2].view(torch.int32)))
    hit = k[1] >= 0
    err = float((k[0][hit] - p[0][hit]).abs().max()) if bool(hit.any()) else 0.0
    return {"rays": int(k[0].numel()), "mismatch": int(bad.sum()), "max_abs_err": err,
            "flag_set": int((k[2] != 0).sum()) if k[2].dtype == torch.float32 else None}


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


def bound(stats, n, row_width, group):
    """Least time for the work this batch needed: the larger of the float
    operations (the box and triangle tests the plain traversal counted)
    over the f32 peak and the bytes over the memory rate (rays read once,
    results written once, each node and leaf row read once)."""
    ops = (float(stats["box_tests"].sum()) * OPS_PER_BOX
           + float(stats["leaf_visits"].sum()) * group * OPS_PER_TRIANGLE)
    nbytes = (n * (32 + 12) + stats["node_rows_read"] * 128 * 4
              + stats["leaf_rows_read"] * row_width * 4)
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def main():
    timer = threading.Timer(DEADLINE_S, watchdog)
    timer.daemon = True
    timer.start()

    import torch

    if not torch.cuda.is_available():
        emit({"error": "no CUDA device: torch.cuda.is_available() is false"})
        return 2
    with Phase("device") as info:
        import tpurt_torch  # noqa: F401  (fails outside a checkout of the repo)

        smi = nvidia_smi()
        info.update(name=torch.cuda.get_device_name(0), nvidia_smi=smi,
                    torch=torch.__version__, cuda=torch.version.cuda,
                    count=torch.cuda.device_count())

    import numpy as np

    from tpurt_torch import film, native
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

    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory()
    lights = [SphereLight(*x) for x in LIGHTS]
    camera = Camera.from_angles(*CAMERA)
    with Phase("scene") as info:
        t0 = time.perf_counter()
        path = write_sponza_like_scene(os.path.join(tmp.name, "sponza.gltf"), **SCENE_KW)
        write_s = time.perf_counter() - t0
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_samples=1024)
        r = Renderer.from_gltf(path, config=cfg, camera=camera, lights=lights, device=dev)
        kb = r.bvh
        info.update(triangles=int(r.device_scene.tri_pos.shape[0]),
                    wide_nodes=int(kb.node_rows.shape[1]),
                    leaves=int(kb.tri_rows.shape[0]),
                    leaf_row_floats=int(kb.tri_rows.shape[1]),
                    stack_bound=kb.stack_bound,
                    table_mb=round((kb.node_rows.numel() + kb.tri_rows.numel()) * 4 / 2**20, 2),
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
            cmp = compare(mode, out_k, out_p)
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
            raise RuntimeError(f"kernel/plain mismatches beyond exact-t ties: {bad}")
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
            cmp = compare_rope(mode, out_k, out_p)
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
            raise RuntimeError(f"rope kernel mismatches beyond exact-t ties: {bad}")
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
        t0 = time.perf_counter()
        r.render(3)
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

        t0 = time.perf_counter()
        main_cases = {}
        for name, (args, kw, out_k) in captured.items():
            out_p = wide.traverse_plain(kb.node_rows, kb.tri_rows, *args, group=kb.group_size,
                                        arity=kb.arity, **kw)
            main_cases[name] = compare("occlusion" if kw["occlusion"] else "closest",
                                       out_k, out_p)
            del out_p
        info.update(main_path_cases=main_cases,
                    main_path_check_s=round(time.perf_counter() - t0, 3))
        for want in ("camera_wave", "bounce_wave", "shadow_wave"):
            if want not in main_cases:
                raise RuntimeError(f"the render launched no {want}: {sorted(main_cases)}")
        bad = sum(v["mismatch"] for v in main_cases.values())
        if bad:
            raise RuntimeError(f"main-path kernel/plain mismatches beyond exact-t ties: {bad}")
        for row, modes in ((kernel_rows[0], ("camera_wave", "bounce_wave", "alpha_retrace")),
                           (kernel_rows[1], ("shadow_wave", "shadow_retrace"))):
            errs = [main_cases[m]["max_abs_err"] for m in modes if m in main_cases]
            row["max_abs_err"] = max([row["max_abs_err"], *errs])
            row["main_path_rays_checked"] = sum(main_cases[m]["rays"] for m in modes
                                                if m in main_cases)

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
        # wave and of the first bounce wave (the first trace with spheres)
        import tpurt_torch.bvh.traverse as traverse_mod

        captured, wanted = {}, []
        scene_walk, launch = traverse_mod.intersect_scene, rope.traverse_cuda

        def walk(bvh, tri_pos, lights_, o, d, t_min, t_max, include_spheres=True, active=None):
            fresh = not bool((t_min != 0).any())
            name = "bounce_wave" if include_spheres else "camera_wave"
            wanted.append(name if fresh and name not in captured else None)
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
                    peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))
        if launches["rope_closest"] <= 0 or launches["rope_occlusion"] or launches["closest"] \
                or launches["occlusion"]:
            raise RuntimeError(f"the rope render did not launch K3 alone: {launches}")
        if nan_px or not rmse_wide <= ROPE_VS_WIDE_RMSE:
            raise RuntimeError(f"rope image: {nan_px} NaN pixels, RMSE {rmse_wide} against "
                               f"the wide render (bound {ROPE_VS_WIDE_RMSE})")
        kernel_rows[2]["launches"] = launches["rope_closest"]

        t0 = time.perf_counter()
        rt = rr.bvh
        main_cases = {}
        for name, (args, kw, out_k) in captured.items():
            out_p = rope.traverse_plain(rt.node_rows, rt.tri_rows, *args,
                                        n_internal=rt.n_internal, group=rt.group_size, **kw)
            main_cases[name] = compare_rope("closest", out_k, out_p)
        if sorted(main_cases) != ["bounce_wave", "camera_wave"]:
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
        out_p = rope.traverse_plain(rk.node_rows, rk.tri_rows, org, d_s, z, t_lim, act,
                                    n_internal=rk.n_internal, group=rk.group_size,
                                    occlusion=True, all_definite=False)
        blocked_k, t_k, p_k, u_k, v_k = out_k
        main_cases["k4_shadow_frame"] = compare_rope(
            "occlusion", (t_k, p_k, u_k, v_k, blocked_k.float()),
            (out_p[0], rope.original_ids(rk, out_p[1]), out_p[2], out_p[3], out_p[4]))
        cudalib.check_kernel_errors(dev)
        info.update(main_path_cases=main_cases, k4_launches=harness["rope_occlusion"],
                    main_path_check_s=round(time.perf_counter() - t0, 3))
        bad = sum(v["mismatch"] for v in main_cases.values())
        if bad:
            raise RuntimeError(f"rope main-path kernel/plain mismatches beyond exact-t ties: {bad}")
        for row, modes in ((kernel_rows[2], ("camera_wave", "bounce_wave")),
                           (kernel_rows[3], ("k4_shadow_frame",))):
            row["max_abs_err"] = max([row["max_abs_err"]]
                                     + [main_cases[m]["max_abs_err"] for m in modes])
            row["main_path_rays_checked"] = sum(main_cases[m]["rays"] for m in modes)

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
                mode=mode, walks=walks, ms=k_ms, k1_ms=k1_ms, plain_ms=p_ms,
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
        t0 = time.perf_counter()
        main_cases = {}
        for name, (args, kw, out_k) in captured.items():
            out_p = wide.octet_plain(kb.node_rows, kb.tri_rows, *args, group=kb.group_size,
                                     arity=kb.arity, **kw)
            main_cases[name] = compare_exact(out_k, out_p)
            del out_p
        del captured
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
            "main_path_rays_checked": sum(v["rays"] for v in main_cases.values())})

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
        info.update(steps=steps, cases=step_results, full_vs_k1=full_vs_k1)
        bad = sum(v["mismatch"] for v in step_results.values()) + full_vs_k1["mismatch"]
        if bad:
            raise RuntimeError(f"K6 mismatches: {bad}")
        # kernel_bench's step-cost table through its entry point; the first
        # K6 launch of each configuration is kept and, after the run, held
        # against stepcost_plain on the same inputs, bit for bit
        from tpurt_torch import kernel_bench

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
            "main_path_rays_checked": sum(v["rays"] for v in bench_checks.values())})

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

    tmp.cleanup()
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    timer.cancel()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # any failing phase fails the run
        emit({"error": f"{type(e).__name__}: {e}", "phase": _state["phase"]})
        code = 1
    sys.stdout.flush()
    os._exit(code)
