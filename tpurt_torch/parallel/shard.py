"""Multi-device rendering: spp and image-tile sharding over a (tile, spp)
device mesh (the counterpart of tpurt/parallel/shard.py).

tpurt's design is kept: one process drives every device, with no
torch.distributed. Shard (t, s) renders its slice of each row band at
its own sample index, tiles concatenate, and the spp axis reduces by
mean, so one launch delivers S * cfg.spp_per_launch samples per pixel.
The scene and BVH are replicated once per distinct device of the mesh.

Shards run in turn, in rank order (t * S + s), and the spp mean is
summed in rank order on the mesh's first device, so the result does not
depend on timing. A mesh may name one device more than once: that is how
the CPU tests get eight shards and how one card runs a 2x2 mesh. Each
shard runs with its card as the thread's current device, where the
kernels' ctypes launches run.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

from tpurt_torch import film
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig
from tpurt_torch.integrator.wavefront import RayStats, render_rows_stats
from tpurt_torch.kernels import cudalib
from tpurt_torch.runtime.device import DeviceNotFound, resolve_device, to_device
from tpurt_torch.scene.device import DeviceScene
from tpurt_torch.utils.profiling import annotate


class Mesh:
    """A (tile, spp) grid of torch.devices; `shape` is {"tile": T, "spp": S}."""

    def __init__(self, grid: List[List[torch.device]]):
        self.devices = grid
        self.shape = {"tile": len(grid), "spp": len(grid[0])}
        self._replicas = {}  # device -> (scene, bvh, scene there, bvh there)

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    def distinct(self) -> List[torch.device]:
        out = []
        for d in (d for row in self.devices for d in row):
            if d not in out:
                out.append(d)
        return out

    def replica(self, scene: DeviceScene, bvh, device: torch.device):
        """(scene, bvh) on `device`: the originals where they lie there,
        else one copy per device, kept while the originals stay the same."""
        if scene.tri_pos.device == device:
            return scene, bvh
        held = self._replicas.get(device)
        if held is None or held[0] is not scene or held[1] is not bvh:
            held = self._replicas[device] = (scene, bvh, to_device(scene, device),
                                             to_device(bvh, device))
        return held[2], held[3]


def make_mesh(n_tile: int = 1, n_spp: Optional[int] = None, devices=None) -> Mesh:
    """A (tile, spp) mesh over `devices` (default: every CUDA device),
    laid out row-major: shard (t, s) takes devices[t * S + s]."""
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceNotFound("make_mesh: no CUDA device is available (name the devices, "
                                 "e.g. devices=['cpu'] * 8, to shard on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_spp is None:
        n_spp = len(devices) // n_tile
    assert n_tile * n_spp == len(devices), f"mesh {n_tile}x{n_spp} != {len(devices)} devices"
    return Mesh([devices[t * n_spp:(t + 1) * n_spp] for t in range(n_tile)])


def _current(device: torch.device):
    """`device` as the thread's current CUDA device over the body (a CUDA
    launch through ctypes runs on the current device); nothing off the
    card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _band_sizes(height: int, n_tile: int, chunk_rows: int):
    """tpurt's row bands: each a multiple of the tile axis, about
    `chunk_rows` rows (the whole frame when chunk_rows <= 0)."""
    if chunk_rows <= 0 or chunk_rows >= height:
        return [height]
    per = max(chunk_rows - chunk_rows % n_tile, n_tile)
    sizes = []
    row = 0
    while row < height:
        sizes.append(min(per, height - row))
        row += sizes[-1]
    return sizes


def render_sample_stats_sharded(scene: DeviceScene, bvh, camera: Camera, sample_index: int,
                                mesh: Mesh, *, width: int, height: int, cfg: RenderConfig,
                                has_alpha: bool, chunk_rows: int = 0,
                                tex_flags=(True, True, True, True)):
    """One progressive launch over the mesh: ((H, W, 4) radiance on the
    mesh's first device, samples delivered, RayStats of every shard).

    Shard (t, s) renders rows band_row0 + t * rows ... of each band of
    `band_rows` (rows = band_rows // T) at sample index
    sample_index * S + s, as render_rows_stats renders a band; the ray
    counts are summed in host doubles. The kernels' error word of every
    device is checked before the image is returned."""
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    assert height % n_tile == 0, f"height {height} must divide over {n_tile} tiles"
    first = mesh.first
    bands, total = [], np.zeros(2, np.float64)
    row = 0
    for band_rows in _band_sizes(height, n_tile, chunk_rows):
        rows = band_rows // n_tile
        tiles = []
        for t in range(n_tile):
            acc = None
            for s in range(n_spp):
                dev = mesh.devices[t][s]
                sc, bv = mesh.replica(scene, bvh, dev)
                with _current(dev):
                    img, st = render_rows_stats(sc, bv, camera, int(sample_index) * n_spp + s,
                                                row + t * rows, rows=rows, width=width,
                                                height=height, cfg=cfg, has_alpha=has_alpha,
                                                tex_flags=tex_flags)
                total += (st.logical, st.physical)
                with annotate("shard_reduce"):
                    img = img.to(first)
                    acc = img if acc is None else acc + img
            with annotate("shard_reduce"):
                tiles.append(acc if n_spp == 1 else acc / n_spp)
        bands.append(torch.cat(tiles, dim=0))
        row += band_rows
    out = bands[0] if len(bands) == 1 else torch.cat(bands, dim=0)
    for dev in mesh.distinct():
        with _current(dev):
            cudalib.check_kernel_errors(dev)
    return (out, n_spp * cfg.spp_per_launch,
            RayStats(logical=float(total[0]), physical=float(total[1])))


def render_sample_sharded(scene: DeviceScene, bvh, camera: Camera, sample_index: int,
                          mesh: Mesh, *, width: int, height: int, cfg: RenderConfig,
                          has_alpha: bool, chunk_rows: int = 0,
                          tex_flags=(True, True, True, True)):
    """render_sample_stats_sharded without the ray counts: ((H, W, 4)
    radiance, samples delivered)."""
    out, delivered, _ = render_sample_stats_sharded(
        scene, bvh, camera, sample_index, mesh, width=width, height=height, cfg=cfg,
        has_alpha=has_alpha, chunk_rows=chunk_rows, tex_flags=tex_flags)
    return out, delivered


class ShardedRenderer:
    """Progressive renderer over a mesh, wrapping a Renderer for its
    scene, BVH, config, camera and accumulation. Each step() delivers
    S * cfg.spp_per_launch samples per pixel, accumulated as one launch."""

    def __init__(self, renderer, mesh: Mesh):
        self.r = renderer
        self.mesh = mesh

    def step(self) -> torch.Tensor:
        with annotate("launch"):
            r = self.r
            cfg = r.config
            t0 = time.perf_counter()
            launch_index = r.sample_count // (self.mesh.shape["spp"] * cfg.spp_per_launch)
            radiance, delivered, stats = render_sample_stats_sharded(
                r.device_scene, r.bvh, r.camera, launch_index, self.mesh, width=cfg.width,
                height=cfg.height, cfg=cfg, has_alpha=r.has_alpha, chunk_rows=cfg.chunk_rows,
                tex_flags=r.tex_flags)
            r.sample_count += delivered
            with annotate("accumulate"):
                r.accum = film.accumulate(r.accum, radiance.to(r.device), launch_index + 1)
            r.last_stats = stats
            r.rays = RayStats(r.rays.logical + stats.logical, r.rays.physical + stats.physical)
            r.sample_time += time.perf_counter() - t0
            return r.accum

    def render(self, spp: int) -> torch.Tensor:
        while self.r.sample_count < spp:
            self.step()
        return self.r.accum
