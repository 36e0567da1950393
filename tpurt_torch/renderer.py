"""Progressive renderer: scene, BVH, integrator and film tied together
(the counterpart of tpurt/renderer.py).

It owns the accumulation buffer and the sample counter, resets on a
camera change, prints the reference's convergence line once the sample
target is reached, and saves and resumes checkpoints in tpurt's format.
The scene cache comes in a later slice.

Two render paths, chosen at construction:

- the wide path (the default): the 16-ary wide tables, traced by K1/K2,
  or by the multi-walk K5 when `config.kernel` sets `octet_closest` /
  `octet_occlusion` (the integrator reads the policy per dispatch);
- the rope path: the binary TriBVH's rope tables, traced by K3, with
  shadow rays resolved by a full closest-hit trace. It is taken when the
  caller passes a TriBVH as `bvh` (tpurt's goldens come from this path:
  tpurt takes it on the CPU), or when the leaves do not fit the wide leaf
  row (`wide.wide_supported`).

Unlike tpurt, the path does not depend on the device: the CPU runs the
same path through each kernel's plain version.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpurt_torch import film
from tpurt_torch.bvh.lbvh import TriBVH, build_triangle_bvh
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator.wavefront import RayStats, render_sample_stats
from tpurt_torch.kernels import cudalib
from tpurt_torch.kernels.experimental import rope
from tpurt_torch.kernels.wide import (
    WideKernelBVH,
    collapse_to_wide,
    make_wide_kernel_bvh,
    pick_group_size_wide,
    wide_supported,
)
from tpurt_torch.runtime.device import resolve_device
from tpurt_torch.scene.device import DeviceScene, build_device_scene
from tpurt_torch.scene.gltf import camera_for_render, load_gltf
from tpurt_torch.scene.types import NO_TEXTURE, SceneData
from tpurt_torch.utils import debug


class Renderer:
    def __init__(self, scene: SceneData, config: RenderConfig = RenderConfig(),
                 lights: Sequence[SphereLight] = (), camera: Optional[Camera] = None,
                 device="cuda", bvh=None):
        """`bvh`: a prebuilt acceleration structure to use instead of
        building one: a TriBVH (the rope path; its rope tables move to the
        device here, once) or a WideKernelBVH on `device`."""
        self.device = resolve_device(device)
        self.config = config
        self.timings = {}
        t0 = time.perf_counter()
        self.device_scene: DeviceScene = build_device_scene(scene, lights=lights,
                                                            device=self.device)
        self.timings["device_scene_s"] = time.perf_counter() - t0
        self.camera = (camera or camera_for_render(scene.camera)).to(self.device)
        ds = self.device_scene
        self.has_alpha = bool(ds.tri_alpha.any())
        mats = ds.materials
        self.tex_flags = tuple(bool((t != NO_TEXTURE).any()) for t in
                               (mats.tex_albedo, mats.tex_mr, mats.tex_normal,
                                mats.tex_emissive))
        tri_np = ds.tri_pos.cpu().numpy()
        if bvh is None:
            t0 = time.perf_counter()
            bvh = build_triangle_bvh(tri_np, group_size=pick_group_size_wide(tri_np.shape[0]))
            self.timings["sah_s"] = time.perf_counter() - t0
            if wide_supported(bvh):
                t0 = time.perf_counter()
                collapse = collapse_to_wide(bvh)
                self.timings["collapse_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                bvh = make_wide_kernel_bvh(
                    bvh, tri_np,
                    tri_alpha_mask=ds.tri_alpha_mask if self.has_alpha else None,
                    tri_alpha_opaque=ds.tri_alpha_opaque if self.has_alpha else None,
                    device=self.device, collapse=collapse)
                self.timings["pack_s"] = time.perf_counter() - t0
        if isinstance(bvh, TriBVH):
            t0 = time.perf_counter()
            bvh = rope.make_kernel_bvh(bvh, tri_np, device=self.device)
            self.timings["pack_s"] = time.perf_counter() - t0
        elif not isinstance(bvh, WideKernelBVH):
            raise TypeError(f"bvh must be a TriBVH or a WideKernelBVH, not {type(bvh).__name__}")
        self.bvh = bvh
        self.last_stats = RayStats(0.0, 0.0)
        self.reset()

    @classmethod
    def from_gltf(cls, paths, config: RenderConfig = RenderConfig(),
                  lights: Sequence[SphereLight] = (), camera: Optional[Camera] = None,
                  device="cuda", bvh=None) -> "Renderer":
        """Load a glTF/GLB scene and build the renderer on `device`
        (`bvh` as for the constructor)."""
        resolve_device(device)
        t0 = time.perf_counter()
        scene = load_gltf(paths)
        load_s = time.perf_counter() - t0
        r = cls(scene, config=config, lights=lights, camera=camera, device=device, bvh=bvh)
        r.timings["gltf_load_s"] = load_s
        return r

    # ---- progressive accumulation ------------------------------------------

    def reset(self) -> None:
        cfg = self.config
        self.accum = torch.zeros((cfg.height, cfg.width, 4), dtype=torch.float32,
                                 device=self.device)
        self.sample_count = 0
        self.sample_time = 0.0
        self.rays = RayStats(0.0, 0.0)
        self._converged_reported = False

    def set_camera(self, camera: Camera) -> None:
        """Any camera change resets accumulation."""
        self.camera = camera.to(self.device)
        self.reset()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> torch.Tensor:
        """One launch of cfg.spp_per_launch samples per pixel; returns the
        accumulation buffer."""
        cfg = self.config
        if self.sample_count >= cfg.max_samples:
            self._finish()
            return self.accum
        t0 = time.perf_counter()
        spp = cfg.spp_per_launch
        launch_index = self.sample_count // spp
        radiance, stats = render_sample_stats(
            self.device_scene, self.bvh, self.camera, launch_index,
            width=cfg.width, height=cfg.height, cfg=cfg, has_alpha=self.has_alpha,
            chunk_rows=cfg.chunk_rows, tex_flags=self.tex_flags)
        if debug.checks_enabled():
            debug.check_sample(radiance, self.sample_count)
        self.sample_count += spp
        self.accum = film.accumulate(self.accum, radiance, launch_index + 1)
        self._sync()
        cudalib.check_kernel_errors(self.device)
        self.sample_time += time.perf_counter() - t0
        self.last_stats = stats
        self.rays = RayStats(self.rays.logical + stats.logical,
                             self.rays.physical + stats.physical)
        if self.sample_count >= cfg.max_samples:
            self._finish()
        return self.accum

    def _finish(self) -> None:
        if not self._converged_reported:
            print("Max. sample count reached. Time=%f s" % self.sample_time)
            self._converged_reported = True

    def render(self, spp: Optional[int] = None, progress_every: int = 0) -> torch.Tensor:
        """Accumulate `spp` samples (default: config.max_samples)."""
        target = spp if spp is not None else self.config.max_samples
        while self.sample_count < min(target, self.config.max_samples):
            self.step()
            if progress_every and self.sample_count % progress_every == 0:
                print(f"  {self.sample_count}/{target} spp, {self.sample_time:.2f}s")
        return self.accum

    # ---- output ---------------------------------------------------------------

    def tonemapped(self) -> torch.Tensor:
        return film.tonemap(self.accum, self.config.exposure)

    def save_png(self, path: str) -> None:
        film.save_png(path, self.tonemapped())

    def image(self) -> np.ndarray:
        return self.accum.detach().cpu().numpy()

    # ---- checkpoints ------------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        film.save_checkpoint(path, self.accum, self.sample_count, self.config.seed,
                             self.camera, spp_per_launch=self.config.spp_per_launch)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of either package; the accumulation
        buffer and the camera go to this renderer's device."""
        ck = film.load_checkpoint(path)
        shape = (self.config.height, self.config.width, 4)
        if ck.accum.shape != shape:  # tpurt's assertion, kept under python -O
            raise AssertionError(f"checkpoint accumulation {ck.accum.shape}, renderer {shape}")
        # another seed would decorrelate or repeat the sample stream of the
        # accumulated image; another spp_per_launch would mis-weight the
        # per-launch running average
        if ck.seed != self.config.seed:
            raise ValueError(
                f"checkpoint was rendered with seed {ck.seed}, config has "
                f"seed {self.config.seed}; exact resume requires the same seed")
        if ck.spp_per_launch and ck.spp_per_launch != self.config.spp_per_launch:
            raise ValueError(
                f"checkpoint used spp_per_launch={ck.spp_per_launch}, config "
                f"has {self.config.spp_per_launch}; the per-launch running "
                "average requires the same value to resume exactly")
        self.accum = torch.from_numpy(np.ascontiguousarray(ck.accum, np.float32)).to(self.device)
        self.sample_count = ck.sample_count
        self.camera = ck.camera(self.device)
        self._converged_reported = False
