"""Progressive renderer: scene, BVH, integrator and film tied together
(the counterpart of tpurt/renderer.py).

It owns the accumulation buffer and the sample counter, resets on a
camera change, prints the reference's convergence line once the sample
target is reached, and saves and resumes checkpoints in tpurt's format.
`from_gltf` memoizes the device scene and the BVH on disk
(scene/cache.py). `step` keeps up to FRAMES_IN_FLIGHT launches in flight
(runtime.FramePacer) and checks the kernels' error word where a frame
retires and in `drain`; a launch that fails for lack of memory is
retried from the newest complete state with half the row band.

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

import os
import sys
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
    ARITY,
    WideKernelBVH,
    collapse_to_wide,
    make_wide_kernel_bvh,
    pick_group_size_wide,
    wide_supported,
)
from tpurt_torch.runtime.device import FramePacer, resolve_device, to_device
from tpurt_torch.scene import cache as scache
from tpurt_torch.scene.device import DeviceScene, build_device_scene
from tpurt_torch.scene.gltf import camera_for_render, load_gltf
from tpurt_torch.scene.types import NO_TEXTURE, SceneData
from tpurt_torch.utils import debug

# errors a smaller row band can fix (tpurt's list): a launch killed by a
# wall-time limit, a lost transport, or memory exhausted
_RETRYABLE = ("deadline", "timed out", "timeout", "cancelled", "canceled",
              "killed", "preempt", "unavailable", "aborted",
              "connection reset", "socket closed",
              "resource_exhausted", "resource exhausted", "out of memory",
              "response body closed", "read body", "remote_compile",
              "connection closed", "broken pipe")
# CUDA faults that poison the context, and the port's own kernel faults
# (cudalib.check_kernel_errors): a smaller band cannot fix them
_FATAL = ("illegal memory access", "unspecified launch failure", "cuda kernel fault")


def _is_launch_failure(err: Exception) -> bool:
    """True for errors a retry with half the row band can fix: a
    torch.cuda.OutOfMemoryError, or a plain RuntimeError whose message
    has one of tpurt's needles. False for programming errors (another
    exception type, or a message without a needle). Unlike tpurt, also
    False for a CUDA fault that poisons the context or a kernel fault the
    port reports itself, even where the message holds a needle."""
    msg = str(err).lower()
    if any(n in msg for n in _FATAL):
        return False
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    if type(err) is not RuntimeError:
        return False
    return any(n in msg for n in _RETRYABLE)


class Renderer:
    def __init__(self, scene: SceneData | DeviceScene, config: RenderConfig = RenderConfig(),
                 lights: Sequence[SphereLight] = (), camera: Optional[Camera] = None,
                 device="cuda", bvh=None):
        """`scene`: a SceneData, or a DeviceScene taken as it is (moved to
        `device` if it lies elsewhere; its lights are the ones it was built
        with, and without `camera` it uses Camera.default()). `bvh`: a
        prebuilt acceleration structure to use instead of building one: a
        TriBVH (the rope path; its rope tables move to the device here,
        once) or a WideKernelBVH on `device`."""
        self.device = resolve_device(device)
        self.config = config
        self.timings = {}
        if isinstance(scene, DeviceScene):
            self.device_scene = (scene if scene.tri_pos.device == self.device
                                 else to_device(scene, self.device))
            self.camera = (camera or Camera.default()).to(self.device)
        else:
            t0 = time.perf_counter()
            self.device_scene = build_device_scene(scene, lights=lights, device=self.device)
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
            bvh = build_triangle_bvh(tri_np, group_size=pick_group_size_wide(tri_np.shape[0]),
                                     device=self.device)
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
                  device="cuda", bvh=None, cache: bool = True) -> "Renderer":
        """Load a glTF/GLB scene and build the renderer on `device` (`bvh`
        as for the constructor). With `cache` (the default) and a cache
        directory (scene/cache.py), the device scene and the BVH come from
        disk when the scene's bytes, the lights and the device kind match,
        and are saved there after a cold build; `timings` then holds
        `cache_load_s`, or the build's keys and `cache_save_s`. A caller's
        `bvh` bypasses the cache."""
        dev = resolve_device(device)
        cache_dir = scache.default_cache_dir() if cache and bvh is None else None
        cpath = None
        if cache_dir:
            plist = [paths] if isinstance(paths, (str, bytes)) else list(paths)
            key = scache.scene_cache_key(plist, lights, ARITY, scache.backend_name(dev))
            cpath = os.path.join(cache_dir, key + ".npz")
            t0 = time.perf_counter()
            loaded = scache.load_artifacts(cpath, device=dev)
            if loaded is not None:
                ds, cached_bvh, default_cam = loaded
                r = cls(ds, config=config, lights=lights, camera=camera or default_cam,
                        device=dev, bvh=cached_bvh)
                r.timings = {"cache_load_s": time.perf_counter() - t0}
                return r
        t0 = time.perf_counter()
        scene = load_gltf(paths)
        load_s = time.perf_counter() - t0
        r = cls(scene, config=config, lights=lights, camera=camera, device=dev, bvh=bvh)
        r.timings["gltf_load_s"] = load_s
        if cpath is not None:
            # the scene's resolved DEFAULT camera, never the caller's, so a
            # warm start without a camera resolves what a cold one does
            t0 = time.perf_counter()
            scache.save_artifacts(cpath, r.device_scene, r.bvh,
                                  camera=camera_for_render(scene.camera))
            r.timings["cache_save_s"] = time.perf_counter() - t0
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
        # frames in flight: step() blocks only when more than
        # FRAMES_IN_FLIGHT launches are outstanding
        self._pacer = FramePacer()
        self._wall_start: Optional[float] = None
        self._time_base = 0.0
        # the row band a launch may take: halved by _recover_launch_failure
        # and kept across reset() (a property of the device, not of this
        # accumulation)
        if not hasattr(self, "_chunk_rows_now"):
            self._chunk_rows_now = cfg.chunk_rows
        self._accum_history: list = []  # [(sample_count, accum), ...], newest last

    def set_camera(self, camera: Camera) -> None:
        """Any camera change resets accumulation."""
        self.camera = camera.to(self.device)
        self.reset()

    def step(self) -> torch.Tensor:
        """One launch of cfg.spp_per_launch samples per pixel; returns the
        accumulation buffer. A launch that fails in a way a smaller band
        can fix (_is_launch_failure) is retried from the newest complete
        state with half the row band, up to eight times."""
        for _ in range(8):  # each retry halves the band; 8 is < any height
            try:
                return self._step_once()
            except Exception as e:  # noqa: BLE001 — filtered below
                if not _is_launch_failure(e):
                    raise
                self._recover_launch_failure(e)
        return self._step_once()

    def _step_once(self) -> torch.Tensor:
        cfg = self.config
        if self.sample_count >= cfg.max_samples:
            self._finish()
            return self.accum
        if self._wall_start is None:
            self._wall_start = time.perf_counter()
        # a concurrent reset() (a viewer's camera move) may clear
        # _wall_start mid-step; the stale time is overwritten after it
        wall_start = self._wall_start
        spp = cfg.spp_per_launch
        launch_index = self.sample_count // spp
        radiance, stats = render_sample_stats(
            self.device_scene, self.bvh, self.camera, launch_index,
            width=cfg.width, height=cfg.height, cfg=cfg, has_alpha=self.has_alpha,
            chunk_rows=self._chunk_rows_now, tex_flags=self.tex_flags)
        if debug.checks_enabled():
            debug.check_sample(radiance, self.sample_count)
        self.sample_count += spp
        self.accum = film.accumulate(self.accum, radiance, launch_index + 1)
        if self._pacer.submit(self.accum) is not None:  # the oldest frame retired
            cudalib.check_kernel_errors(self.device)
        self._accum_history.append((self.sample_count, self.accum))
        if len(self._accum_history) > 6:
            del self._accum_history[0]
        self.sample_time = self._time_base + time.perf_counter() - wall_start
        self.last_stats = stats
        self.rays = RayStats(self.rays.logical + stats.logical,
                             self.rays.physical + stats.physical)
        if self.sample_count >= cfg.max_samples:
            self._finish()
        return self.accum

    def _recover_launch_failure(self, err: Exception) -> None:
        """Roll back to the newest state of the history (every entry is
        complete: an allocation fails before its launch is queued, and
        faults that could spoil a queued launch are not retried), halve
        the row band (floor 8 rows), release the allocator's cached
        blocks, and go on. Re-raises `err` when the band is already 8."""
        cfg = self.config
        prev = self._chunk_rows_now if self._chunk_rows_now > 0 else cfg.height
        new = max(prev // 2, 8)  # 8 rows, the floor
        if new >= prev:
            raise err
        self._chunk_rows_now = new
        # the traceback holds the failed launch's frames and their tensors:
        # drop it so that empty_cache below can return their memory
        err.__traceback__ = None
        self._pacer = FramePacer()
        if self._accum_history:
            self.sample_count, self.accum = self._accum_history[-1]
        else:
            self.accum = torch.zeros((cfg.height, cfg.width, 4), dtype=torch.float32,
                                     device=self.device)
            self.sample_count = 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[tpurt_torch] launch failed ({type(err).__name__}); retrying from "
              f"sample {self.sample_count} with chunk_rows={self._chunk_rows_now}",
              file=sys.stderr)

    def drain(self) -> None:
        """Wait for every launch in flight, check the kernels' error word,
        and fold the elapsed span into the sample timer."""
        self._pacer.drain()
        cudalib.check_kernel_errors(self.device)
        if self._wall_start is not None:
            self._time_base += time.perf_counter() - self._wall_start
            self._wall_start = None
            self.sample_time = self._time_base

    def _finish(self) -> None:
        """Drain, fix the convergence time, report it once."""
        self.drain()
        if not self._converged_reported:
            print("Max. sample count reached. Time=%f s" % self.sample_time)
            self._converged_reported = True

    def render(self, spp: Optional[int] = None, progress_every: int = 0) -> torch.Tensor:
        """Accumulate up to `spp` samples in all (default:
        config.max_samples); the launches are finished and checked before
        the buffer is returned."""
        target = spp if spp is not None else self.config.max_samples
        while self.sample_count < min(target, self.config.max_samples):
            self.step()
            if progress_every and self.sample_count % progress_every == 0:
                print(f"  {self.sample_count}/{target} spp, {self.sample_time:.2f}s")
        if self.sample_count >= self.config.max_samples:
            self._finish()
        else:
            self.drain()
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
        self._accum_history = [(self.sample_count, self.accum)]
        self.camera = ck.camera(self.device)
        self._converged_reported = False

