"""Pinhole camera with frustum-corner ray generation, and the scripted
orbit and fly-through paths (the counterpart of tpurt/camera.py). The
arithmetic is written in tpurt's order, one elementwise operation at a
time, so the CPU rays equal tpurt's to the last bit wherever both
libraries round the same IEEE operations."""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tpurt_torch import rng
from tpurt_torch.kernels.bsdf import _cross, _norm, recip32


class Camera(NamedTuple):
    """World-space camera basis: position, unit direction, unit right."""

    position: torch.Tensor   # (3,) f32
    direction: torch.Tensor  # (3,) f32
    right: torch.Tensor      # (3,) f32

    @property
    def up(self) -> torch.Tensor:
        return _cross(self.direction, self.right)

    def to(self, device) -> "Camera":
        return Camera(*(x.to(device) for x in self))

    @staticmethod
    def default() -> "Camera":
        return Camera(
            position=torch.tensor([-2.0, 0.0, 1.0], dtype=torch.float32),
            direction=torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32),
            right=torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32),
        )

    @staticmethod
    def from_angles(position: Sequence[float], phi: float, theta: float) -> "Camera":
        """Spherical-angle camera (phi = yaw, theta = pitch)."""
        direction = np.array(
            [math.cos(theta) * math.sin(phi), math.sin(theta), math.cos(theta) * math.cos(phi)],
            dtype=np.float32,
        )
        right = np.array(
            [math.sin(phi - math.pi * 0.5), 0.0, math.cos(phi - math.pi * 0.5)],
            dtype=np.float32,
        )
        return Camera(
            position=torch.as_tensor(np.asarray(position, np.float32)),
            direction=torch.from_numpy(direction),
            right=torch.from_numpy(right),
        )

    def moved(self, forward: float = 0.0, rightward: float = 0.0, upward: float = 0.0) -> "Camera":
        """Fly-style translation along the camera basis (tpurt's order of
        f32 operations)."""
        pos = (self.position + forward * self.direction + rightward * self.right
               + upward * self.up)
        return self._replace(position=pos)


def _frustum_rays(camera: Camera, pix: torch.Tensor, jx, jy, width: int,
                  height: int, tan_half_fov) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one ray-generation formula (tpurt/camera.py::_frustum_rays):
    jitter in [-0.5, 0.5]^2, then frustum-corner interpolation."""
    px_i = (pix % width).to(torch.float32)
    py_i = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    # tpurt divides by the image size; its compiled program multiplies by
    # the float32 reciprocal (recip32)
    point_x = (px_i + jx - 0.5) * recip32(width) - 0.5
    point_y = (py_i + jy - 0.5) * recip32(height) - 0.5
    aspect = np.float32(width / height)
    t = np.float32(tan_half_fov)
    sx = float(np.float32(2.0) * t * aspect)
    sy = float(np.float32(2.0) * t)
    cam = camera.to(pix.device)
    d = (
        cam.direction[None, :]
        + point_x[:, None] * sx * cam.right[None, :]
        + point_y[:, None] * sy * cam.up[None, :]
    )
    d = d / _norm(d)[:, None]
    o = cam.position[None, :].expand(pix.shape[0], 3)
    return o, d


def generate_rays(camera: Camera, width: int, height: int, tan_half_fov: float,
                  state: torch.Tensor):
    """One jittered primary ray per pixel from caller-provided RNG states
    (row-major pixel order). Returns (origins, directions, new state)."""
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=state.device)
    state, jx, jy = rng.next_uniform2(state)
    o, d = _frustum_rays(camera, pix, jx, jy, width, height, tan_half_fov)
    return o, d, state


def camera_rays_for_rows(camera: Camera, row_start: int, rows: int, width: int,
                         height: int, tan_half_fov, sample_index: int, seed: int,
                         spp: int = 1, device="cuda"):
    """Jittered primary rays for a band of image rows; with spp > 1 the
    batch holds `spp` replicas of the band at sample indices
    sample_index * spp + j. Returns (origins, directions, rng state)."""
    n = rows * width
    pix = torch.arange(n, dtype=torch.int64, device=device) + int(row_start) * width
    if spp > 1:
        pix = pix.repeat(spp)
        sample_vec = torch.repeat_interleave(
            (int(sample_index) * spp + torch.arange(spp, dtype=torch.int64,
                                                     device=device)) & rng._MASK, n)
    else:
        sample_vec = int(sample_index)
    state = rng.init_state(pix, sample_vec, seed)
    state, jx = rng.next_rand(state)
    state, jy = rng.next_rand(state)
    o, d = _frustum_rays(camera, pix, jx, jy, width, height, tan_half_fov)
    return o, d, state


def orbit_path(center: Sequence[float], radius: float, height: float, num_frames: int):
    """Scripted orbit: one Camera (on the CPU) per frame, circling
    `center` at `radius`, `height` above it, looking at it."""
    cams = []
    for i in range(num_frames):
        ang = 2.0 * math.pi * i / max(num_frames, 1)
        pos = np.array(
            [
                center[0] + radius * math.sin(ang),
                center[1] + height,
                center[2] + radius * math.cos(ang),
            ],
            dtype=np.float32,
        )
        look = np.asarray(center, dtype=np.float32) - pos
        look /= np.linalg.norm(look)
        phi = math.atan2(look[0], look[2])
        theta = math.asin(np.clip(look[1], -1.0, 1.0))
        cams.append(Camera.from_angles(pos, phi, theta))
    return cams


def fly_path(waypoints: Sequence[Sequence[float]], look_at: Sequence[float],
             frames_per_leg: int):
    """Piecewise-linear fly-through between waypoints, `frames_per_leg`
    Cameras (on the CPU) per leg, always looking at `look_at`."""
    cams = []
    target = np.asarray(look_at, dtype=np.float32)
    for a, b in zip(waypoints[:-1], waypoints[1:]):
        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        for i in range(frames_per_leg):
            pos = a + (b - a) * (i / max(frames_per_leg, 1))
            look = target - pos
            look /= np.linalg.norm(look)
            phi = math.atan2(look[0], look[2])
            theta = math.asin(np.clip(look[1], -1.0, 1.0))
            cams.append(Camera.from_angles(pos, phi, theta))
    return cams
