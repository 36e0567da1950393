"""Film: progressive accumulation, NaN guard, tonemap, PNG output,
checkpoints, RMSE (the counterpart of tpurt/film.py). A checkpoint is
tpurt's `.npz` with the same keys and dtypes, so either package resumes
the other's."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch.camera import Camera
from tpurt_torch.utils import png


def accumulate(prev: torch.Tensor, new: torch.Tensor, sample_count) -> torch.Tensor:
    """One progressive-accumulation step: the running average
    prev*(1-1/N) + new*(1/N) once N > 1, and NaN pixels painted red.
    `sample_count` includes this launch."""
    count = np.float32(sample_count)
    inv = float(np.float32(1.0) / count)
    if count > 1.0:
        blended = prev * float(np.float32(1.0) - np.float32(inv)) + new * inv
    else:
        blended = new.clone()
    nan_mask = torch.isnan(blended).any(dim=-1, keepdim=True)
    red = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=blended.dtype,
                       device=blended.device)
    return torch.where(nan_mask, red, blended)


def tonemap(accum: torch.Tensor, exposure) -> torch.Tensor:
    """Exposure tonemap `1 - exp(-x * exposure)`, clip, gamma 1/2.2."""
    mapped = 1.0 - torch.exp(-accum * float(np.float32(exposure)))
    mapped = torch.clamp(mapped, 0.0, 1.0)
    return torch.pow(mapped, float(np.float32(1.0 / 2.2)))


def to_srgb8(mapped) -> np.ndarray:
    """Tone-mapped float image -> uint8."""
    arr = mapped.detach().cpu().numpy() if isinstance(mapped, torch.Tensor) else np.asarray(mapped)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, mapped) -> None:
    """Write a tone-mapped (H, W, 3|4) float image as an RGB PNG."""
    arr = to_srgb8(mapped)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    png.write_png(path, arr)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class Checkpoint:
    """Resumable progressive-render state: the accumulation buffer plus
    everything needed to continue sampling deterministically."""

    accum: np.ndarray          # (H, W, 4) float32
    sample_count: int
    seed: int
    camera_position: np.ndarray
    camera_direction: np.ndarray
    camera_right: np.ndarray
    # samples per launch while accumulating; the running average is per
    # launch, so resuming with another value would mis-weight it (0 =
    # unknown, a checkpoint from before tpurt wrote the key)
    spp_per_launch: int = 0

    def camera(self, device="cpu") -> Camera:
        return Camera(*(torch.as_tensor(np.asarray(x, np.float32)).to(device)
                        for x in (self.camera_position, self.camera_direction,
                                  self.camera_right)))


def save_checkpoint(path: str, accum, sample_count: int, seed: int, camera: Camera,
                    spp_per_launch: int = 0) -> None:
    np.savez(
        path,
        accum=_np(accum).astype(np.float32, copy=False),
        sample_count=np.int64(sample_count),
        seed=np.int64(seed),
        spp_per_launch=np.int64(spp_per_launch),
        camera_position=_np(camera.position).astype(np.float32, copy=False),
        camera_direction=_np(camera.direction).astype(np.float32, copy=False),
        camera_right=_np(camera.right).astype(np.float32, copy=False),
    )


def load_checkpoint(path: str) -> Checkpoint:
    data = np.load(path)
    return Checkpoint(
        accum=data["accum"],
        sample_count=int(data["sample_count"]),
        seed=int(data["seed"]),
        spp_per_launch=int(data["spp_per_launch"]) if "spp_per_launch" in data else 0,
        camera_position=data["camera_position"],
        camera_direction=data["camera_direction"],
        camera_right=data["camera_right"],
    )


def rmse(a, b) -> float:
    """Per-pixel RMSE between two images."""
    a = _np(a).astype(np.float64)
    b = _np(b).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
