"""Film: progressive accumulation, NaN guard, tonemap, PNG output, RMSE
(the counterpart of tpurt/film.py; checkpoints come in a later slice)."""

from __future__ import annotations

import numpy as np
import torch

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


def rmse(a, b) -> float:
    """Per-pixel RMSE between two images."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
