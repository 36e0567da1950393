"""Debug and validation (the counterpart of tpurt/utils/debug.py).

- `validate_scene`: structural invariants of a DeviceScene before a
  render, with tpurt's checks and problem strings,
- `nan_report`: locate NaN/Inf pixels in a radiance buffer,
- `with_checks`: a scope in which `Renderer.step` checks every sample's
  radiance before accumulating it.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

_checks = [0]  # open with_checks scopes


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def validate_scene(scene) -> List[str]:
    """Return a list of problems (empty = valid)."""
    problems = []
    t = scene.tri_pos.shape[0]
    if scene.tri_normal.shape[0] != t or scene.tri_uv.shape[0] != t:
        problems.append("triangle attribute arrays disagree in length")
    if not np.isfinite(_np(scene.tri_pos)).all():
        problems.append("non-finite triangle positions")
    mats = _np(scene.tri_mat)
    if mats.size and (mats.min() < 0 or mats.max() >= scene.materials.roughness.shape[0]):
        problems.append("material index out of range")
    table = _np(scene.tex_table)
    ah, aw = scene.atlas.shape[:2]
    for i, row in enumerate(table):
        x, y, w, h = row[:4]
        if x < 0 or y < 0 or x + w > aw or y + h > ah:
            problems.append(f"texture {i} region outside atlas")
    lights = _np(scene.lights)
    if lights.size and (lights[:, 3] <= 0).any():
        problems.append("non-positive light radius")
    return problems


def nan_report(image) -> str:
    """Summarize NaN/Inf pixels of an (H, W, C) tensor or array."""
    arr = _np(image)
    nan_mask = ~np.isfinite(arr).all(axis=-1)
    count = int(nan_mask.sum())
    if count == 0:
        return "no non-finite pixels"
    ys, xs = np.nonzero(nan_mask)
    return (f"{count} non-finite pixels; first at (y={ys[0]}, x={xs[0]}) "
            f"value={arr[ys[0], xs[0]]}")


@contextlib.contextmanager
def with_checks():
    """Inside this scope `Renderer.step` checks each sample's radiance
    before accumulating it and raises FloatingPointError naming the
    sample and its first non-finite pixel. Coarser than tpurt's
    `jax_debug_nans`, which stops at the first operation that makes a
    NaN: this names the sample and pixel, not the operation. Costs one
    host sync per sample."""
    _checks[0] += 1
    try:
        yield
    finally:
        _checks[0] -= 1


def checks_enabled() -> bool:
    return _checks[0] > 0


def check_sample(radiance: torch.Tensor, sample_index: int) -> None:
    """Raise FloatingPointError if `radiance` (H, W, C) holds a NaN or Inf."""
    bad = ~torch.isfinite(radiance).all(dim=-1)
    if bool(bad.any()):
        raise FloatingPointError(f"sample {sample_index}: {nan_report(radiance)}")
