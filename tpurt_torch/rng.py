"""Counter-based per-ray RNG (the counterpart of tpurt/rng.py).

tpurt keeps a uint32 state per ray. PyTorch's CPU build implements
neither `+` nor `>>` on uint32, so the state lives in int64 holding a
value in [0, 2^32), and every step masks with 0xFFFFFFFF. The products
stay below 2^62, so no step overflows int64, and the streams are
bit-equal to tpurt's.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
# exact 2^-32 and the largest float32 below 1 (see tpurt/rng.py)
_INV_2_32 = 2.3283064365386963e-10
_ONE_MINUS_EPS = 1.0 - 2.0 ** -24


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def pcg_hash(x) -> torch.Tensor:
    """PCG-RXS-M-XS output permutation over an LCG step (u32 -> u32)."""
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def init_state(pixel_index, sample_index, seed=0) -> torch.Tensor:
    """Per-ray stream from (pixel, sample, seed), as tpurt.rng.init_state."""
    dev = pixel_index.device if isinstance(pixel_index, torch.Tensor) else None
    h = pcg_hash(_u32(seed, dev))
    h = pcg_hash(h ^ _u32(sample_index, dev))
    return pcg_hash(h ^ _u32(pixel_index, dev))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> float32 uniform in [0, 1)."""
    return torch.clamp(bits.to(torch.float32) * _INV_2_32, max=_ONE_MINUS_EPS)


def next_rand(state: torch.Tensor):
    """Advance one step. Returns (new_state, uniform in [0,1))."""
    new_state = pcg_hash(state)
    return new_state, uniform_from_bits(new_state)


def next_uniform2(state: torch.Tensor):
    """Two consecutive uniforms."""
    state, u1 = next_rand(state)
    state, u2 = next_rand(state)
    return state, u1, u2
