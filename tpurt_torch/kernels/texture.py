"""Texture sampling from the packed atlases (the counterpart of
tpurt/kernels/texture.py): wrap modes, NEAREST/bilinear filtering at lod
0, sRGB decode, and the one-row quad-atlas fetch."""

from __future__ import annotations

import torch

from tpurt_torch.kernels.bsdf import recip32
from tpurt_torch.scene.types import FILTER_LINEAR, WRAP_MIRRORED_REPEAT, WRAP_REPEAT


def srgb_to_linear(c):
    """Piecewise sRGB EOTF."""
    return torch.where(c <= 0.04045, c * recip32(12.92),
                       torch.pow((c + 0.055) * recip32(1.055), 2.4))


def _wrap(i, size, mode):
    """Integer texel wrap: i, size, mode are (N,) int tensors."""
    size = torch.clamp(size, min=1)
    rep = torch.remainder(i, size)
    period = 2 * size
    m = torch.remainder(i, period)
    mir = torch.where(m < size, m, period - 1 - m)
    clamped = torch.minimum(torch.clamp(i, min=0), size - 1)
    return torch.where(mode == WRAP_REPEAT, rep,
                       torch.where(mode == WRAP_MIRRORED_REPEAT, mir, clamped))


def _wrap_f32(x, size, mode):
    """Texel wrap on integer-valued f32 coordinates (exact for |x| < 2^24),
    the float floor-division form tpurt uses."""
    r = x - torch.floor(x / size) * size
    r = torch.where(r < 0, r + size, torch.where(r >= size, r - size, r))
    period = 2.0 * size
    m = x - torch.floor(x / period) * period
    m = torch.where(m < 0, m + period, torch.where(m >= period, m - period, m))
    mir = torch.where(m < size, m, period - 1.0 - m)
    clamped = torch.minimum(torch.clamp(x, min=0.0), size - 1.0)
    return torch.where(mode == WRAP_REPEAT, r,
                       torch.where(mode == WRAP_MIRRORED_REPEAT, mir, clamped))


def _bilinear(x, y, filt):
    x = torch.where(filt == FILTER_LINEAR, x - 0.5, torch.floor(x))
    y = torch.where(filt == FILTER_LINEAR, y - 0.5, torch.floor(y))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0, y0, (x - x0)[:, None], (y - y0)[:, None]


def _blend(c00, c10, c01, c11, fx, fy, srgb):
    out = (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
           + c01 * (1 - fx) * fy + c11 * fx * fy)
    rgb = torch.where((srgb > 0)[:, None], srgb_to_linear(out[:, :3]), out[:, :3])
    return torch.cat([rgb, out[:, 3:4]], dim=-1)


def sample_texture(atlas, tex_table, tex_id, u, v):
    """Four-tap reference sampler over the RGBA8 atlas. Returns (N, 4)
    linear texels (alpha always linear)."""
    nt = tex_table.shape[0]
    row = tex_table[torch.clamp(tex_id, 0, nt - 1).long()]
    ax, ay = row[:, 0], row[:, 1]
    w, h = row[:, 2], row[:, 3]
    wrap_s, wrap_t = row[:, 4], row[:, 5]
    x0, y0, fx, fy = _bilinear(u * w.to(torch.float32), v * h.to(torch.float32), row[:, 6])
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    ah, aw = atlas.shape[0], atlas.shape[1]
    flat = atlas.reshape(-1, 4)

    def fetch(xi, yi):
        xw = _wrap(xi, w, wrap_s) + ax
        yw = _wrap(yi, h, wrap_t) + ay
        idx = torch.clamp(yw * aw + xw, 0, ah * aw - 1).long()
        return flat[idx].to(torch.float32) * (1.0 / 255.0)

    return _blend(fetch(x0, y0), fetch(x0 + 1, y0), fetch(x0, y0 + 1),
                  fetch(x0 + 1, y0 + 1), fx, fy, row[:, 7])


def sample_texture_quad(atlas_quad, tex_table, tex_id, u, v):
    """One quad-row gather per sample: the quad atlas holds each texel's
    2x2 footprint [c00 c10 c01 c11] (see scene/device.py)."""
    nt = tex_table.shape[0]
    row = tex_table[torch.clamp(tex_id, 0, nt - 1).long()]
    w, h = row[:, 2], row[:, 3]
    wrap_s, wrap_t = row[:, 4], row[:, 5]
    qx, qy = row[:, 8], row[:, 9]
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x0, y0, fx, fy = _bilinear(u * wf, v * hf, row[:, 6])
    qh, qw = atlas_quad.shape[0], atlas_quad.shape[1]
    xw = _wrap_f32(x0, torch.clamp(wf, min=1.0), wrap_s).to(torch.int32) + qx
    yw = _wrap_f32(y0, torch.clamp(hf, min=1.0), wrap_t).to(torch.int32) + qy
    idx = torch.clamp(yw * qw + xw, 0, qh * qw - 1).long()
    q = atlas_quad.reshape(-1, 16)[idx].to(torch.float32) * (1.0 / 255.0)
    return _blend(q[:, 0:4], q[:, 4:8], q[:, 8:12], q[:, 12:16], fx, fy, row[:, 7])


def sample_texture_alpha_quad(atlas_quad, tex_table, tex_id, u, v):
    """Alpha channel, single NEAREST tap (the quad row's c00 texel)."""
    nt = tex_table.shape[0]
    row = tex_table[torch.clamp(tex_id, 0, nt - 1).long()]
    w, h = row[:, 2], row[:, 3]
    wrap_s, wrap_t = row[:, 4], row[:, 5]
    qx, qy = row[:, 8], row[:, 9]
    wf = torch.clamp(w.to(torch.float32), min=1.0)
    hf = torch.clamp(h.to(torch.float32), min=1.0)
    x0 = torch.floor(u * wf)
    y0 = torch.floor(v * hf)
    qh, qw = atlas_quad.shape[0], atlas_quad.shape[1]
    xw = _wrap_f32(x0, wf, wrap_s).to(torch.int32) + qx
    yw = _wrap_f32(y0, hf, wrap_t).to(torch.int32) + qy
    idx = torch.clamp(yw * qw + xw, 0, qh * qw - 1).long()
    return atlas_quad.reshape(-1, 16)[idx, 3].to(torch.float32) * (1.0 / 255.0)
