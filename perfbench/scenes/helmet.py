"""The Damaged-Helmet stand-in: the repository's helmet-like writer (a UV
sphere with tangents and a normal-mapped metallic-roughness material) at
the published asset's counts: 46,356 triangles (the sphere's, less as
many of its degenerate pole triangles as it has over that) and five
2048x2048 textures (base colour, metallic-roughness, normal, emissive
and an occlusion map, which the renderer loads and never samples) with
the published material factors (metallic 1, roughness 1, emissive 1)
and a declared sampler, as the asset has. The texture contents are made
from `seed`: panels with grooves over smooth noise, a height field
behind the normal map and the occlusion map, and glowing strips in the
emissive map. No alpha test."""

from __future__ import annotations

import numpy as np

from perfbench.scenes.gltf_writer import GLTFBuilder, uv_sphere


def _smooth(rng, size, cells, channels):
    """Noise in [0, 1): a (cells+1)^2 random grid, bilinearly upsampled."""
    grid = rng.rand(cells + 1, cells + 1, channels)
    x = np.linspace(0.0, cells, size, endpoint=False)
    i = x.astype(np.int64)
    f = (x - i)[:, None]
    rows = grid[i] * (1 - f[:, :, None]) + grid[i + 1] * f[:, :, None]
    return rows[:, i] * (1 - f[None, :, :]) + rows[:, i + 1] * f[None, :, :]


def _textures(size, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    panel = size // 8
    groove = ((xx % panel) < size // 256) | ((yy % panel) < size // 256)
    n1 = _smooth(rng, size, 32, 3)
    paint = _smooth(rng, size, 8, 3)
    albedo = np.empty((size, size, 4), np.uint8)
    base = 0.35 + 0.3 * n1 + 0.25 * (paint > 0.6)
    base[groove] *= 0.35
    albedo[..., :3] = np.clip(base * 255, 0, 255)
    albedo[..., 3] = 255
    n2 = _smooth(rng, size, 16, 2)
    mr = np.empty((size, size, 4), np.uint8)
    mr[..., 0] = 255
    mr[..., 1] = np.clip((0.2 + 0.65 * n2[..., 0]) * 255, 0, 255)
    mr[..., 2] = np.where(n2[..., 1] > 0.45, 230, 30)
    mr[..., 3] = 255
    height = _smooth(rng, size, 64, 1)[..., 0] * 2.0 - 1.5 * groove
    gy, gx = np.gradient(height)
    nrm = np.stack([-gx * 8.0, -gy * 8.0, np.ones_like(gx)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = np.empty((size, size, 4), np.uint8)
    normal[..., :3] = np.clip((nrm * 0.5 + 0.5) * 255 + 0.5, 0, 255)
    normal[..., 3] = 255
    n3 = _smooth(rng, size, 16, 1)[..., 0]
    strip = (np.abs(yy - size * 0.45) < size * 0.03) & (n3 > 0.5)
    emissive = np.zeros((size, size, 4), np.uint8)
    emissive[strip, :3] = [255, 170, 80]
    emissive[..., 3] = 255
    occlusion = np.empty((size, size, 4), np.uint8)
    occlusion[..., :3] = np.clip((0.75 + 0.1 * height - 0.4 * groove) * 255, 0, 255)[..., None]
    occlusion[..., 3] = 255
    return albedo, mr, normal, emissive, occlusion


def build(segments=168, rings=138, radius=0.95, texture_size=2048, triangles=46356,
          seed=7) -> GLTFBuilder:
    b = GLTFBuilder()
    p, n, uv, idx = uv_sphere(segments, rings, radius)
    if triangles:
        # drop degenerate triangles of the top pole row (every other one of
        # its first 2 * segments), which no ray can hit
        extra = idx.size // 3 - triangles
        if not 0 <= extra <= segments:
            raise ValueError(f"{triangles} triangles from a {segments}x{rings} sphere")
        keep = np.ones(idx.size // 3, bool)
        keep[0:2 * extra:2] = False
        idx = idx.reshape(-1, 3)[keep].reshape(-1)
    tangents = np.zeros((p.shape[0], 4), np.float32)
    phi = 2 * np.pi * uv[:, 0]
    tangents[:, 0] = -np.sin(phi + np.pi / 2)
    tangents[:, 2] = np.cos(phi + np.pi / 2)
    tangents[:, 3] = 1.0
    sampler = {"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}
    t_alb, t_mr, t_n, t_e, t_o = (b.add_texture(img, sampler=dict(sampler))
                                  for img in _textures(texture_size, seed))
    mat = b.add_material(base_color=(1, 1, 1, 1), metallic=1.0, roughness=1.0,
                         emissive=(1.0, 1.0, 1.0), base_color_texture=t_alb,
                         mr_texture=t_mr, normal_texture=t_n, emissive_texture=t_e,
                         occlusion_texture=t_o)
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, tangents=tangents, material=mat))
    b.add_node(camera=b.add_camera(), translation=[0.0, 0.0, -3.0])
    return b
