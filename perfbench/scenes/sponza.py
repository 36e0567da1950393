"""The Sponza interior at the published asset's counts: 262,267 triangles,
25 materials and 69 texture images of 1024x1024 (a base colour and a
normal map for every material, a metallic-roughness map for 19), three
of the materials alpha-MASK (leaves, vase plants, chains).

The meshes are stand-ins for the Crytek meshes, laid out as an atrium
of 30 x 20 x 8 units: floor, ceiling and brick walls; two rows of
columns of stacked UV spheres (three column materials); lintels and
balustrades over them; fourteen drapes in six fabrics; floor vases with
plants, hanging vases on chains; lion heads, background panels, roof
beams and flagpoles; ivy of single leaf quads on the walls and the
lintels; and a moulding strip along the walls that takes whatever
triangles are left, so the total is exact. Leaf, plant and chain quads
each map their texture once (uv in [0, 1]) and lie in thin layers, so a
ray crosses a few of them at most. Poses of the ivy and plant leaves
are drawn from `seed`.

The texture contents are blocky patterns (an eighth of the resolution,
each texel repeated 8x8) over per-material tints: bricks, stone, fabric
stripes, leaves and chain links with alpha holes. Every texture declares
a REPEAT sampler.

Geometry built here in glTF space (y up, the floor at 0, the ceiling at
8) sits in nodes whose rotation the loader reads as the identity.
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes.gltf_writer import (GLTFBuilder, box_mesh, quad_mesh, quirk_rotation,
                                         uv_sphere)

# the node rotation that the loader's positional read turns into the identity
IDENTITY = [0.0, 0.0, 0.0, -1.0]
SAMPLER = {"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}

# (role, tint, roughness, metallic, pattern, has metallic-roughness map);
# the alpha-MASK roles are last
MATERIALS = [
    ("floor", (0.62, 0.58, 0.52), 0.8, 0.0, "stone", True),
    ("ceiling", (0.70, 0.66, 0.60), 0.9, 0.0, "stone", True),
    ("bricks", (0.66, 0.50, 0.40), 0.9, 0.0, "bricks", True),
    ("arch", (0.72, 0.66, 0.58), 0.8, 0.0, "stone", True),
    ("column_a", (0.75, 0.70, 0.65), 0.5, 0.1, "stone", True),
    ("column_b", (0.70, 0.68, 0.62), 0.5, 0.1, "stone", True),
    ("column_c", (0.78, 0.72, 0.64), 0.5, 0.1, "stone", True),
    ("details", (0.68, 0.64, 0.58), 0.7, 0.0, "bricks", True),
    ("flagpole", (0.45, 0.40, 0.35), 0.4, 0.8, "stone", True),
    ("vase_hanging", (0.60, 0.45, 0.30), 0.6, 0.2, "stone", True),
    ("vase", (0.65, 0.50, 0.35), 0.6, 0.0, "stone", True),
    ("vase_round", (0.55, 0.48, 0.40), 0.6, 0.0, "stone", True),
    ("lion", (0.70, 0.66, 0.60), 0.7, 0.0, "stone", True),
    ("background", (0.50, 0.48, 0.45), 0.9, 0.0, "bricks", True),
    ("roof", (0.45, 0.35, 0.30), 0.8, 0.0, "bricks", True),
    ("moulding", (0.72, 0.68, 0.62), 0.7, 0.0, "stone", True),
    ("fabric_a", (0.70, 0.15, 0.12), 0.9, 0.0, "fabric", True),
    ("fabric_c", (0.15, 0.45, 0.20), 0.9, 0.0, "fabric", True),
    ("fabric_d", (0.20, 0.25, 0.65), 0.9, 0.0, "fabric", True),
    ("fabric_e", (0.75, 0.60, 0.15), 0.9, 0.0, "fabric", False),
    ("fabric_f", (0.55, 0.20, 0.50), 0.9, 0.0, "fabric", False),
    ("fabric_g", (0.80, 0.78, 0.70), 0.9, 0.0, "fabric", False),
    ("chain", (0.35, 0.33, 0.30), 0.4, 0.9, "chain", False),
    ("leaf", (0.20, 0.50, 0.18), 1.0, 0.0, "leaf", False),
    ("plant", (0.25, 0.55, 0.22), 1.0, 0.0, "plant", False),
]
ALPHA_ROLES = ("chain", "leaf", "plant")
FABRICS = [m[0] for m in MATERIALS if m[0].startswith("fabric")]


# ---- textures ------------------------------------------------------------------------

def _blocky(rng, detail, cells):
    """Smooth noise in [0, 1) at `detail` x `detail`: a random grid of
    `cells` + 1 points, bilinearly upsampled."""
    grid = rng.rand(cells + 1, cells + 1)
    x = np.linspace(0.0, cells, detail, endpoint=False)
    i = x.astype(np.int64)
    f = x - i
    rows = grid[i] * (1 - f[:, None]) + grid[i + 1] * f[:, None]
    return rows[:, i] * (1 - f[None, :]) + rows[:, i + 1] * f[None, :]


def _pattern(kind, rng, detail):
    """(height in [0, 1], alpha mask or None) at detail x detail."""
    yy, xx = np.mgrid[0:detail, 0:detail] / float(detail)
    noise = _blocky(rng, detail, 8)
    if kind == "bricks":
        row = np.floor(yy * 8)
        mortar = ((yy * 8) % 1 < 0.08) | (((xx * 4) + 0.5 * (row % 2)) % 1 < 0.04)
        return np.where(mortar, 0.1, 0.6 + 0.4 * noise), None
    if kind == "fabric":
        return 0.5 + 0.3 * (np.sin(xx * 2 * np.pi * 24) > 0) + 0.2 * noise, None
    if kind == "stone":
        return 0.4 + 0.6 * noise, None
    u, v = xx - 0.5, yy - 0.5
    if kind == "leaf":
        alpha = (u ** 2 / 0.16 + v ** 2 / 0.07) < 1.0
    elif kind == "plant":
        alpha = (np.abs(u) < 0.12 + 0.25 * (0.5 - np.abs(v))) & (np.abs(v) < 0.48)
    else:  # chain links: rings down the middle
        r = np.hypot(u * 2.5, ((yy * 4) % 1) - 0.5)
        alpha = (r > 0.25) & (r < 0.45)
    return 0.5 + 0.5 * noise, alpha


def _images(kind, tint, has_mr, rng, size):
    """(base colour, normal, metallic-roughness or None), RGBA8 at size x size."""
    cell = max(1, size // 128)
    detail = size // cell
    height, alpha = _pattern(kind, rng, detail)

    def up(a):
        return np.repeat(np.repeat(a, cell, axis=0), cell, axis=1)

    base = np.empty((detail, detail, 4), np.uint8)
    base[..., :3] = np.clip(np.asarray(tint)[None, None, :] * (0.5 + 0.5 * height[..., None])
                            * 255, 0, 255)
    base[..., 3] = 255 if alpha is None else np.where(alpha, 255, 0)
    gy, gx = np.gradient(height * 4.0)
    nrm = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = np.empty((detail, detail, 4), np.uint8)
    normal[..., :3] = np.clip((nrm * 0.5 + 0.5) * 255 + 0.5, 0, 255)
    normal[..., 3] = 255
    mr = None
    if has_mr:
        mr = np.empty((detail, detail, 4), np.uint8)
        mr[..., 0] = 255
        mr[..., 1] = np.clip((0.4 + 0.5 * height) * 255, 0, 255)
        mr[..., 2] = np.clip(height * 80, 0, 255)
        mr[..., 3] = 255
        mr = up(mr)
    return up(base), up(normal), mr


# ---- meshes in glTF space ---------------------------------------------------------------

def _quads(corners):
    """Independent quads (N, 4, 3), each mapping uv [0, 1]^2."""
    corners = np.asarray(corners, np.float32).reshape(-1, 4, 3)
    n = corners.shape[0]
    nrm = np.cross(corners[:, 1] - corners[:, 0], corners[:, 3] - corners[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    uv = np.tile(np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32), (n, 1))
    idx = (np.arange(n)[:, None] * 4 + np.array([0, 1, 2, 0, 2, 3])[None, :]).reshape(-1)
    return (corners.reshape(-1, 3), np.repeat(nrm, 4, axis=0).astype(np.float32), uv,
            idx.astype(np.uint32))


def _grid(origin, axis_u, axis_v, nu, nv, bulge=(0.0, 0.0, 0.0), waves=0.0):
    """A sheet of nu x nv quads (2 nu nv triangles) with shared vertices,
    displaced along `bulge` by sin(waves * 2 pi u), uv over the sheet."""
    u = np.linspace(0.0, 1.0, nu + 1)
    v = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(u, v)
    o, a, b, w = (np.asarray(x, np.float64) for x in (origin, axis_u, axis_v, bulge))
    pos = (o + uu[..., None] * a + vv[..., None] * b
           + np.sin(waves * 2 * np.pi * uu)[..., None] * w).reshape(-1, 3)
    n = np.cross(a, b)
    n = np.tile(n / np.linalg.norm(n), (pos.shape[0], 1))
    uv = np.stack([uu, vv], axis=-1).reshape(-1, 2)
    i0 = (np.arange(nv)[:, None] * (nu + 1) + np.arange(nu)[None, :]).reshape(-1)
    idx = np.stack([i0, i0 + 1, i0 + nu + 2, i0, i0 + nu + 2, i0 + nu + 1], -1).reshape(-1)
    return (pos.astype(np.float32), n.astype(np.float32), uv.astype(np.float32),
            idx.astype(np.uint32))


def _leaves(rng, center, axis_u, axis_v, size):
    """Leaf quads of `size` over the rectangle center +- axis_u/2 +-
    axis_v/2, one to each cell of a grid of pitch size / 1.25, set off
    from the cell's centre by up to a quarter pitch and turned about the
    sheet's normal. Leaves that can overlap (cells up to two apart) lie
    at different depths, 0.01 apart (nine levels by cell index mod 3),
    so no two surfaces a ray meets are nearer than that."""
    a, b = np.asarray(axis_u, np.float64), np.asarray(axis_v, np.float64)
    n = np.cross(a, b)
    n /= np.linalg.norm(n)
    ea, eb = a / np.linalg.norm(a), b / np.linalg.norm(b)
    pitch = size / 1.25
    nu, nv = max(int(np.linalg.norm(a) / pitch), 1), max(int(np.linalg.norm(b) / pitch), 1)
    i, j = (x.reshape(-1, 1) for x in np.meshgrid(np.arange(nu), np.arange(nv)))
    ju, jv = rng.uniform(-0.25, 0.25, (2, i.shape[0], 1))
    depth = ((i % 3) + 3 * (j % 3) - 4) * 0.01
    c = (np.asarray(center, np.float64) - a / 2 - b / 2 + (i + 0.5 + ju) * pitch * ea
         + (j + 0.5 + jv) * pitch * eb + depth * n)
    ang = rng.uniform(0, 2 * np.pi, (i.shape[0], 1))
    du = (np.cos(ang) * ea + np.sin(ang) * eb) * size / 2
    dv = (-np.sin(ang) * ea + np.cos(ang) * eb) * size / 2
    return np.stack([c - du - dv, c + du - dv, c + du + dv, c - du + dv], axis=1)


def _plant(rng, base, count, height):
    """A vase plant: `count` blades standing about a vertical axis."""
    yaw = rng.uniform(0, np.pi, count)
    tilt = rng.uniform(-0.35, 0.35, count)
    w = height * 0.35
    out = []
    for a, t in zip(yaw, tilt):
        side = np.array([np.cos(a), 0.0, np.sin(a)]) * w / 2
        up = np.array([np.sin(t) * np.sin(a), np.cos(t), -np.sin(t) * np.cos(a)]) * height
        b = np.asarray(base, np.float64)
        out.append([b - side, b + side, b + side + up, b - side + up])
    return np.asarray(out)


def _trim(mesh, triangles):
    """The first `triangles` triangles of a mesh."""
    p, n, uv, idx = mesh
    return p, n, uv, idx[: 3 * triangles]


def _count(b: GLTFBuilder) -> int:
    return sum(b._mesh_data[node["mesh"]][3].size // 3 for node in b.nodes if "mesh" in node)


def build(columns=12, stacks=8, segments=28, rings=20, drapes=14, drape=(24, 16), leaf=0.3,
          plant_blades=12, texture_size=1024, triangles=262267, seed=3) -> GLTFBuilder:
    rng = np.random.RandomState(seed)
    b = GLTFBuilder()
    mat = {}
    for role, tint, rough, metal, kind, has_mr in MATERIALS:
        base, normal, mr = _images(kind, tint, has_mr, rng, texture_size)
        t_base = b.add_texture(base, sampler=dict(SAMPLER))
        t_nrm = b.add_texture(normal, sampler=dict(SAMPLER))
        t_mr = b.add_texture(mr, sampler=dict(SAMPLER)) if mr is not None else None
        mask = role in ALPHA_ROLES
        mat[role] = b.add_material(base_color=(1, 1, 1, 1), roughness=rough, metallic=metal,
                                   base_color_texture=t_base, normal_texture=t_nrm,
                                   mr_texture=t_mr, alpha_mode="MASK" if mask else "OPAQUE",
                                   alpha_cutoff=0.5 if mask else None)

    def world(mesh, role):
        b.add_node(mesh=b.add_mesh(*mesh, material=mat[role]), rotation=IDENTITY)

    qp, qn, quv, qidx = quad_mesh()
    box = box_mesh()
    floor = b.add_mesh(qp, qn, quv * 8.0, qidx, material=mat["floor"])
    ceiling = b.add_mesh(qp, qn, quv * 8.0, qidx, material=mat["ceiling"])
    b.add_node(mesh=floor, rotation=quirk_rotation(-0.7071068, 0, 0, 0.7071068),
               scale=[30, 20, 1])
    b.add_node(mesh=ceiling, rotation=quirk_rotation(0.7071068, 0, 0, 0.7071068),
               translation=[0, 8, 0], scale=[30, 20, 1])
    boxes = {role: b.add_mesh(*box, material=mat[role])
             for role in ("bricks", "arch", "details", "roof", "flagpole")}
    for t, s in (([0, 4, -10], [30, 8, 0.5]), ([0, 4, 10], [30, 8, 0.5]),
                 ([-15, 4, 0], [0.5, 8, 20]), ([15, 4, 0], [0.5, 8, 20])):
        b.add_node(mesh=boxes["bricks"], translation=t, scale=s)

    # two rows of columns of stacked spheres, lintels and balustrades between them
    sphere = uv_sphere(segments, rings, 0.5)
    col = [b.add_mesh(*sphere, material=mat[r]) for r in ("column_a", "column_b", "column_c")]
    xs = [-12 + 24 * i / max(columns - 1, 1) for i in range(columns)]
    for i, x in enumerate(xs):
        for z in (-6.0, 6.0):
            for y in range(stacks):
                b.add_node(mesh=col[i % 3], translation=[x, 0.5 + y * 7.0 / stacks, z])
    gaps = [(x0 + x1) / 2 for x0, x1 in zip(xs, xs[1:])]
    span = (xs[1] - xs[0]) if len(xs) > 1 else 2.0
    for x in gaps:
        for z in (-6.0, 6.0):
            b.add_node(mesh=boxes["arch"], translation=[x, 4.0, z], scale=[span, 0.4, 0.6])
            b.add_node(mesh=boxes["details"], translation=[x, 4.6, z * 1.05],
                       scale=[span, 0.8, 0.15])
    for t, s in (([0, 7.8, -9.5], [30, 0.4, 0.6]), ([0, 7.8, 9.5], [30, 0.4, 0.6]),
                 ([-14.5, 7.8, 0], [0.6, 0.4, 20]), ([14.5, 7.8, 0], [0.6, 0.4, 20])):
        b.add_node(mesh=boxes["roof"], translation=t, scale=s)
    for k in range(8):
        x = -10.5 + 3 * k
        b.add_node(mesh=boxes["flagpole"], translation=[x, 6.5, -9.2 if k % 2 else 9.2],
                   scale=[0.08, 0.08, 1.2])

    # drapes between the upper columns, lion heads and background panels
    for k in range(drapes):
        x, z = gaps[k % len(gaps)], (6.4 if k % 2 == 0 else -6.4)
        world(_grid([x - span * 0.4, 7.2, z], [span * 0.8, 0, 0], [0, -2.6, 0], *drape,
                    bulge=[0, 0, 0.12], waves=3.0), FABRICS[k % len(FABRICS)])
    small = uv_sphere(max(segments // 2, 4), max(rings // 2, 3), 0.5)
    lion = b.add_mesh(*small, material=mat["lion"])
    for x in (-14.6, 14.6):
        b.add_node(mesh=lion, translation=[x, 5.5, 0.0], scale=[0.5, 0.9, 0.9])
        world(_quads([[[x * 0.995, 1.0, -3.0], [x * 0.995, 1.0, 3.0], [x * 0.995, 4.5, 3.0],
                       [x * 0.995, 4.5, -3.0]]]), "background")

    # floor vases with plants, hanging vases on chains
    vase = {r: b.add_mesh(*uv_sphere(max(segments - 4, 4), max(rings - 4, 3), 0.5),
                          material=mat[r]) for r in ("vase", "vase_round")}
    hang = b.add_mesh(*small, material=mat["vase_hanging"])
    plants = []
    for k, (x, z) in enumerate(((-10, -3), (10, -3), (-10, 3), (10, 3),
                                (-5, -8), (5, -8), (-5, 8), (5, 8))):
        role = "vase" if k < 4 else "vase_round"
        b.add_node(mesh=vase[role], translation=[x, 0.6, z], scale=[1.0, 1.2, 1.0])
        plants.append(_plant(rng, [x, 1.1, z], plant_blades, 1.4))
    world(_quads(np.concatenate(plants)), "plant")
    chains = []
    for k in range(8):
        x, z = -10.5 + 3 * k, (-3.0 if k % 2 else 3.0)
        b.add_node(mesh=hang, translation=[x, 4.8, z], scale=[0.7, 0.7, 0.7])
        for dx, dz in ((0.12, 0.0), (0.0, 0.12)):
            chains.append([[x - dx, 5.1, z - dz], [x + dx, 5.1, z + dz],
                           [x + dx, 8.0, z + dz], [x - dx, 8.0, z - dz]])
    world(_quads(chains), "chain")

    # ivy: leaf quads in thin layers on the long walls and in front of the
    # lintels and balustrades, each backed by an opaque surface
    sheets = [([0, 2.5, -9.6], [26, 0, 0], [0, 4.0, 0]), ([0, 2.5, 9.6], [26, 0, 0], [0, 4.0, 0]),
              ([0, 4.4, -5.55], [22, 0, 0], [0, 1.0, 0]), ([0, 4.4, 5.55], [22, 0, 0],
                                                           [0, 1.0, 0])]
    world(_quads(np.concatenate([_leaves(rng, c, u, v, leaf) for c, u, v in sheets])), "leaf")

    # the moulding along the walls takes the triangles that are left
    left = triangles - _count(b) if triangles else 0
    if left > 0:
        nu = int(np.ceil(left / 2 / 16))
        world(_trim(_grid([-14.7, 0.05, -9.7], [29.4, 0, 0], [0, 0.5, 0], nu, 16), left),
              "moulding")
    elif triangles and left < 0:
        raise ValueError(f"{triangles} triangles asked for, {_count(b)} built before the "
                         "moulding")
    b.add_node(camera=b.add_camera(), translation=[0.0, -2.0, 0.0])
    return b
