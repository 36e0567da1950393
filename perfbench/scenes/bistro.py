"""The Amazon Lumberyard Bistro exterior at the published asset's size:
2,800,000 triangles (ORCA's rounded "2.8 million"), 120 materials and
300 texture images of 1024x1024 (a base colour and a normal map for
every material, a metallic-roughness map for 60), four of the materials
alpha-MASK (tree leaves, planter shrubs, hanging-basket flowers, ivy) on
280,000 triangles.

The meshes are stand-ins for the Bistro's, laid out as a street of
120 x 16 m: a cobbled road between kerbs and slab pavements; two rows of
twelve buildings, each with a relief façade, framed windows with open
louvred shutters, balconies with balusters, shop doors and striped
awnings, two roof slopes of tile rows and chimneys with pots; a closing
façade at the far end; café tables and chairs, lamp posts and tree
trunks. Twelve street trees carry crowns of `cards` leaf cards each, in
`shells` concentric shells whose cards lie tangent to the shell (a ray
through a crown's centre crosses 10-20 of them); planters, hanging
baskets and ivy on two façades carry the rest of the foliage. Every
foliage card maps its whole texture (uv [0, 1]^2), and cards that can
overlap lie at different depths (five levels 0.01 apart), so no two
surfaces a ray meets are nearer than that. The cobbles, small boxes laid
in courses across the road, each course shifted by half a stone and
every stone of its own size, height and turn, take whatever triangles
are left, so the total is exact; no two of them touch.

Texture contents are blocky patterns (an eighth of the resolution, each
texel repeated 8x8) over per-material tints; the alpha of each foliage
texture is a union of ellipses drawn from `seed` until 40% of its texels
are opaque. Every texture declares a REPEAT sampler.

`layout(**params)` lays the scene out and counts it without building a
vertex; `build(**params)` builds the same layout and checks its counts
against the layout's. Geometry is built in glTF space (y up, the road at 0)
in nodes whose rotation the loader reads as the identity.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from perfbench.scenes.gltf_writer import GLTFBuilder

# the node rotation that the loader's positional read turns into the identity
IDENTITY = [0.0, 0.0, 0.0, -1.0]
SAMPLER = {"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}
ALPHA_ROLES = ("leaves", "shrubs", "flowers", "ivy")
STREET = (120.0, 5.0, 8.0)  # length, half-width of the road, of the street


def materials(buildings: int = 24):
    """(role, tint, roughness, metallic, pattern) of the 120 materials:
    three a building, twelve awning fabrics, eight roofs, the street, the
    props; the alpha-MASK roles last."""
    rng = np.random.RandomState(11)
    out = []
    for b in range(buildings):
        out += [(f"wall{b}", tuple(0.55 + 0.35 * rng.rand(3)), 0.9, 0.0, "stone"),
                (f"trim{b}", tuple(0.4 + 0.5 * rng.rand(3)), 0.6, 0.0, "stone"),
                (f"shutter{b}", tuple(0.15 + 0.6 * rng.rand(3)), 0.5, 0.0, "wood")]
    out += [(f"awning{k}", tuple(0.2 + 0.7 * rng.rand(3)), 0.9, 0.0, "fabric")
            for k in range(12)]
    out += [(f"roof{k}", (0.45 + 0.1 * rng.rand(), 0.28, 0.22), 0.8, 0.0, "tiles")
            for k in range(8)]
    out += [("chimney_a", (0.55, 0.35, 0.28), 0.9, 0.0, "bricks"),
            ("chimney_b", (0.62, 0.58, 0.52), 0.9, 0.0, "bricks"),
            ("iron_a", (0.12, 0.12, 0.12), 0.4, 0.9, "metal"),
            ("iron_b", (0.18, 0.22, 0.18), 0.4, 0.9, "metal"),
            ("asphalt", (0.25, 0.25, 0.27), 0.95, 0.0, "stone"),
            ("cobble_a", (0.50, 0.48, 0.45), 0.8, 0.0, "stone"),
            ("cobble_b", (0.42, 0.40, 0.38), 0.8, 0.0, "stone"),
            ("cobble_c", (0.58, 0.54, 0.50), 0.8, 0.0, "stone"),
            ("kerb", (0.65, 0.63, 0.60), 0.7, 0.0, "stone"),
            ("slab_a", (0.70, 0.68, 0.64), 0.8, 0.0, "tiles"),
            ("slab_b", (0.60, 0.60, 0.58), 0.8, 0.0, "tiles"),
            ("table_top", (0.85, 0.85, 0.82), 0.3, 0.0, "stone"),
            ("table_leg", (0.30, 0.30, 0.32), 0.3, 0.9, "metal"),
            ("chair_wood", (0.55, 0.35, 0.20), 0.6, 0.0, "wood"),
            ("chair_metal", (0.20, 0.35, 0.25), 0.4, 0.8, "metal"),
            ("lamp_post", (0.10, 0.12, 0.10), 0.4, 0.9, "metal"),
            ("trunk", (0.35, 0.28, 0.20), 0.9, 0.0, "wood"),
            ("planter", (0.45, 0.40, 0.35), 0.8, 0.0, "stone"),
            ("basket", (0.55, 0.42, 0.25), 0.9, 0.0, "wood"),
            ("door_a", (0.30, 0.18, 0.10), 0.6, 0.0, "wood"),
            ("door_b", (0.15, 0.25, 0.35), 0.6, 0.0, "wood"),
            ("door_c", (0.35, 0.10, 0.10), 0.6, 0.0, "wood"),
            ("door_d", (0.20, 0.30, 0.20), 0.6, 0.0, "wood"),
            ("glass", (0.20, 0.25, 0.30), 0.1, 0.0, "metal")]
    out += [("leaves", (0.22, 0.45, 0.16), 1.0, 0.0, "leaves"),
            ("shrubs", (0.25, 0.50, 0.20), 1.0, 0.0, "shrubs"),
            ("flowers", (0.80, 0.30, 0.45), 1.0, 0.0, "flowers"),
            ("ivy", (0.18, 0.40, 0.15), 1.0, 0.0, "ivy")]
    return out


# ---- layout: primitives by material role ----------------------------------------------

class Layout:
    """The scene as primitives: for each material role, lists of boxes
    (centre, size, turn about the vertical or None), cards (centre, half
    axes a and b), grids (origin, axes, nu x nv cells, relief) and
    cylinders (base, radius, height, segments)."""

    def __init__(self):
        self.boxes = defaultdict(list)
        self.cards = defaultdict(list)
        self.grids = defaultdict(list)
        self.cyls = defaultdict(list)
        self.trim = {}  # role: triangles left off the end of its mesh

    def box(self, role, centre, size, yaw=None):
        self.boxes[role].append((np.asarray(centre, np.float64).reshape(-1, 3),
                                 np.broadcast_to(np.asarray(size, np.float64),
                                                 np.shape(centre)).reshape(-1, 3), yaw))

    def triangles(self, role=None) -> int:
        roles = [role] if role else set(self.boxes) | set(self.cards) | set(self.grids) \
            | set(self.cyls)
        n = 0
        for r in roles:
            n += sum(12 * c.shape[0] for c, _, _ in self.boxes.get(r, []))
            n += sum(2 * c.shape[0] for c, _, _ in self.cards.get(r, []))
            n += sum(2 * g[3] * g[4] for g in self.grids.get(r, []))
            n += sum(3 * s * b.shape[0] for b, _, _, s in self.cyls.get(r, []))
            n -= self.trim.get(r, 0)
        return int(n)


def _fibonacci(n, rng):
    """n unit vectors spread evenly over the sphere, turned at random."""
    k = np.arange(n) + 0.5
    z = 1.0 - 2.0 * k / n
    phi = np.pi * (1.0 + 5.0 ** 0.5) * k
    r = np.sqrt(1.0 - z * z)
    v = np.stack([r * np.cos(phi), z, r * np.sin(phi)], 1)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return v @ q


def _tangent_cards(centre, radii, normals, size, rng):
    """Cards of `size` tangent to spheres about `centre`: at radius `radii`
    along `normals`, each turned about its normal at random; centres,
    half axes a, b."""
    helper = np.where(np.abs(normals[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    e1 = np.cross(normals, helper)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(normals, e1)
    ang = rng.uniform(0, 2 * np.pi, (normals.shape[0], 1))
    a = (np.cos(ang) * e1 + np.sin(ang) * e2) * size / 2
    b = (-np.sin(ang) * e1 + np.cos(ang) * e2) * size / 2
    return np.asarray(centre) + radii[:, None] * normals, a, b


def _cluster(lay, role, centre, radius, count, shells, size, rng):
    """`count` cards in `shells` shells about `centre` (outermost at
    `radius`, innermost at 40% of it), each shell's share of the cards in
    proportion to its area; radii staggered in five levels 0.01 apart."""
    radii = radius * (0.4 + 0.6 * np.arange(shells) / max(shells - 1, 1))
    share = radii ** 2 / (radii ** 2).sum()
    n = np.floor(share * count).astype(int)
    n[-1] += count - n.sum()
    for r, k in zip(radii, n):
        normals = _fibonacci(int(k), rng)
        level = (np.arange(k) % 5 - 2) * 0.01
        c, a, b = _tangent_cards(centre, r + level, normals, size, rng)
        lay.cards[role].append((c, a, b))


def _sheet_cards(lay, role, origin, axis_u, axis_v, count, size, rng):
    """`count` cards over a flat rectangle (ivy on a wall): on a grid with
    jitter, turned about the sheet's normal, in nine depth levels 0.01
    apart by cell index, as Sponza's ivy."""
    a, b = np.asarray(axis_u, np.float64), np.asarray(axis_v, np.float64)
    nrm = np.cross(a, b)
    nrm /= np.linalg.norm(nrm)
    nu = max(int(round(np.sqrt(count * np.linalg.norm(a) / np.linalg.norm(b)))), 1)
    nv = int(np.ceil(count / nu))
    i = np.arange(count) % nu
    j = np.arange(count) // nu
    ju, jv = rng.uniform(-0.25, 0.25, (2, count))
    depth = ((i % 3) + 3 * (j % 3)) * 0.01 + 0.02
    c = (np.asarray(origin) + ((i + 0.5 + ju) / nu)[:, None] * a
         + ((j + 0.5 + jv) / nv)[:, None] * b + depth[:, None] * nrm)
    ang = rng.uniform(0, 2 * np.pi, (count, 1))
    ea, eb = a / np.linalg.norm(a), b / np.linalg.norm(b)
    lay.cards[role].append((c, (np.cos(ang) * ea + np.sin(ang) * eb) * size / 2,
                            (-np.sin(ang) * ea + np.cos(ang) * eb) * size / 2))


def layout(buildings=24, facade=(160, 120), roof=(100, 40), awning=(40, 12), windows=4,
           floors=4, slats=16, balusters=40, segments=24, crowns=12, cards=10000, shells=6, crown_radius=2.2,
           leaf=0.15, planters=16, shrub_cards=500, baskets=20, flower_cards=300,
           ivy_cards=6000, tables=30, chairs=120, lamps=10, paving=0.6, triangles=2800000,
           seed=5,
           texture_size=1024):
    """The scene's primitives (Layout), the counts it holds to, and the
    trees' places (x, z)."""
    rng = np.random.RandomState(seed)
    lay = Layout()
    length, road, street = STREET
    per_side = buildings // 2
    width = length / per_side
    z0 = -length / 2
    heights = 10.0 + 6.0 * rng.rand(buildings)
    mats = materials(buildings)
    n_aw = sum(1 for m in mats if m[0].startswith("awning"))
    n_roof = sum(1 for m in mats if m[0].startswith("roof"))
    doors = ("door_a", "door_b", "door_c", "door_d")

    # buildings: façade x = side * street, facing the road
    for bi in range(buildings):
        side = -1.0 if bi < per_side else 1.0
        k = bi % per_side
        za, h = z0 + k * width, float(heights[bi])
        x = side * street
        out = -side  # the façade's normal, toward the road
        # the wall as a relief grid, origin and axes so the normal faces the road
        if side < 0:
            lay.grids[f"wall{bi}"].append(((x, 0.0, za + width), (0, 0, -width), (0, h, 0),
                                           facade[0], facade[1], 0.02))
        else:
            lay.grids[f"wall{bi}"].append(((x, 0.0, za), (0, 0, width), (0, h, 0),
                                           facade[0], facade[1], 0.02))
        xs = x + out * np.array([0.03, 0.06, 0.09])  # glass, frame, shutter planes
        n_floor = min(floors, int((h - 3.5) // 3.0))
        for f in range(n_floor):
            y = 3.5 + 3.0 * f + 0.8
            for w in range(windows):
                zc = za + width * (w + 0.5) / windows
                lay.cards["glass"].append((np.array([[xs[0], y + 0.8, zc]]),
                                           np.array([[0.0, 0.0, 0.55 * -out]]),
                                           np.array([[0.0, 0.8, 0.0]])))
                # lintel, sill, jambs, mullions: no two faces in one plane
                frame_c = [[xs[1], y + 1.65, zc], [xs[1], y - 0.05, zc],
                           [xs[1], y + 0.8, zc - 0.6], [xs[1], y + 0.8, zc + 0.6],
                           [xs[1], y + 0.8, zc], [xs[1], y + 0.8, zc]]
                frame_s = [[0.1, 0.1, 1.24], [0.25, 0.1, 1.4], [0.12, 1.76, 0.1],
                           [0.12, 1.76, 0.1], [0.06, 1.56, 0.05], [0.07, 0.05, 1.1]]
                lay.box(f"trim{bi}", frame_c, frame_s)
                # two open shutters of `slats` louvres beside the window
                sy = y + 0.05 + 1.5 * (np.arange(slats) + 0.5) / slats
                for dz in (-0.95, 0.95):
                    c = np.stack([np.full(slats, xs[2]), sy, np.full(slats, zc + dz)], 1)
                    lay.box(f"shutter{bi}", c, [0.04, 1.5 / slats * 0.8, 0.5])
            if f == 0:  # a balcony across the first floor
                zc = za + width / 2
                xb = x + out * 0.45
                lay.box(f"iron_{'ab'[bi % 2]}", [[xb, y - 0.9, zc]], [0.9, 0.12, width * 0.7])
                bz = zc + width * 0.35 * np.linspace(-1, 1, balusters)
                bx = np.full(balusters, x + out * 0.85)
                lay.box(f"iron_{'ab'[bi % 2]}",
                        np.stack([bx, np.full(balusters, y - 0.4), bz], 1), [0.03, 0.9, 0.03])
                lay.box(f"iron_{'ab'[bi % 2]}", [[x + out * 0.85, y + 0.07, zc]],
                        [0.06, 0.05, width * 0.7])
        # the shop floor: two doors and two striped awnings
        for d, dz in enumerate((0.25, 0.75)):
            zc = za + width * dz
            lay.box(doors[(bi + d) % 4], [[x + out * 0.05, 1.2, zc]], [0.1, 2.4, 1.4])
            if side < 0:
                org, ax_u = (x, 3.2, zc + 2.0), (0, 0, -4.0)
            else:
                org, ax_u = (x, 3.2, zc - 2.0), (0, 0, 4.0)
            lay.grids[f"awning{(bi + d) % n_aw}"].append(
                (org, ax_u, (out * 1.8, -0.7, 0), awning[0], awning[1], -0.03))
        # two roof slopes up to a ridge 5 m behind the façade, chimneys on it
        for up, (o, v) in enumerate((((x, h, za), (side * 5.0, 2.5, 0)),
                                     ((x + side * 10.0, h, za), (-side * 5.0, 2.5, 0)))):
            o = np.asarray(o)
            u_ax = (0, 0, width) if (side > 0) == (up == 0) else (0, 0, -width)
            if u_ax[2] < 0:
                o = o + np.array([0, 0, width])
            lay.grids[f"roof{bi % n_roof}"].append((tuple(o), u_ax, v, roof[0], roof[1], 0.03))
        cz = za + width * np.array([0.2, 0.5, 0.8])
        cx = np.full(3, x + side * 5.0)
        lay.box(f"chimney_{'ab'[bi % 2]}", np.stack([cx, np.full(3, h + 3.0), cz], 1),
                [0.6, 1.6, 0.6])
        pots = np.concatenate([np.stack([cx + 0.15, np.full(3, h + 3.8), cz], 1),
                               np.stack([cx - 0.15, np.full(3, h + 3.8), cz], 1)])
        lay.cyls["chimney_a"].append((pots, np.full(6, 0.09), np.full(6, 0.4), segments // 2))
    # the closing façade at the far end
    lay.grids["wall0"].append(((street, 0.0, -z0), (-2 * street, 0, 0), (0, 14.0, 0),
                               facade[0], facade[1], 0.02))

    # the street: asphalt under the cobbles, kerbs, pavement slabs
    lay.cards["asphalt"].append((np.array([[0.0, -0.01, 0.0]]), np.array([[0.0, 0.0, length / 2]]),
                                 np.array([[road, 0.0, 0.0]])))
    nk = int(length / paving)
    kz = z0 + paving * (np.arange(nk) + 0.5)
    walk = street - road - 0.15
    nx = max(int(walk / paving), 1)
    for s in (-1.0, 1.0):
        lay.box("kerb", np.stack([np.full(nk, s * road), np.full(nk, 0.1), kz], 1),
                [0.25, 0.2, paving - 0.02])
        gx, gz = np.meshgrid(s * (road + 0.15 + walk / nx * (np.arange(nx) + 0.5)), kz)
        slabs = np.stack([gx.ravel(), np.full(gx.size, 0.075), gz.ravel()], 1)
        for k, role in enumerate(("slab_a", "slab_b")):
            sel = slabs[(np.arange(slabs.shape[0]) % 2) == k]
            lay.box(role, sel, [walk / nx - 0.02, 0.15, paving - 0.02])

    # street trees: trunks and crowns
    tz = z0 + length * (np.arange(crowns // 2) + 0.625) / (crowns // 2)
    trees = [(s * (road + 0.5), z) for s in (-1.0, 1.0) for z in tz][:crowns]
    for tx, z in trees:
        lay.cyls["trunk"].append((np.array([[tx, 0.15, z], [tx, 1.5, z], [tx, 2.8, z]]),
                                  np.array([0.2, 0.16, 0.12]), np.array([1.35, 1.3, 1.6]),
                                  segments))
        _cluster(lay, "leaves", (tx, 5.3, z), crown_radius, cards, shells, leaf, rng)

    # planters with shrubs, hanging baskets with flowers, ivy on two façades
    pz = z0 + length * (np.arange(planters // 2) + 0.375) / max(planters // 2, 1)
    for s in (-1.0, 1.0):
        for z in pz:
            px = s * (street - 0.8)
            lay.box("planter", [[px, 0.4, z]], [0.9, 0.8, 0.9])
            _cluster(lay, "shrubs", (px, 1.3, z), 0.6, shrub_cards, 2, 0.12, rng)
    bz = z0 + length * (np.arange(baskets // 2) + 0.5) / max(baskets // 2, 1)
    for s in (-1.0, 1.0):
        for z in bz:
            bx = s * (street - 0.7)
            lay.cyls["basket"].append((np.array([[bx, 3.0, z]]), np.array([0.3]),
                                       np.array([0.25]), segments * 2 // 3))
            lay.box("iron_a", [[s * (street - 0.35), 3.6, z]], [0.7, 0.03, 0.03])
            _cluster(lay, "flowers", (bx, 3.35, z), 0.35, flower_cards, 2, 0.09, rng)
    half = ivy_cards // 2
    _sheet_cards(lay, "ivy", (-street, 0.5, -20.0), (0, 0, 8.0), (0, 6.0, 0), half, 0.2, rng)
    _sheet_cards(lay, "ivy", (street, 0.5, 28.0), (0, 0, -8.0), (0, 6.0, 0),
                 ivy_cards - half, 0.2, rng)

    # café tables and chairs on the left pavement, lamp posts
    tz = z0 + 6.0 + (length - 12.0) * rng.rand(tables)
    txs = -(road + 1.2 + 1.0 * rng.rand(tables))
    lay.cyls["table_top"].append((np.stack([txs, np.full(tables, 0.9), tz], 1),
                                  np.full(tables, 0.35), np.full(tables, 0.04), segments))
    lay.cyls["table_leg"].append((np.stack([txs, np.full(tables, 0.15), tz], 1),
                                  np.full(tables, 0.03), np.full(tables, 0.75),
                                  segments // 3))
    ci = np.arange(chairs)
    ang = 2 * np.pi * (ci % 4) / 4 + 0.3 * rng.rand(chairs)
    cc = np.stack([txs[ci % tables] + 0.6 * np.cos(ang), np.zeros(chairs),
                   tz[ci % tables] + 0.6 * np.sin(ang)], 1)
    for dx, dz in ((-0.17, -0.17), (0.17, -0.17), (-0.17, 0.17), (0.17, 0.17)):
        lay.box("chair_metal", cc + [dx, 0.38, dz], [0.03, 0.46, 0.03])
    lay.box("chair_wood", cc + [0, 0.62, 0], [0.4, 0.04, 0.4])
    for dy in (0.75, 0.9, 1.05):
        lay.box("chair_wood", cc + [0, dy, 0.18], [0.4, 0.05, 0.03])
    lz = z0 + length * (np.arange(lamps) + 0.5) / lamps
    lx = np.where(np.arange(lamps) % 2 == 0, -(road + 0.3), road + 0.3)
    lay.cyls["lamp_post"].append((np.stack([lx, np.full(lamps, 0.15), lz], 1),
                                  np.full(lamps, 0.06), np.full(lamps, 4.0),
                                  segments * 2 // 3))
    lay.cyls["lamp_post"].append((np.stack([lx, np.full(lamps, 0.15), lz], 1),
                                  np.full(lamps, 0.14), np.full(lamps, 0.5),
                                  segments * 2 // 3))
    lay.box("lamp_post", np.stack([lx, np.full(lamps, 4.35), lz], 1), [0.45, 0.1, 0.45])

    # the cobbles take the triangles that are left: courses across the
    # road, each shifted by half a stone against the last; a stone's
    # sides are 66-78% of its pitch, it turns up to 10 degrees and moves
    # up to 3% of a pitch, so its footprint stays inside its own cell
    left = triangles - lay.triangles() if triangles else 0
    cobbles = 0
    if left > 0:
        cobbles = -(-left // 12)
        cols = int(np.ceil(np.sqrt(cobbles * 2 * road / length)))
        rows = -(-cobbles // cols)
        pitch_x, pitch_z = 2 * road / cols, length / rows
        i = np.arange(cobbles)
        course = i // cols
        shift = 0.25 - 0.5 * (course % 2) + rng.uniform(-0.03, 0.03, cobbles)
        height = rng.uniform(0.05, 0.07, cobbles)
        c = np.stack([-road + pitch_x * (i % cols + 0.5 + shift), height / 2,
                      z0 + pitch_z * (course + 0.5 + rng.uniform(-0.03, 0.03, cobbles))], 1)
        size = np.stack([pitch_x * rng.uniform(0.66, 0.78, cobbles), height,
                         pitch_z * rng.uniform(0.66, 0.78, cobbles)], 1)
        yaw = rng.uniform(-np.pi / 18, np.pi / 18, cobbles)
        for k, role in enumerate(("cobble_a", "cobble_b", "cobble_c")):
            sel = i % 3 == k
            lay.box(role, c[sel], size[sel], yaw[sel])
        # the last cobble keeps only the triangles the total leaves
        lay.trim[("cobble_a", "cobble_b", "cobble_c")[(cobbles - 1) % 3]] = 12 * cobbles - left
    elif triangles and left < 0:
        raise ValueError(f"{triangles} triangles asked for, {lay.triangles()} laid out "
                         "before the cobbles")
    counts = {"triangles": lay.triangles(),
              "alpha_mask_triangles": sum(lay.triangles(r) for r in ALPHA_ROLES),
              "materials": len(mats),
              "images": 2 * len(mats) + min(60, len(mats) - len(ALPHA_ROLES)),
              "image_size": texture_size, "crowns": len(trees), "cards_per_crown": cards}
    return lay, counts, trees


# ---- textures ---------------------------------------------------------------------------

def _blocky(rng, detail, cells):
    grid = rng.rand(cells + 1, cells + 1)
    x = np.linspace(0.0, cells, detail, endpoint=False)
    i = x.astype(np.int64)
    f = x - i
    rows = grid[i] * (1 - f[:, None]) + grid[i + 1] * f[:, None]
    return rows[:, i] * (1 - f[None, :]) + rows[:, i + 1] * f[None, :]


def _ellipses(rng, detail, opaque=0.40):
    """A union of random ellipses, drawn until `opaque` of the texels are in."""
    yy, xx = (np.mgrid[0:detail, 0:detail] + 0.5) / detail
    alpha = np.zeros((detail, detail), bool)
    while alpha.mean() < opaque:
        cx, cy = rng.uniform(0.1, 0.9, 2)
        ra, rb = rng.uniform(0.04, 0.16, 2)
        t = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
        v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
        alpha |= (u / ra) ** 2 + (v / rb) ** 2 < 1.0
    return alpha


def _pattern(kind, rng, detail):
    yy, xx = np.mgrid[0:detail, 0:detail] / float(detail)
    noise = _blocky(rng, detail, 8)
    if kind == "bricks":
        row = np.floor(yy * 8)
        mortar = ((yy * 8) % 1 < 0.08) | (((xx * 4) + 0.5 * (row % 2)) % 1 < 0.04)
        return np.where(mortar, 0.1, 0.6 + 0.4 * noise), None
    if kind == "tiles":
        return np.where(((xx * 8) % 1 < 0.06) | ((yy * 8) % 1 < 0.06), 0.2,
                        0.5 + 0.5 * noise), None
    if kind == "fabric":
        return 0.5 + 0.3 * (np.sin(xx * 2 * np.pi * 8) > 0) + 0.2 * noise, None
    if kind == "wood":
        return 0.5 + 0.25 * np.sin(yy * 2 * np.pi * 24 + 6 * noise) + 0.2 * noise, None
    if kind in ("stone", "metal"):
        return 0.4 + 0.6 * noise, None
    return 0.5 + 0.5 * noise, _ellipses(rng, detail)


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


# ---- meshes from the layout ---------------------------------------------------------------

def _box_arrays(centre, size, yaw=None):
    """N boxes, axis-aligned or turned by `yaw` about the vertical:
    (positions, normals, uvs, indices), 12 triangles each."""
    faces = np.array([[(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)],
                      [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)],
                      [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)],
                      [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)],
                      [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)],
                      [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)]], np.float64)
    normals = np.array([(0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0)],
                       np.float64)
    n = centre.shape[0]
    off = faces[None] * size[:, None, None, :] / 2
    nrm = np.broadcast_to(normals[None, :, None, :], (n, 6, 4, 3))
    if yaw is not None:  # x' = x cos + z sin, z' = z cos - x sin
        cs, sn = np.cos(yaw)[:, None, None], np.sin(yaw)[:, None, None]

        def turn(v):
            return np.stack([v[..., 0] * cs + v[..., 2] * sn, v[..., 1],
                             v[..., 2] * cs - v[..., 0] * sn], -1)

        off, nrm = turn(off), turn(nrm)
    pos = centre[:, None, None, :] + off
    uv = np.broadcast_to(np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float64), (n, 6, 4, 2))
    quad = np.array([0, 1, 2, 0, 2, 3])
    idx = (np.arange(n * 6)[:, None] * 4 + quad[None, :]).reshape(-1)
    return pos.reshape(-1, 3), nrm.reshape(-1, 3), uv.reshape(-1, 2), idx


def _card_arrays(centre, a, b):
    """N quads centre +- a +- b, each mapping uv [0, 1]^2: 2 triangles each."""
    corners = np.stack([centre - a - b, centre + a - b, centre + a + b, centre - a + b], 1)
    nrm = np.cross(a, b)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    n = centre.shape[0]
    uv = np.tile(np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float64), (n, 1))
    idx = (np.arange(n)[:, None] * 4 + np.array([0, 1, 2, 0, 2, 3])[None, :]).reshape(-1)
    return corners.reshape(-1, 3), np.repeat(nrm, 4, axis=0), uv, idx


def _grid_arrays(origin, axis_u, axis_v, nu, nv, relief):
    """A sheet of nu x nv quads with shared vertices, pushed along its
    normal by `relief` times a block pattern (stone courses, tile rows,
    awning stripes), uv over the sheet in metres."""
    o, a, b = (np.asarray(x, np.float64) for x in (origin, axis_u, axis_v))
    n = np.cross(a, b)
    n /= np.linalg.norm(n)
    uu, vv = np.meshgrid(np.linspace(0.0, 1.0, nu + 1), np.linspace(0.0, 1.0, nv + 1))
    bump = (np.sin(uu * nu * np.pi / 2) * np.sin(vv * nv * np.pi / 2) > 0).astype(np.float64)
    pos = (o + uu[..., None] * a + vv[..., None] * b
           + (relief * bump)[..., None] * n).reshape(-1, 3)
    uv = np.stack([uu * np.linalg.norm(a), vv * np.linalg.norm(b)], -1).reshape(-1, 2) / 4
    i0 = (np.arange(nv)[:, None] * (nu + 1) + np.arange(nu)[None, :]).reshape(-1)
    idx = np.stack([i0, i0 + 1, i0 + nu + 2, i0, i0 + nu + 2, i0 + nu + 1], -1).reshape(-1)
    return pos, np.tile(n, (pos.shape[0], 1)), uv, idx


def _cyl_arrays(base, radius, height, seg):
    """N vertical cylinders: the side (2 * seg triangles) and a top fan (seg)."""
    n = base.shape[0]
    t = 2 * np.pi * np.arange(seg + 1) / seg
    ring = np.stack([np.cos(t), np.zeros_like(t), np.sin(t)], 1)
    r = radius[:, None, None]
    bottom = base[:, None, :] + r * ring[None]
    top = bottom + np.array([0.0, 1.0, 0.0]) * height[:, None, None]
    centre = base + np.array([0.0, 1.0, 0.0]) * height[:, None]
    pos = np.concatenate([bottom, top, top, centre[:, None, :]], 1)  # (n, 3 (seg+1) + 1, 3)
    nrm = np.concatenate([np.broadcast_to(ring, (n, seg + 1, 3))] * 2
                         + [np.broadcast_to([0.0, 1.0, 0.0], (n, seg + 2, 3))], 1)
    uv = np.concatenate([np.stack([t / (2 * np.pi), np.zeros_like(t)], 1),
                         np.stack([t / (2 * np.pi), np.ones_like(t)], 1),
                         ring[:, [0, 2]] * 0.5 + 0.5, [[0.5, 0.5]]])
    k = np.arange(seg)
    side = np.stack([k, seg + 1 + k, k + 1, k + 1, seg + 1 + k, seg + 2 + k], 1).reshape(-1)
    fan = np.stack([np.full(seg, 3 * (seg + 1)), 2 * (seg + 1) + k + 1,
                    2 * (seg + 1) + k], 1).reshape(-1)
    per = 3 * (seg + 1) + 1
    idx = (np.arange(n)[:, None] * per + np.concatenate([side, fan])[None, :]).reshape(-1)
    return pos.reshape(-1, 3), nrm.reshape(-1, 3), np.tile(uv, (n, 1)), idx


def _role_mesh(lay, role):
    parts = ([_box_arrays(c, s, y) for c, s, y in lay.boxes.get(role, [])]
             + [_card_arrays(c, a, b) for c, a, b in lay.cards.get(role, [])]
             + [_grid_arrays(*g) for g in lay.grids.get(role, [])]
             + [_cyl_arrays(b, r, h, s) for b, r, h, s in lay.cyls.get(role, [])])
    if not parts:
        return None
    pos, nrm, uv, idx, base = [], [], [], [], 0
    for p, n, u, i in parts:
        pos.append(p)
        nrm.append(n)
        uv.append(u)
        idx.append(i + base)
        base += p.shape[0]
    idx = np.concatenate(idx)
    idx = idx[: idx.size - 3 * lay.trim.get(role, 0)]
    return (np.concatenate(pos).astype(np.float32), np.concatenate(nrm).astype(np.float32),
            np.concatenate(uv).astype(np.float32), idx.astype(np.uint32))


def _count(b: GLTFBuilder) -> int:
    return sum(b._mesh_data[node["mesh"]][3].size // 3 for node in b.nodes if "mesh" in node)


def build(texture_size=1024, **params) -> GLTFBuilder:
    lay, counts, _ = layout(texture_size=texture_size, **params)
    rng = np.random.RandomState(params.get("seed", 5) + 1000)
    b = GLTFBuilder()
    mats = materials(params.get("buildings", 24))
    opaque_seen = 0
    for role, tint, rough, metal, kind in mats:
        mask = role in ALPHA_ROLES
        has_mr = not mask and opaque_seen < 60
        opaque_seen += not mask
        base, normal, mr = _images(kind, tint, has_mr, rng, texture_size)
        t_base = b.add_texture(base, sampler=dict(SAMPLER))
        t_nrm = b.add_texture(normal, sampler=dict(SAMPLER))
        t_mr = b.add_texture(mr, sampler=dict(SAMPLER)) if mr is not None else None
        m = b.add_material(base_color=(1, 1, 1, 1), roughness=rough, metallic=metal,
                           base_color_texture=t_base, normal_texture=t_nrm, mr_texture=t_mr,
                           alpha_mode="MASK" if mask else "OPAQUE",
                           alpha_cutoff=0.5 if mask else None)
        mesh = _role_mesh(lay, role)
        if mesh is not None:
            b.add_node(mesh=b.add_mesh(*mesh, material=m), rotation=IDENTITY)
    if _count(b) != counts["triangles"] or len(b.materials) != counts["materials"] \
            or len(b.images) != counts["images"]:
        raise AssertionError(f"built {_count(b)} triangles, {len(b.materials)} materials, "
                             f"{len(b.images)} images against the layout's {counts}")
    b.add_node(camera=b.add_camera(), translation=[0.0, -2.0, 0.0])
    return b
