"""Procedural glTF scene generation (the port's copy of the writers of
tpurt/scene/procedural.py). Textures are encoded by
tpurt_torch/utils/png.py instead of Pillow; it writes Pillow's bytes, so
every writer here writes the bytes tpurt's writer writes for the same
arguments.

The target sample scenes (Box, Damaged Helmet, Lantern, Sponza —
reference README.md:26, BASELINE.json configs) are not redistributable,
so these writers synthesize glTF files with the same structural
features: single-cube Box, normal-mapped PBR spheres, multi-node scene
graphs with emissive materials, and a Sponza-scale interior with
alpha-tested foliage. All files are valid glTF 2.0 and exercise the same
loader paths (accessor dedup, index widening, transform flattening,
materials, textures, samplers).
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Optional

import numpy as np

from tpurt_torch.utils import png


def _box_mesh(size=1.0):
    """24-vertex, 12-triangle cube matching the Khronos Box sample layout."""
    s = size / 2.0
    # six faces, each with its own 4 vertices and normal
    faces = [
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)]),
        ((1, 0, 0), [(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)]),
        ((-1, 0, 0), [(-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)]),
        ((0, 1, 0), [(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    positions, normals, uvs, indices = [], [], [], []
    for fi, (n, verts) in enumerate(faces):
        base = fi * 4
        positions.extend(verts)
        normals.extend([n] * 4)
        uvs.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        indices.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return (
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(indices, np.uint16),
    )


def _quad_mesh():
    positions = np.array(
        [(-0.5, -0.5, 0), (0.5, -0.5, 0), (0.5, 0.5, 0), (-0.5, 0.5, 0)], np.float32
    )
    normals = np.array([(0, 0, 1)] * 4, np.float32)
    uvs = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    return positions, normals, uvs, indices


def _uv_sphere(segments=16, rings=12, radius=0.5):
    positions, normals, uvs = [], [], []
    for r in range(rings + 1):
        theta = np.pi * r / rings
        for s in range(segments + 1):
            phi = 2 * np.pi * s / segments
            n = (
                np.sin(theta) * np.cos(phi),
                np.cos(theta),
                np.sin(theta) * np.sin(phi),
            )
            positions.append(tuple(radius * c for c in n))
            normals.append(n)
            uvs.append((s / segments, r / rings))
    indices = []
    for r in range(rings):
        for s in range(segments):
            a = r * (segments + 1) + s
            b = a + segments + 1
            indices.extend([a, b, a + 1, a + 1, b, b + 1])
    return (
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(indices, np.uint32),
    )


class GLTFBuilder:
    """Assemble a minimal-but-valid glTF 2.0 JSON + embedded-base64 buffer."""

    def __init__(self):
        self.blob = bytearray()
        self.buffer_views = []
        self.accessors = []
        self.meshes = []
        self.nodes = []
        self.materials = []
        self.textures = []
        self.images = []
        self.samplers = []
        self.cameras = []
        self.scene_nodes = []

    def _add_accessor(self, arr: np.ndarray, target: Optional[int], type_str, comp_type,
                      minmax=False):
        arr = np.ascontiguousarray(arr)
        offset = len(self.blob)
        self.blob.extend(arr.tobytes())
        while len(self.blob) % 4:
            self.blob.append(0)
        self.buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": arr.nbytes,
             **({"target": target} if target else {})}
        )
        acc = {
            "bufferView": len(self.buffer_views) - 1,
            "componentType": comp_type,
            "count": int(arr.shape[0]),
            "type": type_str,
        }
        if minmax:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_mesh(self, positions, normals=None, uvs=None, indices=None, tangents=None,
                 material: Optional[int] = None):
        comp = {np.dtype(np.uint8): 5121, np.dtype(np.uint16): 5123,
                np.dtype(np.uint32): 5125}[indices.dtype]
        attrs = {"POSITION": self._add_accessor(positions, 34962, "VEC3", 5126, minmax=True)}
        if normals is not None:
            attrs["NORMAL"] = self._add_accessor(normals, 34962, "VEC3", 5126)
        if tangents is not None:
            attrs["TANGENT"] = self._add_accessor(tangents, 34962, "VEC4", 5126)
        if uvs is not None:
            attrs["TEXCOORD_0"] = self._add_accessor(uvs, 34962, "VEC2", 5126)
        prim = {
            "attributes": attrs,
            "indices": self._add_accessor(indices.reshape(-1, 1), 34963, "SCALAR", comp),
        }
        if material is not None:
            prim["material"] = material
        self.meshes.append({"primitives": [prim]})
        return len(self.meshes) - 1

    def add_material(self, base_color=(1, 1, 1, 1), metallic=0.0, roughness=1.0,
                     emissive=(0, 0, 0), alpha_mode="OPAQUE", alpha_cutoff=None,
                     base_color_texture=None, mr_texture=None, normal_texture=None,
                     emissive_texture=None, normal_scale=1.0):
        m = {
            "pbrMetallicRoughness": {
                "baseColorFactor": list(base_color),
                "metallicFactor": metallic,
                "roughnessFactor": roughness,
            },
            "emissiveFactor": list(emissive),
        }
        if base_color_texture is not None:
            m["pbrMetallicRoughness"]["baseColorTexture"] = {"index": base_color_texture}
        if mr_texture is not None:
            m["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {"index": mr_texture}
        if normal_texture is not None:
            m["normalTexture"] = {"index": normal_texture, "scale": normal_scale}
        if emissive_texture is not None:
            m["emissiveTexture"] = {"index": emissive_texture}
        if alpha_mode != "OPAQUE":
            m["alphaMode"] = alpha_mode
        if alpha_cutoff is not None:
            m["alphaCutoff"] = alpha_cutoff
        self.materials.append(m)
        return len(self.materials) - 1

    def add_texture(self, image_rgba: np.ndarray, sampler: Optional[dict] = None):
        """Add an image (embedded PNG) + optional sampler dict -> texture id."""
        blob = png.encode_png(np.asarray(image_rgba, np.uint8))
        uri = "data:image/png;base64," + base64.b64encode(blob).decode()
        self.images.append({"uri": uri})
        tex = {"source": len(self.images) - 1}
        if sampler is not None:
            self.samplers.append(sampler)
            tex["sampler"] = len(self.samplers) - 1
        self.textures.append(tex)
        return len(self.textures) - 1

    def add_node(self, mesh=None, translation=None, rotation=None, scale=None,
                 camera=None, children=None, root=True):
        node = {}
        if mesh is not None:
            node["mesh"] = mesh
        if camera is not None:
            node["camera"] = camera
        if translation is not None:
            node["translation"] = list(translation)
        if rotation is not None:
            node["rotation"] = list(rotation)
        if scale is not None:
            node["scale"] = list(scale)
        if children is not None:
            node["children"] = children
        self.nodes.append(node)
        idx = len(self.nodes) - 1
        if root:
            self.scene_nodes.append(idx)
        return idx

    def add_camera(self, yfov=0.7853981, znear=0.01, zfar=1000.0):
        self.cameras.append(
            {"type": "perspective",
             "perspective": {"yfov": yfov, "znear": znear, "zfar": zfar}}
        )
        return len(self.cameras) - 1

    def _doc(self, buffer_entry):
        doc = {
            "asset": {"version": "2.0", "generator": "tpurt-procedural"},
            "scene": 0,
            "scenes": [{"nodes": self.scene_nodes}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [buffer_entry],
        }
        if self.materials:
            doc["materials"] = self.materials
        if self.textures:
            doc["textures"] = self.textures
        if self.images:
            doc["images"] = self.images
        if self.samplers:
            doc["samplers"] = self.samplers
        if self.cameras:
            doc["cameras"] = self.cameras
        return doc

    def write(self, path: str):
        doc = self._doc({
            "byteLength": len(self.blob),
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(bytes(self.blob)).decode(),
        })
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def write_glb(self, path: str):
        """Write the binary GLB container (JSON chunk + BIN chunk)."""
        bin_chunk = bytes(self.blob)
        while len(bin_chunk) % 4:
            bin_chunk += b"\x00"
        doc = self._doc({"byteLength": len(bin_chunk)})  # no uri: GLB BIN chunk
        json_chunk = json.dumps(doc).encode()
        while len(json_chunk) % 4:
            json_chunk += b" "
        total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, total))  # 'glTF', v2
            f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))  # JSON
            f.write(json_chunk)
            f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))  # BIN
            f.write(bin_chunk)
        return path


def write_box_scene(path: str, base_color=(0.8, 0.2, 0.2, 1.0)) -> str:
    """The Box analogue: one cube, one material (BASELINE.json config 1)."""
    b = GLTFBuilder()
    p, n, uv, idx = _box_mesh()
    mat = b.add_material(base_color=base_color, roughness=1.0)
    mesh = b.add_mesh(p, n, uv, idx, material=mat)
    b.add_node(mesh=mesh)
    return b.write(path)


def write_textured_quad_scene(path: str, tex_size=16, checker=4,
                              sampler: Optional[dict] = None) -> str:
    """A single textured quad (texture sampling / wrap-mode tests)."""
    b = GLTFBuilder()
    p, n, uv, idx = _quad_mesh()
    img = np.zeros((tex_size, tex_size, 4), np.uint8)
    yy, xx = np.mgrid[0:tex_size, 0:tex_size]
    mask = ((xx // checker) + (yy // checker)) % 2 == 0
    img[mask] = [255, 255, 255, 255]
    img[~mask] = [0, 0, 0, 255]
    tex = b.add_texture(img, sampler=sampler)
    mat = b.add_material(base_color_texture=tex)
    mesh = b.add_mesh(p, n, uv, idx, material=mat)
    b.add_node(mesh=mesh)
    return b.write(path)


def write_helmet_like_scene(path: str) -> str:
    """Damaged-Helmet analogue: normal-mapped, metallic-roughness-textured
    sphere with tangents (BASELINE.json config 2)."""
    b = GLTFBuilder()
    p, n, uv, idx = _uv_sphere(24, 18, 0.7)
    # tangents: d(position)/d(u) direction
    tangents = np.zeros((p.shape[0], 4), np.float32)
    phi = 2 * np.pi * uv[:, 0]
    tangents[:, 0] = -np.sin(phi + np.pi / 2)
    tangents[:, 2] = np.cos(phi + np.pi / 2)
    tangents[:, 3] = 1.0
    rng = np.random.RandomState(7)
    albedo = (rng.rand(32, 32, 4) * 127 + 64).astype(np.uint8)
    albedo[..., 3] = 255
    mr = np.zeros((16, 16, 4), np.uint8)
    mr[..., 1] = np.linspace(40, 220, 16, dtype=np.uint8)[None, :]
    mr[..., 3] = 255
    nrm = np.full((16, 16, 4), 128, np.uint8)
    nrm[..., 2] = 255
    nrm[..., 3] = 255
    t_alb = b.add_texture(albedo)
    t_mr = b.add_texture(mr)
    t_n = b.add_texture(nrm)
    mat = b.add_material(base_color=(1, 1, 1, 1), metallic=0.7, roughness=0.4,
                         base_color_texture=t_alb, mr_texture=t_mr, normal_texture=t_n)
    mesh = b.add_mesh(p, n, uv, idx, tangents=tangents, material=mat)
    b.add_node(mesh=mesh)
    cam = b.add_camera()
    # loader camera position maps (tx, ty, tz) -> (tx, -ty, -tz)
    # (ModelLoader.cpp:568 + Raytracer.cpp:134) and looks along -z, so place
    # the node at z=-2.5 to end up at +2.5 facing the sphere at the origin
    b.add_node(camera=cam, translation=[0.0, 0.0, -2.5])
    return b.write(path)


def write_lantern_like_scene(path: str) -> str:
    """Lantern analogue: multi-node scene graph with nested transforms and an
    emissive material (BASELINE.json config 3)."""
    b = GLTFBuilder()
    p, n, uv, idx = _box_mesh()
    body = b.add_material(base_color=(0.3, 0.3, 0.35, 1.0), roughness=0.6)
    glow = b.add_material(base_color=(1.0, 0.9, 0.7, 1.0), emissive=(1.0, 0.8, 0.5))
    mesh_body = b.add_mesh(p, n, uv, idx, material=body)
    mesh_glow = b.add_mesh(p, n, uv, idx, material=glow)
    # pole with a hanging glowing box, plus ground
    glow_node = b.add_node(mesh=mesh_glow, translation=[0, 1.5, 0],
                           scale=[0.3, 0.3, 0.3], root=False)
    pole = b.add_node(mesh=mesh_body, translation=[0, 0.5, 0], scale=[0.1, 2.0, 0.1],
                      children=[glow_node])
    # ground: a thin unrotated box (a rotated quad would be garbled by the
    # reference's shifted-quaternion quirk that this loader replicates)
    ground_mat = b.add_material(base_color=(0.5, 0.5, 0.5, 1.0))
    ground = b.add_mesh(p, n, uv, idx.astype(np.uint8), material=ground_mat)
    b.add_node(mesh=ground, translation=[0, 3.3, 0], scale=[20, 0.1, 20])
    return b.write(path)


def quirk_rotation(x, y, z, w):
    """glTF rotation array that loads as the INTENDED quaternion (x,y,z,w)
    under the reference's shifted-quaternion read, which this repo's
    loader replicates (ModelLoader.cpp:521-522 constructs glm::quat(w,x,
    y,z) but feeds it the glTF (x,y,z,w) array, so element 0 lands in w).
    Authoring [w,x,y,z] pre-compensates the shift. Scenes targeting the
    reference renderer must be authored this way or rotated nodes land in
    unintended poses — round 4's independent-oracle parity test caught
    write_sponza_like_scene's floor and ceiling collapsing into one
    coplanar z-fighting plane because its rotations were standard-glTF."""
    return [w, x, y, z]


def write_sponza_like_scene(path: str, columns=6, foliage=24, seed=3,
                            stacks=4, segments=20, rings=14) -> str:
    """Sponza-scale analogue: an interior atrium with many geometries and
    alpha-tested foliage quads (BASELINE.json config 4). Triangle count
    scales with columns * stacks * segments * rings (columns=12, stacks=8,
    segments=28, rings=20 gives ~260k — the real Sponza's scale).

    Rotations are authored via `quirk_rotation` so the loaded poses match
    the intent: floor plane at y=0, ceiling plane at y=-8 (loaded coords),
    enclosing the walls' y in [-8, 0] span. Before round 4 the raw
    rotations collapsed both quads into one coplanar z=0 slab through the
    shifted-quaternion quirk — a degenerate z-fighting fixture whose
    closest-hit winner is tie-order-dependent."""
    rng = np.random.RandomState(seed)
    b = GLTFBuilder()
    sp, sn, suv, sidx = _uv_sphere(segments, rings, 0.5)
    bp, bn, buv, bidx = _box_mesh()
    qp, qn, quv, qidx = _quad_mesh()

    wall = b.add_material(base_color=(0.7, 0.65, 0.6, 1.0), roughness=0.9)
    floor_img = np.zeros((32, 32, 4), np.uint8)
    yy, xx = np.mgrid[0:32, 0:32]
    floor_img[..., :3] = np.where((((xx // 8) + (yy // 8)) % 2 == 0)[..., None], 180, 90)
    floor_img[..., 3] = 255
    t_floor = b.add_texture(floor_img, sampler={"wrapS": 10497, "wrapT": 10497})
    floor_mat = b.add_material(base_color_texture=t_floor, roughness=0.8)
    column_mat = b.add_material(base_color=(0.75, 0.7, 0.65, 1.0), roughness=0.5,
                                metallic=0.1)
    # foliage: leaf texture with alpha holes, MASK mode
    leaf = np.zeros((32, 32, 4), np.uint8)
    cy, cx = np.mgrid[0:32, 0:32]
    inside = ((cx - 16) ** 2 / 180.0 + (cy - 16) ** 2 / 90.0) < 1.0
    leaf[inside] = [40, 140, 50, 255]
    leaf[~inside] = [0, 0, 0, 0]
    t_leaf = b.add_texture(leaf)
    leaf_mat = b.add_material(base_color_texture=t_leaf, alpha_mode="MASK",
                              alpha_cutoff=0.5, roughness=1.0)

    mesh_floor = b.add_mesh(qp, qn, quv * 8.0, qidx, material=floor_mat)
    mesh_wall = b.add_mesh(bp, bn, buv, bidx, material=wall)
    mesh_col = b.add_mesh(sp, sn, suv, sidx, material=column_mat)
    mesh_leaf = b.add_mesh(qp, qn, quv, qidx.astype(np.uint32), material=leaf_mat)

    # floor + ceiling: intended rot_x(∓90°) — floor quad normal loads as
    # -y (up: the scene's inhabited span is y in [-8, 0] after the y-flip),
    # ceiling at translation [0,8,0] loads at y=-8 facing +y
    b.add_node(mesh=mesh_floor,
               rotation=quirk_rotation(-0.7071068, 0, 0, 0.7071068),
               scale=[30, 20, 1])
    b.add_node(mesh=mesh_floor,
               rotation=quirk_rotation(0.7071068, 0, 0, 0.7071068),
               translation=[0, 8, 0], scale=[30, 20, 1])
    # walls
    b.add_node(mesh=mesh_wall, translation=[0, 4, -10], scale=[30, 8, 0.5])
    b.add_node(mesh=mesh_wall, translation=[0, 4, 10], scale=[30, 8, 0.5])
    b.add_node(mesh=mesh_wall, translation=[-15, 4, 0], scale=[0.5, 8, 20])
    b.add_node(mesh=mesh_wall, translation=[15, 4, 0], scale=[0.5, 8, 20])
    # columns (spheres stacked)
    for i in range(columns):
        x = -12 + 24 * i / max(columns - 1, 1)
        for z in (-6.0, 6.0):
            for y in range(stacks):
                b.add_node(mesh=mesh_col, translation=[x, 0.5 + y * 7.0 / stacks, z],
                           scale=[1.0, 1.0, 1.0])
    # foliage quads at random poses
    for _ in range(foliage):
        pos = [float(rng.uniform(-12, 12)), float(rng.uniform(0.5, 5.0)),
               float(rng.uniform(-8, 8))]
        ang = float(rng.uniform(0, np.pi))
        rot = quirk_rotation(0.0, float(np.sin(ang / 2)), 0.0,
                             float(np.cos(ang / 2)))  # intended rot_y(ang)
        b.add_node(mesh=mesh_leaf, translation=pos, rotation=rot,
                   scale=[1.5, 1.5, 1.5])
    cam = b.add_camera()
    b.add_node(camera=cam, translation=[0.0, -2.0, 0.0])
    return b.write(path)
