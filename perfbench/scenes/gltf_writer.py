"""The benchmark's frozen glTF writer: builds a scene once as a glTF 2.0
file for the program and once as plain world-space arrays for the
reference (`SceneArrays`). Nothing here imports the program.

The builder is a copy of the procedural writer the repository's sample
scenes come from (a minimal glTF 2.0 document with one embedded base64
buffer and embedded PNG images). Its PNG encoder writes filter type 0
rows and zlib level 6: any decoder reads the same pixels.

`SceneArrays` applies the loader semantics of the original renderer
(its ModelLoader), which the program follows too:

- a node's matrix is coordFlip @ T @ R @ S with coordFlip = diag(1, -1,
  1, 1);
- R comes from the glTF rotation read positionally as a (w, x, y, z)
  quaternion, multiplied by the parent's rotation, which for a root node
  is the loader's "identity" (w, x, y, z) = (0, 0, 0, 1), a 180-degree
  turn about z; a node without a rotation takes that identity alone;
- normals go through coordFlip @ R, tangents and uvs stay as written;
- a declared sampler filters NEAREST, the fallback sampler LINEAR, both
  with the declared (default REPEAT) wraps;
- an image is sRGB unless a normal map uses it;
- a material's alpha test is on unless alphaMode is OPAQUE, with
  alphaCutoff (default 0.5) as the cutoff; untextured emission is scaled
  at shading time, not here.

Only root nodes are written (no children), so no transform is
inherited.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
import zlib
from typing import List, Optional

import numpy as np

NO_TEXTURE = 0xFFFF
WRAP_REPEAT, WRAP_MIRRORED_REPEAT, WRAP_CLAMP_TO_EDGE = 0, 1, 2
FILTER_NEAREST, FILTER_LINEAR = 0, 1
_WRAP_OF_GL = {10497: WRAP_REPEAT, 33648: WRAP_MIRRORED_REPEAT, 33071: WRAP_CLAMP_TO_EDGE}


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 4) uint8 RGBA -> PNG bytes (filter 0 on every row)."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = img.shape
    if c != 4:
        raise ValueError(f"expected (H, W, 4) uint8, got {img.shape}")
    rows = np.zeros((h, 1 + w * 4), np.uint8)
    rows[:, 1:] = img.reshape(h, w * 4)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def box_mesh(size=1.0):
    """24-vertex, 12-triangle cube (the Khronos Box layout)."""
    s = size / 2.0
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
    return (np.asarray(positions, np.float32), np.asarray(normals, np.float32),
            np.asarray(uvs, np.float32), np.asarray(indices, np.uint16))


def quad_mesh():
    positions = np.array([(-0.5, -0.5, 0), (0.5, -0.5, 0), (0.5, 0.5, 0), (-0.5, 0.5, 0)],
                         np.float32)
    normals = np.array([(0, 0, 1)] * 4, np.float32)
    uvs = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    return positions, normals, uvs, indices


def uv_sphere(segments=16, rings=12, radius=0.5):
    """A UV sphere of 2 * segments * rings triangles (the pole rows are
    degenerate, as in the original writer)."""
    r = np.arange(rings + 1, dtype=np.float64)[:, None]
    s = np.arange(segments + 1, dtype=np.float64)[None, :]
    theta = np.pi * r / rings
    phi = 2 * np.pi * s / segments
    n = np.stack(np.broadcast_arrays(np.sin(theta) * np.cos(phi), np.cos(theta),
                                     np.sin(theta) * np.sin(phi)), axis=-1).reshape(-1, 3)
    uv = np.stack(np.broadcast_arrays(s / segments, r / rings), axis=-1).reshape(-1, 2)
    positions = (radius * n).astype(np.float32)
    a = (np.arange(rings)[:, None] * (segments + 1) + np.arange(segments)[None, :]).reshape(-1)
    b = a + segments + 1
    indices = np.stack([a, b, a + 1, a + 1, b, b + 1], axis=-1).reshape(-1)
    return positions, n.astype(np.float32), uv.astype(np.float32), indices.astype(np.uint32)


def quirk_rotation(x, y, z, w):
    """The glTF rotation array that the loader reads as the intended
    quaternion (x, y, z, w): it reads element 0 as w."""
    return [w, x, y, z]


@dataclasses.dataclass
class SceneArrays:
    """What the reference reads: world-space triangles with their
    attributes, materials and raw RGBA8 textures."""

    tri_pos: np.ndarray       # (T, 3, 3) f32
    tri_normal: np.ndarray    # (T, 3, 3) f32, through coordFlip @ R
    tri_tangent: np.ndarray   # (T, 3, 4) f32, as written
    tri_uv: np.ndarray        # (T, 3, 2) f32
    tri_mat: np.ndarray       # (T,) i32
    mat_albedo: np.ndarray    # (M, 3) f32 baseColorFactor rgb
    mat_roughness: np.ndarray  # (M,) f32
    mat_normal_scale: np.ndarray  # (M,) f32 (0 without a normal texture)
    mat_emissive: np.ndarray  # (M, 3) f32
    mat_cutoff: np.ndarray    # (M,) f32
    mat_alpha_tested: np.ndarray  # (M,) bool
    mat_tex: np.ndarray       # (M, 4) i32 albedo, metallic-roughness, normal, emissive
    textures: list            # [(rgba (H, W, 4) u8, filter, wrap_s, wrap_t, srgb)]


class GLTFBuilder:
    """Assemble a glTF 2.0 document with an embedded base64 buffer, and
    keep what it holds for `arrays()`."""

    def __init__(self):
        self.blob = bytearray()
        self.buffer_views, self.accessors, self.meshes, self.nodes = [], [], [], []
        self.materials, self.textures, self.images, self.samplers = [], [], [], []
        self.cameras, self.scene_nodes = [], []
        self._mesh_data: List[tuple] = []
        self._images: List[np.ndarray] = []

    def _add_accessor(self, arr, target, type_str, comp_type, minmax=False):
        arr = np.ascontiguousarray(arr)
        offset = len(self.blob)
        self.blob.extend(arr.tobytes())
        while len(self.blob) % 4:
            self.blob.append(0)
        self.buffer_views.append({"buffer": 0, "byteOffset": offset, "byteLength": arr.nbytes,
                                  **({"target": target} if target else {})})
        acc = {"bufferView": len(self.buffer_views) - 1, "componentType": comp_type,
               "count": int(arr.shape[0]), "type": type_str}
        if minmax:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_mesh(self, positions, normals, uvs, indices, tangents=None, material=0):
        comp = {np.dtype(np.uint8): 5121, np.dtype(np.uint16): 5123,
                np.dtype(np.uint32): 5125}[indices.dtype]
        attrs = {"POSITION": self._add_accessor(positions, 34962, "VEC3", 5126, minmax=True),
                 "NORMAL": self._add_accessor(normals, 34962, "VEC3", 5126)}
        if tangents is not None:
            attrs["TANGENT"] = self._add_accessor(tangents, 34962, "VEC4", 5126)
        attrs["TEXCOORD_0"] = self._add_accessor(uvs, 34962, "VEC2", 5126)
        prim = {"attributes": attrs,
                "indices": self._add_accessor(indices.reshape(-1, 1), 34963, "SCALAR", comp),
                "material": material}
        self.meshes.append({"primitives": [prim]})
        self._mesh_data.append((positions, normals, uvs, indices.astype(np.int64),
                                tangents, material))
        return len(self.meshes) - 1

    def add_material(self, base_color=(1, 1, 1, 1), metallic=0.0, roughness=1.0,
                     emissive=(0, 0, 0), alpha_mode="OPAQUE", alpha_cutoff=None,
                     base_color_texture=None, mr_texture=None, normal_texture=None,
                     emissive_texture=None, normal_scale=1.0, occlusion_texture=None):
        m = {"pbrMetallicRoughness": {"baseColorFactor": list(base_color),
                                      "metallicFactor": metallic,
                                      "roughnessFactor": roughness},
             "emissiveFactor": list(emissive)}
        if base_color_texture is not None:
            m["pbrMetallicRoughness"]["baseColorTexture"] = {"index": base_color_texture}
        if mr_texture is not None:
            m["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {"index": mr_texture}
        if normal_texture is not None:
            m["normalTexture"] = {"index": normal_texture, "scale": normal_scale}
        if emissive_texture is not None:
            m["emissiveTexture"] = {"index": emissive_texture}
        if occlusion_texture is not None:
            m["occlusionTexture"] = {"index": occlusion_texture}
        if alpha_mode != "OPAQUE":
            m["alphaMode"] = alpha_mode
        if alpha_cutoff is not None:
            m["alphaCutoff"] = alpha_cutoff
        self.materials.append(m)
        return len(self.materials) - 1

    def add_texture(self, image_rgba: np.ndarray, sampler: Optional[dict] = None):
        img = np.ascontiguousarray(image_rgba, np.uint8)
        uri = "data:image/png;base64," + base64.b64encode(encode_png(img)).decode()
        self.images.append({"uri": uri})
        self._images.append(img)
        tex = {"source": len(self.images) - 1}
        if sampler is not None:
            self.samplers.append(sampler)
            tex["sampler"] = len(self.samplers) - 1
        self.textures.append(tex)
        return len(self.textures) - 1

    def add_node(self, mesh=None, translation=None, rotation=None, scale=None, camera=None):
        node = {}
        for key, val in (("mesh", mesh), ("camera", camera)):
            if val is not None:
                node[key] = val
        for key, val in (("translation", translation), ("rotation", rotation),
                         ("scale", scale)):
            if val is not None:
                node[key] = [float(x) for x in val]
        self.nodes.append(node)
        self.scene_nodes.append(len(self.nodes) - 1)
        return len(self.nodes) - 1

    def add_camera(self, yfov=0.7853981, znear=0.01, zfar=1000.0):
        self.cameras.append({"type": "perspective",
                             "perspective": {"yfov": yfov, "znear": znear, "zfar": zfar}})
        return len(self.cameras) - 1

    def write(self, path: str) -> str:
        doc = {"asset": {"version": "2.0", "generator": "perfbench"}, "scene": 0,
               "scenes": [{"nodes": self.scene_nodes}], "nodes": self.nodes,
               "meshes": self.meshes, "accessors": self.accessors,
               "bufferViews": self.buffer_views,
               "buffers": [{"byteLength": len(self.blob),
                            "uri": "data:application/octet-stream;base64,"
                                   + base64.b64encode(bytes(self.blob)).decode()}]}
        for key in ("materials", "textures", "images", "samplers", "cameras"):
            if getattr(self, key):
                doc[key] = getattr(self, key)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    # ---- the reference's view of the same scene ---------------------------

    def arrays(self) -> SceneArrays:
        pos, nrm, tan, uv, mat = [], [], [], [], []
        for node in self.nodes:
            if "mesh" not in node:
                continue
            p, n, u, idx, t, m = self._mesh_data[node["mesh"]]
            world, normal_m = node_matrices(node)
            tri = idx.reshape(-1, 3)
            ph = np.concatenate([p.astype(np.float64), np.ones((p.shape[0], 1))], axis=1)
            pw = (ph @ world.astype(np.float64).T)[:, :3].astype(np.float32)
            nw = (n.astype(np.float64) @ normal_m.astype(np.float64).T).astype(np.float32)
            pos.append(pw[tri])
            nrm.append(nw[tri])
            uv.append(u[tri])
            tan.append(t[tri] if t is not None else np.zeros((tri.shape[0], 3, 4), np.float32))
            mat.append(np.full(tri.shape[0], m, np.int32))
        mats = self.materials
        tex_of = {}
        normal_images = set()
        for m in mats:
            if "normalTexture" in m:
                normal_images.add(self.textures[m["normalTexture"]["index"]]["source"])
        textures = []
        for i, tex in enumerate(self.textures):
            smp = self.samplers[tex["sampler"]] if "sampler" in tex else None
            textures.append((self._images[tex["source"]],
                             FILTER_NEAREST if smp is not None else FILTER_LINEAR,
                             _WRAP_OF_GL[(smp or {}).get("wrapS", 10497)],
                             _WRAP_OF_GL[(smp or {}).get("wrapT", 10497)],
                             tex["source"] not in normal_images))
            tex_of[i] = i

        def tex_index(ref):
            return NO_TEXTURE if ref is None else tex_of[ref["index"]]

        pbr = [m["pbrMetallicRoughness"] for m in mats]
        return SceneArrays(
            tri_pos=np.concatenate(pos), tri_normal=np.concatenate(nrm),
            tri_tangent=np.concatenate(tan).astype(np.float32),
            tri_uv=np.concatenate(uv).astype(np.float32), tri_mat=np.concatenate(mat),
            mat_albedo=np.array([p["baseColorFactor"][:3] for p in pbr], np.float32),
            mat_roughness=np.array([p["roughnessFactor"] for p in pbr], np.float32),
            mat_normal_scale=np.array([m["normalTexture"]["scale"] if "normalTexture" in m
                                       else 0.0 for m in mats], np.float32),
            mat_emissive=np.array([m["emissiveFactor"] for m in mats], np.float32),
            mat_cutoff=np.array([m.get("alphaCutoff", 0.5) for m in mats], np.float32),
            mat_alpha_tested=np.array([m.get("alphaMode", "OPAQUE") != "OPAQUE"
                                       for m in mats]),
            mat_tex=np.array([[tex_index(p.get("baseColorTexture")),
                               tex_index(p.get("metallicRoughnessTexture")),
                               tex_index(m.get("normalTexture")),
                               tex_index(m.get("emissiveTexture"))]
                              for p, m in zip(pbr, mats)], np.int32).reshape(-1, 4),
            textures=textures)


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], np.float32)


def _quat_to_mat3(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                    np.float32)


def node_matrices(node: dict):
    """(world 4x4, normal 3x3) of a root node, in float32 as the loader
    forms them."""
    identity = np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # (w, x, y, z)
    q = (_quat_mul(np.asarray(node["rotation"], np.float32), identity)
         if "rotation" in node else identity)
    rot = _quat_to_mat3(q)
    flip = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = node.get("translation", [0.0, 0.0, 0.0])
    s = np.diag(np.append(np.asarray(node.get("scale", [1.0, 1.0, 1.0]), np.float32),
                          1.0)).astype(np.float32)
    r = np.eye(4, dtype=np.float32)
    r[:3, :3] = rot
    return flip @ t @ r @ s, (flip[:3, :3] @ rot).astype(np.float32)
