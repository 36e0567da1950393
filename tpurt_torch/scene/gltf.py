"""glTF 2.0 scene ingestion, replicating the reference ModelLoader semantics
(the port's copy of tpurt/scene/gltf.py; images decode through
tpurt_torch/utils/png.py instead of Pillow).

This replaces the cgltf + stb_image C path (src/util/ModelLoader.cpp, 1026
LoC) with a pure-Python parser feeding NumPy arrays. Behavioral parity points
(each cites the reference):

- multi-file loading with per-file global material/sampler/image/texture
  index offsets (ModelLoader.cpp:132-161)
- default scene if present, else all scenes (ModelLoader.cpp:94-100)
- two-pass ingest: count/flatten transforms, then copy packed arrays with
  accessor de-duplication (ModelLoader.cpp:489-663, 671-831)
- the reference's *component-wise* TRS flattening: child translations add
  un-rotated and un-scaled, scales multiply component-wise, and a node
  without its own rotation does NOT inherit the parent rotation for its
  matrix (ModelLoader.cpp:498-522)
- the shifted quaternion construction: glTF stores (x, y, z, w) but the
  reference constructs glm::quat(w=x, x=y, y=z, z=w) (ModelLoader.cpp:520-521),
  so an identity glTF rotation becomes a 180-degree Z rotation
- the Y-flip coordinate convention matrix (ModelLoader.cpp:540-545)
- index widening u8/u16 -> u32 (ModelLoader.cpp:753-781)
- material table incl. blend-mode alpha cutoff 0.9 (ModelLoader.cpp:877),
  emissive strength (:879-883), packed texture indices with 65535 = none
- camera extraction (ModelLoader.cpp:555-573) with z negation, plus the
  renderer-side y negation (Raytracer.cpp:130-136) applied by
  `SceneData.camera` consumers via `camera_for_render`
- sRGB vs UNORM image classification by normal-map usage (ModelLoader.cpp:922-926)
- sampler wrap modes; the magFilter-never-set quirk making glTF-declared
  samplers effectively NEAREST (ModelLoader.cpp:965-1026) while the fallback
  sampler is LINEAR (:119-125)
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpurt_torch.utils import png
from tpurt_torch.scene.types import (
    FILTER_LINEAR,
    FILTER_NEAREST,
    HostCamera,
    HostGeometry,
    HostImage,
    HostMaterial,
    HostTexture,
    SceneData,
    WRAP_CLAMP_TO_EDGE,
    WRAP_MIRRORED_REPEAT,
    WRAP_REPEAT,
)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16}

# The reference "identity" quaternion: glm::quat(0,0,0,1) = w=0,x=0,y=0,z=1
# (ModelLoader.cpp:492,502), a 180-degree rotation about Z.
_REF_IDENTITY_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # (w, x, y, z)

_COORD_FLIP = np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32)  # ModelLoader.cpp:540-545


def _quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product in (w, x, y, z) order (glm operator*)."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        np.float32,
    )


def _quat_to_mat3(q: np.ndarray) -> np.ndarray:
    """glm::mat3_cast for a (w, x, y, z) quaternion (not necessarily unit;
    glm does not normalize and neither does the reference)."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def _shifted_quat(gltf_rotation) -> np.ndarray:
    """Reference quirk (ModelLoader.cpp:520-521): glTF (x,y,z,w) components
    are fed positionally into glm::quat(w, x, y, z)."""
    r = np.asarray(gltf_rotation, np.float32)
    return np.array([r[0], r[1], r[2], r[3]], np.float32)  # (w,x,y,z) := (x,y,z,w) values


class _GLTFFile:
    """One parsed glTF/GLB file with resolved buffers."""

    def __init__(self, path: str):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            blob = f.read()
        self.bin_chunk: Optional[bytes] = None
        if blob[:4] == b"glTF":
            magic, version, length = struct.unpack_from("<III", blob, 0)
            offset = 12
            gltf_json = None
            while offset < length:
                chunk_len, chunk_type = struct.unpack_from("<II", blob, offset)
                chunk = blob[offset + 8 : offset + 8 + chunk_len]
                if chunk_type == 0x4E4F534A:  # 'JSON'
                    gltf_json = chunk
                elif chunk_type == 0x004E4942:  # 'BIN\0'
                    self.bin_chunk = chunk
                offset += 8 + chunk_len
            self.json = json.loads(gltf_json)
        else:
            self.json = json.loads(blob)
        self._buffers: Dict[int, bytes] = {}

    def buffer(self, index: int) -> bytes:
        if index not in self._buffers:
            spec = self.json["buffers"][index]
            uri = spec.get("uri")
            if uri is None:
                data = self.bin_chunk
            elif uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.dir, uri), "rb") as f:
                    data = f.read()
            self._buffers[index] = data
        return self._buffers[index]

    def accessor_array(self, accessor_index: int) -> np.ndarray:
        """Decode an accessor to (count, ncomp) with native dtype.

        Handles byteStride (interleaved) views and sparse accessors
        (substitution applied over the base view — or zeros when the
        accessor has no bufferView — matching cgltf_load_buffers semantics,
        the reference's decode path at ModelLoader.cpp:753-781)."""
        acc = self.json["accessors"][accessor_index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        if "bufferView" not in acc:
            base = np.zeros((count, ncomp), dtype)
        else:
            base = self._decode_view(acc["bufferView"], acc.get("byteOffset", 0),
                                     count, ncomp, dtype)
        if "sparse" in acc:
            sp = acc["sparse"]
            n = sp["count"]
            idx_spec = sp["indices"]
            idx_dtype = _COMPONENT_DTYPES[idx_spec["componentType"]]
            idx = self._decode_view(idx_spec["bufferView"],
                                    idx_spec.get("byteOffset", 0), n, 1,
                                    idx_dtype).reshape(-1).astype(np.int64)
            val_spec = sp["values"]
            vals = self._decode_view(val_spec["bufferView"],
                                     val_spec.get("byteOffset", 0), n, ncomp,
                                     dtype)
            if idx.size and (idx.min() < 0 or idx.max() >= count):
                raise ValueError("sparse accessor index out of range")
            base = base.copy()
            base[idx] = vals
        return base

    def _decode_view(self, view_index: int, acc_offset: int, count: int,
                     ncomp: int, dtype) -> np.ndarray:
        """Decode (count, ncomp) elements from a bufferView (byteStride
        aware; native C fast path for packed f32)."""
        itemsize = np.dtype(dtype).itemsize
        view = self.json["bufferViews"][view_index]
        data = self.buffer(view["buffer"])
        start = view.get("byteOffset", 0) + acc_offset
        stride = view.get("byteStride", ncomp * itemsize)
        if stride == ncomp * itemsize:
            arr = np.frombuffer(data, dtype, count=count * ncomp, offset=start)
            return arr.reshape(count, ncomp)
        # a malformed file raises here instead of reading out of bounds
        if count < 0 or stride < 0 or start < 0:
            raise ValueError(f"negative accessor params: count={count} "
                             f"stride={stride} offset={start}")
        if count > 0 and start + (count - 1) * stride + ncomp * itemsize > len(data):
            raise ValueError(f"accessor out of bounds: count={count} "
                             f"ncomp={ncomp} stride={stride} offset={start}, "
                             f"buffer has {len(data)} bytes")
        # strided view (glTF guarantees offsets/strides aligned to the
        # component size) — no Python loop
        total = (count - 1) * (stride // itemsize) + ncomp
        flat = np.frombuffer(data, dtype, count=total, offset=start)
        view = np.lib.stride_tricks.as_strided(
            flat, shape=(count, ncomp), strides=(stride, itemsize))
        return np.ascontiguousarray(view)

    def image_bytes(self, image_index: int) -> bytes:
        img = self.json["images"][image_index]
        if "bufferView" in img:
            view = self.json["bufferViews"][img["bufferView"]]
            data = self.buffer(view["buffer"])
            start = view.get("byteOffset", 0)
            return data[start : start + view["byteLength"]]
        uri = img["uri"]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(self.dir, uri), "rb") as f:
            return f.read()


class _Loader:
    def __init__(self):
        self.geometries: List[HostGeometry] = []
        self.materials: List[HostMaterial] = []
        self.textures: List[HostTexture] = []
        self.images: List[HostImage] = []
        self.camera = HostCamera()
        self.positions: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.indices: List[np.ndarray] = []
        self.bounds_min = np.full(3, 3e38, np.float32)
        self.bounds_max = np.full(3, -3e38, np.float32)
        # global per-file offsets (ModelLoader.cpp:155-158)
        self.material_offset = 0
        self.image_offset = 0
        self.texture_offset = 0
        # accessor dedup maps keyed by (file id, accessor index)
        self._vertex_accessors: Dict[Tuple[int, int], int] = {}
        self._index_accessors: Dict[Tuple[int, int], int] = {}
        # element-count cursors for each packed array
        self._pos_cursor = 0
        self._normal_cursor = 0
        self._tangent_cursor = 0
        self._uv_cursor = 0
        self._index_cursor = 0
        # images that are referenced by a normal-map texture slot get UNORM
        # treatment (ModelLoader.cpp:791-794, 922-926)
        self.normal_usage: Dict[int, bool] = {}

    # ---- pass over nodes -------------------------------------------------

    def add_file(self, file_id: int, f: _GLTFFile):
        scenes = f.json.get("scenes", [])
        default = f.json.get("scene")
        scene_ids = [default] if default is not None else list(range(len(scenes)))
        for sid in scene_ids:
            for node_id in scenes[sid].get("nodes", []):
                self._add_node(
                    file_id,
                    f,
                    node_id,
                    np.zeros(3, np.float32),
                    _REF_IDENTITY_QUAT.copy(),
                    np.ones(3, np.float32),
                )

    def _add_node(self, file_id, f, node_id, parent_t, parent_r, parent_s):
        node = f.json["nodes"][node_id]
        # component-wise TRS accumulation (ModelLoader.cpp:501-522)
        local_t = parent_t.copy()
        local_r = _REF_IDENTITY_QUAT.copy()
        local_s = parent_s.copy()
        if "scale" in node:
            local_s = local_s * np.asarray(node["scale"], np.float32)
        if "translation" in node:
            local_t = local_t + np.asarray(node["translation"], np.float32)
        if "rotation" in node:
            local_r = _quat_mul(_shifted_quat(node["rotation"]), parent_r)

        rot3 = _quat_to_mat3(local_r)
        t_mat = np.eye(4, dtype=np.float32)
        t_mat[:3, 3] = local_t
        s_mat = np.diag(np.append(local_s, 1.0)).astype(np.float32)
        r_mat = np.eye(4, dtype=np.float32)
        r_mat[:3, :3] = rot3
        transform = _COORD_FLIP @ t_mat @ r_mat @ s_mat          # ModelLoader.cpp:553
        no_rotation_transform = _COORD_FLIP @ t_mat @ s_mat      # ModelLoader.cpp:552
        normal_transform = (_COORD_FLIP[:3, :3] @ rot3).astype(np.float32)  # :550

        if "camera" in node:
            cam = f.json["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                r4 = np.eye(4, dtype=np.float32)
                r4[:3, :3] = rot3
                base_dir = (r4 @ np.array([0, 0, -1, 0], np.float32))[:3]
                base_right = (r4 @ np.array([1, 0, 0, 0], np.float32))[:3]
                self.camera = HostCamera(
                    position=np.array(
                        [local_t[0], local_t[1], -local_t[2]], np.float32
                    ),  # z negation, ModelLoader.cpp:568
                    direction=base_dir.astype(np.float32),
                    right=base_right.astype(np.float32),
                    fov=float(cam["perspective"].get("yfov", 0.0)),
                    znear=float(cam["perspective"].get("znear", 0.0)),
                    zfar=float(cam["perspective"].get("zfar", 10000.0)),
                )

        if "mesh" in node:
            mesh = f.json["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:  # triangles only (ModelLoader.cpp:582-585)
                    continue
                geom = self._ingest_primitive(
                    file_id, f, prim, transform, no_rotation_transform, normal_transform
                )
                self.geometries.append(geom)

        for child in node.get("children", []):
            self._add_node(file_id, f, child, local_t, local_r, local_s)

    def _copy_accessor(self, file_id, f, acc_index, kind) -> Tuple[int, int]:
        """Copy (or reuse) a vertex-attribute accessor into the packed array
        for `kind`. Returns (element offset, element count). Replicates the
        CopiedAccessor dedup (ModelLoader.cpp:683-745)."""
        key = (file_id, acc_index)
        if key in self._vertex_accessors:
            acc = f.json["accessors"][acc_index]
            return self._vertex_accessors[key], acc["count"]
        arr = f.accessor_array(acc_index).astype(np.float32)
        if kind == "position":
            offset = self._pos_cursor
            self.positions.append(arr[:, :3])
            self._pos_cursor += arr.shape[0]
        elif kind == "normal":
            offset = self._normal_cursor
            self.normals.append(arr[:, :3])
            self._normal_cursor += arr.shape[0]
        elif kind == "tangent":
            offset = self._tangent_cursor
            self.tangents.append(arr[:, :4])
            self._tangent_cursor += arr.shape[0]
        elif kind == "uv":
            offset = self._uv_cursor
            self.uvs.append(arr[:, :2])
            self._uv_cursor += arr.shape[0]
        else:
            raise ValueError(kind)
        self._vertex_accessors[key] = offset
        return offset, arr.shape[0]

    def _ingest_primitive(self, file_id, f, prim, transform, no_rot_transform, normal_transform):
        attrs = prim.get("attributes", {})
        geom = HostGeometry(
            transform=transform,
            normal_transform=normal_transform,
            aabb_min=np.zeros(3, np.float32),
            aabb_max=np.zeros(3, np.float32),
            vertex_offset=0,
            uv_offset=0,
            normal_offset=0,
            tangent_offset=0,
            index_offset=0,
            vertex_count=0,
            index_count=0,
            material_index=0,
            is_alpha_tested=False,
        )

        pos_acc = attrs.get("POSITION")
        if pos_acc is None:
            raise ValueError("primitive without POSITION")
        geom.vertex_offset, geom.vertex_count = self._copy_accessor(file_id, f, pos_acc, "position")
        acc = f.json["accessors"][pos_acc]
        # world AABB from accessor min/max through the no-rotation transform
        # (ModelLoader.cpp:600-651; note the reference transforms the two
        # corners only, so rotated geometry AABBs are approximate by design)
        amin = np.asarray(acc.get("min", [0, 0, 0]), np.float32)
        amax = np.asarray(acc.get("max", [0, 0, 0]), np.float32)
        tmin = (no_rot_transform @ np.append(amin, 1.0))[:3]
        tmax = (no_rot_transform @ np.append(amax, 1.0))[:3]
        geom.aabb_min, geom.aabb_max = tmin, tmax
        self.bounds_min = np.minimum(self.bounds_min, tmin)
        self.bounds_max = np.maximum(self.bounds_max, tmax)

        if "NORMAL" in attrs:
            geom.normal_offset, _ = self._copy_accessor(file_id, f, attrs["NORMAL"], "normal")
            geom.has_normals = True
        if "TANGENT" in attrs:
            geom.tangent_offset, _ = self._copy_accessor(file_id, f, attrs["TANGENT"], "tangent")
            geom.has_tangents = True
        if "TEXCOORD_0" in attrs:
            geom.uv_offset, _ = self._copy_accessor(file_id, f, attrs["TEXCOORD_0"], "uv")
            geom.has_uvs = True

        # indices with u8/u16 -> u32 widening + dedup (ModelLoader.cpp:748-788)
        idx_acc = prim["indices"]
        key = (file_id, idx_acc)
        acc = f.json["accessors"][idx_acc]
        geom.index_count = acc["count"]
        if key in self._index_accessors:
            geom.index_offset = self._index_accessors[key]
        else:
            arr = f.accessor_array(idx_acc).reshape(-1).astype(np.uint32)
            geom.index_offset = self._index_cursor
            self.indices.append(arr)
            self._index_cursor += arr.shape[0]
            self._index_accessors[key] = geom.index_offset

        if "material" in prim:
            mat = f.json["materials"][prim["material"]]
            geom.material_index = prim["material"] + self.material_offset
            geom.is_alpha_tested = mat.get("alphaMode", "OPAQUE") != "OPAQUE"
            norm_tex = mat.get("normalTexture", {}).get("index")
            if norm_tex is not None:
                tex = f.json["textures"][norm_tex]
                if "source" in tex:
                    self.normal_usage[tex["source"] + self.image_offset] = True
        return geom

    # ---- materials / textures / images ----------------------------------

    def add_material(self, f: _GLTFFile, mat: dict):
        """addMaterial (ModelLoader.cpp:833-886)."""
        m = HostMaterial()
        unsupported = any(
            k in mat.get("extensions", {})
            for k in (
                "KHR_materials_clearcoat",
                "KHR_materials_pbrSpecularGlossiness",
                "KHR_materials_sheen",
                "KHR_materials_transmission",
                "KHR_materials_volume",
            )
        )
        if unsupported:
            pass  # reference leaves the material zeroed (black) in this case
        else:
            # cgltf sets has_pbr_metallic_roughness for any core material
            # (the pbrMetallicRoughness object has spec defaults), so the
            # reference path (ModelLoader.cpp:844) runs for every
            # non-extension material.
            pbr = mat.get("pbrMetallicRoughness") or {}
            ext = mat.get("extensions", {})
            if "KHR_materials_ior" in ext:
                m.ior = float(ext["KHR_materials_ior"].get("ior", 1.5))
            if "normalTexture" in mat:
                m.normal_texture = mat["normalTexture"]["index"] + self.texture_offset
                m.normal_map_factor = float(mat["normalTexture"].get("scale", 1.0))
            if "emissiveTexture" in mat:
                m.emissive_texture = mat["emissiveTexture"]["index"] + self.texture_offset
            if "baseColorTexture" in pbr:
                m.albedo_texture = pbr["baseColorTexture"]["index"] + self.texture_offset
            if "metallicRoughnessTexture" in pbr:
                m.metallic_roughness_texture = (
                    pbr["metallicRoughnessTexture"]["index"] + self.texture_offset
                )
            m.albedo_scale = tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]))
            emissive = list(mat.get("emissiveFactor", [0.0, 0.0, 0.0])) + [1.0]
            strength = ext.get("KHR_materials_emissive_strength", {}).get("emissiveStrength")
            if strength is not None:
                emissive = [emissive[0] * strength, emissive[1] * strength,
                            emissive[2] * strength, emissive[3]]
            m.emissive_factor = tuple(emissive)
            m.roughness_factor = float(pbr.get("roughnessFactor", 1.0))
            m.metallic_factor = float(pbr.get("metallicFactor", 1.0))
            # blend mode forces cutoff 0.9 (ModelLoader.cpp:877); otherwise
            # the glTF alphaCutoff with its spec default of 0.5 (cgltf
            # initializes alpha_cutoff to 0.5 like the spec).
            if mat.get("alphaMode") == "BLEND":
                m.alpha_cutoff = 0.9
            else:
                m.alpha_cutoff = float(mat.get("alphaCutoff", 0.5))
        self.materials.append(m)

    def add_texture(self, f: _GLTFFile, tex: dict):
        """addTexture + addSampler quirks (ModelLoader.cpp:888-899, 965-1026)."""
        image_index = tex.get("source", 0) + self.image_offset
        if "sampler" in tex:
            smp = f.json.get("samplers", [])[tex["sampler"]]
            wrap_map = {10497: WRAP_REPEAT, 33648: WRAP_MIRRORED_REPEAT, 33071: WRAP_CLAMP_TO_EDGE}
            self.textures.append(
                HostTexture(
                    image_index=image_index,
                    wrap_s=wrap_map.get(smp.get("wrapS", 10497), WRAP_REPEAT),
                    wrap_t=wrap_map.get(smp.get("wrapT", 10497), WRAP_REPEAT),
                    # magFilter is never assigned by the reference's sampler
                    # translation, so declared samplers are NEAREST at lod 0.
                    filter=FILTER_NEAREST,
                )
            )
        else:
            # fallback sampler: LINEAR + REPEAT (ModelLoader.cpp:119-125)
            self.textures.append(
                HostTexture(image_index=image_index, wrap_s=WRAP_REPEAT,
                            wrap_t=WRAP_REPEAT, filter=FILTER_LINEAR)
            )

    def add_image(self, f: _GLTFFile, image_global_index: int, local_index: int):
        """addImage (ModelLoader.cpp:901-963): decode to RGBA8; sRGB unless
        the image is used by a normal map."""
        rgba = png.decode_png(f.image_bytes(local_index))
        self.images.append(
            HostImage(data=rgba, srgb=not self.normal_usage.get(image_global_index, False))
        )


def load_gltf(filenames) -> SceneData:
    """Load one or more glTF/GLB files into a SceneData, mirroring
    ModelLoader::ModelLoader (ModelLoader.cpp:75-161)."""
    if isinstance(filenames, (str, os.PathLike)):
        filenames = [filenames]
    loader = _Loader()
    files = [_GLTFFile(str(p)) for p in filenames]
    # pass 1+2 fused per file: nodes (which also copies packed arrays and
    # marks normal-map image usage), then images, textures, materials in the
    # reference's per-file order (ModelLoader.cpp:132-161).
    for file_id, f in enumerate(files):
        loader.add_file(file_id, f)
        for i in range(len(f.json.get("images", []))):
            loader.add_image(f, i + loader.image_offset, i)
        for tex in f.json.get("textures", []):
            loader.add_texture(f, tex)
        for mat in f.json.get("materials", []):
            loader.add_material(f, mat)
        loader.material_offset += len(f.json.get("materials", []))
        loader.image_offset += len(f.json.get("images", []))
        loader.texture_offset += len(f.json.get("textures", []))

    def _cat(chunks, ncomp):
        if not chunks:
            return np.zeros((0, ncomp), np.float32)
        return np.concatenate(chunks, axis=0)

    return SceneData(
        positions=_cat(loader.positions, 3),
        normals=_cat(loader.normals, 3),
        tangents=_cat(loader.tangents, 4),
        uvs=_cat(loader.uvs, 2),
        indices=(np.concatenate(loader.indices) if loader.indices else np.zeros(0, np.uint32)),
        geometries=loader.geometries,
        materials=loader.materials,
        textures=loader.textures,
        images=loader.images,
        camera=loader.camera,
        model_bounds_min=loader.bounds_min,
        model_bounds_max=loader.bounds_max,
    )


def camera_for_render(cam: HostCamera):
    """Apply the renderer-side y negation (Raytracer.cpp:130-136) and build
    the runtime Camera."""
    import torch

    from tpurt_torch.camera import Camera

    flip = np.array([1.0, -1.0, 1.0], np.float32)
    return Camera(
        position=torch.from_numpy(np.asarray(cam.position * flip, np.float32)),
        direction=torch.from_numpy(np.asarray(cam.direction * flip, np.float32)),
        right=torch.from_numpy(np.asarray(cam.right * flip, np.float32)),
    )
