"""Scene data model: host-side numpy structures mirroring the reference's
packed buffers (the port's own copy of tpurt/scene/types.py, which is
pure numpy; the port imports nothing from tpurt).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

NO_TEXTURE = 0xFFFF  # reference encodes "no texture" as 65535 (triangle.rchit:162)

# Sampler wrap modes (glTF constants -> small enum)
WRAP_REPEAT = 0          # 0x2901
WRAP_MIRRORED_REPEAT = 1  # 0x8370
WRAP_CLAMP_TO_EDGE = 2   # 0x812F

FILTER_NEAREST = 0
FILTER_LINEAR = 1


@dataclasses.dataclass
class HostMaterial:
    """Mirror of reference `Material` (ModelLoader.hpp:77-94) with addMaterial
    semantics (ModelLoader.cpp:833-886)."""

    alpha_cutoff: float = 0.0
    albedo_scale: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    roughness_factor: float = 0.0
    metallic_factor: float = 0.0
    normal_map_factor: float = 0.0
    ior: float = 1.5
    emissive_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    albedo_texture: int = NO_TEXTURE
    metallic_roughness_texture: int = NO_TEXTURE
    emissive_texture: int = NO_TEXTURE
    normal_texture: int = NO_TEXTURE


@dataclasses.dataclass
class HostGeometry:
    """Mirror of reference `Geometry` (ModelLoader.hpp:46-63): one glTF
    primitive with its flattened world transform."""

    transform: np.ndarray         # (4,4) = coordFlip @ T @ R @ S (ModelLoader.cpp:553)
    normal_transform: np.ndarray  # (3,3) = (coordFlip @ R)[:3,:3] (ModelLoader.cpp:550)
    aabb_min: np.ndarray          # (3,) world AABB of the accessor min/max corners
    aabb_max: np.ndarray
    vertex_offset: int            # element offsets into the packed arrays
    uv_offset: int
    normal_offset: int
    tangent_offset: int
    index_offset: int
    vertex_count: int
    index_count: int
    material_index: int
    is_alpha_tested: bool
    has_uvs: bool = False
    has_tangents: bool = False
    has_normals: bool = False


@dataclasses.dataclass
class HostTexture:
    """A glTF texture = image + sampler (reference `Texture`,
    ModelLoader.cpp:888-899), with the reference's sampler quirks baked in."""

    image_index: int
    wrap_s: int = WRAP_REPEAT
    wrap_t: int = WRAP_REPEAT
    # The reference never sets magFilter for glTF-declared samplers (the
    # switch at ModelLoader.cpp:990-1001 assigns minFilter twice), so their
    # effective mag filter is NEAREST; the fallback sampler is LINEAR
    # (ModelLoader.cpp:119-125). RT shaders sample lod 0 => mag filter rules.
    filter: int = FILTER_NEAREST


@dataclasses.dataclass
class HostImage:
    data: np.ndarray   # (H, W, 4) uint8
    srgb: bool         # sRGB format unless used as a normal map (ModelLoader.cpp:922-926)


@dataclasses.dataclass
class HostCamera:
    """Reference `Camera` defaults (ModelLoader.hpp:107-114)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-2.0, 0.0, 1.0], np.float32))
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0], np.float32))
    right: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0], np.float32))
    fov: float = 0.0
    znear: float = 0.0
    zfar: float = 10000.0


@dataclasses.dataclass
class SceneData:
    """Host-side loaded scene: packed attribute arrays + geometry table,
    the direct analogue of ModelLoader's outputs."""

    positions: np.ndarray   # (Nv, 3) f32, object space
    normals: np.ndarray     # (Nn, 3) f32, object space
    tangents: np.ndarray    # (Nt, 4) f32
    uvs: np.ndarray         # (Nu, 2) f32
    indices: np.ndarray     # (Ni,) u32 (widened from u8/u16, ModelLoader.cpp:753-781)
    geometries: List[HostGeometry]
    materials: List[HostMaterial]
    textures: List[HostTexture]
    images: List[HostImage]
    camera: HostCamera
    model_bounds_min: np.ndarray
    model_bounds_max: np.ndarray

    @property
    def triangle_count(self) -> int:
        return sum(g.index_count // 3 for g in self.geometries)
