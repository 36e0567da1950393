"""Scene ingestion: glTF loading, procedural scenes, and the flat device
tensors the integrator and kernels read."""

from tpurt_torch.scene.types import (
    HostCamera,
    HostGeometry,
    HostImage,
    HostMaterial,
    HostTexture,
    NO_TEXTURE,
    SceneData,
)
from tpurt_torch.scene.gltf import camera_for_render, load_gltf
from tpurt_torch.scene.device import DeviceScene, Materials, build_device_scene, lights_array

__all__ = [
    "HostCamera",
    "HostGeometry",
    "HostImage",
    "HostMaterial",
    "HostTexture",
    "NO_TEXTURE",
    "SceneData",
    "camera_for_render",
    "load_gltf",
    "DeviceScene",
    "Materials",
    "build_device_scene",
    "lights_array",
]
