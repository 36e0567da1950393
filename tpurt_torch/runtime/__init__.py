"""Runtime: device discovery and selection, and frame pacing."""

from tpurt_torch.runtime.device import (
    FRAMES_IN_FLIGHT,
    DeviceInfo,
    DeviceNotFound,
    FramePacer,
    list_devices,
    resolve_device,
    select_device,
)

__all__ = [
    "FRAMES_IN_FLIGHT",
    "DeviceInfo",
    "DeviceNotFound",
    "FramePacer",
    "list_devices",
    "resolve_device",
    "select_device",
]
