"""Runtime: device selection."""

from tpurt_torch.runtime.device import DeviceNotFound, resolve_device

__all__ = ["DeviceNotFound", "resolve_device"]
