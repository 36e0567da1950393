"""Device selection (the counterpart of tpurt/runtime/device.py).

`resolve_device` turns the `device` argument of the port's entry points
into a torch.device. "cuda" with no usable card raises DeviceNotFound:
the port never falls back to the CPU on its own; the CPU runs only when
the caller names it.
"""

from __future__ import annotations

import torch


class DeviceNotFound(RuntimeError):
    """No device of the requested kind exists."""


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceNotFound(f"device {device!r} requested but no CUDA device is available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise DeviceNotFound(f"device {device!r} requested; "
                                 f"{torch.cuda.device_count()} CUDA device(s) present")
        return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return dev
    raise DeviceNotFound(f"unsupported device {device!r}")
