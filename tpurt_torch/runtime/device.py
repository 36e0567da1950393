"""Device discovery and selection, and frame pacing (the counterpart of
tpurt/runtime/device.py).

`resolve_device` turns the `device` argument of the port's entry points
into a torch.device. "cuda" with no usable card raises DeviceNotFound:
the port never falls back to the CPU on its own; the CPU runs only when
the caller names it.

`list_devices` reports each CUDA card, or the CPU when there is none.
tpurt's `DeviceInfo.is_tpu` has no counterpart here and is left out.

`to_device` moves every tensor of a structure (a DeviceScene, a Camera,
a WideKernelBVH or rope KernelBVH with its card tables) to a device.

`FramePacer` is the frames-in-flight ring: it records a CUDA event after
each submitted launch and waits on the oldest only when more than
`depth` are outstanding. On the CPU, work is synchronous and the pacer
only keeps the bookkeeping.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import torch

from tpurt_torch.utils.profiling import host_sync

FRAMES_IN_FLIGHT = 3  # tpurt's ring depth


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


def to_device(x, device):
    """`x` with every tensor inside it on `device`: tensors, NamedTuples
    and dataclasses are walked; anything else (host numpy, ints) is kept."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_device(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str            # "cuda" or "cpu"
    kind: str                # the card's name, or "cpu"
    index: int
    memory_bytes: Optional[int]


def list_devices() -> List[DeviceInfo]:
    """Every CUDA device, or the CPU alone when there is no card."""
    if torch.cuda.is_available():
        out = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            out.append(DeviceInfo(platform="cuda", kind=props.name, index=i,
                                  memory_bytes=int(props.total_memory)))
        return out
    return [DeviceInfo(platform="cpu", kind="cpu", index=0, memory_bytes=None)]


def select_device(platform: Optional[str] = None) -> DeviceInfo:
    """The first device of list_devices(), optionally of `platform`
    ("cuda" or "cpu")."""
    infos = list_devices()
    for info in infos:
        if platform is None or info.platform == platform:
            return info
    raise DeviceNotFound(f"no device for platform={platform!r}; "
                         f"available: {[i.platform for i in infos]}")


class FramePacer:
    """Bounded ring of in-flight launches (tpurt's frames-in-flight).

    `submit` records a CUDA event after the launch that produced `value`
    and blocks on the oldest event only when more than `depth` launches
    are outstanding; it then returns that oldest value, else None."""

    def __init__(self, depth: int = FRAMES_IN_FLIGHT):
        self.depth = depth
        self._inflight = deque()

    def submit(self, value):
        event = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(value.device))
        self._inflight.append((value, event))
        if len(self._inflight) > self.depth:
            oldest, event = self._inflight.popleft()
            if event is not None:
                with host_sync("pacer"):
                    event.synchronize()
            return oldest
        return None

    def drain(self):
        """Wait for every outstanding launch; returns their values, oldest
        first."""
        out = list(self._inflight)
        self._inflight.clear()
        for _, event in out:
            if event is not None:
                with host_sync("pacer"):
                    event.synchronize()
        return [value for value, _ in out]
