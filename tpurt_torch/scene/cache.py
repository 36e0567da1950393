"""Per-scene artifact cache on disk (the counterpart of
tpurt/scene/cache.py): a warm start skips the glTF parse, the atlas and
cell-mask packing, the SAH build and the wide-table packing, and is one
`.npz` read and an upload to the device.

The key is sha256 over the scene files' BYTES (and the sidecar buffers
and images a .gltf names by URI), the packed lights, the wide-table
arity, the backend and CACHE_VERSION. The backend is the port's own,
"torch-cuda" or "torch-cpu", so the two packages never hit each other's
entries through the key. The file itself has tpurt's key layout (`ds/...`,
`camera/...`, `bvh_kind`, `bvh/arity`, `bvh/node_rows`, `bvh/tri_rows`,
`bvh/tri_pos`, `bvh/tribvh/...`), so an artifact of either package loads
in the other.

On load, a `wide` artifact rebuilds the port's derived fields from the
stored arrays: the stack and depth bounds and the card tables
(convert.wide_bvh_from_numpy). Unlike tpurt, a `wide` artifact is not
demoted to its TriBVH on the CPU: the port's CPU runs the wide path
through the kernels' plain versions.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import LBVH, TriBVH
from tpurt_torch.camera import Camera
from tpurt_torch.config import SphereLight
from tpurt_torch.convert import scene_from_numpy, wide_bvh_from_numpy
from tpurt_torch.kernels.experimental.rope import KernelBVH
from tpurt_torch.kernels.wide import WideKernelBVH
from tpurt_torch.scene.device import DeviceScene, Materials, lights_array

# bump on ANY packed-layout or build-policy change (tpurt's value: the
# layouts are tpurt's)
CACHE_VERSION = 1


def default_cache_dir() -> Optional[str]:
    """TPURT_SCENE_CACHE_DIR, else <repo>/.tpurt_cache when the package
    sits in a git checkout, else None (off). TPURT_SCENE_CACHE_DIR=0
    turns the cache off."""
    env = os.environ.get("TPURT_SCENE_CACHE_DIR")
    if env == "0":
        return None
    if env:
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if os.path.isdir(os.path.join(here, ".git")):
        return os.path.join(here, ".tpurt_cache")
    return None


def backend_name(device) -> str:
    """The key's backend component: "torch-cuda" or "torch-cpu"."""
    return f"torch-{torch.device(device).type}"


def _hash_files(paths: Sequence[str], h) -> None:
    for p in paths:
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        # a .gltf may name sidecar buffers and images by URI: hash them too
        # (a textual scan; CACHE_VERSION still guards the layouts)
        if p.lower().endswith(".gltf"):
            try:
                with open(p, "r") as f:
                    doc = json.load(f)
            except Exception:  # noqa: BLE001 — load_gltf will report it
                continue
            base = os.path.dirname(os.path.abspath(p))
            uris = [b.get("uri") for b in doc.get("buffers", [])]
            uris += [i.get("uri") for i in doc.get("images", [])]
            for uri in uris:
                if not uri or uri.startswith("data:"):
                    continue
                side = os.path.join(base, uri)
                if os.path.isfile(side):
                    with open(side, "rb") as f:
                        h.update(f.read())


def scene_cache_key(paths: Sequence[str], lights: Sequence[SphereLight],
                    arity: int, backend: str) -> str:
    h = hashlib.sha256()
    h.update(f"v{CACHE_VERSION}|arity={arity}|backend={backend}|".encode())
    h.update(np.ascontiguousarray(lights_array(lights)).tobytes())
    _hash_files(list(paths), h)
    return h.hexdigest()[:32]


# ---- flat (de)serialization -------------------------------------------------

def _pack(prefix: str, obj, out: dict) -> None:
    if hasattr(obj, "_fields"):
        for name in obj._fields:
            _pack(f"{prefix}/{name}", getattr(obj, name), out)
    elif isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(obj)


# the only nested NamedTuple fields of the artifacts
_NESTED = {"materials": Materials, "bvh": LBVH}


def _unpack_nt(cls, prefix: str, data: dict, leaf):
    vals = []
    for name in cls._fields:
        key = f"{prefix}/{name}"
        if key in data:
            vals.append(leaf(data[key]))
        else:
            vals.append(_unpack_nt(_NESTED[name], key, data, leaf))
    return cls(*vals)


def save_artifacts(path: str, scene: DeviceScene, bvh, camera=None) -> None:
    """Write (DeviceScene, BVH, resolved default camera) to one .npz. A
    WideKernelBVH is saved as `wide`; a TriBVH, or the rope KernelBVH that
    carries one, as `tri`. Anything else is not cached."""
    out: dict = {}
    _pack("ds", scene, out)
    if camera is not None:
        _pack("camera", camera, out)
    if isinstance(bvh, WideKernelBVH):
        out["bvh_kind"] = np.asarray("wide")
        out["bvh/arity"] = np.asarray(bvh.arity)
        _pack("bvh/node_rows", bvh.node_rows, out)
        _pack("bvh/tri_rows", bvh.tri_rows, out)
        _pack("bvh/tri_pos", bvh.tri_pos, out)
        _pack("bvh/tribvh", bvh.tribvh, out)
    elif isinstance(bvh, (TriBVH, KernelBVH)):
        out["bvh_kind"] = np.asarray("tri")
        _pack("bvh/tribvh", bvh.tribvh if isinstance(bvh, KernelBVH) else bvh, out)
    else:
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **out)
    os.replace(tmp, path)  # atomic: concurrent builders race benignly


def load_artifacts(path: str, device="cuda"
                   ) -> Optional[Tuple[DeviceScene, object, Optional[Camera]]]:
    """(DeviceScene on `device`, bvh, camera or None) from an artifact of
    either package; the bvh is a WideKernelBVH on `device` or a host
    TriBVH. None on a missing, corrupt or partial file: the caller then
    builds cold."""
    if not os.path.isfile(path):
        return None
    try:
        data = dict(np.load(path, allow_pickle=False))
        kind = str(data["bvh_kind"])
        if kind not in ("wide", "tri"):
            return None
        ds = _unpack_nt(DeviceScene, "ds", data, np.asarray)
        tribvh = _unpack_nt(TriBVH, "bvh/tribvh", data, np.asarray)
        wide = ({"arity": data["bvh/arity"], "node_rows": data["bvh/node_rows"],
                 "tri_rows": data["bvh/tri_rows"], "tri_pos": data["bvh/tri_pos"]}
                if kind == "wide" else None)
        cam = _unpack_nt(Camera, "camera", data, np.asarray) if "camera/position" in data else None
    except Exception:  # noqa: BLE001 — a corrupt or partial cache is a cold build
        return None
    scene = scene_from_numpy({**ds._asdict(), "materials": ds.materials._asdict()},
                             device=device)
    if wide is not None:
        bvh = wide_bvh_from_numpy({**tribvh.bvh._asdict(), "tri_order": tribvh.tri_order,
                                   **wide}, device=device)
    else:
        bvh = tribvh
    camera = None if cam is None else Camera(*(torch.from_numpy(np.array(x)) for x in cam)).to(device)
    return scene, bvh, camera
