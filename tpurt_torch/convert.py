"""Carry tpurt's device structures across to the port.

`scene_from_numpy`, `wide_bvh_from_numpy`, `tribvh_from_tpurt` and
`kernel_bvh_from_tpurt` take the fields of tpurt's `DeviceScene`,
`WideKernelBVH`, `TriBVH` and rope `KernelBVH` as numpy arrays (so this
module needs neither JAX nor tpurt) and build the port's structures;
`policy_from_tpurt` takes the fields of a tpurt `KernelPolicy` as a
mapping. The tests use them to feed both packages the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import LBVH, TriBVH
from tpurt_torch.config import KernelPolicy
from tpurt_torch.kernels.experimental.rope import KernelBVH
from tpurt_torch.kernels.wide import MAX_STACK, WideKernelBVH, _stack_bound, collapse_to_wide
from tpurt_torch.scene.device import DeviceScene, Materials


def _dev(x, device):
    return torch.from_numpy(np.array(x)).to(device)


def scene_from_numpy(arrays: Mapping[str, object], device="cuda") -> DeviceScene:
    """`arrays` holds every DeviceScene field by name; `materials` is a
    mapping of the Materials fields."""
    mats = arrays["materials"]
    fields = {k: _dev(arrays[k], device) for k in DeviceScene._fields if k != "materials"}
    return DeviceScene(materials=Materials(**{k: _dev(mats[k], device)
                                              for k in Materials._fields}),
                       **fields)


def wide_bvh_from_numpy(arrays: Mapping[str, object], device="cuda") -> WideKernelBVH:
    """`arrays` holds node_rows, tri_rows, tri_pos, arity and the TriBVH
    fields: tri_order plus the LBVH fields (left, right, node_min,
    node_max, leaf_prim, first, skip)."""
    tribvh = tribvh_from_tpurt(arrays)
    bvh = tribvh.bvh
    arity = int(arrays["arity"])
    child, wide_of = collapse_to_wide(tribvh, arity)
    bound = _stack_bound(child, wide_of, bvh.num_internal)
    if bound > MAX_STACK:
        raise ValueError(f"stack bound {bound} exceeds {MAX_STACK}")
    return WideKernelBVH(
        tribvh=tribvh,
        node_rows=_dev(np.asarray(arrays["node_rows"], np.float32), device),
        tri_rows=_dev(np.asarray(arrays["tri_rows"], np.float32), device),
        tri_pos=_dev(np.asarray(arrays["tri_pos"], np.float32), device),
        arity=arity, stack_bound=bound)


def tribvh_from_tpurt(arrays: Mapping[str, object]) -> TriBVH:
    """`arrays` holds tri_order and the LBVH fields (left, right,
    node_min, node_max, leaf_prim, first, skip), as numpy arrays."""
    bvh = LBVH(**{k: np.asarray(arrays[k]) for k in LBVH._fields})
    return TriBVH(bvh=bvh, tri_order=np.asarray(arrays["tri_order"]))


def kernel_bvh_from_tpurt(arrays: Mapping[str, object], device="cuda") -> KernelBVH:
    """tpurt's rope tables: `arrays` holds node_rows, tri_rows and the
    TriBVH fields (see tribvh_from_tpurt)."""
    tribvh = tribvh_from_tpurt(arrays)
    return KernelBVH(tribvh=tribvh,
                     node_rows=_dev(np.asarray(arrays["node_rows"], np.float32), device),
                     tri_rows=_dev(np.asarray(arrays["tri_rows"], np.float32), device),
                     tri_order=_dev(np.asarray(tribvh.tri_order, np.int64), device))


# tpurt's KernelPolicy fields without a counterpart, at tpurt's defaults
# (tpurt/config.py): TPU step variants and budgets, and the re-trace sort
_TPU_ONLY_DEFAULTS = {
    "sort_retrace": False, "pair_closest": False, "dual_closest": False,
    "pair_occlusion": False, "dual_occlusion": False, "descend_closest": False,
    "descend_occlusion": False, "sup_closest": 2, "sup_occlusion": 4,
    "sumcol": True, "unroll": 4, "arity": 16, "resident_budget_mb": 104,
}


def policy_from_tpurt(fields: Mapping[str, object]) -> KernelPolicy:
    """The port's KernelPolicy from `dataclasses.asdict` of a tpurt
    KernelPolicy. Raises ValueError if a field without a counterpart
    differs from tpurt's default (the port could not honour it), and
    KeyError on a field tpurt does not have."""
    kept = {f.name for f in dataclasses.fields(KernelPolicy)}
    out = {}
    for name, value in fields.items():
        if name in kept:
            out[name] = value
        elif name not in _TPU_ONLY_DEFAULTS:
            raise KeyError(f"{name!r} is not a tpurt KernelPolicy field")
        elif value != _TPU_ONLY_DEFAULTS[name]:
            raise ValueError(f"KernelPolicy.{name}={value!r} has no counterpart in the port "
                             f"(only tpurt's default {_TPU_ONLY_DEFAULTS[name]!r} carries across)")
    return KernelPolicy(**out)
