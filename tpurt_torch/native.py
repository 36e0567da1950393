"""ctypes bindings for the native host core (native/tpurt_native.cpp), the
counterpart of tpurt/native.py.

The port compiles the same C++ source with g++ into its own build
directory (tpurt_torch/_build/, ignored by git); it never writes
native/libtpurt_native.so, which belongs to tpurt. There is no numpy
fallback: if the library does not build, the call raises. `available()`
says whether it builds and loads; bvh/lbvh.py then builds the triangle
BVH on the device instead, as tpurt does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
_SRC = os.path.join(os.path.dirname(_PKG), "native", "tpurt_native.cpp")
_SO = os.path.join(BUILD_DIR, "libtpurt_native.so")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED: Optional[str] = None  # why the library did not build or load


def build(force: bool = False) -> str:
    """Compile the host core if the library is missing or older than its
    source. Writes to a temporary name and renames, so a concurrent
    build never loads a half-written file. Returns the library path."""
    fresh = (os.path.exists(_SO)
             and os.path.getmtime(_SO) >= os.path.getmtime(_SRC))
    if fresh and not force:
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    # no -march=native: the same flags as tpurt's build, so both libraries
    # round identically (no FMA contraction on baseline x86-64)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, _SO)
    return _SO


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        f32p = ctypes.POINTER(ctypes.c_float)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.tpurt_gather_triangles.argtypes = [f32p, u32p, i64, f32p, f32p]
        lib.tpurt_morton30.argtypes = [f32p, i64, u32p]
        lib.tpurt_lbvh_build.argtypes = [f32p, f32p, i64, i32p, i32p, f32p,
                                         f32p, i32p, i32p, i32p]
        lib.tpurt_lbvh_build.restype = ctypes.c_int
        lib.tpurt_sah_build.argtypes = [f32p, f32p, i64, ctypes.c_int32,
                                        ctypes.c_int32, i32p, i32p, i32p,
                                        f32p, f32p, i32p, i32p, i32p]
        lib.tpurt_sah_build.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the library builds and loads (tpurt/native.py::available).
    A failure is remembered: the build is not retried in this process."""
    global _FAILED
    if _FAILED is None:
        try:
            get_lib()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _FAILED = f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"
    return _FAILED is None


def unavailable_reason() -> Optional[str]:
    return _FAILED


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def gather_triangles(positions: np.ndarray, indices: np.ndarray,
                     transform: np.ndarray) -> np.ndarray:
    """World-space per-triangle vertex gather: (T*3,) indices into
    (Nv, 3) positions through a 4x4 transform -> (T, 3, 3)."""
    tri_count = indices.size // 3
    if indices.size and (int(indices.max()) >= positions.shape[0]
                         or int(indices.min()) < 0):
        raise ValueError(
            f"triangle index out of bounds: max {int(indices.max())}, "
            f"min {int(indices.min())}, {positions.shape[0]} vertices")
    lib = get_lib()
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices.reshape(-1), np.uint32)
    tm = np.ascontiguousarray(transform, np.float32)
    out = np.empty((tri_count, 3, 3), np.float32)
    lib.tpurt_gather_triangles(_ptr(pos, ctypes.c_float),
                               _ptr(idx, ctypes.c_uint32), tri_count,
                               _ptr(tm, ctypes.c_float),
                               _ptr(out, ctypes.c_float))
    return out


def morton30(points01: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points01, np.float32)
    out = np.empty(pts.shape[0], np.uint32)
    get_lib().tpurt_morton30(_ptr(pts, ctypes.c_float), pts.shape[0],
                             _ptr(out, ctypes.c_uint32))
    return out


def build_lbvh_native(prim_min: np.ndarray, prim_max: np.ndarray):
    """Karras LBVH over primitive AABBs. Returns an lbvh.LBVH of numpy
    arrays, or None when the native build reports failure."""
    from tpurt_torch.bvh.lbvh import LBVH

    n = prim_min.shape[0]
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    left = np.empty(n - 1, np.int32)
    right = np.empty(n - 1, np.int32)
    node_min = np.empty((2 * n - 1, 3), np.float32)
    node_max = np.empty((2 * n - 1, 3), np.float32)
    leaf_prim = np.empty(n, np.int32)
    first = np.empty((8, n - 1), np.int32)
    skip = np.empty((8, 2 * n - 1), np.int32)
    rc = get_lib().tpurt_lbvh_build(
        _ptr(pmin, ctypes.c_float), _ptr(pmax, ctypes.c_float), n,
        _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
        _ptr(node_min, ctypes.c_float), _ptr(node_max, ctypes.c_float),
        _ptr(leaf_prim, ctypes.c_int32), _ptr(first, ctypes.c_int32),
        _ptr(skip, ctypes.c_int32))
    if rc != 0:
        return None
    return LBVH(left=left, right=right, node_min=node_min, node_max=node_max,
                leaf_prim=leaf_prim, first=first, skip=skip)


def build_sah_tribvh(prim_min: np.ndarray, prim_max: np.ndarray, group: int):
    """Binned-SAH build over per-triangle AABBs with `group` triangles per
    leaf. Returns (tri_order, lbvh.LBVH) with identity leaf order, or None
    when the build overflows its leaf budget (the caller then takes the
    Morton + Karras build)."""
    from tpurt_torch.bvh.lbvh import LBVH

    n = prim_min.shape[0]
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    max_leaves = max(2 * ((n + group - 1) // group) + 16, 4)
    tri_order = np.empty(max_leaves * group, np.int32)
    left = np.empty(max_leaves - 1, np.int32)
    right = np.empty(max_leaves - 1, np.int32)
    node_min = np.empty((2 * max_leaves - 1, 3), np.float32)
    node_max = np.empty((2 * max_leaves - 1, 3), np.float32)
    leaf_prim = np.empty(max_leaves, np.int32)
    first = np.empty(8 * (max_leaves - 1), np.int32)
    skip = np.empty(8 * (2 * max_leaves - 1), np.int32)
    n_leaves = get_lib().tpurt_sah_build(
        _ptr(pmin, ctypes.c_float), _ptr(pmax, ctypes.c_float), n,
        group, max_leaves, _ptr(tri_order, ctypes.c_int32),
        _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
        _ptr(node_min, ctypes.c_float), _ptr(node_max, ctypes.c_float),
        _ptr(leaf_prim, ctypes.c_int32), _ptr(first, ctypes.c_int32),
        _ptr(skip, ctypes.c_int32))
    if n_leaves < 2:
        return None
    nl = int(n_leaves)
    bvh = LBVH(
        left=left[:nl - 1].copy(), right=right[:nl - 1].copy(),
        node_min=node_min[:2 * nl - 1].copy(),
        node_max=node_max[:2 * nl - 1].copy(),
        leaf_prim=leaf_prim[:nl].copy(),
        first=first[:8 * (nl - 1)].copy().reshape(8, nl - 1),
        skip=skip[:8 * (2 * nl - 1)].copy().reshape(8, 2 * nl - 1))
    return tri_order[:nl * group].copy(), bvh
