"""Plumbing shared by the hand-written CUDA kernels (csrc/*.cu): the nvcc
build into a shared library with a plain C interface, its ctypes
binding, and the per-card error word the kernels report faults through.

Each source is built on first use into tpurt_torch/_build/ (ignored by
git), with no PyTorch headers, so a build takes seconds. Nothing here
runs at import: the CPU tests import every module on a machine without
nvcc or a card.

Error word. Every kernel launch on a card gets the same device int; a
kernel that cannot finish a ray correctly ORs its bit into it instead of
writing past an array or looping forever. `check_kernel_errors` reads the
word (one host sync), raises with every fault named, and clears it; the
renderer calls it once per sample, and code that launches a kernel
directly calls it before trusting the results.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import tempfile
import threading
from typing import Dict

import torch

from tpurt_torch.utils.profiling import host_sync

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# bits of the error word, one per fault a kernel can detect
ERR_WIDE_STACK = 1  # wide_traverse.cu, wide_octet.cu, wide_stepcost.cu: a wide stack overflowed
ERR_ROPE_STEPS = 2  # rope_traverse.cu: a walk hit its 4*M step cap
_ERR_TEXT = {ERR_WIDE_STACK: "wide traversal stack overflow",
             ERR_ROPE_STEPS: "rope walk exceeded its 4*M step cap (a broken rope link)"}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_ERR_WORDS: Dict[int, torch.Tensor] = {}
# ptxas's report (-Xptxas=-v) of each source built in this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build(name: str, force: bool = False) -> str:
    """nvcc csrc/<name>.cu into _build/lib<name>.so unless the library is
    newer than its source. Writes a temporary file and renames it, so a
    concurrent build never loads a half-written library."""
    from tpurt_torch.native import BUILD_DIR

    src, so = os.path.join(_CSRC, name + ".cu"), os.path.join(BUILD_DIR, f"lib{name}.so")
    if not force and os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)
    BUILD_LOG[name] = res.stdout + res.stderr
    return so


def kernel_resources(name: str) -> Dict[str, dict]:
    """Per kernel of csrc/<name>.cu, as ptxas reported them when this
    process built it: registers per thread, static shared memory, stack
    frame and spill bytes. Empty if the library was not built here."""
    out: Dict[str, dict] = {}
    cur = None
    for line in BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        for key, pat in (("registers", r"Used (\d+) registers"), ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    return out


def load(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; each entry point named in
    `argtypes` gets those argument types and returns a C int (the CUDA
    error code of its launch)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn_name, types in argtypes.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def _card(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def error_word(device) -> torch.Tensor:
    """The card's error word (one int32, allocated at first use)."""
    card = _card(device)
    err = _ERR_WORDS.get(card)
    if err is None:
        err = _ERR_WORDS[card] = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", card))
    return err


def check_kernel_errors(device) -> None:
    """Raise if any kernel launched on `device` since the last check
    reported a fault (its results are then wrong), and clear the word.
    Waits for the launches queued so far. A no-op off the card."""
    if torch.device(device).type != "cuda":
        return
    err = _ERR_WORDS.get(_card(device))
    if err is None:
        return
    with host_sync("error_word"):
        bits = int(err.item())
    if bits:
        err.zero_()
        faults = [text for bit, text in _ERR_TEXT.items() if bits & bit]
        raise RuntimeError("CUDA kernel fault: " + "; ".join(faults or [f"code {bits}"]))


def launch_check(rc: int, what: str) -> None:
    """Raise if a launch was refused (the C entry points return
    cudaGetLastError() right after their launch)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def launch(what: str, lib: str, argtypes: Dict[str, list], entry: str, rays, tables,
           outs, args, launches: Dict[str, int], keys):
    """The steps every traversal launch shares, in order: check the ray
    columns `rays` = (o, d, t_min, t_limit[, active]) (on o's device, f32
    and contiguous, `active` bool, of o's N rays) and the kernel's tables
    (`tables(device)` raises unless they are fit and returns them);
    allocate one (N,) output of each dtype in `outs`, returned unlaunched
    when N == 0; else build and load csrc/<lib>.cu, call `entry` with
    `args(tables, outputs, error word pointer, stream)` on the current
    stream, raise if the launch was refused, and count it under each of
    `keys` in `launches`. Returns the outputs. Does not wait for the
    card: a fault surfaces at the next check_kernel_errors."""
    o = rays[0]
    dev, n = o.device, o.shape[0]
    cols = (("d", (n, 3), torch.float32), ("t_min", (n,), torch.float32),
            ("t_limit", (n,), torch.float32), ("active", (n,), torch.bool))
    for (name, _, _), x in zip(cols, rays[1:]):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
    check(o, "o", (n, 3))
    for (name, shape, dtype), x in zip(cols, rays[1:]):
        check(x, name, shape, dtype)
    card = tables(dev)
    out = tuple(torch.empty(n, dtype=dtype, device=dev) for dtype in outs)
    if n == 0:
        return out
    fn = getattr(load(lib, argtypes), entry)
    err = error_word(dev)
    rc = fn(*args(card, out, err.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    launch_check(rc, what)
    for key in keys:
        launches[key] += 1
    return out


def check(x: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Raise unless `x` has the dtype, shape and contiguity a kernel reads."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def argtypes(spec: str) -> list:
    """ctypes argument types from a compact spec: 'p' a pointer or the
    stream (void*, so a 64-bit value is not cut), 'i' a C int, 'f' a C
    float."""
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    return [kinds[c] for c in spec]

