"""The port stands alone: every tpurt_torch module (and chip_smoke.py)
imports on a Python that has numpy and torch, without JAX, tpurt, Pillow
or ml_dtypes; entry points default to the CUDA device and never fall back
to the CPU on their own."""

import inspect
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import tpurt_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "tpurt", "PIL", "ml_dtypes")


def _all_modules():
    names = ["tpurt_torch"]
    for info in pkgutil.walk_packages(tpurt_torch.__path__, "tpurt_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_imports_without_jax_tpurt_pil_ml_dtypes():
    mods = _all_modules()
    assert "tpurt_torch.kernels.wide" in mods and "tpurt_torch.integrator.wavefront" in mods
    assert {"tpurt_torch.kernels.experimental.rope", "tpurt_torch.kernels.cudalib",
            "tpurt_torch.kernels.experimental", "tpurt_torch.integrator.oracle",
            "tpurt_torch.scene.cache", "tpurt_torch.scene.samples", "tpurt_torch.viewer",
            "tpurt_torch.parallel", "tpurt_torch.parallel.shard", "tpurt_torch.runtime",
            "tpurt_torch.runtime.device"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "sys.path.insert(0, %r)\n"
        "import chip_smoke\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n" % ROOT
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONSTARTUP",)}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    assert res.stdout.startswith("ok")


def test_no_module_source_mentions_forbidden_imports():
    pkg_dir = os.path.dirname(tpurt_torch.__file__)
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg_dir):
        sources += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    top = s.split()[1].split(".")[0]
                    assert top not in FORBIDDEN, f"{path}: {s}"


@pytest.mark.parametrize("fn", [
    "tpurt_torch.renderer:Renderer.__init__",
    "tpurt_torch.renderer:Renderer.from_gltf",
    "tpurt_torch.scene.device:build_device_scene",
    "tpurt_torch.kernels.wide:make_wide_kernel_bvh",
    "tpurt_torch.camera:camera_rays_for_rows",
    "tpurt_torch.convert:scene_from_numpy",
    "tpurt_torch.convert:wide_bvh_from_numpy",
    "tpurt_torch.convert:kernel_bvh_from_tpurt",
    "tpurt_torch.kernels.experimental.rope:make_kernel_bvh",
    "tpurt_torch.runtime.device:resolve_device",
    "tpurt_torch.bvh.lbvh:build_lbvh",
    "tpurt_torch.bvh.lbvh:_build_triangle_bvh_device",
    "tpurt_torch.bvh.lbvh:build_triangle_bvh",
    "tpurt_torch.scene.cache:load_artifacts",
])
def test_entry_points_default_to_cuda(fn):
    import importlib

    mod, attr = fn.split(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


def test_cuda_without_a_card_raises_instead_of_falling_back():
    from tpurt_torch.parallel import make_mesh
    from tpurt_torch.runtime.device import DeviceNotFound, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(DeviceNotFound):
            resolve_device("cuda")
        # a mesh over "every device" means every card, never the CPU
        with pytest.raises(DeviceNotFound):
            make_mesh()


def test_kernel_wrapper_routes_cpu_tensors_to_the_plain_version():
    """A CPU tensor takes the plain traversal and leaves the kernels' launch
    counters alone (wide K1, rope K3/K4)."""
    import numpy as np

    from tpurt_torch.bvh.lbvh import build_triangle_bvh
    from tpurt_torch.kernels import wide
    from tpurt_torch.kernels.experimental import rope

    r = np.random.RandomState(0)
    tris = ((r.rand(40, 1, 3) - 0.5) * 6 + (r.rand(40, 3, 3) - 0.5)).astype(np.float32)
    kb = wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 8), tris, device="cpu")
    o = torch.from_numpy((r.rand(64, 3).astype(np.float32) - 0.5) * 8)
    d = torch.nn.functional.normalize(torch.from_numpy(r.randn(64, 3).astype(np.float32)), dim=1)
    before = dict(wide.LAUNCHES)
    t, prim, u, v = wide.traverse_packets(kb, o, d, torch.zeros(64), 1e9,
                                          torch.ones(64, dtype=torch.bool))
    assert wide.LAUNCHES == before
    assert t.shape == (64,) and prim.dtype == torch.int32
    rk = rope.make_kernel_bvh(kb.tribvh, tris, device="cpu")
    before = dict(rope.LAUNCHES)
    t3, prim3, _, _ = rope.traverse_packets(rk, o, d, torch.zeros(64), 1e9,
                                           torch.ones(64, dtype=torch.bool))
    b4, _, _, _, _ = rope.occlusion_packets(rk, o, d, torch.zeros(64), torch.full((64,), 1e9),
                                            torch.ones(64, dtype=torch.bool), False)
    assert rope.LAUNCHES == before
    assert torch.equal(t3, t) and b4.dtype == torch.bool
