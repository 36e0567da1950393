"""The port's package surfaces against tpurt's: every name of the `__all__`
lists of tpurt.kernels, tpurt.integrator, tpurt.bvh and tpurt.scene is
exported by the port's counterpart, importing the four packages builds
nothing, and the small API pieces this leaves to check (`ray_aabb`,
`RenderConfig.aspect_ratio`) equal tpurt's on the same inputs."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["kernels", "integrator", "bvh", "scene"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_tpurt_export_exists_in_the_port(pkg):
    theirs = importlib.import_module(f"tpurt.{pkg}")
    ours = importlib.import_module(f"tpurt_torch.{pkg}")
    assert sorted(ours.__all__) == sorted(theirs.__all__)
    missing = [name for name in theirs.__all__ if not hasattr(ours, name)]
    assert not missing, missing
    ns = {}
    exec(f"from tpurt_torch.{pkg} import *", ns)
    assert set(theirs.__all__) <= set(ns)


def test_importing_the_packages_builds_nothing():
    """No compiler run and no library loaded while the four packages (and
    the oracle) import: once torch and numpy are in, subprocess and ctypes
    loading raise in the child."""
    code = (
        "import ctypes, subprocess\n"
        "import numpy, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'build or load at import: {a[:1]}')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "ctypes.CDLL = refuse\n"
        "import tpurt_torch.kernels, tpurt_torch.integrator, tpurt_torch.bvh\n"
        "import tpurt_torch.scene, tpurt_torch.integrator.oracle\n"
        "from tpurt_torch.bvh import intersect_scene, build_lbvh\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_ray_aabb_matches_tpurt():
    from tpurt.kernels import ray_aabb as j_ray_aabb
    from tpurt_torch.kernels import ray_aabb, safe_inv_dir

    r = np.random.RandomState(2)
    n = 4096
    o = ((r.rand(n, 3) - 0.5) * 10).astype(np.float32)
    d = r.randn(n, 3).astype(np.float32)
    d[:64, 0] = 0.0  # axis-parallel rays: the safe reciprocal's 1e20
    lo = ((r.rand(n, 3) - 0.5) * 8).astype(np.float32)
    hi = (lo + r.rand(n, 3) * 3).astype(np.float32)
    t_min = (r.rand(n) * 2).astype(np.float32)
    inv = safe_inv_dir(torch.from_numpy(d))
    for t_max in (1e9, (r.rand(n) * 10).astype(np.float32)):
        hit, t_near = ray_aabb(torch.from_numpy(o), inv, torch.from_numpy(lo),
                               torch.from_numpy(hi), torch.from_numpy(t_min),
                               torch.from_numpy(t_max) if isinstance(t_max, np.ndarray)
                               else t_max)
        jhit, jt = j_ray_aabb(jnp.asarray(o), jnp.asarray(inv.numpy()), jnp.asarray(lo),
                              jnp.asarray(hi), jnp.asarray(t_min), jnp.asarray(t_max))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        assert t_near.numpy().tobytes() == np.asarray(jt).tobytes()
        assert 0 < int(hit.sum()) < n


@pytest.mark.parametrize("width,height", [(640, 480), (1920, 1080), (33, 7)])
def test_aspect_ratio_matches_tpurt(width, height):
    from tpurt.config import RenderConfig as JConfig
    from tpurt_torch.config import RenderConfig

    got = RenderConfig(width=width, height=height).aspect_ratio
    assert got == JConfig(width=width, height=height).aspect_ratio == width / height
