"""The port's brute-force oracle (tpurt_torch/integrator/oracle.py) held
against tpurt's (tpurt/integrator/oracle.py) on the same scene, camera
and sample indices, and against the port's own production integrator
(exact mode, the same per-ray streams), as tests/test_oracle_parity.py
holds tpurt's.

tpurt's oracle is jitted once per shape (~26 s on the CPU at 16x12 on the
box scene), so one module fixture renders both of its samples."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.camera import Camera as JCamera
from tpurt.config import RenderConfig as JConfig
from tpurt.config import SphereLight as JLight
from tpurt.integrator import oracle as joracle
from tpurt.renderer import Renderer as JRenderer
from tpurt.scene.procedural import write_box_scene
from tpurt_torch import convert
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator import oracle
from tpurt_torch.integrator.wavefront import render_sample
from tpurt_torch.renderer import Renderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_FMA = "--xla_cpu_max_isa=AVX"
W, H = 16, 12
EYE, YAW, PITCH = [1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45
LIGHT = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)


def _rel_rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean())) / float(b.mean())


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    path = write_box_scene(str(tmp_path_factory.mktemp("oracle") / "box.gltf"))
    cfg = RenderConfig(width=W, height=H, max_samples=8, fold_bsdf_mis=False)
    r = Renderer.from_gltf(path, config=cfg, camera=Camera.from_angles(EYE, YAW, PITCH),
                           lights=[SphereLight(*LIGHT)], device="cpu")
    return path, r


@pytest.fixture(scope="module")
def tpurt_oracle_samples(box):
    """tpurt's oracle, samples 0 and 1 of the box at 16x12, exact mode."""
    path, _ = box
    cfg = JConfig(width=W, height=H, max_samples=8, fold_bsdf_mis=False)
    jr = JRenderer.from_gltf(path, config=cfg, camera=JCamera.from_angles(EYE, YAW, PITCH),
                             lights=[JLight(*LIGHT)])
    return [np.asarray(joracle.render_sample_oracle(jr.device_scene, jr.camera, jnp.uint32(s),
                                                    width=W, height=H, cfg=cfg))
            for s in (0, 1)]


@pytest.mark.parametrize("sample", [0, 1])
def test_oracle_matches_tpurt(box, tpurt_oracle_samples, sample):
    _, r = box
    got = oracle.render_sample_oracle(r.device_scene, r.camera, sample, width=W, height=H,
                                      cfg=r.config).numpy()
    want = tpurt_oracle_samples[sample]
    assert got.shape == want.shape == (H, W, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    rmse = float(np.sqrt(((got - want) ** 2).mean()))
    assert rmse <= 1e-5, rmse


def test_oracle_matches_production_exact_mode(box):
    """Exact-mode production and the oracle draw the same samples from the
    same streams (tests/test_oracle_parity.py's bound)."""
    _, r = box
    prod = np.zeros((H, W, 3))
    orac = np.zeros((H, W, 3))
    for s in range(2):
        prod += render_sample(r.device_scene, r.bvh, r.camera, s, width=W, height=H,
                              cfg=r.config, has_alpha=r.has_alpha,
                              tex_flags=r.tex_flags).numpy()[..., :3]
        orac += oracle.render_sample_oracle(r.device_scene, r.camera, s, width=W, height=H,
                                            cfg=r.config).numpy()
    rel = _rel_rmse(prod, orac)
    assert rel < 0.01, rel


# tpurt's _bf_closest in a process of its own, without FMA (see
# tests/test_torch_fma.py): `python -c _TPURT_BF <scene.gltf> <rays.npz> <out.npz>`
_TPURT_BF = r'''
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from tpurt.config import RenderConfig, SphereLight
from tpurt.integrator.oracle import _bf_closest
from tpurt.scene.device import build_device_scene
from tpurt.scene.gltf import load_gltf

scene_path, rays_path, out = sys.argv[1:4]
rays = np.load(rays_path)
ds = build_device_scene(load_gltf(scene_path), lights=[SphereLight(*eval(rays["light"].item()))])
dup = rays["dup"]
per_tri = ("tri_pos", "tri_normal", "tri_tangent", "tri_uv", "tri_mat", "tri_alpha",
           "tri_alpha_row", "tri_shade_row", "tri_alpha_mask", "tri_alpha_opaque")
ds = ds._replace(**{f: jnp.concatenate([getattr(ds, f), getattr(ds, f)[dup]]) for f in per_tri})
res = {f: np.asarray(getattr(ds, f)) for f in ds._fields if f != "materials"}
res.update({"mat_" + m: np.asarray(getattr(ds.materials, m)) for m in ds.materials._fields})
for spheres in (0, 1):
    hit = _bf_closest(ds, RenderConfig(), jnp.asarray(rays["o"]), jnp.asarray(rays["d"]),
                      include_spheres=bool(spheres))
    for k, x in zip(("t", "prim", "u", "v", "is_tri", "is_sphere", "sphere_id"), hit):
        res[f"{k}_{spheres}"] = np.asarray(x)
np.savez(out, **res)
'''


def test_bf_closest_matches_tpurt(tmp_path):
    """_bf_closest against tpurt's on a small alpha-tested scene with two
    triangles duplicated at the end of the table (an alpha-tested one and
    an opaque one), with and without the sphere lights: t within 1e-5
    relative, prim equal (the lower id wins each exact tie, the alpha test
    runs inside the loop). tpurt runs without FMA in a subprocess: with
    FMA, rays that graze a shared edge pass the barycentric test in one
    package and not the other (ROADMAP queue 3)."""
    import subprocess
    import sys

    from tpurt.scene import procedural as jproc

    path = jproc.write_sponza_like_scene(str(tmp_path / "mini.gltf"), columns=1, foliage=2,
                                         stacks=1, segments=6, rings=4)
    from tpurt_torch.scene.device import build_device_scene
    from tpurt_torch.scene.gltf import load_gltf

    base = build_device_scene(load_gltf(path), lights=[SphereLight(*LIGHT)], device="cpu")
    alpha = base.tri_alpha.numpy()
    assert alpha.any(), "the scene must hold alpha-tested triangles"
    a_id, o_id = int(np.nonzero(alpha)[0][0]), int(np.nonzero(~alpha)[0][0])
    dup = np.array([a_id, o_id])
    tri = np.concatenate([base.tri_pos.numpy(), base.tri_pos.numpy()[dup]])
    r = np.random.RandomState(3)
    n = 512
    # rays aimed at points on random triangles, a quarter of them at the
    # duplicated pair
    aim = r.randint(0, tri.shape[0], n)
    aim[:128] = np.tile(dup, 64)
    bary = r.dirichlet([1, 1, 1], n).astype(np.float32)
    target = np.einsum("nk,nkc->nc", bary, tri[aim])
    o = (target + r.randn(n, 3) * 3).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    np.savez(tmp_path / "rays.npz", o=o, d=d, dup=dup, light=repr(LIGHT))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=NO_FMA, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _TPURT_BF, path, str(tmp_path / "rays.npz"),
                          str(tmp_path / "out.npz")], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    arrays = {f: want[f] for f in base._fields if f != "materials"}
    arrays["materials"] = {m: want["mat_" + m] for m in base.materials._fields}
    ds = convert.scene_from_numpy(arrays, device="cpu")
    np.testing.assert_array_equal(arrays["tri_pos"], tri)
    cfg = RenderConfig()
    for spheres in (0, 1):
        got = oracle._bf_closest(ds, cfg, torch.from_numpy(o), torch.from_numpy(d),
                                 include_spheres=bool(spheres))
        got = dict(zip(("t", "prim", "u", "v", "is_tri", "is_sphere", "sphere_id"),
                       (x.numpy() for x in got)))
        for k in ("prim", "is_tri", "is_sphere", "sphere_id"):
            np.testing.assert_array_equal(got[k], want[f"{k}_{spheres}"], err_msg=k)
        for k in ("t", "u", "v"):
            np.testing.assert_allclose(got[k], want[f"{k}_{spheres}"], rtol=1e-5, atol=0,
                                       err_msg=k)
    prim = want["prim_0"]
    assert (prim == a_id).any() and (prim == o_id).any(), "no ray hit a duplicated pair"
    assert not (prim >= tri.shape[0] - 2).any(), "a duplicate beat its lower id"
    # rays aimed at the alpha-tested triangle: some pass through a
    # transparent texel, some stop on it
    assert (prim[:128:2] != a_id).any() and (prim[:128:2] == a_id).any()


def test_bf_closest_chunks_give_the_loop_result(box, monkeypatch):
    """Tiny chunks (down to one triangle per chunk, tpurt's loop) give the
    same hits as the default chunk."""
    _, r = box
    ds = r.device_scene
    g = torch.Generator().manual_seed(5)
    n = 300
    o = torch.randn(n, 3, generator=g) * 2
    d = torch.nn.functional.normalize(-o + torch.randn(n, 3, generator=g) * 0.3, dim=1)
    ref = oracle._bf_closest(ds, r.config, o, d, include_spheres=True)
    for elements in (n, 7 * n):
        monkeypatch.setattr(oracle, "CHUNK_ELEMENTS", elements)
        got = oracle._bf_closest(ds, r.config, o, d, include_spheres=True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
