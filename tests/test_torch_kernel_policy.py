"""KernelPolicy's `sort_wave0` and `cell_masks_closest` on the render path,
on the CPU, each turned away from its default.

`sort_wave0` sorts the camera wave by the octant-Morton key before its
closest-hit trace and puts the results back in pixel order, so the image
is the one without it; the port's image with it on is held against
tpurt's with it on. `cell_masks_closest=False` leaves the decided-cell
alpha tests out of the closest-hit traversal, so the host texture tap
decides every alpha-tested hit: the hits are those of the in-kernel
formulation (tpurt's tests/test_alpha_masks.py::
test_cell_masks_closest_trace_parity), and so is the image, held against
tpurt's with the same policy."""

import dataclasses

import numpy as np
import torch

from tpurt_torch import film
from tpurt_torch.bvh import traverse as traverse_mod
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.camera import Camera
from tpurt_torch.config import KernelPolicy, RenderConfig, SphereLight
from tpurt_torch.integrator.wavefront import _trace
from tpurt_torch.kernels import wide
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.device import build_device_scene
from tpurt_torch.scene.gltf import load_gltf
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene

BOX_POSE = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
BOX_LIGHT = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)
MINI_SPONZA = dict(columns=1, foliage=8, stacks=1, segments=8, rings=6)
SPONZA_POSE = ([0.0, -4.0, 0.0], 0.7, -0.1)
SPONZA_LIGHT = ((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)


def _against_tpurt(path, kw, policy, pose, light):
    """The port's image and tpurt's, same scene, camera, seed and policy."""
    from tpurt.camera import Camera as JCamera
    from tpurt.config import KernelPolicy as JKernelPolicy
    from tpurt.config import RenderConfig as JRenderConfig
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.renderer import Renderer as JRenderer

    r = Renderer.from_gltf(path, config=RenderConfig(**kw, kernel=KernelPolicy(**policy)),
                           camera=Camera.from_angles(*pose), lights=[SphereLight(*light)],
                           device="cpu")
    img = r.render(kw["max_samples"]).numpy()
    jcfg = JRenderConfig(**kw, kernel=dataclasses.replace(JKernelPolicy(), **policy))
    jr = JRenderer.from_gltf(path, config=jcfg, camera=JCamera.from_angles(*pose),
                             lights=[JSphereLight(*light)])
    ref = np.asarray(jr.render(kw["max_samples"]))
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert float(ref[..., :3].mean()) > 0.0
    return r, img, ref


def test_sort_wave0_matches_tpurt(tmp_path, monkeypatch):
    """The box at 64x48 (3,072 camera rays, above the sort threshold):
    with sort_wave0 the camera wave is sorted too, and the image is
    tpurt's with sort_wave0 within 1e-5 RMSE."""
    path = write_box_scene(str(tmp_path / "box.gltf"))
    sorted_n = []
    sort = traverse_mod._sort_rays

    def counted(key, cols):
        sorted_n.append(int(key.shape[0]))
        return sort(key, cols)

    monkeypatch.setattr(traverse_mod, "_sort_rays", counted)
    kw = dict(width=64, height=48, max_samples=2)
    _, img, ref = _against_tpurt(path, kw, dict(sort_wave0=True), BOX_POSE, BOX_LIGHT)
    # the camera wave (every pixel) went through the sort
    assert 64 * 48 in sorted_n
    err = film.rmse(img, ref)
    assert err < 1e-5, f"sort_wave0=True: RMSE={err} against tpurt"
    sorted_n.clear()
    Renderer.from_gltf(path, config=RenderConfig(**kw), camera=Camera.from_angles(*BOX_POSE),
                       lights=[SphereLight(*BOX_LIGHT)], device="cpu").render(1)
    assert 64 * 48 not in sorted_n


def _mini_sponza(tmp_path):
    path = write_sponza_like_scene(str(tmp_path / "mini.gltf"), **MINI_SPONZA)
    ds = build_device_scene(load_gltf(path), device="cpu")
    assert bool(ds.tri_alpha.any())
    tri = ds.tri_pos.numpy()
    kb = wide.make_wide_kernel_bvh(build_triangle_bvh(tri, group_size=8), tri,
                                   tri_alpha_mask=ds.tri_alpha_mask,
                                   tri_alpha_opaque=ds.tri_alpha_opaque, device="cpu")
    assert kb.use_masks
    return path, ds, kb


def test_cell_masks_closest_trace_parity(tmp_path):
    """512 rays from inside the mini Sponza's atrium in random directions
    (foliage crossings, walls, misses): the alpha-resolved hits with the
    in-kernel cell tests off equal those with them on, kind and prim
    exactly and t bit for bit (the same triangle tests decide both)."""
    path, ds, kb = _mini_sponza(tmp_path)
    n = 512
    rng = np.random.RandomState(7)
    o = torch.from_numpy(np.tile([0.0, -4.0, 0.0], (n, 1)).astype(np.float32)
                         + rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    act, zeros = torch.ones(n, dtype=torch.bool), torch.zeros(n)
    cfg_kern = RenderConfig(width=8, height=8)
    cfg_host = dataclasses.replace(cfg_kern, kernel=KernelPolicy(cell_masks_closest=False))
    # the default runs the cell tests in the traversal and leaves some hits
    # pending; with them off there is no pending set at all
    _, pend = traverse_mod.closest_hit(kb, ds.lights, o, d, zeros, cfg_kern.t_max,
                                       include_spheres=False, active=act, sort_rays=False,
                                       return_pending=True, policy=cfg_kern.kernel)
    _, none = traverse_mod.closest_hit(kb, ds.lights, o, d, zeros, cfg_kern.t_max,
                                       include_spheres=False, active=act, sort_rays=False,
                                       return_pending=True, policy=cfg_host.kernel)
    assert pend is not None and bool(pend.any()) and none is None
    h_host = _trace(ds, kb, o, d, zeros, act, False, cfg_host, True, sort_rays=False)
    h_kern = _trace(ds, kb, o, d, zeros, act, False, cfg_kern, True, sort_rays=False)
    assert torch.equal(h_host.kind, h_kern.kind)
    assert torch.equal(h_host.prim, h_kern.prim)
    assert torch.equal(h_host.t.view(torch.int32), h_kern.t.view(torch.int32))
    assert int((h_kern.prim >= 0).sum()) > n // 2


def test_cell_masks_closest_off_matches_tpurt(tmp_path):
    """The mini Sponza (alpha foliage) at 32x24, 2 spp, with
    cell_masks_closest=False: the port's image is tpurt's with the same
    policy within 1e-5 RMSE, and the port's own default image."""
    path, _, _ = _mini_sponza(tmp_path)
    kw = dict(width=32, height=24, max_samples=2)
    r, img, ref = _against_tpurt(path, kw, dict(cell_masks_closest=False), SPONZA_POSE,
                                 SPONZA_LIGHT)
    assert r.has_alpha and r.bvh.use_masks
    err = film.rmse(img, ref)
    assert err < 1e-5, f"cell_masks_closest=False: RMSE={err} against tpurt"
    default = Renderer.from_gltf(path, config=RenderConfig(**kw),
                                 camera=Camera.from_angles(*SPONZA_POSE),
                                 lights=[SphereLight(*SPONZA_LIGHT)], device="cpu")
    assert film.rmse(default.render(2).numpy(), img) < 1e-5
