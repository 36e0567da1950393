"""spp and tile sharding in the port (tpurt_torch/parallel/shard.py) over
a mesh that names the CPU eight times, as tpurt's tests shard over eight
virtual CPU devices: tests/test_sharding.py's seven cases with tpurt's
bounds or tighter, and one launch held against tpurt's
render_sample_sharded on the same scene and mesh."""

import dataclasses

import numpy as np
import pytest
import torch

from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator.wavefront import render_sample_stats
from tpurt_torch.parallel import (ShardedRenderer, make_mesh, render_sample_sharded,
                                  render_sample_stats_sharded)
from tpurt_torch.renderer import Renderer
from tpurt_torch.runtime import DeviceNotFound
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene

CFG = RenderConfig(width=32, height=24, max_samples=64)
DEVS = ["cpu"] * 8
POSE = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
LIGHT = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These renders are a few hundred rays each: intra-op threads only
    crowd the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    path = write_box_scene(str(tmp_path_factory.mktemp("box") / "box.gltf"))
    return Renderer.from_gltf(path, config=CFG, camera=Camera.from_angles(*POSE),
                              lights=[SphereLight(*LIGHT)], device="cpu", cache=False)


def _fresh(box, cfg=CFG):
    """A renderer of the box's device scene and tables with its own
    accumulation."""
    return Renderer(box.device_scene, config=cfg, camera=box.camera, device="cpu", bvh=box.bvh)


@pytest.fixture(scope="module")
def sequential(box):
    """The sequential accumulation after 2, 8 and 16 samples."""
    r = _fresh(box)
    out = {}
    for n in (2, 8, 16):
        out[n] = r.render(n).clone()
    return out


def _launch(box, mesh, cfg=CFG, **kw):
    return render_sample_sharded(box.device_scene, box.bvh, box.camera, 0, mesh,
                                 width=cfg.width, height=cfg.height, cfg=cfg,
                                 has_alpha=box.has_alpha, **kw)


def test_eight_devices_available():
    mesh = make_mesh(n_tile=1, devices=DEVS)
    assert mesh.shape == {"tile": 1, "spp": 8}
    mesh = make_mesh(n_tile=2, n_spp=4, devices=DEVS)
    assert mesh.shape == {"tile": 2, "spp": 4}
    assert [[str(d) for d in row] for row in mesh.devices] == [["cpu"] * 4] * 2
    assert mesh.distinct() == [torch.device("cpu")] and mesh.first == torch.device("cpu")
    with pytest.raises(AssertionError):
        make_mesh(n_tile=3, n_spp=3, devices=DEVS)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceNotFound):
            make_mesh(n_tile=1, n_spp=1)


def test_spp_sharded_matches_sequential_statistics(box, sequential):
    """8-way spp sharding gives the mean image of the sequential samples
    0..7 (tpurt's bounds: median |diff| < 1e-5, mean < 1e-3)."""
    radiance, delivered = _launch(box, make_mesh(n_tile=1, n_spp=8, devices=DEVS))
    assert delivered == 8
    sharded = radiance.numpy()
    assert sharded.shape == (CFG.height, CFG.width, 4) and np.isfinite(sharded).all()
    diff = np.abs(sharded[..., :3] - sequential[8].numpy()[..., :3])
    assert np.median(diff) < 1e-5
    assert diff.mean() < 1e-3
    np.testing.assert_array_equal(sharded[..., 3], 1.0)


def test_tile_sharded_matches(box, sequential):
    """A 4 tile x 2 spp mesh reproduces the full-frame 2-sample image."""
    radiance, delivered = _launch(box, make_mesh(n_tile=4, n_spp=2, devices=DEVS))
    assert delivered == 2
    diff = np.abs(radiance.numpy()[..., :3] - sequential[2].numpy()[..., :3])
    assert np.median(diff) < 1e-5


def test_tile_only_mesh_is_the_banded_render_bit_for_bit(box):
    """T tiles x 1 spp renders each tile as the single-device render with
    bands of H / T rows renders that band: the same bits."""
    for n_tile in (2, 4, 8):
        radiance, stats = render_sample_stats_sharded(
            box.device_scene, box.bvh, box.camera, 3,
            make_mesh(n_tile=n_tile, n_spp=1, devices=DEVS[:n_tile]),
            width=CFG.width, height=CFG.height, cfg=CFG, has_alpha=box.has_alpha)[::2]
        ref, ref_stats = render_sample_stats(box.device_scene, box.bvh, box.camera, 3,
                                             width=CFG.width, height=CFG.height, cfg=CFG,
                                             has_alpha=box.has_alpha,
                                             chunk_rows=CFG.height // n_tile)
        assert torch.equal(radiance, ref), n_tile
        assert stats == ref_stats


def test_sharded_renderer_progressive(box, sequential):
    r = _fresh(box)
    sr = ShardedRenderer(r, make_mesh(n_tile=2, n_spp=4, devices=DEVS))
    sr.render(16)
    assert r.sample_count == 16
    img = r.accum.numpy()
    assert np.isfinite(img).all()
    # against the sequential 16 spp: the same estimator, other sample
    # indices per pixel and launch, so a Monte Carlo tolerance
    assert abs(img[..., :3].mean() - sequential[16].numpy()[..., :3].mean()) < 0.05
    assert r.rays.physical > 0 and r.last_stats.physical > 0


def test_banded_sharded_matches_unbanded(box):
    """Row bands (chunk_rows) are invisible in the result; each band is a
    multiple of the tile axis."""
    cfg = RenderConfig(width=32, height=48, max_samples=8)
    mesh = make_mesh(n_tile=2, n_spp=4, devices=DEVS)
    full, d_full = _launch(box, mesh, cfg)
    banded, d_banded = _launch(box, mesh, cfg, chunk_rows=20)  # 20-row bands
    assert d_full == d_banded == 4
    assert torch.equal(full, banded)


@pytest.mark.slow  # as tests/test_sharding.py marks it: 16 band renders of the alpha scene
def test_sharded_alpha_tested_scene_matches(tmp_path):
    """The alpha-tested mini Sponza: the sharded launch is the mean of the
    sequential samples 0..3, rendered in the tiles' 12-row bands, bit for
    bit (tpurt's bound is a median |diff| < 1e-5 against whole frames; on
    the CPU a whole-frame batch can round a pixel one ulp apart, ROADMAP
    queue 3), and the mesh counted exactly the rays the sequential
    samples traced."""
    cfg = RenderConfig(width=32, height=24, max_samples=4)
    lights = [SphereLight((-8.0, -5.0, -2.0), 0.1, (0.8, 0.6, 0.6), 500.0)]
    path = write_sponza_like_scene(str(tmp_path / "mini.gltf"), columns=1, foliage=8,
                                   stacks=1, segments=8, rings=6)
    r = Renderer.from_gltf(path, config=cfg, camera=Camera.from_angles([0.0, -4.0, 0.0], 0.7,
                                                                       -0.1),
                           lights=lights, device="cpu", cache=False)
    assert r.has_alpha, "the fixture must exercise the any-hit path"
    radiance, delivered, stats = render_sample_stats_sharded(
        r.device_scene, r.bvh, r.camera, 0, make_mesh(n_tile=2, n_spp=4, devices=DEVS),
        width=cfg.width, height=cfg.height, cfg=cfg, has_alpha=r.has_alpha,
        tex_flags=r.tex_flags)
    assert delivered == 4 and np.isfinite(radiance.numpy()).all()
    acc, total = None, np.zeros(2, np.float64)
    for s in range(4):
        img, rays = render_sample_stats(r.device_scene, r.bvh, r.camera, s, width=cfg.width,
                                        height=cfg.height, cfg=cfg, has_alpha=r.has_alpha,
                                        tex_flags=r.tex_flags, chunk_rows=12)
        acc = img if acc is None else acc + img
        total += (rays.logical, rays.physical)
    mean = acc / 4
    diff = np.abs(radiance.numpy()[..., :3] - mean.numpy()[..., :3])
    assert np.median(diff) < 1e-5
    assert torch.equal(radiance, mean)
    assert stats.logical == total[0] and stats.physical == total[1]


def test_sharded_spp_per_launch(box):
    """cfg.spp_per_launch batches samples inside each shard: one launch of
    an 8-tile mesh delivers spp_per_launch samples, the sequential
    stream's first launch (tpurt's median bound), and bit for bit the
    same launch rendered in the tiles' 3-row bands."""
    cfg = RenderConfig(width=32, height=24, max_samples=8, spp_per_launch=2)
    radiance, delivered = _launch(box, make_mesh(n_tile=8, n_spp=1, devices=DEVS), cfg)
    assert delivered == 2
    img = _fresh(box, cfg).render(2)  # one launch of 2 samples
    diff = np.abs(radiance.numpy()[..., :3] - img.numpy()[..., :3])
    assert np.median(diff) < 1e-5
    banded = _fresh(box, dataclasses.replace(cfg, chunk_rows=3)).render(2)
    assert torch.equal(radiance, banded)


def test_launch_matches_tpurts_sharded_launch(box, tmp_path):
    """One 4 tile x 2 spp launch of the box against tpurt's shard_map
    launch on its eight virtual CPU devices: the cross-package image
    bound, RMSE < 1e-5 (XLA's CPU FMAs differ from the port's rounding
    in the last ulp)."""
    import jax.numpy as jnp

    from tpurt import film as jfilm
    from tpurt.camera import Camera as JCamera
    from tpurt.config import RenderConfig as JRenderConfig
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.parallel import make_mesh as j_make_mesh
    from tpurt.parallel import render_sample_sharded as j_sharded
    from tpurt.renderer import Renderer as JRenderer
    from tpurt.scene.procedural import write_box_scene as j_write_box

    jcfg = JRenderConfig(width=CFG.width, height=CFG.height, max_samples=CFG.max_samples)
    jr = JRenderer.from_gltf(j_write_box(str(tmp_path / "box.gltf")), config=jcfg,
                             camera=JCamera.from_angles(*POSE), lights=[JSphereLight(*LIGHT)],
                             cache=False)
    ref, j_delivered = j_sharded(jr.device_scene, jr.bvh, jr.camera, 0,
                                 j_make_mesh(n_tile=4, n_spp=2), width=CFG.width,
                                 height=CFG.height, cfg=jcfg, has_alpha=jr.has_alpha,
                                 tex_flags=jr.tex_flags)
    got, delivered = _launch(box, make_mesh(n_tile=4, n_spp=2, devices=DEVS),
                             tex_flags=box.tex_flags)
    assert delivered == j_delivered == 2
    ref = np.asarray(jnp.asarray(ref))
    assert float(ref[..., :3].mean()) > 0.0
    err = jfilm.rmse(got.numpy(), ref)
    assert err < 1e-5, f"RMSE {err} against tpurt's sharded launch"
