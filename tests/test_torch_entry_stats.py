"""`render_sample_stats` and `render_rows_stats`, the port's ray-counting
entry points, against tpurt's on the small Sponza-like scene (columns=2,
foliage=8: 9,088 triangles, alpha-tested foliage) at 32x24 with the
bench's camera and three lights: the logical and physical counts of
samples 0 and 1 equal tpurt's exactly, whole frame and in 12-row bands,
on the wide and on the rope path. tpurt renders on the CPU through its
binary-BVH walk, the path that made the goldens.

The single-sample image is tpurt's but for a few pixels: on this scene
the port meets the goldens' RMSE bound of 1e-5 only off the pixels
whose path branches on a last-bit difference, the standing CPU fault of
ROADMAP.md's queue 3 (XLA contracts multiply-adds into FMAs, and its
sin, cos, exp, log and pow differ from PyTorch's by an ulp on a few
percent of inputs). Measured: 8 and 6 of 768 pixels differ by more than
1e-4 in samples 0 and 1 (whole-image RMSE 1.4e-3 and 1.5e-4; 2 and 1
pixels, 3.2e-4 and 1.7e-5, against tpurt without FMA). So: at most 2%
of the pixels differ by more than 1e-4, and the others are within RMSE
1e-5. The box, which has no such pixel, is held to 1e-5 whole
(tests/test_torch_cli.py, tests/test_torch_golden.py)."""

import numpy as np
import pytest

from tpurt_torch import film
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator.wavefront import (
    render_rows,
    render_rows_stats,
    render_sample,
    render_sample_stats,
)
from tpurt_torch.kernels.experimental import rope
from tpurt_torch.kernels.wide import WideKernelBVH
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.gltf import load_gltf
from tpurt_torch.scene.procedural import write_sponza_like_scene

W, H = 32, 24
SCENE_KW = dict(columns=2, foliage=8)
POSE = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHTS = [((-8.0, -5.0, -2.0), 0.1, (0.8, 0.6, 0.6), 500.0),
          ((8.0, -5.0, -2.5), 0.1, (0.4, 0.7, 0.6), 500.0),
          ((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)]
CFG = RenderConfig(width=W, height=H, max_samples=4)
CHUNKS = (0, 12)
SAMPLES = (0, 1)
# pixels that may branch away from tpurt's path (see the module docstring)
BRANCH_DIFF, BRANCH_SHARE = 1e-4, 0.02


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_sponza_like_scene(str(tmp_path_factory.mktemp("s") / "s.gltf"), **SCENE_KW)


@pytest.fixture(scope="module")
def tpurt_stats(scene_path):
    """{(chunk_rows, sample): (image, logical, physical)} from tpurt."""
    import jax.numpy as jnp

    from tpurt.camera import Camera as JCamera
    from tpurt.config import RenderConfig as JRenderConfig
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.integrator.wavefront import render_sample_stats as j_stats
    from tpurt.renderer import Renderer as JRenderer

    jcfg = JRenderConfig(width=W, height=H, max_samples=4)
    jr = JRenderer.from_gltf(scene_path, config=jcfg, camera=JCamera.from_angles(*POSE),
                             lights=[JSphereLight(*x) for x in LIGHTS], cache=False)
    out = {}
    for chunk in CHUNKS:
        for s in SAMPLES:
            img, st = j_stats(jr.device_scene, jr.bvh, jr.camera, jnp.uint32(s), width=W,
                              height=H, cfg=jcfg, has_alpha=jr.has_alpha,
                              tex_flags=jr.tex_flags, chunk_rows=chunk)
            out[(chunk, s)] = (np.asarray(img), st.logical, st.physical)
    return out


@pytest.fixture(scope="module")
def renderers(scene_path):
    """The port's wide-path and rope-path renderers of the scene."""
    kw = dict(config=CFG, camera=Camera.from_angles(*POSE),
              lights=[SphereLight(*x) for x in LIGHTS], device="cpu")
    wide_r = Renderer.from_gltf(scene_path, **kw)
    assert isinstance(wide_r.bvh, WideKernelBVH) and wide_r.has_alpha
    tri = wide_r.device_scene.tri_pos.numpy()
    rope_r = Renderer(load_gltf(scene_path), bvh=build_triangle_bvh(tri, group_size=8), **kw)
    assert isinstance(rope_r.bvh, rope.KernelBVH)
    return {"wide": wide_r, "rope": rope_r}


def _stats(r, s, chunk):
    return render_sample_stats(r.device_scene, r.bvh, r.camera, s, width=W, height=H,
                               cfg=CFG, has_alpha=r.has_alpha, tex_flags=r.tex_flags,
                               chunk_rows=chunk)


@pytest.fixture(scope="module")
def port_stats(renderers):
    """{(path, chunk_rows, sample): (image, RayStats)} from the port."""
    return {(path, chunk, s): _stats(r, s, chunk) for path, r in renderers.items()
            for chunk in CHUNKS for s in SAMPLES}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("path", ["wide", "rope"])
def test_counts_and_image_match_tpurt(port_stats, tpurt_stats, path, chunk):
    for s in SAMPLES:
        img, st = port_stats[(path, chunk, s)]
        ref, logical, physical = tpurt_stats[(chunk, s)]
        assert (st.logical, st.physical) == (logical, physical), (path, chunk, s)
        assert img.shape == (H, W, 4) and bool(img.isfinite().all())
        img = img.numpy()
        branched = np.abs(img - ref).max(axis=-1) > BRANCH_DIFF
        assert branched.mean() <= BRANCH_SHARE, \
            f"{path} chunk_rows={chunk} sample {s}: {int(branched.sum())} pixels differ"
        err = film.rmse(img[~branched], ref[~branched])
        assert err < 1e-5, f"{path} chunk_rows={chunk} sample {s}: RMSE {err}"


@pytest.mark.parametrize("path", ["wide", "rope"])
def test_bands_sum_to_the_frame(port_stats, path):
    """In 12-row bands (render_rows_stats per band) a sample counts the
    rays of the whole frame, and its image is the whole frame's within
    1e-5 RMSE (a band's rays go through the batch in another order)."""
    for s in SAMPLES:
        img, st = port_stats[(path, 0, s)]
        bands, bst = port_stats[(path, 12, s)]
        assert (bst.logical, bst.physical) == (st.logical, st.physical)
        assert film.rmse(bands, img) < 1e-5


def test_return_stats_flags_are_the_stats_entry_points(renderers, port_stats):
    """render_sample and render_rows, with and without return_stats, give
    the stats entry points' image and counts."""
    r = renderers["wide"]
    kw = dict(width=W, height=H, cfg=CFG, has_alpha=r.has_alpha, tex_flags=r.tex_flags)
    img, st = port_stats[("wide", 0, 0)]
    img2 = render_sample(r.device_scene, r.bvh, r.camera, 0, **kw)
    assert np.array_equal(img2.numpy(), img.numpy())
    band, bst = render_rows(r.device_scene, r.bvh, r.camera, 0, 12, rows=12,
                            return_stats=True, **kw)
    band2, bst2 = render_rows_stats(r.device_scene, r.bvh, r.camera, 0, 12, rows=12, **kw)
    assert np.array_equal(band.numpy(), band2.numpy()) and bst == bst2
    assert film.rmse(band, img[12:]) < 1e-5 and 0 < bst.physical < st.physical


def test_renderer_last_stats_are_the_sample_counts(renderers, tpurt_stats):
    """Renderer.step records each sample's RayStats (the bench's ray
    counts are held against them on the card)."""
    r = renderers["wide"]
    r.reset()
    r.sample_count = 1  # resume at sample 1
    r.step()
    _, logical, physical = tpurt_stats[(0, 1)]
    assert (r.last_stats.logical, r.last_stats.physical) == (logical, physical)
    assert r.rays == r.last_stats and r.sample_count == 2
