"""RNG, camera and film of the port against tpurt on the same inputs:
the RNG streams and camera RNG states bit-equal; ray origins/directions
within 1e-6 (XLA's CPU backend contracts multiply-adds into FMAs and
PyTorch's does not, so the last bit may differ); film maths within 1e-6
for the same reason plus the libm difference in exp/pow."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpurt import camera as jcam
from tpurt import film as jfilm
from tpurt import rng as jrng
from tpurt_torch import camera as tcam
from tpurt_torch import film as tfilm
from tpurt_torch import rng as trng
from tpurt_torch.utils import png


def _u32(seed, n):
    return np.random.RandomState(seed).randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcg_hash_bit_equal(seed):
    x = _u32(seed, 10000)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    ref = np.asarray(jrng.pcg_hash(jnp.asarray(x)))
    got = trng.pcg_hash(_t(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.mark.parametrize("sample,seed", [(0, 0), (7, 0), (3, 42), (123456, 2 ** 31 + 5)])
def test_init_state_bit_equal(sample, seed):
    pix = np.arange(5000, dtype=np.uint32) * 37
    ref = np.asarray(jrng.init_state(jnp.asarray(pix), sample, seed))
    got = trng.init_state(_t(pix), sample, seed).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_next_uniform2_bit_equal():
    state = _u32(5, 20000)
    js, ju1, ju2 = jrng.next_uniform2(jnp.asarray(state))
    ts, tu1, tu2 = trng.next_uniform2(_t(state))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_array_equal(tu1.numpy(), np.asarray(ju1))
    np.testing.assert_array_equal(tu2.numpy(), np.asarray(ju2))
    assert tu1.dtype == torch.float32 and float(tu1.max()) < 1.0


def _cams():
    return ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)


@pytest.mark.parametrize("spp", [1, 3])
@pytest.mark.parametrize("row_start,rows", [(0, 48), (16, 8)])
def test_camera_rays_for_rows_match(spp, row_start, rows):
    pos, phi, theta = _cams()
    jc = jcam.Camera.from_angles(pos, phi, theta)
    tc = tcam.Camera.from_angles(pos, phi, theta)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jo, jd, js = jcam.camera_rays_for_rows(jc, row_start, rows, 64, 48, 0.41421356, 5, 9,
                                           spp=spp)
    to, td, ts = tcam.camera_rays_for_rows(tc, row_start, rows, 64, 48, 0.41421356, 5, 9,
                                           spp=spp, device="cpu")
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_generate_rays_match():
    w, h = 32, 24
    state = _u32(11, w * h)
    jo, jd, js = jcam.generate_rays(jcam.Camera.default(), w, h, 0.41421356, jnp.asarray(state))
    to, td, ts = tcam.generate_rays(tcam.Camera.default(), w, h, 0.41421356, _t(state))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jcam.Camera.default().up),
                               tcam.Camera.default().up.numpy(), atol=0)


@pytest.mark.parametrize("count", [1, 2, 7])
def test_accumulate_matches(count):
    r = np.random.RandomState(count)
    prev = r.rand(6, 5, 4).astype(np.float32)
    new = (r.rand(6, 5, 4) * 3).astype(np.float32)
    new[2, 3, 1] = np.nan
    ref = np.asarray(jfilm.accumulate(jnp.asarray(prev), jnp.asarray(new), count))
    got = tfilm.accumulate(torch.from_numpy(prev), torch.from_numpy(new), count).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2, 3], [1.0, 0.0, 0.0, 1.0])


def test_tonemap_and_srgb8_match():
    x = (np.random.RandomState(3).rand(16, 9, 4) * 2).astype(np.float32)
    ref = np.asarray(jfilm.tonemap(jnp.asarray(x), 3.0))
    got = tfilm.tonemap(torch.from_numpy(x), 3.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tfilm.to_srgb8(torch.from_numpy(ref.copy())), jfilm.to_srgb8(ref))
    a, b = x[..., 0], x[..., 1]
    assert tfilm.rmse(torch.from_numpy(a), b) == jfilm.rmse(a, b)


def test_save_png_round_trips(tmp_path):
    from PIL import Image

    x = np.random.RandomState(4).rand(12, 17, 4).astype(np.float32)
    path = str(tmp_path / "img.png")
    tfilm.save_png(path, torch.from_numpy(x))
    expect = tfilm.to_srgb8(torch.from_numpy(x))[..., :3]
    with Image.open(path) as img:
        assert img.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(img), expect)
    np.testing.assert_array_equal(png.read_png(path)[..., :3], expect)
    assert (png.read_png(path)[..., 3] == 255).all()


def test_render_config_defaults_match_tpurt():
    """Every port RenderConfig field has tpurt's default (the kernel policy
    carried across with convert.policy_from_tpurt); the fields the port
    leaves out are tpurt's fixed-capacity compaction knobs, which never
    change a rendered value, and two fields that nothing reads
    (samples_per_launch, t_min)."""
    import dataclasses

    from tpurt import config as jconfig
    from tpurt_torch import config as tconfig
    from tpurt_torch.convert import policy_from_tpurt

    left_out = {"compact_ladder", "shade_frac", "retrace_frac",
                "retrace_gather", "shade_gather", "ladder_gather",
                "samples_per_launch", "t_min"}
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.RenderConfig)}
    assert set(jf) - set(tf) == left_out
    assert set(tf) <= set(jf)
    jf["kernel"] = policy_from_tpurt(dataclasses.asdict(jf["kernel"]))
    for name, default in tf.items():
        assert default == jf[name], name
    assert tconfig.RenderConfig().tan_half_fov == jconfig.RenderConfig().tan_half_fov
    assert [dataclasses.astuple(x) for x in tconfig.DEFAULT_SPONZA_LIGHTS] == \
        [dataclasses.astuple(x) for x in jconfig.DEFAULT_SPONZA_LIGHTS]
