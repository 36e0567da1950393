"""Per-ray maths of the port (BSDF, light sampling, textures, intersection)
against tpurt on the same random inputs.

Tolerances. Comparisons and selects agree exactly. Float results agree to
atol 1e-5 / rtol 1e-4 (a few float32 ulps: XLA's CPU backend contracts
multiply-adds into FMAs and has its own exp/log/sin/cos/pow, PyTorch does
neither the same way) on at least 99.9% of the elements. The rest are
inputs where `sqrt(1 - c*c)` cancels catastrophically (c within ~1e-4 of
1): there XLA's fused `1 - c*c` keeps bits that two roundings lose, and a
one-ulp difference upstream becomes up to ~1e-3 relative; those must
still agree to 5e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpurt.kernels import bsdf as jb
from tpurt.kernels import intersect as ji
from tpurt.kernels import lights as jl
from tpurt.kernels import texture as jt
from tpurt_torch.kernels import bsdf as tb
from tpurt_torch.kernels import intersect as ti
from tpurt_torch.kernels import lights as tl
from tpurt_torch.kernels import texture as tt

N = 4096


def _unit(r, n):
    v = r.randn(n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    r = np.random.RandomState(seed)
    n = _unit(r, N)
    wo = _unit(r, N)
    wo = np.where((np.sum(wo * n, -1) < 0)[:, None], -wo, wo).astype(np.float32)
    wi = _unit(r, N)
    alpha = np.concatenate([r.rand(N - 8) * 1.2, [0.0, 1e-5, 0.005, 0.01, 0.5, 1.0, 2.0, 0.3]])
    u1 = r.rand(N).astype(np.float32)
    u2 = r.rand(N).astype(np.float32)
    n[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1]]  # frame branches
    return n, wo, wi, alpha.astype(np.float32), u1, u2


def _cmp(got, ref, atol=1e-5, rtol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    got, ref = got[ok], ref[ok]
    close = np.isclose(got, ref, atol=atol, rtol=rtol)
    assert close.mean() >= 0.999, f"{(~close).sum()} of {close.size} differ"
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=5e-3)


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("seed", [0, 1])
def test_bsdf_terms_match(seed):
    n, wo, wi, alpha, _, _ = _inputs(seed)
    _cmp(tb.microfacet_bsdf(T(wi), T(wo), T(n), T(alpha)),
         jb.microfacet_bsdf(J(wi), J(wo), J(n), J(alpha)))
    _cmp(tb.pdf_microfacet(T(wi), T(wo), T(n), T(alpha)),
         jb.pdf_microfacet(J(wi), J(wo), J(n), J(alpha)))
    _cmp(tb.microfacet_weight(T(wi), T(wo), T(n), T(alpha)),
         jb.microfacet_weight(J(wi), J(wo), J(n), J(alpha)))
    c = np.linspace(-1, 1, N).astype(np.float32)
    _cmp(tb.fresnel(T(c)), jb.fresnel(J(c)))
    x = np.linspace(-3, 3, N).astype(np.float32)
    _cmp(tb.erf_approx(T(x)), jb.erf_approx(J(x)))
    _cmp(tb.erf_inv_approx(T(x / 3)), jb.erf_inv_approx(J(x / 3)))
    _cmp(tb.roughness_to_alpha(T(alpha)), jb.roughness_to_alpha(J(alpha)))
    _cmp(tb.power_heuristic(1.0, T(alpha), 1.0, 0.159), jb.power_heuristic(1.0, J(alpha), 1.0, 0.159))
    _cmp(tb.power_heuristic(1.0, 0.159, 1.0, T(alpha)), jb.power_heuristic(1.0, 0.159, 1.0, J(alpha)))
    _cmp(tb.reflect(T(wo), T(n)), jb.reflect(J(wo), J(n)))


@pytest.mark.parametrize("seed", [0, 1])
def test_microfacet_sampling_matches(seed):
    n, wo, _, alpha, u1, u2 = _inputs(seed)
    alpha = np.maximum(alpha, 0.01).astype(np.float32)
    _cmp(tb.sample_microfacet_distribution(T(wo), T(n), T(alpha), T(u1), T(u2)),
         jb.sample_microfacet_distribution(J(wo), J(n), J(alpha), J(u1), J(u2)), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_light_sampling_matches(seed):
    n, wo, _, _, u1, u2 = _inputs(seed)
    r = np.random.RandomState(seed + 10)
    p = ((r.rand(N, 3) - 0.5) * 10).astype(np.float32)
    lp = ((r.rand(N, 3) - 0.5) * 10).astype(np.float32)
    lp[:64] = p[:64] + 0.01  # origin inside the sphere
    rad = (0.05 + r.rand(N)).astype(np.float32)
    _cmp(tl.sample_hemisphere_uniform(T(n), T(u1), T(u2)),
         jl.sample_hemisphere_uniform(J(n), J(u1), J(u2)))
    ds = tl.sample_sphere(T(p), T(lp), T(rad), T(u1), T(u2))
    _cmp(ds, jl.sample_sphere(J(p), J(lp), J(rad), J(u1), J(u2)), atol=1e-4)
    _cmp(tl.pdf_sphere(T(p), T(wo), T(lp), T(rad)), jl.pdf_sphere(J(p), J(wo), J(lp), J(rad)))


@pytest.mark.parametrize("wrap", [0, 1, 2])
@pytest.mark.parametrize("filt", [0, 1])
def test_texture_sampling_matches(wrap, filt):
    r = np.random.RandomState(wrap * 2 + filt)
    atlas = r.randint(0, 256, (24, 40, 4)).astype(np.uint8)
    quad = r.randint(0, 256, (24, 40, 16)).astype(np.uint8)
    table = np.array([[3, 2, 9, 7, wrap, wrap, filt, 1, 5, 4],
                      [0, 10, 16, 12, wrap, (wrap + 1) % 3, filt, 0, 20, 8]], np.int32)
    tex = r.randint(0, 2, N).astype(np.int32)
    u = ((r.rand(N) - 0.5) * 6).astype(np.float32)
    v = ((r.rand(N) - 0.5) * 6).astype(np.float32)
    _cmp(tt.sample_texture(T(atlas), T(table[:, :8].copy()), T(tex), T(u), T(v)),
         jt.sample_texture(J(atlas), J(table[:, :8]), J(tex), J(u), J(v)))
    _cmp(tt.sample_texture_quad(T(quad), T(table), T(tex), T(u), T(v)),
         jt.sample_texture_quad(J(quad), J(table), J(tex), J(u), J(v)))
    np.testing.assert_array_equal(
        tt.sample_texture_alpha_quad(T(quad), T(table), T(tex), T(u), T(v)).numpy(),
        np.asarray(jt.sample_texture_alpha_quad(J(quad), J(table), J(tex), J(u), J(v))))


def test_intersection_matches():
    r = np.random.RandomState(5)
    o = ((r.rand(N, 3) - 0.5) * 4).astype(np.float32)
    d = _unit(r, N)
    v0, v1, v2 = (((r.rand(N, 3) - 0.5) * 4).astype(np.float32) for _ in range(3))
    tmin = np.zeros(N, np.float32)
    hj, tj, uj, vj = ji.ray_triangle(J(o), J(d), J(v0), J(v1), J(v2), J(tmin), 1e9)
    ht, tt_, ut, vt = ti.ray_triangle(T(o), T(d), T(v0), T(v1), T(v2), T(tmin), 1e9)
    agree = ht.numpy() == np.asarray(hj)
    assert agree.mean() > 0.999
    both = agree & ht.numpy()
    for a, b in ((tt_, tj), (ut, uj), (vt, vj)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], rtol=1e-4, atol=1e-5)
    lights = np.array([[0.5, 0.2, -0.3, 0.4, 1, 1, 1, 5], [-1.0, 0.8, 0.1, 0.25, 1, 0, 0, 9],
                       [0.0, 0.0, 5.0, 2.0, 0, 1, 0, 1]], np.float32)
    sj = ji.intersect_spheres(J(o), J(d), J(lights), J(tmin), 1e9)
    st = ti.intersect_spheres(T(o), T(d), T(lights), T(tmin), 1e9)
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(sj[0]))
    np.testing.assert_array_equal(st[2].numpy()[st[0].numpy()], np.asarray(sj[2])[st[0].numpy()])
    _cmp(st[1][st[0]], np.asarray(sj[1])[st[0].numpy()])
    _cmp(ti.safe_inv_dir(T(d)), ji.safe_inv_dir(J(d)), atol=0, rtol=0)
