"""The multi-walk traversal K5 (`traverse_packets(octet=N)`,
`occlusion_packets(octet=N)`) on the CPU, where it runs its plain
version `wide.octet_plain`.

Against tpurt: tpurt's own multi-walk kernel (`_octet_packets`) in
interpret mode with unroll=1, on the same numpy-seeded triangles and
rays, over tables carried across with convert.wide_bvh_from_numpy. tpurt
runs in a fresh subprocess, as its own octet tests do: the interpret
graphs crash XLA's CPU compiler mid-suite (tests/test_wide_kernel.py:
567-590). Both walk in the same order, so t agrees to 1e-5 relative
(XLA's CPU backend fuses multiply-adds, the port does not), prim is the
same triangle except on exact-t ties, pending is equal; in occlusion,
blocked is equal on every ray, and t/prim on the unblocked ones (tpurt
stops a walk only when its whole 1024-ray program is done, the port when
the walk's own rays are all blocked, which changes only the t/prim of
blocked rays). The walks=2 comparison runs in the fast gate; walks=8 and
the alpha-mask case on tpurt's mini Sponza are slow.

Against the port's K1/K2 plain version (`traverse_plain`): t bit-equal,
prim equal but for ties, pending equal; blocked equal on tables without
mask columns. Then the box golden rendered through K5, and
`convert.policy_from_tpurt`."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpurt.config import DEFAULT_KERNEL_POLICY as J_DEFAULT_POLICY
from tpurt.config import KernelPolicy as JKernelPolicy
from tpurt_torch import film
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.camera import Camera
from tpurt_torch.config import KernelPolicy, RenderConfig, SphereLight
from tpurt_torch.convert import policy_from_tpurt, wide_bvh_from_numpy
from tpurt_torch.kernels import wide
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tpurt's side: `python -c _TPURT <case> <walks> <out.npz>`
_TPURT = r'''
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from tpurt.bvh import build_triangle_bvh
from tpurt.kernels.pallas_wide import make_wide_kernel_bvh, occlusion_packets, traverse_packets

case, walks, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
n = 1024
if case == "random":
    r = np.random.RandomState(3)
    tris = ((r.rand(200, 1, 3) - 0.5) * 10 + (r.rand(200, 3, 3) - 0.5)).astype(np.float32)
    tb = build_triangle_bvh(jnp.asarray(tris), group_size=4)
    kb = make_wide_kernel_bvh(tb, jnp.asarray(tris))
    o = ((r.rand(n, 3) - 0.5) * 12).astype(np.float32)
    # aimed near random triangles, so most rays hit something
    d = tris[r.randint(0, 200, n)].mean(axis=1) + 0.3 * (r.rand(n, 3) - 0.5) - o
    has_alpha = False
else:
    import os, tempfile
    from tpurt.scene import build_device_scene, load_gltf
    from tpurt.scene.procedural import write_sponza_like_scene
    with tempfile.TemporaryDirectory() as td:
        path = write_sponza_like_scene(os.path.join(td, "mini.gltf"), columns=1, foliage=8,
                                       stacks=1, segments=8, rings=6)
        ds = build_device_scene(load_gltf(path))
    tris = np.asarray(ds.tri_pos)
    tb = build_triangle_bvh(ds.tri_pos, group_size=8)
    kb = make_wide_kernel_bvh(tb, ds.tri_pos, tri_alpha_mask=ds.tri_alpha_mask,
                              tri_alpha_opaque=ds.tri_alpha_opaque)
    r = np.random.RandomState(9)
    o = (np.tile([0.0, -4.0, 0.0], (n, 1)) + r.uniform(-1, 1, (n, 3))).astype(np.float32)
    d = r.normal(size=(n, 3))
    has_alpha = True
d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
t_limit = (1.0 + 8.0 * r.rand(n)).astype(np.float32)
z = jnp.zeros(n)
act = jnp.ones(n, bool)
t, p, _, _, pend = traverse_packets(kb, jnp.asarray(o), jnp.asarray(d), z, 1e9, act,
                                    interpret=True, cell_masks=True, octet=walks, unroll=1)
b, ot, op, _, _ = occlusion_packets(kb, jnp.asarray(o), jnp.asarray(d), z,
                                    jnp.asarray(t_limit), act, has_alpha, interpret=True,
                                    octet=walks, unroll=1)
res = {k: np.asarray(getattr(tb.bvh, k)) for k in tb.bvh._fields}
res.update(tri_order=np.asarray(tb.tri_order), node_rows=np.asarray(kb.node_rows),
           tri_rows=np.asarray(kb.tri_rows), tri_pos=np.asarray(kb.tri_pos), arity=kb.arity,
           tris=tris, o=o, d=d, t_limit=t_limit, has_alpha=has_alpha,
           t=np.asarray(t), prim=np.asarray(p),
           pending=np.zeros(n, bool) if pend is None else np.asarray(pend),
           blocked=np.asarray(b), occ_t=np.asarray(ot), occ_prim=np.asarray(op))
np.savez(out, **res)
'''


def _run_tpurt(tmp_path, case, walks):
    out = str(tmp_path / f"{case}_{walks}.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _TPURT, case, str(walks), out],
                         capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return dict(np.load(out))


def _hit_t(tris, o, d, prim):
    """Float64 Moller-Trumbore: the t at which each ray hits triangle
    `prim` (NaN where it misses)."""
    v = tris[prim].astype(np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    pv = np.cross(d, e2)
    det = (e1 * pv).sum(-1)
    s = o - v[:, 0]
    u = (s * pv).sum(-1) / det
    q = np.cross(s, e1)
    w = (d * q).sum(-1) / det
    t = (e2 * q).sum(-1) / det
    ok = (np.abs(det) > 1e-12) & (u >= -1e-6) & (w >= -1e-6) & (u + w <= 1 + 1e-6) & (t > 0)
    return np.where(ok, t, np.nan)


def _assert_hits_agree(t_got, p_got, t_ref, p_ref, tris, o, d):
    """Same hit set, t to 1e-5 relative; a differing prim must be a tie:
    the ray hits both triangles at the reference t. Returns the tie mask."""
    np.testing.assert_array_equal(p_got >= 0, p_ref >= 0)
    hit = p_ref >= 0
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=1e-5, atol=0)
    diff = hit & (p_got != p_ref)
    if diff.any():
        for p in (p_got, p_ref):
            np.testing.assert_allclose(_hit_t(tris, o[diff], d[diff], p[diff]), t_ref[diff],
                                       rtol=1e-5, atol=0)
    return diff


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check_against_tpurt(ref, walks):
    kb = wide_bvh_from_numpy(ref, device="cpu")
    o, d, t_limit, tris = ref["o"], ref["d"], ref["t_limit"], ref["tris"]
    n = o.shape[0]
    zeros, ones = torch.zeros(n), torch.ones(n, dtype=torch.bool)
    before = dict(wide.LAUNCHES)
    t, p, _, _, pend = wide.traverse_packets(kb, _t(o), _t(d), zeros, 1e9, ones,
                                             cell_masks=True, octet=walks)
    diff = _assert_hits_agree(t.numpy(), p.numpy(), ref["t"], ref["prim"], tris, o, d)
    if kb.use_masks:
        np.testing.assert_array_equal(pend.numpy()[~diff], ref["pending"][~diff])
    else:
        assert pend is None
    b, ot, op, _, _ = wide.occlusion_packets(kb, _t(o), _t(d), zeros, _t(t_limit), ones,
                                             bool(ref["has_alpha"]), octet=walks)
    np.testing.assert_array_equal(b.numpy(), ref["blocked"])
    free = ~ref["blocked"]
    _assert_hits_agree(ot.numpy()[free], op.numpy()[free], ref["occ_t"][free],
                       ref["occ_prim"][free], tris, o[free], d[free])
    assert wide.LAUNCHES == before  # CPU tensors: the plain version, no launch
    return int(ref["blocked"].sum()), int((ref["prim"] >= 0).sum())


def test_octet_plain_matches_tpurt_walks2(tmp_path):
    blocked, hits = _check_against_tpurt(_run_tpurt(tmp_path, "random", 2), 2)
    assert blocked > 100 and hits > 500


@pytest.mark.slow
def test_octet_plain_matches_tpurt_walks8(tmp_path):
    blocked, hits = _check_against_tpurt(_run_tpurt(tmp_path, "random", 8), 8)
    assert blocked > 100 and hits > 500


@pytest.mark.slow
def test_octet_plain_matches_tpurt_alpha_masks(tmp_path):
    ref = _run_tpurt(tmp_path, "alpha", 8)
    assert ref["pending"].any()
    _check_against_tpurt(ref, 8)


# ---- against the port's own K1/K2 plain version ---------------------------

def _scene(masks: bool, n_tris=300, seed=3):
    """Wide tables over `n_tris` random triangles, and the triangles."""
    r = np.random.RandomState(seed)
    tris = ((r.rand(n_tris, 1, 3) - 0.5) * 10 + (r.rand(n_tris, 3, 3) - 0.5)).astype(np.float32)
    mk = ((r.rand(n_tris) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, n_tris)
    opaque = r.randint(0, 1 << 16, n_tris).astype(np.int32) & ~mk & 0xFFFF
    kb = wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 8), tris,
                                   tri_alpha_mask=mk.astype(np.int32) if masks else None,
                                   tri_alpha_opaque=opaque if masks else None, device="cpu")
    return kb, tris


def _rays(n, seed):
    r = np.random.RandomState(seed)
    o = ((r.rand(n, 3) - 0.5) * 12).astype(np.float32)
    d = r.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    lim = np.where(np.arange(n) % 7 == 0, -3e38, 1e9).astype(np.float32)  # some inactive
    return _t(o), _t(d), torch.zeros(n), _t(lim)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("walks", [2, 4, 8])
def test_octet_plain_matches_k1_k2(walks, masks):
    """1,500 rays: a ragged last walk. Closest with and without cell
    masks: t bit-equal, prim but for exact-t ties (each differing ray
    hits both triangles at that t), pending where prim agrees. Occlusion without mask columns: blocked equal with every hit
    definite, and the closest hit's t with none definite."""
    kb, tris = _scene(masks)
    o, d, z, lim = _rays(1500, seed=walks)
    kw = dict(group=kb.group_size, arity=kb.arity)
    for cell_masks in (False, True):
        c = dict(occlusion=False, all_definite=False, cell_masks=cell_masks)
        t1, p1, f1 = wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, z, lim, **kw, **c)
        t5, p5, f5 = wide.octet_plain(kb.node_rows, kb.tri_rows, o, d, z, lim, walks=walks,
                                      **kw, **c)
        assert torch.equal(t5.view(torch.int32), t1.view(torch.int32))
        diff = _assert_hits_agree(t5.numpy(), p5.numpy(), t1.numpy(), p1.numpy(), tris,
                                  o.numpy(), d.numpy())
        same = torch.from_numpy(~diff)
        assert torch.equal(f5[same], f1[same])
        assert bool((p5[lim < 0] == -1).all())
        if masks and cell_masks:
            assert bool((f1 > 0).any())
    if not masks:
        short = torch.where(lim > 0, torch.full_like(lim, 3.0), lim)
        for all_definite in (True, False):
            c = dict(occlusion=True, all_definite=all_definite, cell_masks=False)
            t2, _, b2 = wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, z, short, **kw, **c)
            t5, _, b5 = wide.octet_plain(kb.node_rows, kb.tri_rows, o, d, z, short,
                                         walks=walks, **kw, **c)
            assert torch.equal(b5, b2)
            assert bool(b2.any()) == all_definite
            if not all_definite:
                assert torch.equal(t5.view(torch.int32), t2.view(torch.int32))


def test_octet_routing_and_arguments():
    """CPU tensors run octet_plain through the wrappers and launch nothing;
    a walk count other than 2, 4 or 8 is refused."""
    kb, _ = _scene(False, n_tris=60)
    o, d, z, lim = _rays(300, seed=1)
    ones = torch.ones(300, dtype=torch.bool)
    before = dict(wide.LAUNCHES)
    t, p, u, v = wide.traverse_packets(kb, o, d, z, 1e9, ones, octet=4)
    tp, pp, _ = wide.octet_plain(kb.node_rows, kb.tri_rows, o, d, z,
                                 torch.full((300,), 1e9), group=kb.group_size, arity=kb.arity,
                                 walks=4, occlusion=False, all_definite=False, cell_masks=False)
    assert torch.equal(t, tp) and torch.equal(p, pp) and bool((u[p >= 0] != 0).any())
    _, _, u0, v0 = wide.traverse_packets(kb, o, d, z, 1e9, ones, octet=4, need_uv=False)
    assert not bool(u0.any()) and not bool(v0.any())
    assert wide.LAUNCHES == before
    for bad in (1, 3, 16):
        with pytest.raises(ValueError):
            wide.traverse_packets(kb, o, d, z, 1e9, ones, octet=bad)


def test_render_through_octet_matches_box_golden(tmp_path):
    """The box golden's configuration with every closest and occlusion
    query through K5 (8 walks): the same image within the goldens' RMSE
    bound."""
    path = write_box_scene(str(tmp_path / "box.gltf"))
    cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    cfg = RenderConfig(width=64, height=48, max_samples=8,
                       kernel=KernelPolicy(octet_closest=8, octet_occlusion=8))
    r = Renderer.from_gltf(path, config=cfg, camera=cam, device="cpu",
                           lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)])
    calls = {"octet": 0}
    plain = wide.octet_plain

    def counted(*args, **kw):
        calls["octet"] += 1
        return plain(*args, **kw)

    wide.octet_plain = counted
    try:
        img = r.render(8).numpy()
    finally:
        wide.octet_plain = plain
    assert calls["octet"] > 0
    golden = np.load(os.path.join(ROOT, "tests", "goldens", "box_64x48_8spp.npz"))["accum"]
    assert film.rmse(img, golden) < 1e-5


def test_policy_from_tpurt():
    assert policy_from_tpurt(dataclasses.asdict(J_DEFAULT_POLICY)) == KernelPolicy()
    assert RenderConfig().kernel == KernelPolicy()
    jp = dataclasses.replace(JKernelPolicy(), octet_closest=8, octet_occlusion=4,
                             sort_wave0=True, cell_masks_closest=False)
    assert policy_from_tpurt(dataclasses.asdict(jp)) == KernelPolicy(
        sort_wave0=True, cell_masks_closest=False, octet_closest=8, octet_occlusion=4)
    for field, value in (("sup_closest", 1), ("pair_closest", True), ("unroll", 8),
                         ("sort_retrace", True)):
        with pytest.raises(ValueError, match=field):
            policy_from_tpurt(dataclasses.asdict(dataclasses.replace(JKernelPolicy(),
                                                                     **{field: value})))
        with pytest.raises(TypeError):
            KernelPolicy(**{field: value})
    with pytest.raises(KeyError):
        policy_from_tpurt({"no_such_field": 1})
