"""The step-cost instrument K6 (`wide.stepcost_packets`) on the CPU, where
it runs its plain version `wide.stepcost_plain`.

With every phase on, K6 walks K1's walk for a fixed number of steps and
restarts at the root, so once the steps cover a ray's walk its t and prim
equal traverse_plain's closest hit bit for bit. Against tpurt's
`stepcost_packets` (interpret mode, unroll=1) only t is comparable: tpurt
walks one octant per 1024-ray packet over the packet's union, which gives
each ray the same closest t once the steps cover the packet's walk, and
it folds its scalar accumulator into prim, so its prim is not a triangle
id. t agrees to 1e-5 relative (XLA's CPU backend fuses multiply-adds,
the port does not). Every configuration kernel_bench times runs and gives
the same outputs twice."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import build_triangle_bvh as j_build_bvh
from tpurt.kernels import pallas_wide as jw
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.convert import wide_bvh_from_numpy
from tpurt_torch.kernels import wide


def _tris(n, seed):
    r = np.random.RandomState(seed)
    return ((r.rand(n, 1, 3) - 0.5) * 10 + (r.rand(n, 3, 3) - 0.5)).astype(np.float32)


def _aimed_rays(tris, n, seed):
    """Rays from a 12-wide box aimed near random triangles."""
    r = np.random.RandomState(seed)
    o = ((r.rand(n, 3) - 0.5) * 12).astype(np.float32)
    d = tris[r.randint(0, tris.shape[0], n)].mean(axis=1) + 0.3 * (r.rand(n, 3) - 0.5) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _masked_tables(n_tris=300, seed=5):
    tris = _tris(n_tris, seed)
    r = np.random.RandomState(seed)
    mk = ((r.rand(n_tris) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, n_tris)
    return wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 8), tris,
                                     tri_alpha_mask=mk.astype(np.int32), device="cpu"), tris


def test_full_step_equals_k1_once_the_walk_is_covered():
    """Leaf rows with a mask column (the id lanes move): with every phase
    on and steps >= the longest walk, t and prim equal K1's bit for bit;
    a few steps short of some walks they do not."""
    kb, tris = _masked_tables()
    o, d = _aimed_rays(tris, 2000, seed=6)
    z = torch.zeros(2000)
    lim = torch.from_numpy(np.where(np.arange(2000) % 9 == 0, -3e38, 1e9).astype(np.float32))
    kw = dict(group=kb.group_size, arity=kb.arity)
    stats = {}
    t1, p1, _ = wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, z, lim, occlusion=False,
                                    all_definite=False, cell_masks=False, stats=stats, **kw)
    walk = int((stats["node_visits"] + stats["leaf_visits"]).max())
    assert int((p1 >= 0).sum()) > 800
    t6, p6, _ = wide.stepcost_packets(kb, o, d, z, lim, steps=walk)
    assert torch.equal(t6.view(torch.int32), t1.view(torch.int32))
    assert torch.equal(p6, p1)
    t6, p6, _ = wide.stepcost_packets(kb, o, d, z, lim, steps=walk + 7)
    assert torch.equal(t6.view(torch.int32), t1.view(torch.int32)) and torch.equal(p6, p1)
    t_short, _, _ = wide.stepcost_packets(kb, o, d, z, lim, steps=max(walk // 4, 1))
    assert not torch.equal(t_short, t1)


def test_full_step_t_matches_tpurt_stepcost():
    tris = _tris(64, seed=7)
    jtb = j_build_bvh(jnp.asarray(tris), group_size=4)
    jkb = jw.make_wide_kernel_bvh(jtb, jnp.asarray(tris))
    arrays = {k: np.asarray(getattr(jtb.bvh, k)) for k in jtb.bvh._fields}
    arrays.update(tri_order=np.asarray(jtb.tri_order), node_rows=np.asarray(jkb.node_rows),
                  tri_rows=np.asarray(jkb.tri_rows), tri_pos=np.asarray(jkb.tri_pos),
                  arity=jkb.arity)
    kb = wide_bvh_from_numpy(arrays, device="cpu")
    steps = 64
    # a packet visits each wide node and leaf at most once per walk
    assert kb.node_rows.shape[1] + kb.tri_rows.shape[0] <= steps
    o, d = _aimed_rays(tris, 1024, seed=8)
    z = np.zeros(1024, np.float32)
    lim = np.full(1024, 1e9, np.float32)
    octants, *rays, _ = jw._layout(jkb, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                   jnp.asarray(z), jnp.asarray(lim), jnp.ones(1024, bool))
    jt, _, _ = jw.stepcost_packets(octants, jkb.node_rows, jkb.tri_rows, *rays,
                                   group=jtb.group_size, steps=steps, unroll=1,
                                   arity=jkb.arity, interpret=True)
    jt = np.asarray(jt).reshape(-1)
    t, p, _ = wide.stepcost_packets(kb, o, d, torch.from_numpy(z), torch.from_numpy(lim),
                                    steps=steps)
    hit = p.numpy() >= 0
    assert hit.sum() > 500
    np.testing.assert_array_equal(jt < 1e9, hit)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=0)


@pytest.mark.parametrize("config", [name for name, _ in wide.STEPCOST_CONFIGS])
def test_every_config_runs_and_is_deterministic(config):
    """Each kernel_bench configuration: shapes and types, the same outputs
    twice, and what its off phases imply (no leaf phase: no hit; no
    phase at all: the accumulator counts 0x5 per step)."""
    toggles = dict(wide.STEPCOST_CONFIGS)[config]
    kb, tris = _masked_tables(n_tris=120, seed=9)
    o, d = _aimed_rays(tris, 700, seed=10)
    z, lim = torch.zeros(700), torch.full((700,), 1e9)
    before = dict(wide.LAUNCHES)
    out1 = wide.stepcost_packets(kb, o, d, z, lim, steps=40, **toggles)
    out2 = wide.stepcost_packets(kb, o, d, z, lim, steps=40, **toggles)
    assert wide.LAUNCHES == before
    t, p, acc = out1
    assert t.dtype == torch.float32 and p.dtype == torch.int32 and acc.dtype == torch.int32
    assert all(x.shape == (700,) for x in out1)
    for a, b in zip(out1, out2):
        assert torch.equal(a, b)
    if toggles.get("do_leaf", True):
        assert bool((p >= 0).any())
    else:
        assert bool((p == -1).all()) and bool((t == lim).all())
    if config == "-box":
        assert bool((acc == 40 * 5).all())
    else:
        assert bool(acc.any())


def test_stack_saturates_without_extract():
    """With the kind and link loads off every slot is an internal child
    pointing at the root, so the stack fills; pushes past its size are
    dropped and the walk goes on."""
    kb, tris = _masked_tables(n_tris=120, seed=9)
    o, d = _aimed_rays(tris, 64, seed=11)
    z, lim = torch.zeros(64), torch.full((64,), 1e9)
    t, p, acc = wide.stepcost_packets(kb, o, d, z, lim, steps=wide.MAX_STACK + 40,
                                      do_extract=False)
    assert bool((p == -1).all())
    with pytest.raises(ValueError):
        wide.stepcost_packets(kb, o, d, z, lim, steps=0)


def test_kernel_takes_only_the_bench_configs():
    """K6 is built for the STEPCOST_CONFIGS combinations alone: stepcost_cuda
    refuses any other before it reaches the card, while the plain version
    takes every combination."""
    kb, tris = _masked_tables(n_tris=60, seed=9)
    o, d = _aimed_rays(tris, 32, seed=12)
    z, lim = torch.zeros(32), torch.full((32,), 1e9)
    for toggles in (dict(do_extract=False), dict(do_box=False), dict(do_leaf=True, do_push=False),
                    dict(do_box=False, do_leaf=False)):
        with pytest.raises(ValueError, match="STEPCOST_CONFIGS"):
            wide.stepcost_cuda(kb, o, d, z, lim, steps=4, **toggles)
        t, p, acc = wide.stepcost_packets(kb, o, d, z, lim, steps=4, **toggles)
        assert t.shape == p.shape == acc.shape == (32,)
