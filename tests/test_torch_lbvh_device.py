"""The device LBVH build (tpurt_torch/bvh/lbvh.py: build_lbvh,
_build_triangle_bvh_device, validate_lbvh, triangle_aabbs) on the CPU,
held against tpurt's jitted build (tpurt/bvh/lbvh.py) on the same
numpy-seeded boxes: every integer array equal and every box bit-equal,
the trees valid, closest hits over wide tables packed from it equal to
those over the native build (tests/test_native.py:81's counterpart), and
build_triangle_bvh falling back to it when the native library is
unavailable, as tpurt's does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import lbvh as jl
from tpurt_torch import native
from tpurt_torch.bvh import lbvh
from tpurt_torch.kernels import wide


def _tris(n, seed, scale=10.0):
    """n random triangles; two of them repeat earlier ones (duplicate
    primitives: equal Morton codes, ties broken by index)."""
    r = np.random.RandomState(seed)
    tris = ((r.rand(n, 1, 3) - 0.5) * scale + (r.rand(n, 3, 3) - 0.5)).astype(np.float32)
    if n > 3:
        tris[n // 2] = tris[0]
        tris[n - 1] = tris[1]
    return tris


def _assert_lbvh_equal(got, want):
    for f in jl.LBVH._fields:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("n", [2, 3, 100, 1000])
def test_build_lbvh_matches_tpurt(n):
    tris = _tris(n, n)
    pmin, pmax = tris.min(axis=1), tris.max(axis=1)
    got = lbvh.build_lbvh(pmin, pmax, device="cpu")
    _assert_lbvh_equal(got, jl.build_lbvh(jnp.asarray(pmin), jnp.asarray(pmax)))
    lbvh.validate_lbvh(got, pmin, pmax)
    assert got.num_leaves == n


@pytest.mark.parametrize("n,group", [(3, 4), (3, 8), (1000, 4), (1000, 8)])
def test_device_triangle_bvh_matches_tpurt(n, group):
    tris = _tris(n, 7 * n + group)
    got = lbvh._build_triangle_bvh_device(tris, group, device="cpu")
    want = jl._build_triangle_bvh_device(jnp.asarray(tris), group_size=group)
    assert got.tri_order.dtype == np.int32
    np.testing.assert_array_equal(got.tri_order, np.asarray(want.tri_order))
    _assert_lbvh_equal(got.bvh, want.bvh)
    assert got.group_size == group
    gmin = tris[got.tri_order].reshape(-1, group, 3, 3).min(axis=(1, 2))
    gmax = tris[got.tri_order].reshape(-1, group, 3, 3).max(axis=(1, 2))
    lbvh.validate_lbvh(got.bvh, gmin, gmax)


def _near_tie_boxes(n, seed):
    """Boxes around the plane x + y + z = 5 with coordinates of mixed
    magnitudes: the child-centre differences nearly cancel in the
    direction scores, whose sign then depends on the order of the sum."""
    r = np.random.RandomState(seed)
    a = r.choice([1e3, 1.0, 1e-3, 3e4], size=(n, 1)) * r.rand(n, 1)
    b = r.choice([1e3, 1.0, 1e-3, 3e4], size=(n, 1)) * r.rand(n, 1)
    base = np.concatenate([a, b, 5.0 - a - b], 1)[:, None, :]
    tris = (base + r.rand(n, 3, 3) * 1e-3).astype(np.float32)
    return tris.min(axis=1), tris.max(axis=1)


def _order_sensitive(bvh):
    """Scores whose sign differs between (x + y) + z and another order."""
    cen = (np.float32(0.5) * (bvh.node_min + bvh.node_max)).astype(np.float32)
    dl = cen[bvh.right] - cen[bvh.left]
    count = 0
    for o in range(8):
        p = dl * np.array([1 - 2 * ((o >> 2) & 1), 1 - 2 * ((o >> 1) & 1), 1 - 2 * (o & 1)],
                          np.float32)
        xy_z = (p[:, 0] + p[:, 1]) + p[:, 2] >= 0
        count += int((xy_z != (p[:, 0] + (p[:, 1] + p[:, 2]) >= 0)).sum()
                     + (xy_z != ((p[:, 0] + p[:, 2]) + p[:, 1] >= 0)).sum())
    return count


def test_first_links_match_tpurt_on_near_ties():
    """The `first` score sums the three terms in XLA's order: on boxes
    where another order would flip scores, the links still equal
    tpurt's."""
    sensitive = 0
    for seed in range(6):
        pmin, pmax = _near_tie_boxes(500, seed)
        got = lbvh.build_lbvh(pmin, pmax, device="cpu")
        _assert_lbvh_equal(got, jl.build_lbvh(jnp.asarray(pmin), jnp.asarray(pmax)))
        sensitive += _order_sensitive(got)
    assert sensitive > 0, "no score depended on the order of the sum"


def test_clz32():
    vals = np.array([0, 1, 2, 3, 255, 256, 65535, 65536, 2 ** 24 - 1, 2 ** 24, 2 ** 31 - 1,
                     2 ** 31, 2 ** 32 - 1], np.int64)
    vals = np.concatenate([vals, np.random.RandomState(1).randint(0, 2 ** 32, 2000,
                                                                  dtype=np.int64)])
    want = np.array([32 - int(v).bit_length() for v in vals])
    np.testing.assert_array_equal(lbvh._clz32(torch.from_numpy(vals)).numpy(), want)


def test_triangle_aabbs():
    tris = _tris(50, 2)
    lo, hi = lbvh.triangle_aabbs(torch.from_numpy(tris))
    jlo, jhi = jl.triangle_aabbs(jnp.asarray(tris))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_validate_lbvh_refuses_broken_trees():
    tris = _tris(64, 3)
    pmin, pmax = tris.min(axis=1), tris.max(axis=1)
    good = lbvh.build_lbvh(pmin, pmax, device="cpu")
    lbvh.validate_lbvh(good, pmin, pmax)
    skip = good.skip.copy()
    skip[3, good.num_internal + 5] = 0  # a rope back to the root: a cycle
    left = good.left.copy()
    left[1] = left[0]                   # a subtree reached twice
    node_max = good.node_max.copy()
    node_max[good.num_internal] += 1.0  # a leaf box that is not its primitive's
    for broken in (good._replace(skip=skip), good._replace(left=left),
                   good._replace(node_max=node_max)):
        with pytest.raises(lbvh.InvalidLBVH):
            lbvh.validate_lbvh(broken, pmin, pmax)


def test_wide_hits_over_the_device_build_equal_the_native_builds():
    """Two builds shape different trees, but the closest hits through
    the wide tables packed from each are the same (plain K1): kind and t
    equal, prim equal except on exact-t ties."""
    r = np.random.RandomState(11)
    tris = _tris(400, 11, scale=8.0)
    dev_tb = lbvh._build_triangle_bvh_device(tris, 4, device="cpu")
    nat_tb = lbvh.build_triangle_bvh(tris, 4)
    assert nat_tb.bvh.num_leaves != dev_tb.bvh.num_leaves or \
        not np.array_equal(nat_tb.tri_order, dev_tb.tri_order)
    n = 1024
    # rays from random points aimed at random points on the triangles
    o = ((r.rand(n, 3) - 0.5) * 10).astype(np.float32)
    target = np.einsum("nk,nkc->nc", r.dirichlet([1, 1, 1], n), tris[r.randint(0, 400, n)])
    d = target - o
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    o = torch.from_numpy(o)
    ones = torch.ones(n, dtype=torch.bool)
    out = []
    for tb in (dev_tb, nat_tb):
        kb = wide.make_wide_kernel_bvh(tb, tris, device="cpu")
        out.append(wide.traverse_packets(kb, o, d, torch.zeros(n), 1e9, ones))
    (ta, pa, _, _), (tb_, pb, _, _) = out
    assert torch.equal(pa >= 0, pb >= 0) and int((pa >= 0).sum()) > n // 2
    assert torch.equal(ta.view(torch.int32), tb_.view(torch.int32))
    assert bool((ta[pa != pb] == tb_[pa != pb]).all())


def test_build_triangle_bvh_falls_back_to_the_device_build(monkeypatch, capfd):
    """Without the native library, build_triangle_bvh builds on the device
    it is given (one line on stderr says so); the default device is the
    card, so without one it raises instead of building on the CPU."""
    from tpurt_torch.runtime.device import DeviceNotFound

    tris = _tris(300, 5)
    monkeypatch.setattr(native, "available", lambda: False)
    got = lbvh.build_triangle_bvh(tris, 4, device="cpu")
    assert "building the triangle BVH on cpu" in capfd.readouterr().err
    want = lbvh._build_triangle_bvh_device(tris, 4, device="cpu")
    np.testing.assert_array_equal(got.tri_order, want.tri_order)
    for f in lbvh.LBVH._fields:
        np.testing.assert_array_equal(getattr(got.bvh, f), getattr(want.bvh, f))
    if not torch.cuda.is_available():
        with pytest.raises(DeviceNotFound):
            lbvh.build_triangle_bvh(tris, 4)


def test_native_available_remembers_a_failed_build(monkeypatch):
    calls = []

    def failing_build():
        calls.append(1)
        raise RuntimeError("native build failed: g++ ...\nerror")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_FAILED", None)
    monkeypatch.setattr(native, "build", failing_build)
    assert native.available() is False and native.available() is False
    assert len(calls) == 1
    assert native.unavailable_reason() == "RuntimeError: native build failed: g++ ..."
