"""The Bistro configuration holds its stated parameters. The writer's
layout at full size counts 2,800,000 triangles, 280,000 of them on the
four alpha-MASK materials, 12 crowns of 10,000 cards, 120 materials and
300 images of 1024x1024, and the file names 5 lights; at the CPU tests'
size the built scene has exactly the layout's counts. A ray through a
full-size crown's centre crosses 10-20 cards (a numpy cast against one
crown's cards), each foliage texture is 35-50% opaque, and no two of the
cobbles that fill the road touch."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import harness
from perfbench.scenes import bistro

CFG = harness.load_json(harness.HERE, "configs", "bistro.json")
FULL = CFG["scene_params"]
TINY = dict(FULL, **CFG["tiny_scene_params"])


def test_full_size_layout_holds_the_stated_counts():
    plan = bistro.layout(**FULL)[1]
    assert plan == {"triangles": 2800000, "alpha_mask_triangles": 280000, "materials": 120,
                    "images": 300, "image_size": 1024, "crowns": 12, "cards_per_crown": 10000}
    for key in ("triangles", "alpha_mask_triangles", "materials", "images", "image_size",
                "crowns", "cards_per_crown"):
        assert CFG[key] == plan[key], key
    assert CFG["alpha_mask_materials"] == len(bistro.ALPHA_ROLES) == 4
    assert len(CFG["lights"]) == 5


def test_the_built_scene_has_the_layout_s_counts():
    b = bistro.build(**TINY)
    arr = b.arrays()
    plan = bistro.layout(**TINY)[1]
    assert arr.tri_pos.shape[0] == plan["triangles"]
    assert int(arr.mat_alpha_tested[arr.tri_mat].sum()) == plan["alpha_mask_triangles"]
    assert arr.mat_albedo.shape[0] == plan["materials"]
    assert len(b.images) == plan["images"]
    assert {t[0].shape[:2] for t in arr.textures} == {(TINY["texture_size"],) * 2}
    assert int(arr.mat_alpha_tested.sum()) == 4


def _crossings(centre, cards, n_rays=300, seed=0):
    """Cards crossed by rays through `centre` in random directions."""
    c, a, b = (np.concatenate(x) for x in zip(*cards))
    nrm = np.cross(a, b)
    d = np.random.RandomState(seed).normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.asarray(centre)[None] - 6.0 * d
    den = d @ nrm.T
    t = ((c[None] - o[:, None]) * nrm[None]).sum(-1) / np.where(den == 0, 1e-30, den)
    p = o[:, None] + t[..., None] * d[:, None] - c[None]
    u = (p * a[None]).sum(-1) / (a * a).sum(-1)[None]
    v = (p * b[None]).sum(-1) / (b * b).sum(-1)[None]
    return ((t > 0) & (t < 12) & (np.abs(u) <= 1) & (np.abs(v) <= 1)).sum(1)


def test_a_ray_through_a_crown_centre_crosses_10_to_20_cards():
    lay, counts, trees = bistro.layout(**FULL)
    cards = lay.cards["leaves"]
    per_crown = len(cards) // counts["crowns"]
    first = cards[:per_crown]  # the first crown's shells
    assert sum(x[0].shape[0] for x in first) == FULL["cards"]
    n = _crossings((trees[0][0], 5.3, trees[0][1]), first)
    assert 10 <= np.percentile(n, 5) and np.percentile(n, 95) <= 20, np.percentile(n, [5, 50, 95])


@pytest.mark.parametrize("kind", ["leaves", "shrubs", "flowers", "ivy"])
def test_foliage_is_35_to_50_percent_opaque(kind):
    alpha = bistro._ellipses(np.random.RandomState(len(kind)), 128)
    assert 0.35 <= alpha.mean() <= 0.50


def test_no_two_cobbles_touch():
    """The full-size cobbles' footprints, each box's bounds on the road
    after its turn, are pairwise apart: neighbours by a grid of cells one
    footprint wide, compared pair by pair."""
    lay = bistro.layout(**FULL)[0]
    c, size, yaw = (np.concatenate(x) for x in zip(
        *[b for r in ("cobble_a", "cobble_b", "cobble_c") for b in lay.boxes[r]]))
    assert c.shape[0] * 12 >= 0.3 * FULL["triangles"]
    cs, sn = np.abs(np.cos(yaw)), np.abs(np.sin(yaw))
    half = np.stack([size[:, 0] * cs + size[:, 2] * sn, size[:, 0] * sn + size[:, 2] * cs], 1) / 2
    lo, hi = c[:, [0, 2]] - half, c[:, [0, 2]] + half
    cell = np.floor(lo / (2 * half.max(0))).astype(np.int64)
    key = cell[:, 0] * 1000003 + cell[:, 1]
    order = np.argsort(key, kind="stable")
    most = int(np.unique(key, return_counts=True)[1].max())
    pairs = 0
    for dx in (-1, 0, 1):
        for dz in (-1, 0, 1):
            other = (cell[:, 0] + dx) * 1000003 + cell[:, 1] + dz
            at = np.searchsorted(key[order], other)
            for k in range(most):  # every footprint of the neighbouring cell
                j = order[np.minimum(at + k, order.size - 1)]
                near = (key[j] == other) & (j != np.arange(j.size))
                apart = (lo[j] > hi) | (hi[j] < lo)
                assert (apart.any(1) | ~near).all()
                pairs += int(near.sum())
    assert pairs > 4 * c.shape[0]
