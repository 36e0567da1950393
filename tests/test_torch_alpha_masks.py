"""`scene/device._alpha_cell_masks` (the 4x4 cell masks of alpha-tested
triangles, answered from summed-area tables) against tpurt's
`tpurt.scene.device._alpha_cell_masks`, the reference: a loop over every
alpha triangle and each of its cells that gathers every texel of the
cell's texture-space box. Both masks must be equal bit for bit, on
seeded random triangles: every wrap mode, uvs outside [0, 1], boxes over
the texel cap, untextured materials on both sides of the cutoff, several
textures and cutoffs in one atlas, and whole-texture leaf cards. The
device scene and the K1/K2 tables of the benchmark's tiny Sponza are the
same with either function. CPU only, numpy inputs from fixed seeds."""


import numpy as np
import pytest
import torch

from tpurt.scene.device import _alpha_cell_masks as masks_ref
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene import device as D
from tpurt_torch.scene.device import Materials
from tpurt_torch.scene.types import (NO_TEXTURE, WRAP_CLAMP_TO_EDGE, WRAP_MIRRORED_REPEAT,
                                     WRAP_REPEAT)

WRAPS = {"repeat": WRAP_REPEAT, "mirrored": WRAP_MIRRORED_REPEAT, "clamp": WRAP_CLAMP_TO_EDGE}


def _atlas(rng, sizes, wraps):
    """An atlas of blocky random alpha images side by side (cells of 1-4
    texels, so many boxes are decided) and its table."""
    aw = sum(w for w, _ in sizes) + 8
    ah = max(h for _, h in sizes) + 3
    atlas = rng.randint(0, 256, (ah, aw, 4)).astype(np.uint8)
    table = np.zeros((len(sizes), 10), np.int32)
    x = 5
    for i, ((w, h), (ws, wt)) in enumerate(zip(sizes, wraps)):
        block = int(rng.randint(1, 5))
        a = rng.choice([0, 100, 127, 128, 129, 200, 255], ((h + block - 1) // block,
                                                            (w + block - 1) // block))
        atlas[2:2 + h, x:x + w, 3] = np.kron(a, np.ones((block, block), int))[:h, :w]
        table[i, :6] = [x, 2, w, h, ws, wt]
        x += w
    return atlas, table


def _materials(tex, cutoff):
    m = len(tex)
    z = np.zeros(m, np.float32)
    return Materials(albedo_scale=np.ones((m, 4), np.float32), roughness=z, metallic=z,
                     normal_factor=z, ior=z + 1.5, emissive=np.zeros((m, 4), np.float32),
                     alpha_cutoff=np.asarray(cutoff, np.float32),
                     tex_albedo=np.asarray(tex, np.int32), tex_mr=np.asarray(tex, np.int32),
                     tex_normal=np.asarray(tex, np.int32), tex_emissive=np.asarray(tex, np.int32))


def _triangles(rng, n, n_mat, spread):
    """n triangles: a centre in [-spread, 1 + spread]^2 and corners up to
    a random size away, so boxes run from one texel to many textures;
    a tenth are not alpha tested."""
    centre = rng.uniform(-spread, 1 + spread, (n, 1, 2))
    size = 10.0 ** rng.uniform(-3, 0.7, (n, 1, 1))
    uv = (centre + size * rng.uniform(-1, 1, (n, 3, 2))).astype(np.float32)
    return rng.rand(n) > 0.1, uv, rng.randint(0, n_mat, n).astype(np.int32)


def _cards(n, n_mat):
    """Whole-texture leaf cards: two triangles a quad over uv [0, 1]^2."""
    quad = np.array([[(0, 0), (1, 0), (1, 1)], [(0, 0), (1, 1), (0, 1)]], np.float32)
    uv = np.tile(quad, (n, 1, 1))
    return np.ones(2 * n, bool), uv, (np.arange(2 * n) % n_mat).astype(np.int32)


def _same(tri_alpha, uv, mat, materials, atlas, table, **kw):
    new = D._alpha_cell_masks(tri_alpha, uv, mat, materials, atlas, table, **kw)
    ref = masks_ref(tri_alpha, uv, mat, materials, atlas, table, **kw)
    for a, b in zip(new, ref):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    return new


@pytest.mark.parametrize("wrap", sorted(WRAPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_random_triangles_in_one_wrap(wrap, seed):
    rng = np.random.RandomState(seed)
    sizes = [(16, 16), (7, 12), (33, 5)]
    atlas, table = _atlas(rng, sizes, [(WRAPS[wrap], WRAPS[wrap])] * 3)
    materials = _materials([0, 1, 2, 0, NO_TEXTURE], [0.5, 0.3, 0.9, 0.7, 0.5])
    t, m = _same(*_triangles(rng, 1500, 5, spread=2.5), materials, atlas, table)
    # the cases are there: decided cells of both kinds, undecided ones
    assert (t != 0).any() and (m != 0).any() and ((t | m) != 0xFFFF).any()


@pytest.mark.parametrize("seed", [2, 3])
def test_mixed_wraps_textures_and_cutoffs(seed):
    rng = np.random.RandomState(seed)
    modes = list(WRAPS.values())
    sizes = [(int(w), int(h)) for w, h in rng.randint(1, 40, (6, 2))]
    wraps = [(modes[i % 3], modes[(i // 3 + i) % 3]) for i in range(6)]
    atlas, table = _atlas(rng, sizes, wraps)
    tex = [0, 1, 2, 3, 4, 5, 0, 3, NO_TEXTURE, NO_TEXTURE, 99]
    cut = [0.5, 0.5, 0.2, 0.8, 0.5, 0.0, 0.9, 0.31, 0.5, 1.5, 0.6]
    _same(*_triangles(rng, 2500, len(tex), spread=6.0), _materials(tex, cut), atlas, table)


@pytest.mark.parametrize("cap", [1, 40, 1 << 16])
def test_boxes_over_the_texel_cap(cap):
    rng = np.random.RandomState(4)
    atlas, table = _atlas(rng, [(64, 48), (20, 90)],
                          [(WRAP_REPEAT, WRAP_MIRRORED_REPEAT),
                           (WRAP_CLAMP_TO_EDGE, WRAP_REPEAT)])
    materials = _materials([0, 1], [0.5, 0.45])
    _same(*_triangles(rng, 800, 2, spread=1.0), materials, atlas, table, texel_cap=cap)


def test_untextured_materials_on_both_sides_of_the_cutoff():
    rng = np.random.RandomState(5)
    atlas, table = _atlas(rng, [(8, 8)], [(WRAP_REPEAT, WRAP_REPEAT)])
    materials = _materials([NO_TEXTURE, NO_TEXTURE, NO_TEXTURE, 7], [0.5, 1.0, 1.25, 2.0])
    t, o = _same(*_triangles(rng, 200, 4, spread=1.0), materials, atlas, table)
    assert set(np.unique(t)) == {0, 0xFFFF} and set(np.unique(o)) == {0, 0xFFFF}


@pytest.mark.parametrize("size", [16, 64, 1024])
def test_whole_texture_leaf_cards(size):
    rng = np.random.RandomState(6)
    yy, xx = np.mgrid[0:size, 0:size] / size
    atlas = np.zeros((size, size, 4), np.uint8)
    atlas[..., 3] = np.where((xx - 0.5) ** 2 / 0.12 + (yy - 0.4) ** 2 / 0.05 < 1, 255, 0)
    table = np.zeros((1, 10), np.int32)
    table[0, :6] = [0, 0, size, size, WRAP_REPEAT, WRAP_REPEAT]
    tri_alpha, uv, mat = _cards(200, 1)
    uv = uv + rng.randint(-2, 3, (uv.shape[0], 1, 2)).astype(np.float32)
    _same(tri_alpha, uv, mat, _materials([0], [0.5]), atlas, table)


def test_no_alpha_triangle_gives_zero_masks():
    rng = np.random.RandomState(7)
    atlas, table = _atlas(rng, [(8, 8)], [(WRAP_REPEAT, WRAP_REPEAT)])
    _, uv, mat = _triangles(rng, 50, 1, spread=1.0)
    t, o = _same(np.zeros(50, bool), uv, mat, _materials([0], [0.5]), atlas, table)
    assert not t.any() and not o.any()


def test_tiny_sponza_builds_the_same_scene_and_tables(tmp_path, monkeypatch):
    """The benchmark's Sponza at its CPU-test size: every array of the
    device scene and of the wide tables is the same with the port's masks
    as with the reference's."""
    from perfbench import harness
    from perfbench.scenes import sponza

    cfg = harness.load_json(harness.HERE, "configs", "sponza.json")
    path = sponza.build(**dict(cfg["scene_params"], **cfg["tiny_scene_params"])).write(
        str(tmp_path / "sponza.gltf"))

    def build():
        r = Renderer.from_gltf(path, device="cpu", cache=False)
        return r.device_scene, r.bvh

    new_scene, new_bvh = build()
    monkeypatch.setattr(D, "_alpha_cell_masks", masks_ref)
    old_scene, old_bvh = build()
    assert int((new_scene.tri_alpha_opaque | new_scene.tri_alpha_mask & 0xFFFF).ne(0).sum()) > 0
    for name, a, b in zip(new_scene._fields, new_scene, old_scene):
        for x, y in (zip(a, b) if name == "materials" else [(a, b)]):
            assert torch.equal(x, y), name
    assert torch.equal(new_bvh.tri_rows, old_bvh.tri_rows)
    assert torch.equal(new_bvh.node_rows, old_bvh.node_rows)
