"""`python -m tpurt_torch.kernel_bench` driven on the CPU at a small size:
a mini Sponza-like scene, two image rows. It runs the plain versions
there (the times are the CPU's); on the card the same calls launch K1,
K2, K5 and K6."""

import json
import os

import pytest
import torch

from tpurt_torch import kernel_bench
from tpurt_torch.kernels import wide
from tpurt_torch.scene.procedural import write_sponza_like_scene


@pytest.fixture(scope="module")
def mini_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("kb")
    return write_sponza_like_scene(str(d / "mini.gltf"), columns=1, foliage=8, stacks=1,
                                   segments=8, rings=6)


def test_octet_and_stepcost_write_json(mini_scene, tmp_path):
    out = str(tmp_path / "kb.json")
    before = dict(wide.LAUNCHES)
    res = kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "2",
                             "--row0", "540", "--octet", "2", "--stepcost", "4", "--reps", "1",
                             "--nosort", "--json", out])
    assert wide.LAUNCHES == before
    with open(out) as f:
        saved = json.load(f)
    assert saved == res
    assert res["device"] == "cpu" and res["kernels"] == "K5 octet=2"
    assert res["rays"] == 2 * kernel_bench.WIDTH
    for k in ("coherent_closest_ms", "incoherent_closest_ms", "incoherent_nosort_closest_ms",
              "occlusion_ms"):
        assert res[k] > 0.0
    for name, _ in wide.STEPCOST_CONFIGS:
        assert res[f"stepcost_{name}_ms"] > 0.0
    for phase in ("leaf", "push", "extract", "box", "looppop"):
        assert f"stepcost_{phase}_ns" in res
    assert res["stepcost_steps"] == 4


def test_group_rebuild_and_batches(mini_scene):
    """--group rebuilds the tables; the batches are the bench's: the same
    ray count in each, the bounce batch sorted by the octant-Morton key,
    the shadow rays bounded by the light's distance."""
    res = kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "2",
                             "--row0", "540", "--group", "4", "--reps", "1"])
    assert res["group"] == 4 and res["kernels"] == "K1/K2"
    r = kernel_bench.load_renderer(mini_scene, "cpu")
    b = kernel_bench.bench_batches(r, r.bvh, rows=2, row0=540)
    n = 2 * kernel_bench.WIDTH
    assert all(x.shape[0] == n for batch in b.values() for x in batch)
    from tpurt_torch.bvh.traverse import _octant_morton_key

    key = _octant_morton_key(r.bvh, *b["bounce"], torch.ones(n, dtype=torch.bool))
    assert bool((key[1:] >= key[:-1]).all())
    o, d, tl = b["shadow"]
    assert bool((tl > 0).all())
    assert torch.allclose(torch.linalg.norm(d, dim=-1), torch.ones(n), atol=1e-5)


def test_parser_defaults_to_the_card_and_offers_no_tpu_variants():
    ap = kernel_bench.build_parser()
    args = ap.parse_args([])
    assert args.device == "cuda" and args.rows == 256 and args.row0 == 400
    assert args.octet == 0 and args.stepcost == 0
    assert args.arity == 0 and args.near == 0.0
    for flag in ("--dual", "--pair", "--descend", "--sup", "--race-sup"):
        with pytest.raises(SystemExit):
            ap.parse_args([flag])
    for bad in (["--octet", "3"], ["--arity", "12"]):
        with pytest.raises(SystemExit):
            ap.parse_args(bad)


def test_json_path_is_optional(mini_scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "2", "--row0",
                       "540", "--reps", "1"])
    assert os.listdir(tmp_path) == []


def test_each_batch_carries_its_bound(mini_scene):
    """Beside each batch's time stands the bound of the tests the plain
    version counts on it: the larger of operations over the f32 peak and
    bytes over the memory rate, by the formula of traversal_bound."""
    res = kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "2",
                             "--row0", "540", "--reps", "1", "--nosort"])
    for name in ("coherent_closest", "incoherent_closest", "incoherent_nosort_closest",
                 "occlusion"):
        assert res[f"{name}_bound_ms"] > 0.0
        assert res[f"{name}_bound_by"] in ("operations", "bytes")
    stats = {"box_tests": torch.tensor([600, 400]), "leaf_visits": torch.tensor([3, 7]),
             "node_rows_read": 5, "leaf_rows_read": 4}
    ms, by, ops, nbytes = kernel_bench.traversal_bound(stats, 2, 96, 8)
    assert ops == 1000 * 25 + 10 * 8 * 60
    assert nbytes == 2 * 44 + 5 * 512 + 4 * 96 * 4
    assert by == "bytes" and ms == nbytes / kernel_bench.PEAK_BYTES * 1e3
    stats["box_tests"] = torch.tensor([10 ** 9])
    ms, by, ops, _ = kernel_bench.traversal_bound(stats, 2, 96, 8)
    assert by == "operations" and ms == ops / kernel_bench.PEAK_F32 * 1e3


def test_rope_batches_carry_their_bound(mini_scene):
    """--rope times K3 on the camera, unsorted bounce and unsorted shadow
    rays and K4 on the bounded shadow rays, over the rope tables of a G=8
    BVH (the plain walk on the CPU, no launch counted), each beside the
    bound of rope_bound; rope_bound's formula on hand-made counts."""
    from tpurt_torch.kernels.experimental import rope

    before = dict(rope.LAUNCHES)
    res = kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "2",
                             "--row0", "540", "--reps", "1", "--rope"])
    assert rope.LAUNCHES == before
    assert res["rope_group"] == kernel_bench.ROPE_GROUP == 8
    for name in ("rope_camera", "rope_bounce", "rope_shadow_closest", "rope_shadow_occlusion"):
        assert res[f"{name}_rays"] == 2 * kernel_bench.WIDTH
        assert res[f"{name}_ms"] > 0.0 and res[f"{name}_ns_per_ray"] > 0.0
        assert res[f"{name}_bound_ms"] > 0.0
        assert res[f"{name}_bound_by"] in ("operations", "bytes")
        assert res[f"{name}_steps_per_ray"] >= 1.0
    stats = {"node_visits": torch.tensor([30, 50]), "leaf_visits": torch.tensor([2, 4]),
             "node_rows_read": 7, "leaf_rows_read": 3}
    ms, by, ops, nbytes = kernel_bench.rope_bound(stats, 2, 80, 8)
    assert ops == 80 * 25 + 6 * 8 * 60
    assert nbytes == 2 * 53 + 7 * 32 + 3 * 80 * 4
    assert by == "bytes" and ms == nbytes / kernel_bench.PEAK_BYTES * 1e3
    stats["node_visits"] = torch.tensor([10 ** 9])
    ms, by, ops, _ = kernel_bench.rope_bound(stats, 2, 80, 8)
    assert by == "operations" and ms == ops / kernel_bench.PEAK_F32 * 1e3


def test_octet_batches_carry_the_union_bound(mini_scene):
    """--octet N sets beside each batch's bound the union walk's own
    (union_bound): traversal_bound of octet_plain's counts on the same
    rays, where every ray of a walk tests every entry its walk pops."""
    res = kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "2",
                             "--row0", "540", "--reps", "1", "--octet", "8"])
    for name in ("coherent_closest", "incoherent_closest", "occlusion"):
        assert res[f"{name}_union_bound_ms"] > 0.0
        assert res[f"{name}_union_bound_by"] in ("operations", "bytes")
    r = kernel_bench.load_renderer(mini_scene, "cpu")
    o, d = kernel_bench.bench_batches(r, r.bvh, rows=2, row0=540)["bounce"]
    n = o.shape[0]
    z, far = torch.zeros(n), torch.full((n,), float(r.config.t_max))
    kb = r.bvh
    stats = {}
    wide.octet_plain(kb.node_rows, kb.tri_rows, o, d, z, far, group=kb.group_size,
                     arity=kb.arity, walks=8, occlusion=False, all_definite=False,
                     cell_masks=False, stats=stats)
    got = kernel_bench.union_bound(kb, o, d, z, far, walks=8, occlusion=False,
                                   all_definite=False)
    assert got == kernel_bench.traversal_bound(stats, n, kb.tri_rows.shape[1], kb.group_size)
    assert got[2] == (float(stats["box_tests"].sum()) * kernel_bench.OPS_PER_BOX
                      + float(stats["leaf_visits"].sum()) * kb.group_size
                      * kernel_bench.OPS_PER_TRIANGLE)


def test_arity_8_tables_equal_tpurts(mini_scene):
    """--arity 8 rebuilds the renderer's tables through
    make_wide_kernel_bvh(arity=8): node and leaf rows byte-equal to
    tpurt's make_wide_kernel_bvh(..., arity=8) over the same tree, with
    the alpha masks."""
    import jax.numpy as jnp
    import numpy as np

    from tpurt.bvh import build_triangle_bvh as j_build_bvh
    from tpurt.kernels import pallas_wide as jw
    from tpurt.scene.device import build_device_scene as j_dev
    from tpurt.scene.gltf import load_gltf as j_load

    r = kernel_bench.load_renderer(mini_scene, "cpu")
    kb = kernel_bench.rebuild(r, arity=8)
    assert kb.arity == 8 and r.has_alpha and kb.use_masks
    ds = j_dev(j_load(mini_scene))
    jtb = j_build_bvh(ds.tri_pos, group_size=kb.group_size)
    jkb = jw.make_wide_kernel_bvh(jtb, ds.tri_pos, tri_alpha_mask=ds.tri_alpha_mask,
                                  tri_alpha_opaque=ds.tri_alpha_opaque, arity=8)
    assert jkb.arity == 8
    np.testing.assert_array_equal(kb.tribvh.tri_order, np.asarray(jkb.tribvh.tri_order))
    for f in ("node_rows", "tri_rows"):
        a, b = getattr(kb, f).numpy(), np.asarray(getattr(jkb, f))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert kb.card.nodes.shape[2] == 8


def test_arity_8_and_near_two_pass(mini_scene):
    """--arity 8 --near 0.1 on the CPU (plain K1): the record's keys, and
    the two-pass t equal to the single pass bit for bit where no ray
    overflows the second pass's lanes; a bound small enough that most
    rays miss the first pass overflows, and says so."""
    before = dict(wide.LAUNCHES)
    res = kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "4",
                             "--row0", "540", "--reps", "1", "--arity", "8", "--near", "0.1"])
    assert wide.LAUNCHES == before
    assert res["arity"] == 8
    n = 4 * kernel_bench.WIDTH
    assert res["near2_capn"] == max(1024, (n // 4 + 1023) // 1024 * 1024)
    assert res["near2_closest_ms"] > 0.0 and res["near2_closest_mrays"] > 0.0
    assert 0.0 <= res["near2_miss_frac"] <= 1.0 and 0.0 < res["near2_prim_agree"] <= 1.0
    assert res["near2_overflow"] == (res["near2_miss_frac"] * n > res["near2_capn"])
    assert res["near2_overflow"] or res["near2_t_bit_equal"]

    r = kernel_bench.load_renderer(mini_scene, "cpu")
    kb = kernel_bench.rebuild(r, arity=8)
    o, d = kernel_bench.bench_batches(r, kb, rows=4, row0=540)["bounce"]
    t_max = r.config.t_max
    t1, p1, _, _ = wide.traverse_packets(kb, o, d, torch.zeros(n), t_max,
                                         torch.ones(n, dtype=torch.bool), need_uv=False)
    # the mini scene is open, so ~40% of the bounce rays escape and the
    # whole batch overflows the n/4 lanes: the no-overflow case takes the
    # first 4,096 rays that hit, still in sort order, with r0 at the 85th
    # percentile of their t (15% go to the second pass)
    hit = torch.nonzero(p1 >= 0)[:, 0][:4096]
    o, d, t1, p1 = o[hit], d[hit], t1[hit], p1[hit]
    r0 = float(torch.quantile(t1.double(), 0.85))
    for r0, overflows in ((r0, False), (r0 * 1e-3, True)):
        t, p, nmiss, capn = kernel_bench.near_pass(kb, o, d, r0, t_max)
        assert (int(nmiss) > capn) == overflows, (r0, int(nmiss), capn)
        if not overflows:
            assert int(nmiss) > 0
            assert torch.equal(t.view(torch.int32), t1.view(torch.int32))
            assert bool((t[p != p1] == t1[p != p1]).all())
        else:
            # the rays past the second pass's lanes are lost
            assert not torch.equal(t.view(torch.int32), t1.view(torch.int32))
