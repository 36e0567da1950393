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
    for flag in ("--dual", "--pair", "--descend", "--sup", "--race-sup", "--arity", "--near"):
        with pytest.raises(SystemExit):
            ap.parse_args([flag])
    with pytest.raises(SystemExit):
        ap.parse_args(["--octet", "3"])


def test_json_path_is_optional(mini_scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kernel_bench.main(["--device", "cpu", "--scene", mini_scene, "--rows", "2", "--row0",
                       "540", "--reps", "1"])
    assert os.listdir(tmp_path) == []
