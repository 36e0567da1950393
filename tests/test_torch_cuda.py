"""The CUDA traversal kernels (csrc/wide_traverse.cu, K1 closest hit and K2
occlusion; csrc/rope_traverse.cu, K3 rope closest hit and K4 rope
occlusion; csrc/wide_octet.cu, K5 multi-walk; csrc/wide_stepcost.cu, K6
step cost) against their plain PyTorch versions on the same inputs, and
the box golden rendered through the wide kernels, through K5 and through
K3; the brute-force oracle against the wave loop on the card, and the
device LBVH build on the card against its CPU run. These need an NVIDIA
card: they
are marked `cuda` and skip without one. They import nothing of JAX or
tpurt, so they also run where neither is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

The kernels are built with --fmad=false and repeat the plain version's
expression order; K1/K2, K3/K4, K5 and K6 each walk in their plain
version's order, so t, prim and the flags are bit-equal on every ray."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from tpurt_torch import film
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.camera import Camera
from tpurt_torch.config import KernelPolicy, RenderConfig, SphereLight
from tpurt_torch.kernels import cudalib, wide
from tpurt_torch.kernels.experimental import rope
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene

pytestmark = pytest.mark.cuda
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rays(n, seed, spread=12.0):
    r = np.random.RandomState(seed)
    o = ((r.rand(n, 3) - 0.5) * spread).astype(np.float32)
    d = r.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _masked_bvh(dev, n_tris=500, seed=3):
    r = np.random.RandomState(seed)
    tris = ((r.rand(n_tris, 1, 3) - 0.5) * 10 + (r.rand(n_tris, 3, 3) - 0.5)).astype(np.float32)
    masks = ((r.rand(n_tris) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, n_tris)
    opaque = r.randint(0, 1 << 16, n_tris).astype(np.int32) & ~masks & 0xFFFF
    return wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 8), tris,
                                     tri_alpha_mask=masks.astype(np.int32),
                                     tri_alpha_opaque=opaque, device=dev)


@pytest.mark.parametrize("mode,cell_masks", [("closest", False), ("closest", True),
                                             ("occlusion", False)])
@pytest.mark.parametrize("n", [1, 1000, 70000])
def test_kernel_matches_plain(dev, mode, cell_masks, n):
    """K1/K2 against traverse_plain: t (bits), prim and the flag equal on
    every ray (the hit-mask walk visits in the plain version's order);
    inactive rays miss."""
    kb = _masked_bvh(dev)
    o, d = _rays(n, seed=n)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_min = torch.zeros(n, device=dev)
    lim = np.where(np.arange(n) % 5 == 0, -3e38, 1e9).astype(np.float32)  # some inactive
    t_limit = torch.from_numpy(lim).to(dev)
    kw = dict(occlusion=mode == "occlusion", all_definite=False, cell_masks=cell_masks)
    before = dict(wide.LAUNCHES)
    tk, pk, fk = wide.traverse_cuda(kb, o, d, t_min, t_limit, **kw)
    cudalib.check_kernel_errors(dev)
    assert wide.LAUNCHES[mode] == before[mode] + 1
    tp, pp, fp = wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, t_min, t_limit,
                                     group=kb.group_size, arity=kb.arity, **kw)
    assert bool(torch.equal(tk.view(torch.int32), tp.view(torch.int32)))
    assert bool(torch.equal(pk, pp))
    assert bool(torch.equal(fk.view(torch.int32), fp.view(torch.int32)))
    assert bool((pk[torch.from_numpy(lim < 0).to(dev)] == -1).all())


@pytest.mark.parametrize("cell_masks", [False, True])
def test_kernel_matches_plain_whole_frame(dev, cell_masks):
    """K1 on the 2,073,600 camera rays of the bench camera at 1920x1080 on
    the mini Sponza (alpha masks on): t bits, prim and pending equal to
    traverse_plain on every ray."""
    from tpurt_torch.camera import camera_rays_for_rows
    from tpurt_torch.scene.procedural import write_sponza_like_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = write_sponza_like_scene(os.path.join(tmp, "s.gltf"), columns=2, foliage=8)
        cfg = RenderConfig(width=1920, height=1080)
        r = Renderer.from_gltf(path, config=cfg, device=dev,
                               camera=Camera.from_angles([0.0, -4.0, 0.0], 0.7, -0.1))
    kb = r.bvh
    assert kb.use_masks
    o, d, _ = camera_rays_for_rows(r.camera, 0, 1080, 1920, 1080, cfg.tan_half_fov, 0,
                                   cfg.seed, device=dev)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    assert n == 2073600
    t_min = torch.zeros(n, device=dev)
    t_limit = torch.full((n,), 1e9, device=dev)
    kw = dict(occlusion=False, all_definite=False, cell_masks=cell_masks)
    tk, pk, fk = wide.traverse_cuda(kb, o, d, t_min, t_limit, **kw)
    cudalib.check_kernel_errors(dev)
    tp, pp, fp = wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, t_min, t_limit,
                                     group=kb.group_size, arity=kb.arity, **kw)
    assert int((pk >= 0).sum()) > n // 2
    assert bool(torch.equal(tk.view(torch.int32), tp.view(torch.int32)))
    assert bool(torch.equal(pk, pp))
    assert bool(torch.equal(fk.view(torch.int32), fp.view(torch.int32)))


def test_wrapper_rejects_missing_or_misaligned_card_tables(dev):
    kb = _masked_bvh(dev, n_tris=50)
    o = torch.zeros((4, 3), device=dev)
    z = torch.zeros(4, device=dev)
    kw = dict(occlusion=False, all_definite=False, cell_masks=False)
    with pytest.raises(ValueError, match="no card tables"):
        wide.traverse_cuda(dataclasses.replace(kb, card=None), o, o, z, z, **kw)
    flat = torch.zeros(kb.card.nodes.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(kb.card.nodes.shape)
    shifted.copy_(kb.card.nodes)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wide.traverse_cuda(dataclasses.replace(kb, card=wide.CardTables(shifted, kb.card.leaves)),
                           o, o, z, z, **kw)
    on_cpu = wide.CardTables(kb.card.nodes.cpu(), kb.card.leaves.cpu())
    with pytest.raises(ValueError, match="are on cpu"):
        wide.traverse_cuda(dataclasses.replace(kb, card=on_cpu), o, o, z, z, **kw)


def test_tampered_depth_bound_sets_the_stack_bit(dev):
    """A depth bound below the walk's deepest stack makes the walk end with
    the wide-stack bit in the card's error word, which the per-sample check
    reports and clears."""
    kb = _masked_bvh(dev)
    assert kb.depth_bound >= 3
    n = 20000
    o, d = _rays(n, seed=5)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_min = torch.zeros(n, device=dev)
    t_limit = torch.full((n,), 1e9, device=dev)
    cudalib.check_kernel_errors(dev)
    wide.traverse_cuda(kb, o, d, t_min, t_limit, occlusion=False, all_definite=False,
                       cell_masks=False)
    torch.cuda.synchronize(dev)
    assert int(cudalib.error_word(dev).item()) == 0
    wide.traverse_cuda(dataclasses.replace(kb, depth_bound=1), o, d, t_min, t_limit,
                       occlusion=False, all_definite=False, cell_masks=False)
    torch.cuda.synchronize(dev)
    assert int(cudalib.error_word(dev).item()) & cudalib.ERR_WIDE_STACK
    with pytest.raises(RuntimeError, match="wide traversal stack overflow"):
        cudalib.check_kernel_errors(dev)
    cudalib.check_kernel_errors(dev)  # the word was cleared


def test_wrapper_rejects_bad_inputs(dev):
    kb = _masked_bvh(dev, n_tris=50)
    o = torch.zeros((4, 3), device=dev)
    z = torch.zeros(4, device=dev)
    with pytest.raises(TypeError):
        wide.traverse_cuda(kb, o.double(), o, z, z, occlusion=False, all_definite=False,
                           cell_masks=False)
    with pytest.raises(ValueError):
        wide.traverse_cuda(kb, o, o.cpu(), z, z, occlusion=False, all_definite=False,
                           cell_masks=False)


def test_box_golden_through_the_kernel(dev):
    with tempfile.TemporaryDirectory() as tmp:
        path = write_box_scene(os.path.join(tmp, "box.gltf"))
        cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
        r = Renderer.from_gltf(path, config=RenderConfig(width=64, height=48, max_samples=8),
                               camera=cam, device=dev,
                               lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)])
        before = dict(wide.LAUNCHES)
        img = r.render(8).cpu().numpy()
    assert wide.LAUNCHES["closest"] > before["closest"]
    assert wide.LAUNCHES["occlusion"] > before["occlusion"]
    golden = np.load(os.path.join(GOLDEN_DIR, "box_64x48_8spp.npz"))["accum"]
    assert film.rmse(img, golden) < 1e-5


def _rope_bvh(dev, n_tris=500, seed=3, masks=True):
    """Rope tables (G=8) of random triangles, with mixed alpha masks."""
    r = np.random.RandomState(seed)
    tris = ((r.rand(n_tris, 1, 3) - 0.5) * 10 + (r.rand(n_tris, 3, 3) - 0.5)).astype(np.float32)
    mk = ((r.rand(n_tris) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, n_tris)
    return rope.make_kernel_bvh(build_triangle_bvh(tris, 8), tris,
                                mk.astype(np.int32) if masks else None, device=dev), tris


@pytest.mark.parametrize("mode", ["closest", "occlusion"])
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("n", [1, 1000, 70000])
def test_rope_kernel_matches_plain(dev, mode, masks, n):
    """K3 / K4 over the card tables against the plain rope walk over the
    rows: t, prim (the leaf slot), u, v and blocked bit-equal on every ray,
    exact-t ties included (both walk each ray's octant in the same order);
    inactive rays miss."""
    kb, _ = _rope_bvh(dev, masks=masks)
    o, d = _rays(n, seed=n + 1)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_min = torch.zeros(n, device=dev)
    t_limit = torch.full((n,), 3.0 if mode == "occlusion" else 1e9, device=dev)
    active = torch.from_numpy(np.arange(n) % 5 != 0).to(dev)
    kw = dict(occlusion=mode == "occlusion", all_definite=not masks)
    before = dict(rope.LAUNCHES)
    out_k = rope.traverse_cuda(kb, o, d, t_min, t_limit, active, **kw)
    cudalib.check_kernel_errors(dev)
    assert rope.LAUNCHES["rope_" + mode] == before["rope_" + mode] + 1
    out_p = rope.traverse_plain(kb.node_rows, kb.tri_rows, o, d, t_min, t_limit, active,
                                n_internal=kb.n_internal, group=kb.group_size, **kw)
    for name, a, b in zip(("t", "prim", "u", "v", "blocked"), out_k, out_p):
        assert bool(torch.equal(a.view(torch.int32), b.view(torch.int32))), name
    assert bool((out_k[1][~active] == -1).all())


@pytest.mark.parametrize("masks", [False, True])
def test_rope_kernel_matches_plain_whole_frame(dev, masks):
    """K3 on the 2,073,600 camera rays of the bench camera at 1920x1080 on
    the mini Sponza (G = 8, with and without the mask column), and K4 on
    shadow rays from their hits to a light: t, prim, u, v and blocked
    bit-equal to traverse_plain on every ray."""
    from tpurt_torch.camera import camera_rays_for_rows
    from tpurt_torch.scene.device import build_device_scene
    from tpurt_torch.scene.gltf import load_gltf
    from tpurt_torch.scene.procedural import write_sponza_like_scene

    with tempfile.TemporaryDirectory() as tmp:
        scene = load_gltf(write_sponza_like_scene(os.path.join(tmp, "s.gltf"), columns=2,
                                                  foliage=8))
    ds = build_device_scene(scene, device="cpu")
    tris = ds.tri_pos.numpy()
    kb = rope.make_kernel_bvh(build_triangle_bvh(tris, 8), tris,
                              ds.tri_alpha_mask if masks else None, device=dev)
    assert kb.use_masks == masks
    cfg = RenderConfig(width=1920, height=1080)
    cam = Camera.from_angles([0.0, -4.0, 0.0], 0.7, -0.1).to(dev)
    o, d, _ = camera_rays_for_rows(cam, 0, 1080, 1920, 1080, cfg.tan_half_fov, 0, cfg.seed,
                                   device=dev)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    assert n == 2073600
    t_min = torch.zeros(n, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    far = torch.full((n,), 1e9, device=dev)
    kw = dict(n_internal=kb.n_internal, group=kb.group_size)
    out_k = rope.traverse_cuda(kb, o, d, t_min, far, active, occlusion=False,
                               all_definite=False)
    cudalib.check_kernel_errors(dev)
    out_p = rope.traverse_plain(kb.node_rows, kb.tri_rows, o, d, t_min, far, active,
                                occlusion=False, all_definite=False, **kw)
    assert int((out_k[1] >= 0).sum()) > n // 2
    for name, a, b in zip(("t", "prim", "u", "v", "blocked"), out_k, out_p):
        assert bool(torch.equal(a.view(torch.int32), b.view(torch.int32))), name
    hit = out_k[1] >= 0
    org = (o + torch.where(hit, out_k[0], t_min)[:, None] * d - 0.01 * d).contiguous()
    light = torch.tensor([0.0, -7.5, 0.0], device=dev)
    to_l = light[None, :] - org
    dist = torch.linalg.norm(to_l, dim=-1).contiguous()
    d_s = (to_l / dist[:, None]).contiguous()
    out_k = rope.traverse_cuda(kb, org, d_s, t_min, dist, hit, occlusion=True,
                               all_definite=not masks)
    cudalib.check_kernel_errors(dev)
    out_p = rope.traverse_plain(kb.node_rows, kb.tri_rows, org, d_s, t_min, dist, hit,
                                occlusion=True, all_definite=not masks, **kw)
    assert int((out_k[4] > 0).sum()) > 0
    for name, a, b in zip(("t", "prim", "u", "v", "blocked"), out_k, out_p):
        assert bool(torch.equal(a.view(torch.int32), b.view(torch.int32))), name


def test_rope_wrapper_rejects_missing_or_misaligned_card_tables(dev):
    """A CUDA launch without card tables, with card tables that are not
    16-byte aligned, or with card tables on another device raises before
    any launch."""
    kb, _ = _rope_bvh(dev, n_tris=50)
    o = torch.zeros((4, 3), device=dev)
    z = torch.zeros(4, device=dev)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    kw = dict(occlusion=False, all_definite=False)
    before = dict(rope.LAUNCHES)
    with pytest.raises(ValueError, match="no card tables"):
        rope.traverse_cuda(dataclasses.replace(kb, card=None), o, o, z, z, act, **kw)
    flat = torch.zeros(kb.card.boxes.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(kb.card.boxes.shape)
    shifted.copy_(kb.card.boxes)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rope.traverse_cuda(dataclasses.replace(kb, card=dataclasses.replace(kb.card,
                                                                            boxes=shifted)),
                           o, o, z, z, act, **kw)
    on_cpu = rope.RopeCardTables(kb.card.boxes.cpu(), kb.card.links.cpu(), kb.card.tris.cpu())
    with pytest.raises(ValueError, match="are on cpu"):
        rope.traverse_cuda(dataclasses.replace(kb, card=on_cpu), o, o, z, z, act, **kw)
    assert rope.LAUNCHES == before


def test_rope_render_launches_k3(dev):
    """The box golden through Renderer(bvh=<TriBVH>) on the card: K3 runs,
    K1, K2 and K4 do not, and the image is the golden."""
    from tpurt_torch.scene.device import build_device_scene
    from tpurt_torch.scene.gltf import load_gltf

    lights = [SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)]
    with tempfile.TemporaryDirectory() as tmp:
        scene = load_gltf(write_box_scene(os.path.join(tmp, "box.gltf")))
    tri = build_device_scene(scene, lights=lights, device="cpu").tri_pos.numpy()
    cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    r = Renderer(scene, config=RenderConfig(width=64, height=48, max_samples=8), camera=cam,
                 lights=lights, device=dev, bvh=build_triangle_bvh(tri, 8))
    assert isinstance(r.bvh, rope.KernelBVH) and r.bvh.node_rows.is_cuda
    before = {**wide.LAUNCHES, **rope.LAUNCHES}
    img = r.render(8).cpu().numpy()
    after = {**wide.LAUNCHES, **rope.LAUNCHES}
    assert after["rope_closest"] > before["rope_closest"]
    for k in ("closest", "occlusion", "rope_occlusion"):
        assert after[k] == before[k], k
    golden = np.load(os.path.join(GOLDEN_DIR, "box_64x48_8spp.npz"))["accum"]
    assert film.rmse(img, golden) < 1e-5


def test_rope_cuda_tensor_gets_the_kernel_or_an_error(dev):
    """CUDA rays never take the plain walk: tables on the CPU, a bad dtype
    or a broken rope raise (the last at the per-sample error check)."""
    kb, tris = _rope_bvh(dev, n_tris=100, masks=False)
    o, d = _rays(64, seed=9)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    z, far = torch.zeros(64, device=dev), torch.full((64,), 1e9, device=dev)
    ones = torch.ones(64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        rope.traverse_packets(rope.make_kernel_bvh(kb.tribvh, tris, device="cpu"),
                              o, d, z, 1e9, ones)
    with pytest.raises(TypeError):
        rope.traverse_cuda(kb, o, d, z, far, ones.float(), occlusion=False, all_definite=False)
    rows = kb.node_rows.clone()
    rows[:, kb.n_internal:, 7] = 0.0  # every leaf's miss link back to the root
    broken = rope.KernelBVH(kb.tribvh, rows, kb.tri_rows, kb.tri_order,
                            card=rope.card_tables(rows, kb.tri_rows, kb.group_size))
    before = dict(rope.LAUNCHES)
    rope.traverse_packets(broken, o, d, z, 1e9, ones)
    assert rope.LAUNCHES["rope_closest"] == before["rope_closest"] + 1
    with pytest.raises(RuntimeError, match="step cap"):
        cudalib.check_kernel_errors(dev)
    cudalib.check_kernel_errors(dev)  # the word was cleared



def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


@pytest.mark.parametrize("walks", [2, 4, 8])
@pytest.mark.parametrize("mode,cell_masks", [("closest", False), ("closest", True),
                                             ("occlusion", False)])
@pytest.mark.parametrize("n", [1, 1000, 70000])
def test_octet_kernel_matches_plain(dev, walks, mode, cell_masks, n):
    """K5 against octet_plain: the same walk order, so t, prim and the
    flag are bit-equal on every ray; a ragged last walk; inactive rays
    miss."""
    kb = _masked_bvh(dev)
    o, d = _rays(n, seed=n + walks)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_min = torch.zeros(n, device=dev)
    far = 3.0 if mode == "occlusion" else 1e9
    lim = np.where(np.arange(n) % 5 == 0, -3e38, far).astype(np.float32)
    t_limit = torch.from_numpy(lim).to(dev)
    kw = dict(occlusion=mode == "occlusion", all_definite=False, cell_masks=cell_masks)
    before = dict(wide.LAUNCHES)
    out_k = wide.octet_cuda(kb, o, d, t_min, t_limit, walks=walks, **kw)
    cudalib.check_kernel_errors(dev)
    assert wide.LAUNCHES["octet_" + mode] == before["octet_" + mode] + 1
    assert wide.LAUNCHES[mode] == before[mode]
    out_p = wide.octet_plain(kb.node_rows, kb.tri_rows, o, d, t_min, t_limit, walks=walks,
                             group=kb.group_size, arity=kb.arity, **kw)
    for a, b in zip(out_k, out_p):
        assert _bits_equal(a, b)
    assert bool((out_k[1][torch.from_numpy(lim < 0).to(dev)] == -1).all())


@pytest.mark.parametrize("config", [name for name, _ in wide.STEPCOST_CONFIGS])
@pytest.mark.parametrize("n", [1000, 70000])
def test_stepcost_kernel_matches_plain(dev, config, n):
    """K6 against stepcost_plain for each kernel_bench configuration: t,
    prim and acc bit-equal."""
    kb = _masked_bvh(dev)
    o, d = _rays(n, seed=n + 3)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_min = torch.zeros(n, device=dev)
    t_limit = torch.full((n,), 1e9, device=dev)
    toggles = dict(wide.STEPCOST_CONFIGS)[config]
    before = wide.LAUNCHES["stepcost"]
    out_k = wide.stepcost_cuda(kb, o, d, t_min, t_limit, steps=64, **toggles)
    torch.cuda.synchronize(dev)
    assert wide.LAUNCHES["stepcost"] == before + 1
    out_p = wide.stepcost_plain(kb.node_rows, kb.tri_rows, o, d, t_min, t_limit, steps=64,
                                group=kb.group_size, arity=kb.arity, **toggles)
    for a, b in zip(out_k, out_p):
        assert _bits_equal(a, b)


def test_stepcost_full_equals_k1(dev):
    """Every phase on and steps covering the longest walk: K6's t and prim
    equal K1's bit for bit."""
    kb = _masked_bvh(dev)
    o, d = _rays(20000, seed=21)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_min = torch.zeros(20000, device=dev)
    t_limit = torch.full((20000,), 1e9, device=dev)
    stats = {}
    wide.traverse_plain(kb.node_rows, kb.tri_rows, o, d, t_min, t_limit, group=kb.group_size,
                        arity=kb.arity, occlusion=False, all_definite=False, cell_masks=False,
                        stats=stats)
    steps = int((stats["node_visits"] + stats["leaf_visits"]).max())
    t1, p1, _ = wide.traverse_cuda(kb, o, d, t_min, t_limit, occlusion=False,
                                   all_definite=False, cell_masks=False)
    t6, p6, _ = wide.stepcost_cuda(kb, o, d, t_min, t_limit, steps=steps)
    cudalib.check_kernel_errors(dev)
    assert _bits_equal(t6, t1) and _bits_equal(p6, p1)


def test_box_golden_through_octet(dev):
    """The box golden with KernelPolicy(octet_closest=8, octet_occlusion=8):
    K5 runs, K1 and K2 do not, and the image is the golden."""
    with tempfile.TemporaryDirectory() as tmp:
        path = write_box_scene(os.path.join(tmp, "box.gltf"))
        cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
        cfg = RenderConfig(width=64, height=48, max_samples=8,
                           kernel=KernelPolicy(octet_closest=8, octet_occlusion=8))
        r = Renderer.from_gltf(path, config=cfg, camera=cam, device=dev,
                               lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)])
        before = dict(wide.LAUNCHES)
        img = r.render(8).cpu().numpy()
    after = dict(wide.LAUNCHES)
    assert after["octet_closest"] > before["octet_closest"]
    assert after["octet_occlusion"] > before["octet_occlusion"]
    assert after["closest"] == before["closest"] and after["occlusion"] == before["occlusion"]
    golden = np.load(os.path.join(GOLDEN_DIR, "box_64x48_8spp.npz"))["accum"]
    assert film.rmse(img, golden) < 1e-5


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_octet_and_stepcost_refuse_missing_or_misaligned_card_tables(dev, kernel):
    """K5 and K6 read only the card tables: a BVH without them, with
    tables that are not 16-byte aligned or with tables on another device
    raises before any launch."""
    kb = _masked_bvh(dev, n_tris=50)
    o = torch.zeros((4, 3), device=dev)
    z = torch.zeros(4, device=dev)
    if kernel == "K5":
        def call(k):
            return wide.octet_cuda(k, o, o, z, z, walks=8, occlusion=False, all_definite=False,
                                   cell_masks=False)
    else:
        def call(k):
            return wide.stepcost_cuda(k, o, o, z, z, steps=4)
    before = dict(wide.LAUNCHES)
    with pytest.raises(ValueError, match="no card tables"):
        call(dataclasses.replace(kb, card=None))
    flat = torch.zeros(kb.card.leaves.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(kb.card.leaves.shape)
    shifted.copy_(kb.card.leaves)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(dataclasses.replace(kb, card=wide.CardTables(kb.card.nodes, shifted)))
    on_cpu = wide.CardTables(kb.card.nodes.cpu(), kb.card.leaves.cpu())
    with pytest.raises(ValueError, match="are on cpu"):
        call(dataclasses.replace(kb, card=on_cpu))
    assert wide.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_octet_and_stepcost_tampered_depth_bound_set_the_stack_bit(dev, kernel):
    """A depth bound below the walk's deepest hit-mask stack ends the walk
    with the wide-stack bit in the card's error word; the true bound does
    not."""
    kb = _masked_bvh(dev)
    assert kb.depth_bound >= 3
    n = 20000
    o, d = _rays(n, seed=6)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    t_min = torch.zeros(n, device=dev)
    t_limit = torch.full((n,), 1e9, device=dev)
    if kernel == "K5":
        def call(k):
            return wide.octet_cuda(k, o, d, t_min, t_limit, walks=8, occlusion=False,
                                   all_definite=False, cell_masks=False)
    else:
        def call(k):
            return wide.stepcost_cuda(k, o, d, t_min, t_limit, steps=64)
    cudalib.check_kernel_errors(dev)
    call(kb)
    torch.cuda.synchronize(dev)
    assert int(cudalib.error_word(dev).item()) == 0
    call(dataclasses.replace(kb, depth_bound=1))
    torch.cuda.synchronize(dev)
    assert int(cudalib.error_word(dev).item()) & cudalib.ERR_WIDE_STACK
    with pytest.raises(RuntimeError, match="wide traversal stack overflow"):
        cudalib.check_kernel_errors(dev)


@pytest.mark.parametrize("mode,cell_masks", [("closest", True), ("occlusion", False)])
def test_octet_kernel_matches_plain_whole_frame(dev, mode, cell_masks):
    """K5 at 8 walks on the 2,073,600 camera rays of the bench camera at
    1920x1080 on the mini Sponza (alpha masks on), and on shadow rays from
    their hits toward a light: t bits, prim and the flag equal to
    octet_plain on every ray."""
    from tpurt_torch.camera import camera_rays_for_rows
    from tpurt_torch.scene.procedural import write_sponza_like_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = write_sponza_like_scene(os.path.join(tmp, "s.gltf"), columns=2, foliage=8)
        cfg = RenderConfig(width=1920, height=1080)
        r = Renderer.from_gltf(path, config=cfg, device=dev,
                               camera=Camera.from_angles([0.0, -4.0, 0.0], 0.7, -0.1))
    kb = r.bvh
    assert kb.use_masks
    o, d, _ = camera_rays_for_rows(r.camera, 0, 1080, 1920, 1080, cfg.tan_half_fov, 0,
                                   cfg.seed, device=dev)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    assert n == 2073600
    t_min = torch.zeros(n, device=dev)
    t_limit = torch.full((n,), 1e9, device=dev)
    if mode == "occlusion":
        t, prim, _ = wide.traverse_cuda(kb, o, d, t_min, t_limit, occlusion=False,
                                        all_definite=False, cell_masks=False)
        hit = prim >= 0
        org = (o + torch.where(hit, t, t_min)[:, None] * d - 0.01 * d).contiguous()
        to_l = torch.tensor([0.0, -7.5, 0.0], device=dev)[None, :] - org
        t_limit = torch.where(hit, torch.linalg.norm(to_l, dim=-1),
                              torch.full_like(t_min, -3e38)).contiguous()
        o, d = org, (to_l / torch.linalg.norm(to_l, dim=-1, keepdim=True)).contiguous()
    kw = dict(occlusion=mode == "occlusion", all_definite=False, cell_masks=cell_masks)
    out_k = wide.octet_cuda(kb, o, d, t_min, t_limit, walks=8, **kw)
    cudalib.check_kernel_errors(dev)
    out_p = wide.octet_plain(kb.node_rows, kb.tri_rows, o, d, t_min, t_limit, walks=8,
                             group=kb.group_size, arity=kb.arity, **kw)
    if mode == "occlusion":
        assert int((out_k[2] != 0).sum()) > 0
    else:
        assert int((out_k[1] >= 0).sum()) > n // 3
    for a, b in zip(out_k, out_p):
        assert _bits_equal(a, b)


def _box_renderer(box, device, w=32, h=24):
    return Renderer.from_gltf(box, config=RenderConfig(width=w, height=h, max_samples=4),
                              camera=Camera.from_angles([1.5, 1.2, 2.0],
                                                        float(np.arctan2(-1.5, -2.0)), -0.45),
                              lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)],
                              device=device)


def test_render_stats_on_the_card_equal_the_cpu_counts(dev, tmp_path):
    """utils.profiling.render_stats of the box at 32x24 through K1/K2 counts
    the rays the CPU's plain traversal counts."""
    from tpurt_torch.utils.profiling import render_stats

    box = write_box_scene(str(tmp_path / "box.gltf"))
    card, cpu = _box_renderer(box, dev), _box_renderer(box, "cpu")
    before = wide.LAUNCHES["closest"]
    for s in (0, 1, 5):
        got, want = render_stats(card, s), render_stats(cpu, s)
        for k in ("rays_logical", "rays_physical", "fold_efficiency"):
            assert got[k] == want[k], (s, k)
    assert wide.LAUNCHES["closest"] > before


def test_checkpoints_cross_between_card_and_cpu(dev, tmp_path):
    """A checkpoint of a card render resumes on the CPU and one of a CPU
    render on the card; each resumed render is within the golden bound of
    the uninterrupted one, and the loaded buffer sits on the renderer's
    device."""
    box = write_box_scene(str(tmp_path / "box.gltf"))
    for first, second in ((dev, "cpu"), ("cpu", dev)):
        r = _box_renderer(box, first)
        r.render(2)
        path = str(tmp_path / f"{torch.device(first).type}.npz")
        r.save_checkpoint(path)
        resumed = _box_renderer(box, second)
        resumed.load_checkpoint(path)
        assert resumed.accum.device.type == torch.device(second).type
        assert resumed.camera.position.device.type == torch.device(second).type
        assert resumed.image().tobytes() == r.image().tobytes()
        img = resumed.render(4).cpu().numpy()
        whole = _box_renderer(box, second).render(4).cpu().numpy()
        assert film.rmse(img, whole) < 1e-5


def test_cli_render_on_the_card_writes_its_png(dev, tmp_path):
    from tpurt_torch import cli

    box = write_box_scene(str(tmp_path / "box.gltf"))
    out = str(tmp_path / "card.png")
    acc = str(tmp_path / "acc.npz")
    phi = float(np.arctan2(-1.5, -2.0))  # the golden's camera, exactly
    assert cli.main(["--platform", "cuda", "render", box, "--res", "64x48", "--spp", "8",
                     "--camera", f"1.5,1.2,2.0:{phi!r}:-0.45",
                     "--light", "2,2,2:0.3:1,0.9,0.8:50",
                     "-o", out, "--save-accum", acc, "--debug-nans"]) == 0
    assert os.path.getsize(out) > 0
    golden = np.load(os.path.join(GOLDEN_DIR, "box_64x48_8spp.npz"))["accum"]
    assert film.rmse(np.load(acc)["accum"], golden) < 1e-5


def test_oracle_matches_production_on_the_card(dev, tmp_path):
    """The brute-force oracle and the wave loop (K1/K2) on the card's
    tensors, exact mode, the same streams: tests/test_oracle_parity.py's
    bound. The oracle's image equals its CPU run within the golden bound."""
    from tpurt_torch.integrator.oracle import render_sample_oracle
    from tpurt_torch.integrator.wavefront import render_sample

    box = write_box_scene(str(tmp_path / "box.gltf"))
    cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    cfg = RenderConfig(width=32, height=24, max_samples=4, fold_bsdf_mis=False)
    light = [SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)]
    r = Renderer.from_gltf(box, config=cfg, camera=cam, lights=light, device=dev)
    rc = Renderer.from_gltf(box, config=cfg, camera=cam, lights=light, device="cpu")
    before = dict(wide.LAUNCHES)
    prod = np.zeros((24, 32, 3))
    orac = np.zeros((24, 32, 3))
    for s in range(4):
        prod += render_sample(r.device_scene, r.bvh, r.camera, s, width=32, height=24, cfg=cfg,
                              has_alpha=r.has_alpha, tex_flags=r.tex_flags)[..., :3].cpu().numpy()
        img = render_sample_oracle(r.device_scene, r.camera, s, width=32, height=24, cfg=cfg)
        assert img.device.type == "cuda"
        orac += img.cpu().numpy()
        cpu = render_sample_oracle(rc.device_scene, rc.camera, s, width=32, height=24, cfg=cfg)
        assert film.rmse(img.cpu().numpy(), cpu.numpy()) < 1e-5
    assert wide.LAUNCHES["closest"] > before["closest"]
    rel = float(np.sqrt(((prod - orac) ** 2).mean())) / float(orac.mean())
    assert rel < 0.01, rel


def test_device_lbvh_on_the_card_equals_the_cpu_build(dev):
    """The device build on the card's tensors gives the CPU build's tree:
    every integer array equal, every box bit-equal; and it validates."""
    from tpurt_torch.bvh import lbvh

    r = np.random.RandomState(4)
    tris = ((r.rand(5000, 1, 3) - 0.5) * 20 + (r.rand(5000, 3, 3) - 0.5)).astype(np.float32)
    tris[2500] = tris[0]
    for g in (4, 8):
        card = lbvh._build_triangle_bvh_device(tris, g, device=dev)
        cpu = lbvh._build_triangle_bvh_device(tris, g, device="cpu")
        assert card.tri_order.tobytes() == cpu.tri_order.tobytes()
        for f in lbvh.LBVH._fields:
            a, b = getattr(card.bvh, f), getattr(cpu.bvh, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (g, f)
        gmin = tris[card.tri_order].reshape(-1, g, 3, 3).min(axis=(1, 2))
        gmax = tris[card.tri_order].reshape(-1, g, 3, 3).max(axis=(1, 2))
        lbvh.validate_lbvh(card.bvh, gmin, gmax)
