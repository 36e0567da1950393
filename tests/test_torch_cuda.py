"""The CUDA traversal kernels (csrc/wide_traverse.cu, K1 closest hit and K2
occlusion; csrc/rope_traverse.cu, K3 rope closest hit and K4 rope
occlusion; csrc/wide_octet.cu, K5 multi-walk; csrc/wide_stepcost.cu, K6
step cost) against their plain PyTorch versions on the same inputs, and
the box golden rendered through the wide kernels, through K5 and through
K3. These need an NVIDIA card: they
are marked `cuda` and skip without one. They import nothing of JAX or
tpurt, so they also run where neither is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

The kernel is built with --fmad=false and repeats the plain version's
expression order, so `t` is bit-equal on every ray; `prim` may differ
only on an exact-t tie."""

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
    # t bit-equal on every ray; a differing prim is then an exact-t tie
    assert bool(torch.equal(tk.view(torch.int32), tp.view(torch.int32)))
    assert int((pk != pp).sum()) <= max(2, n // 100)
    assert bool(torch.equal(fk, fp))
    assert bool((pk[torch.from_numpy(lim < 0).to(dev)] == -1).all())


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
    """K3 / K4 against the plain rope walk: t, u, v bit-equal, prim the same
    leaf slot (both walk the same order), blocked equal; inactive rays miss."""
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
    for a, b in zip(out_k, out_p):
        assert bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    assert bool((out_k[1][~active] == -1).all())


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
    broken = rope.KernelBVH(kb.tribvh, rows, kb.tri_rows, kb.tri_order)
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
