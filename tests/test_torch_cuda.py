"""The CUDA traversal kernel (csrc/wide_traverse.cu, K1 closest hit and K2
occlusion) against its plain PyTorch version on the same inputs, and the
box golden rendered through the kernel. These need an NVIDIA card: they
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
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.kernels import wide
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
    wide.check_kernel_errors(dev)
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
