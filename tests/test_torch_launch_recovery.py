"""Launch recovery in the port's Renderer (the counterpart of
tests/test_launch_recovery.py): a launch that fails for lack of memory is
retried from the newest complete state with half the row band, and the
render ends as the uninterrupted one; programming errors, CUDA faults
that poison the context and the port's own kernel faults propagate."""

import numpy as np
import pytest
import torch

import tpurt_torch.renderer as renderer_mod
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.renderer import Renderer, _is_launch_failure
from tpurt_torch.scene.procedural import write_box_scene

OOM = "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.10 GiB total capacity)"


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_scene(str(tmp_path_factory.mktemp("box") / "box.gltf"))


def _renderer(path, **cfg_kw):
    cfg = RenderConfig(width=32, height=24, max_samples=4, spp_per_launch=1, **cfg_kw)
    cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    return Renderer.from_gltf(path, config=cfg, camera=cam, device="cpu", cache=False,
                              lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)])


def test_is_launch_failure_filter():
    assert _is_launch_failure(torch.cuda.OutOfMemoryError(OOM))
    assert _is_launch_failure(RuntimeError(OOM))
    assert _is_launch_failure(RuntimeError("DEADLINE_EXCEEDED: launch exceeded wall time"))
    assert _is_launch_failure(RuntimeError("socket closed"))
    # programming errors propagate
    assert not _is_launch_failure(ValueError("deadline"))
    assert not _is_launch_failure(TypeError("out of memory"))
    assert not _is_launch_failure(RuntimeError("INVALID_ARGUMENT: shape mismatch f32[3] vs f32[4]"))
    # faults a smaller band cannot fix, needle or not
    for msg in ("CUDA kernel fault: wide traversal stack overflow",
                "CUDA error: an illegal memory access was encountered",
                "CUDA error: unspecified launch failure (launch timed out)"):
        assert not _is_launch_failure(RuntimeError(msg)), msg


@pytest.mark.parametrize("exc", [torch.cuda.OutOfMemoryError, RuntimeError])
def test_step_recovers_from_a_failed_launch(box, monkeypatch, capsys, exc):
    ref = _renderer(box)
    ref.render(4)

    r = _renderer(box)
    real = renderer_mod.render_sample_stats
    fails = {"left": 2}
    bands = []

    def flaky(*args, **kw):
        bands.append(kw["chunk_rows"])
        if fails["left"] > 0:
            fails["left"] -= 1
            raise exc(OOM)
        return real(*args, **kw)

    monkeypatch.setattr(renderer_mod, "render_sample_stats", flaky)
    r.render(4)
    assert fails["left"] == 0
    assert r.sample_count == 4
    # two failures: the band halves twice from the whole frame, 24 -> 12 ->
    # 8 (the floor), and the later launches keep it
    assert r._chunk_rows_now == 8 and bands == [0, 12, 8, 8, 8, 8]
    # recovery does not corrupt the accumulation: the same sample streams
    # (tpurt's bound; on the CPU a band may round a pixel one ulp apart
    # from a whole frame, ROADMAP queue 3)
    np.testing.assert_allclose(r.accum.numpy(), ref.accum.numpy(), atol=2e-6)
    assert "retrying from sample 0 with chunk_rows=12" in capsys.readouterr().err


def test_recovery_rolls_back_to_the_newest_complete_state(box, monkeypatch):
    """A failure after sample 2 was counted but before its accumulation was
    stored: the retry resumes from the history's sample 2."""
    ref = _renderer(box)
    ref.render(4)
    r = _renderer(box)
    r.render(2)
    real = renderer_mod.film.accumulate
    fails = {"left": 1}

    def flaky(*args):
        if fails["left"]:
            fails["left"] -= 1
            raise torch.cuda.OutOfMemoryError(OOM)
        return real(*args)

    monkeypatch.setattr(renderer_mod.film, "accumulate", flaky)
    r.render(4)
    assert fails["left"] == 0 and r.sample_count == 4 and r._chunk_rows_now == 12
    np.testing.assert_allclose(r.accum.numpy(), ref.accum.numpy(), atol=2e-6)


@pytest.mark.parametrize("msg", ["INVALID_ARGUMENT: dtype mismatch",
                                 "CUDA kernel fault: wide traversal stack overflow",
                                 "CUDA error: an illegal memory access was encountered"])
def test_programming_errors_and_kernel_faults_propagate(box, monkeypatch, msg):
    r = _renderer(box)

    def broken(*args, **kw):
        raise RuntimeError(msg)

    monkeypatch.setattr(renderer_mod, "render_sample_stats", broken)
    with pytest.raises(RuntimeError, match=msg.split(":")[0]):
        r.step()
    assert r._chunk_rows_now == 0 and r.sample_count == 0
