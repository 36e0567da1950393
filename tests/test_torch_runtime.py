"""The port's runtime layer (tpurt_torch/runtime/device.py) and the
renderer's frame pacing: device discovery on the CPU, tpurt's bounded
FramePacer case, where the renderer checks the kernels' error word
(where a frame retires and in drain), drain folding the elapsed time
into sample_time, and Camera.moved against tpurt's."""

import time

import numpy as np
import pytest
import torch

from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.renderer import Renderer
from tpurt_torch.runtime import (FRAMES_IN_FLIGHT, DeviceNotFound, FramePacer, list_devices,
                                 select_device)
from tpurt_torch.scene.procedural import write_box_scene


def test_list_and_select_devices():
    infos = list_devices()
    assert infos and select_device().platform == infos[0].platform
    if torch.cuda.is_available():
        assert all(i.platform == "cuda" and i.memory_bytes > 0 for i in infos)
        assert select_device("cuda").kind == torch.cuda.get_device_name(0)
    else:
        assert [(i.platform, i.kind, i.index) for i in infos] == [("cpu", "cpu", 0)]
        assert select_device("cpu").platform == "cpu"
        with pytest.raises(DeviceNotFound):
            select_device("cuda")
    with pytest.raises(DeviceNotFound):
        select_device("nonexistent-platform")


def test_frame_pacer_bounded():
    pacer = FramePacer(depth=2)
    outs = []
    for i in range(5):
        r = pacer.submit(torch.ones(4) * i)
        if r is not None:
            outs.append(float(r[0]))
    drained = pacer.drain()
    assert len(outs) == 3          # 5 submitted, ring depth 2
    assert len(drained) == 2
    assert outs == [0.0, 1.0, 2.0]  # FIFO order
    assert [float(x[0]) for x in drained] == [3.0, 4.0] and pacer.drain() == []


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_scene(str(tmp_path_factory.mktemp("box") / "b.gltf"))


def _renderer(box, max_samples=8):
    cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    return Renderer.from_gltf(box, config=RenderConfig(width=8, height=8,
                                                       max_samples=max_samples),
                              camera=cam, lights=[SphereLight((2, 2, 2), 0.3, (1, 0.9, 0.8), 50.0)],
                              device="cpu", cache=False)


def test_kernel_errors_checked_where_frames_retire_and_in_drain(box, monkeypatch):
    from tpurt_torch import renderer as renderer_mod

    checks = []
    monkeypatch.setattr(renderer_mod.cudalib, "check_kernel_errors",
                        lambda device: checks.append(torch.device(device)))
    r = _renderer(box)
    for i in range(FRAMES_IN_FLIGHT + 2):
        r.step()
        # nothing is checked until a frame retires from the full ring
        assert len(checks) == max(0, i + 1 - FRAMES_IN_FLIGHT)
    r.render(6)  # one more retiring step, then a drain: it stops short of max_samples
    assert len(checks) == 2 + 1 + 1 and checks[-1] == torch.device("cpu")
    assert r._pacer.drain() == []
    # the ring refills from empty, so neither step retires a frame; the
    # last reaches max_samples, and the step and render each finish with
    # a drain
    r.render(8)
    assert r.sample_count == 8 and len(checks) == 4 + 2


def test_drain_folds_the_elapsed_span_into_sample_time(box):
    r = _renderer(box)
    r.step()
    assert r._wall_start is not None and r.sample_time > 0.0
    time.sleep(0.05)
    before = r.sample_time
    r.drain()
    assert r._wall_start is None
    assert r.sample_time == r._time_base and r.sample_time >= before + 0.05
    # the timer runs on from the folded base at the next step
    r.step()
    assert r.sample_time > r._time_base
    r.drain()
    assert r.sample_time == r._time_base


@pytest.mark.parametrize("move", [dict(forward=0.25), dict(rightward=-0.25),
                                  dict(upward=0.25), dict(forward=-1.3, rightward=0.7,
                                                          upward=0.1)])
def test_camera_moved_matches_tpurt(move):
    from tpurt.camera import Camera as JCamera

    pose = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    got = Camera.from_angles(*pose).moved(**move)
    ref = JCamera.from_angles(*pose).moved(**move)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
