"""The port's viewer (tpurt_torch/viewer.py): tests/test_viewer.py's
serve-and-move case on the port, on a free port, and the same key and
drag sequence moving tpurt's ViewerState and the port's to the same
cameras, bit for bit."""

import json
import threading
import time
import urllib.request

import numpy as np

from tpurt_torch import viewer
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene

POSE = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)


def test_viewer_serves_and_moves(tmp_path):
    cfg = RenderConfig(width=32, height=24, max_samples=4)
    r = Renderer.from_gltf(write_box_scene(str(tmp_path / "b.gltf")), config=cfg,
                           camera=Camera.from_angles(*POSE), device="cpu", cache=False,
                           lights=[SphereLight((2, 2, 2), 0.3, (1, 0.9, 0.8), 50.0)])
    server, state, stop = viewer.serve(r, "127.0.0.1", 0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        for _ in range(60):
            try:
                return urllib.request.urlopen(base + path, timeout=5).read()
            except Exception:
                time.sleep(0.5)
        raise TimeoutError(path)

    try:
        assert b"tpurt" in get("/")
        assert get("/frame.png")[:4] == b"\x89PNG"
        assert b"spp" in get("/status")
        pos_before = r.camera.position.numpy().copy()
        get("/key?k=w")
        time.sleep(0.5)
        assert not np.allclose(pos_before, r.camera.position.numpy())  # camera moved
        cam = json.loads(get("/camera"))
        np.testing.assert_array_equal(np.float32(cam["position"]), r.camera.position.numpy())
        get("/key?k=%2B")
        assert b"3.25" in get("/status")  # exposure bumped

        # drag-look turns the view direction, not the position
        dir_before = r.camera.direction.numpy().copy()
        pos_before = r.camera.position.numpy().copy()
        get("/look?dx=80&dy=-40")
        time.sleep(0.3)
        assert not np.allclose(dir_before, r.camera.direction.numpy())
        assert np.allclose(pos_before, r.camera.position.numpy())
        get("/look?dx=bogus&dy=1")  # malformed deltas must not 500
        assert b"spp" in get("/status")
    finally:
        stop()
    # stop() joined the render worker
    assert not any(t.name == viewer.WORKER_NAME for t in threading.enumerate())


class _Stub:
    """What ViewerState reads and calls of a renderer."""

    def __init__(self, camera):
        self.camera = camera
        self.config = RenderConfig(width=8, height=8)

    def set_camera(self, camera):
        self.camera = camera


SEQUENCE = [("key", "w"), ("key", "a"), ("key", "ArrowLeft"), ("key", "d"),
            ("key", "ArrowUp"), ("key", "r"), ("look", (80.0, -40.0)), ("key", "s"),
            ("key", "ArrowRight"), ("key", "f"), ("key", "ArrowDown"),
            ("look", (-13.5, 22.0)), ("key", "+"), ("key", "w"), ("key", "x")]


def test_key_and_look_sequence_matches_tpurt():
    from tpurt import viewer as jviewer
    from tpurt.camera import Camera as JCamera

    mine = viewer.ViewerState(_Stub(Camera.from_angles(*POSE)))
    ref = jviewer.ViewerState(_Stub(JCamera.from_angles(*POSE)))
    for kind, arg in SEQUENCE:
        for state in (mine, ref):
            if kind == "key":
                state.handle_key(arg)
            else:
                state.handle_look(*arg)
        assert (mine.phi, mine.theta, mine.gen, mine.exposure) == \
            (ref.phi, ref.theta, ref.gen, ref.exposure), (kind, arg)
        for a, b in zip(mine.renderer.camera, ref.renderer.camera):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{kind} {arg}")
