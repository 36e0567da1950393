"""Interactive progressive viewer (the counterpart of tpurt/viewer.py):
a small stdlib HTTP server. The browser shows the progressive render
(refreshed twice a second) and forwards key presses and drags; a worker
thread accumulates samples on the renderer's device and resets on every
camera move.

Keys: W/A/S/D fly, R/F up/down, arrow keys or a left-button drag look,
+/- exposure. Besides tpurt's endpoints, /camera returns the camera as
JSON.

Usage: python -m tpurt_torch.cli view scene.gltf --res 480x360 --port 8000
"""

from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from tpurt_torch import film
from tpurt_torch.camera import Camera
from tpurt_torch.utils import png

_PAGE = """<!doctype html>
<html><head><title>tpurt viewer</title><style>
body { background: #111; color: #ccc; font-family: monospace; text-align: center; }
img { image-rendering: pixelated; width: 80vmin; }
</style></head>
<body>
<h3>tpurt progressive viewer</h3>
<div>WASD fly &middot; R/F up/down &middot; arrows or drag look &middot; +/- exposure</div>
<p id="status"></p>
<img id="frame" src="/frame.png" draggable="false">
<script>
const img = document.getElementById('frame');
const status = document.getElementById('status');
setInterval(() => { img.src = '/frame.png?' + Date.now();
  fetch('/status').then(r => r.text()).then(t => status.textContent = t);
}, 500);
document.addEventListener('keydown', (e) => {
  fetch('/key?k=' + encodeURIComponent(e.key));
});
// drag-to-look, gated on the left button like the reference
// (Window.cpp:67-82): deltas accumulate and flush every 60 ms
let dragging = false, accX = 0, accY = 0;
img.addEventListener('pointerdown', (e) => {
  if (e.button === 0) { dragging = true; img.setPointerCapture(e.pointerId); }
});
img.addEventListener('pointerup', () => { dragging = false; });
img.addEventListener('pointermove', (e) => {
  if (dragging) { accX += e.movementX; accY += e.movementY; }
});
setInterval(() => {
  if (accX !== 0 || accY !== 0) {
    fetch('/look?dx=' + accX + '&dy=' + accY); accX = 0; accY = 0;
  }
}, 60);
</script>
</body></html>"""


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class ViewerState:
    def __init__(self, renderer):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.running = True
        # camera generation: bumped on every camera change so the render
        # loop can tell that a launch used the old camera and discard it
        self.gen = 0
        # the viewer's own exposure: the tonemap runs per frame request
        self.exposure = float(renderer.config.exposure)
        # look angles (yaw phi, pitch theta), from the renderer's camera
        self.phi = 0.0
        self.theta = math.pi
        self._sync_angles_from_camera()

    def _sync_angles_from_camera(self):
        d = _np(self.renderer.camera.direction)
        self.theta = math.asin(float(np.clip(d[1], -1.0, 1.0)))
        self.phi = math.atan2(float(d[0]), float(d[2]))

    def handle_key(self, key: str):
        step = 0.25  # fly step
        look = 0.08
        with self.lock:
            r = self.renderer
            cam = r.camera
            if key in ("w", "W"):
                cam = cam.moved(forward=step)
            elif key in ("s", "S"):
                cam = cam.moved(forward=-step)
            elif key in ("a", "A"):
                cam = cam.moved(rightward=-step)
            elif key in ("d", "D"):
                cam = cam.moved(rightward=step)
            elif key in ("r", "R"):
                cam = cam.moved(upward=step)
            elif key in ("f", "F"):
                cam = cam.moved(upward=-step)
            elif key in ("ArrowLeft", "ArrowRight", "ArrowUp", "ArrowDown"):
                if key == "ArrowLeft":
                    self.phi += look
                elif key == "ArrowRight":
                    self.phi -= look
                elif key == "ArrowUp":
                    self.theta += look
                else:
                    self.theta -= look
                self.theta = max(-1.55, min(1.55, self.theta))
                cam = Camera.from_angles(_np(cam.position), self.phi, self.theta)
            elif key in ("+", "="):
                self.exposure += 0.25
                return
            elif key in ("-", "_"):
                self.exposure = max(0.0, self.exposure - 0.25)
                return
            else:
                return
            r.set_camera(cam)  # resets accumulation
            self.gen += 1

    def handle_look(self, dx: float, dy: float):
        """Drag-look: pixel deltas to yaw and pitch, in the arrow keys'
        convention."""
        sens = 0.005  # radians per pixel
        with self.lock:
            r = self.renderer
            self.phi -= dx * sens         # drag right: look right
            self.theta -= dy * sens       # drag up (dy < 0): look up
            self.theta = max(-1.55, min(1.55, self.theta))
            cam = Camera.from_angles(_np(r.camera.position), self.phi, self.theta)
            r.set_camera(cam)  # resets accumulation
            self.gen += 1

    def frame_png(self) -> bytes:
        # no lock: film.accumulate returns a new tensor each launch, so the
        # reference taken here is a consistent frame; a request never waits
        # for a launch of the render loop
        accum = self.renderer.accum
        mapped = film.to_srgb8(film.tonemap(accum, self.exposure))[..., :3]
        return png.encode_png(mapped)

    def status(self) -> str:
        r = self.renderer
        return (f"{r.sample_count}/{r.config.max_samples} spp | "
                f"{r.sample_time:.1f}s | exposure {self.exposure:.2f}")

    def camera_json(self) -> str:
        cam = self.renderer.camera
        return json.dumps({k: _np(getattr(cam, k)).tolist()
                           for k in ("position", "direction", "right")})

    def render_loop(self):
        r = self.renderer
        on_card = (torch.cuda.device(r.device) if r.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            while self.running:
                with self.lock:
                    gen0 = self.gen
                    busy = r.sample_count < r.config.max_samples
                if busy:
                    # the launch runs outside the lock, so frame requests
                    # and key presses are answered while it runs
                    r.step()
                    with self.lock:
                        if self.gen != gen0:
                            # the camera moved mid-launch: discard it
                            r.reset()
                else:
                    time.sleep(0.1)


WORKER_NAME = "tpurt_torch viewer render loop"


def serve(renderer, host: str = "127.0.0.1", port: int = 8000, block: bool = True):
    """Serve the viewer (port 0: any free port; `server.server_address`
    says which). With `block` (the CLI) this serves until Ctrl-C. With
    block=False it returns (server, state, stop), and the caller MUST call
    stop(): it ends the render worker and joins it before it returns, so
    no launch of the worker overlaps the caller's later device work."""
    state = ViewerState(renderer)
    worker = threading.Thread(target=state.render_loop, name=WORKER_NAME, daemon=True)
    worker.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif url.path == "/frame.png":
                self._send(200, state.frame_png(), "image/png")
            elif url.path == "/status":
                self._send(200, state.status().encode(), "text/plain")
            elif url.path == "/camera":
                self._send(200, state.camera_json().encode(), "application/json")
            elif url.path == "/key":
                key = parse_qs(url.query).get("k", [""])[0]
                state.handle_key(key)
                self._send(200, b"ok", "text/plain")
            elif url.path == "/look":
                q = parse_qs(url.query)
                try:
                    dx = float(q.get("dx", ["0"])[0])
                    dy = float(q.get("dy", ["0"])[0])
                except ValueError:
                    dx = dy = 0.0
                state.handle_look(dx, dy)
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

    server = ThreadingHTTPServer((host, port), Handler)

    def stop_worker():
        state.running = False
        worker.join(timeout=60)

    if not block:
        http_thread = threading.Thread(target=server.serve_forever, daemon=True)
        http_thread.start()

        def stop():
            stop_worker()
            server.shutdown()
            http_thread.join(timeout=10)
            server.server_close()

        return server, state, stop
    bound_host, bound_port = server.server_address[:2]
    print(f"tpurt_torch viewer at http://{bound_host}:{bound_port}/ (Ctrl-C to stop)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop_worker()
        server.server_close()
