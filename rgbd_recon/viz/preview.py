"""Minimal live preview: MJPEG-over-HTTP stream of the latest render.

The reference is an interactive GLFW/ImGui viewer
(source/kinect_client.cpp:583-716); this framework runs headless, with
the feedback channel as its control surface. This module closes the last
gap — WATCHING a running reconstruction — with the lightest-weight remote
display there is: an HTTP endpoint any browser (or ffplay) can open.

    preview = PreviewServer(port=8089)
    ...
    preview.update(np.asarray(out.color))     # (H, W, 3) float [0,1]

Endpoints:  /        tiny HTML page wrapping the stream
            /stream  multipart/x-mixed-replace MJPEG
            /frame   single JPEG snapshot

Stdlib http.server + Pillow (an optional dependency, imported only when
a preview server starts); the encoder runs on the caller's thread at
update() time, the server threads only ship bytes. Frames are dropped, never queued — a slow viewer sees the latest
frame, like every other drop-to-latest surface in this framework.
"""

from __future__ import annotations

import io
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "the live preview encodes JPEG with Pillow, which is not "
            "installed: install it or run without --preview-port"
        ) from e
    return Image


_PAGE = b"""<!doctype html><html><head><title>rgbd_recon</title>
<style>body{background:#111;margin:0;display:flex;align-items:center;
justify-content:center;height:100vh}img{max-width:100%;max-height:100%}
</style></head><body><img src="/stream"></body></html>"""


class PreviewServer:
    """Background MJPEG preview server. Thread-safe update()."""

    def __init__(self, port: int = 8089, host: str = "0.0.0.0",
                 quality: int = 80):
        _pil_image()  # fail at start-up, not on the first frame
        self._lock = threading.Condition()
        self._jpeg: bytes = b""
        self._seq = 0
        self._quality = int(quality)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_PAGE)))
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif self.path == "/frame":
                    buf = outer._latest()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(buf)))
                    self.end_headers()
                    self.wfile.write(buf)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=f",
                    )
                    self.end_headers()
                    last = -1
                    try:
                        while True:
                            buf, last = outer._next(last)
                            self.wfile.write(
                                b"--f\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(buf)}\r\n\r\n"
                                .encode()
                            )
                            self.wfile.write(buf)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _latest(self) -> bytes:
        with self._lock:
            return self._jpeg or _blank_jpeg()

    def _next(self, last_seq: int, timeout: float = 5.0):
        """Block until a frame newer than last_seq exists (or timeout —
        then re-send the latest so the stream stays alive)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._seq == last_seq or not self._jpeg:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._lock.wait(remaining):
                    break
            return self._jpeg or _blank_jpeg(), self._seq

    def update(self, image: np.ndarray) -> None:
        """Publish a frame: (H, W, 3) float [0,1] or uint8."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        buf = io.BytesIO()
        _pil_image().fromarray(img).save(buf, format="JPEG",
                                  quality=self._quality)
        with self._lock:
            self._jpeg = buf.getvalue()
            self._seq += 1
            self._lock.notify_all()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def _blank_jpeg() -> bytes:
    buf = io.BytesIO()
    _pil_image().new("RGB", (16, 16)).save(buf, format="JPEG")
    return buf.getvalue()
