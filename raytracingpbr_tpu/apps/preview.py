"""Live preview endpoint for headless renders.

Closes the last L7 gap vs the reference's windowed app
(``/root/reference/src/main.py:14-18,64`` — ``ti.ui.Window`` +
``canvas.set_image``): a GPU server has no display, so the converging
framebuffer is served over HTTP instead. One background thread, stdlib only:

* ``/``          — HTML page that live-reloads the frame (~2 Hz poll)
* ``/frame.png`` — the latest tonemapped framebuffer
* ``/stream``    — multipart/x-mixed-replace PNG push stream
* ``/stats``     — JSON render stats (frame, mean spp, samples/s)

The render loop calls ``PreviewServer.update(img, **stats)`` whenever it has
fresh pixels; encoding (zlib level 1) happens on the caller's thread once
per update, requests just replay the cached bytes.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..io.image import encode_png

_PAGE = b"""<!doctype html>
<html><head><title>raytracingpbr_tpu preview</title><style>
body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;max-width:95vw;max-height:80vh;
    border:1px solid #333;margin-top:1em}
#s{margin-top:.5em;white-space:pre}
</style></head><body>
<h3>progressive render</h3>
<img id="f" src="/frame.png">
<div id="s"></div>
<script>
const img=document.getElementById('f'),st=document.getElementById('s');
setInterval(()=>{img.src='/frame.png?t='+Date.now();
 fetch('/stats').then(r=>r.json()).then(j=>{
  st.textContent=JSON.stringify(j)}).catch(()=>{})},500);
</script></body></html>"""


class PreviewServer:
    """Threaded HTTP preview; start() returns immediately."""

    # Loopback by default: the endpoints are unauthenticated — binding all
    # interfaces must be an explicit choice (--serve-host; ADVICE r3).
    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._lock = threading.Condition()
        self._png: Optional[bytes] = None
        self._stats: dict = {}
        self._seq = 0
        self._httpd: Optional[ThreadingHTTPServer] = None

    # --- render-loop side -------------------------------------------------
    def update(self, img: np.ndarray, **stats) -> None:
        """Publish a fresh (H, W, 3) frame (float [0,1] or uint8)."""
        png = encode_png(img)
        with self._lock:
            self._png = png
            self._stats = {**stats, "t": round(time.time(), 3)}
            self._seq += 1
            self._lock.notify_all()

    # --- server side -------------------------------------------------------
    def start(self) -> "PreviewServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE)
                elif path == "/frame.png":
                    with outer._lock:
                        png = outer._png
                    if png is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif path == "/stats":
                    with outer._lock:
                        body = json.dumps(outer._stats).encode()
                    self._send(200, "application/json", body)
                elif path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seen = -1
                    try:
                        while True:
                            with outer._lock:
                                if outer._seq == seen:
                                    outer._lock.wait(timeout=5.0)
                                png, seen = outer._png, outer._seq
                            if png is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                b"Content-Length: %d\r\n\r\n" % len(png))
                            self.wfile.write(png + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        print(f"preview: http://{self.host}:{self.port}/", flush=True)
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None
