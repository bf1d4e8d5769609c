"""Progressive render preview.

The reference opens a winit window + LuisaCompute swapchain and hands the
integrators a DisplayChannel (crates/akari_render/src/gui.rs:18-110). An
accelerator host is typically headless, so the equivalent here is a tiny
local HTTP viewer: `DisplayServer` serves an auto-refreshing page + the
latest frame as PNG; integrators push frames through
`RenderSession.display` at progress cadence. Standard library only.

    python -m akari_render.cli -s scene.json -m pt.json --gui
    # then open the printed http://127.0.0.1:<port>/
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = b"""<!doctype html>
<html><head><title>akari_render</title><style>
body { background: #111; margin: 0; display: grid; place-items: center;
       height: 100vh; color: #888; font: 12px monospace; }
img { image-rendering: pixelated; max-width: 95vw; max-height: 90vh; }
</style></head><body>
<div><img id="f" src="/frame.png"><div id="s"></div></div>
<script>
let n = 0;
setInterval(() => {
  const img = document.getElementById('f');
  img.src = '/frame.png?' + (n++);
}, 500);
</script></body></html>"""


class DisplayServer:
    """Serves the most recent frame at http://127.0.0.1:<port>/ (gui.rs analog)."""

    def __init__(self, port: int = 0):
        self._png: bytes | None = None
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with outer._lock:
                        png = outer._png
                    if png is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def update(self, img) -> None:
        """img: [H, W, 3] linear float numpy array."""
        from .core.image_io import encode_png, to_srgb8

        png = encode_png(to_srgb8(img))
        with self._lock:
            self._png = png

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
