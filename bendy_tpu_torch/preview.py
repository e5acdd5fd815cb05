"""Live render preview + runtime control over HTTP (the headless minifb).

Counterpart of ``bendy_tpu/preview.py``, the same server and endpoints,
reading the port's :class:`~bendy_tpu_torch.film.Film` or
:class:`~bendy_tpu_torch.film.DeviceFilm` (stdlib ``http.server``; PIL
only to encode the PNG).

The reference opens a minifb window, blits the progressive film every
frame, and handles hotkeys on the live render: Ctrl+P screenshot,
Ctrl+K scene save, Ctrl+L scene reload + film clear, window resize
(``src/main.rs:262-348``). A render node has no display or keyboard,
so the equivalent is a tiny zero-dependency HTTP server:

    GET  /             auto-refreshing HTML page with preview + telemetry
    GET  /frame.png    latest tonemapped film
    GET  /stats        render telemetry as JSON (the title-bar stats,
                       ``src/main.rs:352-388``)
    POST /screenshot   write the PNG now                (Ctrl+P, main.rs:275-298)
    POST /save-scene   serialize the live scene         (Ctrl+K, main.rs:299-313)
    POST /reload-scene reload scene file + clear film   (Ctrl+L, main.rs:314-335)
    POST /resize?width=W&height=H   resize film + camera aspect
                                                        (main.rs:337-348)
    POST /checkpoint   persist the raw film checkpoint now
    POST /camera?x=&y=&z=[&tx=&ty=&tz=]   move the camera (optionally
                       aim it at a target point) + clear the film —
                       the camera is a launch argument, so this never
                       rebuilds the kernel
    POST /stop         finish the current pass and exit cleanly

POSTs enqueue commands; the render loop drains them between passes (the
reference polls keys once per frame, ``main.rs:245-274`` — same cadence).
The CLI enables it all with ``--serve PORT``.
"""

from __future__ import annotations

import io
import json
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = b"""<!doctype html>
<html><head><title>bendy-tpu</title>
<style>body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;margin-top:1em;max-width:90vw}
button{background:#222;color:#ccc;border:1px solid #555;margin:0 .2em;padding:.3em .8em}</style>
<script>
async function tick(){
  const s = await (await fetch('/stats')).json();
  document.getElementById('s').textContent = JSON.stringify(s);
  document.getElementById('f').src = '/frame.png?' + s.passes;
}
async function cmd(c){ await fetch('/' + c, {method:'POST'}); }
setInterval(tick, 1000); window.onload = tick;
</script></head>
<body><h3>bendy-tpu live preview</h3><div id=s></div>
<div style="margin-top:.5em">
<button onclick="cmd('screenshot')">screenshot</button>
<button onclick="cmd('save-scene')">save scene</button>
<button onclick="cmd('reload-scene')">reload scene</button>
<button onclick="cmd('checkpoint')">checkpoint</button>
<button onclick="cmd('stop')">stop</button>
</div>
<img id=f src=/frame.png></body></html>
"""

_COMMANDS = ("screenshot", "save-scene", "reload-scene", "checkpoint", "stop",
             "resize", "camera")


class PreviewServer:
    def __init__(self, port: int, host: str = "127.0.0.1") -> None:
        """Bind to loopback by default: the POST endpoints mutate a live
        render and write files, so exposure beyond the host must be an
        explicit operator decision (``host="0.0.0.0"``)."""
        self._lock = threading.Lock()
        self._png = b""
        self._want_frame = False  # a client asked for /frame.png
        self._want_stats = False  # a client asked for /stats
        self._stats = {}
        self._commands: deque = deque()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _reply(self, body, ctype, code=200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with server._lock:
                        body, ctype = server._png, "image/png"
                        server._want_frame = True  # refresh next pass
                elif self.path.startswith("/stats"):
                    with server._lock:
                        body = json.dumps(server._stats).encode()
                        server._want_stats = True  # refresh next pass
                    ctype = "application/json"
                else:
                    body, ctype = _PAGE, "text/html"
                self._reply(body, ctype)

            def do_POST(self):
                url = urlparse(self.path)
                name = url.path.lstrip("/")
                if name not in _COMMANDS:
                    self._reply(b'{"error": "unknown command"}',
                                "application/json", 404)
                    return
                args = {k: v[0] for k, v in parse_qs(url.query).items()}
                # client-supplied paths must stay relative and inside cwd
                p = args.get("path", "")
                if p and (p.startswith(("/", "~")) or ".." in p):
                    self._reply(b'{"error": "path must be relative"}',
                                "application/json", 400)
                    return
                with server._lock:
                    server._commands.append((name, args))
                self._reply(b'{"queued": true}', "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        self.port = self._httpd.server_address[1]  # resolved when port=0

    def publish(self, film, lazy=None, **stats) -> None:
        """Publish the film's current preview + telemetry.

        Cheap telemetry (host-side counters + ``stats`` kwargs) updates
        every call. Everything touching the device is DEMAND-DRIVEN —
        this runs once per pass on the render loop, and a device
        round-trip stalls the queue of passes:

        - the frame: ``film.preview()`` on a DeviceFilm is a full
          device->host fetch and sync, so it refreshes only when a client
          requested ``/frame.png`` since the last publish,
        - ``lazy``: an optional callable returning a stats dict whose
          computation costs a device sync (e.g. the renderer's pending
          ray counters); called only when a client requested ``/stats``
          since the last publish, its values persisting in between.

        The auto-refresh page re-requests both every second, so a
        watched render stays live; an unwatched one pays nothing.
        """
        with self._lock:
            prev = self._stats
            want_stats = self._want_stats and lazy is not None
            self._want_stats = False
            want_frame = self._want_frame or not self._png
            self._want_frame = False
        extra = lazy() if want_stats else {
            k: v for k, v in prev.items() if k not in ("samples", "passes")
        }
        with self._lock:
            self._stats = {"samples": film.samples, "passes": film.passes,
                           **extra, **stats}
        if not want_frame:
            return
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(film.preview()).save(buf, format="PNG")
        with self._lock:
            self._png = buf.getvalue()

    def drain_commands(self) -> list[tuple[str, dict]]:
        """Pop all queued control commands ((name, args) pairs, FIFO).

        Called by the render loop between passes — the same cadence at
        which the reference polls its hotkeys (``main.rs:245-274``).
        """
        with self._lock:
            out = list(self._commands)
            self._commands.clear()
        return out

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()  # release the listening socket
