"""Live HTTP render window — the remote-display analog of the
reference's swapchain presentation (``gpu_wavefront_pt/src/display.rs:
112-150``, per-frame present; continuous redraw ``app.rs:102-121``).

Port of ``wavefront_path_tracer_tpu/utils/preview_server.py``.  A GPU
host is headless, so instead of a local window the renderer serves one
over HTTP: point any browser at ``http://host:port/`` and
watch the frame converge live.  Frames are *pushed*, not polled — the
``/stream`` endpoint speaks ``multipart/x-mixed-replace`` (the MJPEG
camera protocol, natively rendered by every browser) and a new part is
emitted the moment the render loop publishes a frame, which is as close
to a swapchain present as HTTP gets.

Endpoints:

* ``/``            viewer page (live <img> on /stream + status ticker +
  keyboard capture: the page POSTs keydowns to /input, so the browser
  window both shows AND steers — the full analog of the reference's
  winit input path, ``app.rs:74-121`` + ``gui.rs:63-199``)
* ``/stream``      multipart PNG push stream (one part per published frame)
* ``/frame.png``   latest frame, single shot (curl-able)
* ``/status.json`` render progress (spp, Mrays/s, fps, frame index)
* ``/input``       POST body = key characters, queued for the render
  loop (``pop_keys()``); same key map as ``--interactive``

Zero dependencies (stdlib ``http.server`` + the repo's own PNG encoder);
the server runs in daemon threads and never blocks the render loop —
``publish()`` just swaps a buffer and notifies waiters.  It takes host
numpy frames: the render loop copies each frame off the card once.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .image import encode_png

_PAGE = """<!doctype html>
<title>wavefront_path_tracer_tpu_torch — live render</title>
<style>
  body { background: #111; margin: 0; display: grid; place-items: center;
         min-height: 100vh; color: #9a9; font: 13px monospace; }
  img { image-rendering: pixelated; max-width: 96vw; max-height: 92vh; }
</style>
<div>
  <img src="/stream" onerror="this.src='/frame.png?'+Date.now()">
  <p id="s">connecting…</p>
</div>
<script>
  const s = document.getElementById("s");
  setInterval(async () => {
    try {
      const r = await (await fetch("/status.json")).json();
      s.textContent = `${r.samples}/${r.target_spp} spp  ` +
        `${r.mrays_per_s.toFixed(1)} Mrays/s  ${r.fps.toFixed(1)} fps  ` +
        `frame ${r.frame}` + (r.done ? "  — done" : "") +
        (r.steerable ? "  —  keys: wasd/qe move, ikjl look, [] vfov"
                     : "");
    } catch (e) { s.textContent = "render ended"; }
  }, 500);
  // Keyboard steering: forward the interactive key map to the render
  // loop (only consumed when the session runs with --interactive).
  document.addEventListener("keydown", (ev) => {
    const k = ev.key.toLowerCase();
    if ("wasdqeikjl[]px".includes(k) && k.length === 1) {
      fetch("/input", { method: "POST", body: k });
      ev.preventDefault();
    }
  });
</script>
"""


class PreviewServer:
    """Publish/subscribe frame server.  ``publish()`` is called by the
    render loop; HTTP handler threads block on the condition variable
    and re-send whenever the sequence number advances."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        # Default bind is loopback: the stream and input endpoints have
        # no auth, so exposing them beyond the host is an explicit
        # opt-in (--serve-host 0.0.0.0).
        self._cond = threading.Condition()
        self._png: bytes | None = None
        self._seq = 0
        self._status: dict = {"samples": 0, "target_spp": 0,
                              "mrays_per_s": 0.0, "fps": 0.0,
                              "frame": 0, "done": False,
                              "steerable": False}
        self._closed = False
        self._keys_lock = threading.Lock()
        self._keys = ""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               _PAGE.encode())
                elif path == "/frame.png":
                    png = server.wait_frame(None)
                    if png is None:
                        self._send(503, "text/plain", b"no frame yet\n")
                    else:
                        self._send(200, "image/png", png)
                elif path == "/status.json":
                    self._send(200, "application/json",
                               json.dumps(server._status).encode())
                elif path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    seen = -1
                    while True:
                        png, seen = server.wait_frame(seen)
                        if png is None:  # server closed
                            return
                        try:
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + b"Content-Length: "
                                + str(len(png)).encode() + b"\r\n\r\n"
                                + png + b"\r\n")
                            self.wfile.flush()
                        except (BrokenPipeError, ConnectionResetError):
                            return  # viewer tab closed
                else:
                    self._send(404, "text/plain", b"not found\n")

            def _input_allowed(self) -> bool:
                """Reject cross-site POSTs to the state-changing /input
                endpoint.  A malicious page in another browser tab can
                fire a no-preflight POST at 127.0.0.1 despite the
                loopback bind, so: (a) if the browser sent an Origin,
                it must match the Host the request arrived on (our own
                viewer page); (b) the Host must be 'localhost' or an IP
                literal — a DNS name means DNS rebinding, where (a)
                alone would pass.  Header-less clients (curl) pass."""
                host = (self.headers.get("Host") or "").strip()
                hostname = host.rsplit(":", 1)[0] if not host.startswith("[") \
                    else host[1:host.index("]")] if "]" in host else host
                if hostname and hostname != "localhost":
                    import ipaddress

                    try:
                        ipaddress.ip_address(hostname)
                    except ValueError:
                        return False
                origin = self.headers.get("Origin")
                if origin:
                    # The viewer page is same-origin (served by us, on
                    # an explicit port), so its POSTs carry exactly
                    # http://<Host>.  "null" and foreign origins fail.
                    if origin.split("://", 1)[-1] != host:
                        return False
                return True

            def do_POST(self):
                path = self.path.split("?")[0]
                if path == "/input":
                    if not self._input_allowed():
                        self._send(403, "text/plain", b"forbidden\n")
                        return
                    n = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(min(n, 4096))
                    server.push_keys(body.decode("utf-8", "replace"))
                    self._send(200, "text/plain", b"ok\n")
                else:
                    self._send(404, "text/plain", b"not found\n")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def publish(self, image: np.ndarray, **status) -> None:
        """Swap in a new frame ((H, W, 3) float [0,1] or uint8) and wake
        every /stream subscriber.  PNG encoding happens here, once,
        regardless of subscriber count."""
        png = encode_png(image)
        with self._cond:
            self._png = png
            self._seq += 1
            self._status.update(status)
            self._cond.notify_all()

    def wait_frame(self, seen):
        """Block until a frame newer than ``seen`` exists (``seen=None``:
        return the latest immediately).  Returns png bytes, or
        (bytes|None, seq) in stream mode."""
        with self._cond:
            if seen is None:
                return self._png
            while (self._seq <= seen or self._png is None) \
                    and not self._closed:
                self._cond.wait(timeout=1.0)
            if self._closed:
                return None, seen
            return self._png, self._seq

    def push_keys(self, keys: str) -> None:
        """Queue key characters from a /input POST (handler threads)."""
        with self._keys_lock:
            # Bound the backlog: an unread queue (no --interactive
            # consumer) must not grow without limit.
            self._keys = (self._keys + keys)[-256:]

    def pop_keys(self) -> str:
        """Drain queued browser keystrokes (render loop; never blocks)."""
        with self._keys_lock:
            keys, self._keys = self._keys, ""
            return keys

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
