"""The port's previews on the CPU: ``utils/preview.py`` against the JAX
package's, and ``utils/preview_server.py``'s endpoints as
``tests/test_preview_server.py`` holds the JAX one, on port 0 at
127.0.0.1.  Every socket read has its own timeout of a few seconds and
every thread join a bound, so that no test can hang the suite."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.utils import preview as jpreview
from wavefront_path_tracer_tpu_torch.utils import preview
from wavefront_path_tracer_tpu_torch.utils.image import read_png
from wavefront_path_tracer_tpu_torch.utils.preview_server import PreviewServer

torch.set_num_threads(2)

TIMEOUT = 5


@pytest.fixture
def server():
    s = PreviewServer(port=0, host="127.0.0.1")
    yield s
    s.close()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _post(port, path, body: bytes, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_terminal_and_html_previews_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 1.0, (9, 14, 3)).astype(np.float32)
    for cols, rows in ((14, 5), (7, 2), (80, 24)):
        assert (preview.ansi_preview(img, cols, rows)
                == jpreview.ansi_preview(img, cols, rows))
    stream = io.StringIO()
    preview.term_preview_frame(img, "status", stream=stream)
    assert stream.getvalue().endswith("status\n")
    assert stream.getvalue().startswith("\x1b[H\x1b[2J")
    html = preview.write_preview_html(str(tmp_path / "p.png"))
    assert html == str(tmp_path / "p.html")
    assert 'src="p.png"' in open(html).read()


def test_frame_roundtrip(server, tmp_path):
    img = np.zeros((6, 8, 3), np.float32)
    img[:, :, 0] = 1.0
    server.publish(img, samples=3, target_spp=10, mrays_per_s=1.5,
                   fps=2.0, frame=1, done=False)
    status, ctype, body = _get(server.port, "/frame.png")
    assert status == 200 and ctype == "image/png"
    p = tmp_path / "f.png"
    p.write_bytes(body)
    decoded = read_png(str(p))
    assert decoded.shape == (6, 8, 3)
    assert decoded[0, 0, 0] == 255 and decoded[0, 0, 1] == 0


def test_status_endpoint(server):
    server.publish(np.zeros((2, 2, 3), np.float32), samples=7,
                   target_spp=16, mrays_per_s=0.5, fps=1.0, frame=4,
                   done=True)
    status, ctype, body = _get(server.port, "/status.json")
    assert status == 200 and ctype == "application/json"
    st = json.loads(body)
    assert st["samples"] == 7 and st["target_spp"] == 16 and st["done"]


def test_viewer_page_404_and_503(server):
    status, _, body = _get(server.port, "/")
    assert status == 200 and b"/stream" in body
    assert b"keydown" in body and b"/input" in body
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.port, "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.port, "/frame.png")
    assert e.value.code == 503


def test_stream_pushes_frames(server):
    parts = []
    ready = threading.Event()

    def subscribe():
        req = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/stream", timeout=TIMEOUT)
        assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
        ready.set()
        for _ in range(2):
            assert req.readline().strip() == b"--frame"
            headers = {}
            while True:
                line = req.readline().strip()
                if not line:
                    break
                k, v = line.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
            parts.append(req.read(int(headers[b"content-length"])))
            req.readline()
        req.close()

    t = threading.Thread(target=subscribe, daemon=True)
    t.start()
    assert ready.wait(TIMEOUT)
    for k in range(2):
        server.publish(np.full((2, 2, 3), k / 2.0, np.float32),
                       samples=k + 1, target_spp=2, mrays_per_s=1.0,
                       fps=1.0, frame=k + 1, done=k == 1)
        deadline = time.monotonic() + TIMEOUT
        while len(parts) < k + 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and len(parts) == 2
    assert all(p.startswith(b"\x89PNG") for p in parts)
    assert parts[0] != parts[1]


def test_input_queue_cross_site_and_backlog(server):
    assert _post(server.port, "/input", b"wj") == 200
    assert server.pop_keys() == "wj"
    assert server.pop_keys() == ""
    me = f"127.0.0.1:{server.port}"
    assert _post(server.port, "/input", b"w",
                 {"Origin": "http://evil.example"}) == 403
    assert _post(server.port, "/input", b"w", {"Origin": "null"}) == 403
    assert _post(server.port, "/input", b"w",
                 {"Host": "attacker.example",
                  "Origin": "http://attacker.example"}) == 403
    assert _post(server.port, "/input", b"w",
                 {"Host": "attacker.example"}) == 403
    assert server.pop_keys() == ""
    assert _post(server.port, "/input", b"w",
                 {"Origin": f"http://{me}"}) == 200
    assert _post(server.port, "/input", b"w") == 200
    assert server.pop_keys() == "ww"
    assert _post(server.port, "/nope", b"w") == 404
    server.push_keys("w" * 1000)
    assert len(server.pop_keys()) <= 256


def test_browser_keys_steer_camera(server):
    from wavefront_path_tracer_tpu_torch.app import (
        InteractiveSession,
        interactive_loop,
    )
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        book_cover,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       max_bounces=2, engine="megakernel")
    session = InteractiveSession(book_cover(),
                                 CameraController.book_one_final(), cfg,
                                 device="cpu")
    yaw0 = session.camera.camera.yaw
    assert _post(server.port, "/input", b"j") == 200
    assert _post(server.port, "/input", b"x") == 200
    interactive_loop(session, input_stream=io.StringIO(""),
                     show_term=False, stream=io.StringIO(),
                     key_source=server.pop_keys, max_frames=3)
    assert session.camera.camera.yaw != yaw0


def test_cli_serve_end_to_end(tmp_path, monkeypatch):
    """--serve publishes every frame batch and the final done frame, as
    host numpy images, and the server is closed when the CLI returns."""
    from wavefront_path_tracer_tpu_torch import cli
    from wavefront_path_tracer_tpu_torch.utils import preview_server

    captured = []
    closed = []
    real_publish = preview_server.PreviewServer.publish
    real_close = preview_server.PreviewServer.close

    def spy(self, image, **status):
        assert isinstance(image, np.ndarray)
        captured.append((image.shape, dict(status)))
        return real_publish(self, image, **status)

    def close_spy(self):
        closed.append(self.port)
        return real_close(self)

    monkeypatch.setattr(preview_server.PreviewServer, "publish", spy)
    monkeypatch.setattr(preview_server.PreviewServer, "close", close_spy)
    out = tmp_path / "o.png"
    assert cli.main(["--device", "cpu", "--scene", "cornell_spheres",
                     "--width", "16", "--height", "16", "--spp", "2",
                     "--spf", "1", "--max-bounces", "2", "--engine",
                     "megakernel", "--serve", "0", "--out", str(out),
                     "--quiet"]) == 0
    assert out.exists()
    assert len(captured) == 3
    assert captured[-1][1]["done"] is True
    assert captured[0][0] == (16, 16, 3)
    assert len(closed) == 1
