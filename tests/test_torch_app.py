"""The port's interactive session (``wavefront_path_tracer_tpu_torch/
app.py``) against the JAX package's ``app.py`` on the CPU: the nine cases
of ``tests/test_app.py``, each run on both sessions with the same key
sequence.  Each case keeps its own assertions; then the two sessions'
cameras must be equal and their accumulated images equal by the parity
rule (``utils/parity.py``), with the same sample count.  Camera motion
integrates the wall-clock time between steps, so both modules get the
same clock: one that advances 1/60 s a call."""

import io

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu import app as japp
from wavefront_path_tracer_tpu.scene import CameraController as JCamera
from wavefront_path_tracer_tpu.scene import book_cover as jbook
from wavefront_path_tracer_tpu.utils.config import RenderConfig as JConfig
from wavefront_path_tracer_tpu_torch import app
from wavefront_path_tracer_tpu_torch.scene import CameraController, book_cover
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

KW = dict(width=32, height=18, samples_per_pixel=4, samples_per_frame=1,
          max_bounces=4, engine="megakernel")


class _Clock:
    """A stand-in for the ``time`` module: 1/60 s a perf_counter call,
    and sleep returns at once."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1.0 / 60.0
        return self.now

    def sleep(self, _seconds):
        pass


def _sessions(monkeypatch):
    monkeypatch.setattr(app, "time", _Clock())
    monkeypatch.setattr(japp, "time", _Clock())
    cc, jcc = CameraController.book_one_final(), JCamera.book_one_final()
    cc.defocus_angle_deg = jcc.defocus_angle_deg = 0.0
    port = app.InteractiveSession(book_cover(), cc, RenderConfig(**KW),
                                  device="cpu")
    ref = japp.InteractiveSession(jbook(), jcc, JConfig(**KW))
    return port, ref


def step_accumulates(s, mod, tmp_path):
    r1 = s.step()
    r2 = s.step()
    assert r1.samples == 1 and r2.samples == 2
    assert 0 < s.progress <= 0.5


def movement_restarts_accumulation(s, mod, tmp_path):
    s.step()
    assert s.renderer.progress.accumulated_samples == 1
    pos_before = s.camera.camera.position.copy()
    s.key_event("w", True)
    s.step()
    s.key_event("w", False)
    assert not np.allclose(s.camera.camera.position, pos_before)
    assert s.renderer.progress.accumulated_samples == 1


def mouse_rotation_restarts(s, mod, tmp_path):
    s.step()
    yaw_before = s.camera.camera.yaw
    s.mouse_delta(100.0, 0.0)
    s.step()
    assert s.camera.camera.yaw != yaw_before
    assert s.renderer.progress.accumulated_samples == 1


def vfov_change_restarts(s, mod, tmp_path):
    s.step()
    s.set_vfov(45.0)
    assert s.renderer.progress.accumulated_samples == 0


def spp_budget_exhausts(s, mod, tmp_path):
    for _ in range(4):
        assert s.step() is not None
    assert s.step() is None
    assert s.progress == 1.0


def interactive_loop_piped_input(s, mod, tmp_path):
    png = tmp_path / f"live_{mod.__name__}.png"
    pos_before = s.camera.camera.position.copy()
    yaw_before = s.camera.camera.yaw
    frames = mod.interactive_loop(
        s, out_png=str(png), input_stream=io.StringIO("wj"),
        max_frames=3, stream=io.StringIO(), show_term=False)
    assert frames == 3
    assert png.exists()
    assert not np.allclose(s.camera.camera.position, pos_before)
    assert s.camera.camera.yaw != yaw_before


def interactive_loop_quit_key(s, mod, tmp_path):
    frames = mod.interactive_loop(
        s, input_stream=io.StringIO("x"), stream=io.StringIO(),
        show_term=False)
    assert frames == 0


def interactive_loop_converges_and_exits_on_eof(s, mod, tmp_path):
    frames = mod.interactive_loop(
        s, input_stream=io.StringIO(""), stream=io.StringIO(),
        show_term=False)
    assert frames == 4
    assert s.progress >= 1.0


def interactive_look_is_deterministic(s, mod, tmp_path):
    s.step()
    yaw0 = s.camera.camera.yaw
    s.look(5.0, 0.0)
    assert abs(s.camera.camera.yaw - yaw0 - np.radians(5.0)) < 1e-6
    assert s.renderer.progress.accumulated_samples == 0


CASES = [step_accumulates, movement_restarts_accumulation,
         mouse_rotation_restarts, vfov_change_restarts, spp_budget_exhausts,
         interactive_loop_piped_input, interactive_loop_quit_key,
         interactive_loop_converges_and_exits_on_eof,
         interactive_look_is_deterministic]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_session_matches_jax(case, monkeypatch, tmp_path):
    port, ref = _sessions(monkeypatch)
    case(port, app, tmp_path)
    case(ref, japp, tmp_path)
    np.testing.assert_array_equal(port.camera.camera.position,
                                  ref.camera.camera.position)
    assert port.camera.camera.yaw == ref.camera.camera.yaw
    assert port.camera.camera.pitch == ref.camera.camera.pitch
    assert port.camera.vfov_deg == ref.camera.vfov_deg
    samples = port.renderer.progress.accumulated_samples
    assert samples == ref.renderer.progress.accumulated_samples
    acc = port.renderer._accum.numpy()
    jacc = np.asarray(ref.renderer._accum)
    if samples == 0:
        assert not acc.any() and not jacc.any()
        assert app.final_image(port) is None
        return
    check_parity(acc / samples, jacc / samples)
    image = app.final_image(port)
    assert image.shape == (KW["height"], KW["width"], 3)
    np.testing.assert_array_equal(
        image, np.sqrt(np.clip(acc / samples, 0.0, None)).reshape(image.shape))


def test_session_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.InteractiveSession(book_cover(), CameraController.book_one_final(),
                               RenderConfig(**KW))
