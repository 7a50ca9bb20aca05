"""Progressive renderer on a torch device.

Port of ``wavefront_path_tracer_tpu/renderer.py``: it owns the scene
tables on the device, runs sample batches (samples per frame) until the
spp budget is met, keeps the accumulator resident on the device, and
restarts accumulation when the camera or the image size changes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch
from wavefront_path_tracer_tpu_torch.models import get_engine
from wavefront_path_tracer_tpu_torch.scene import CameraController, Scene
from wavefront_path_tracer_tpu_torch.utils.config import (
    RenderConfig,
    RenderProgress,
)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no
    CUDA device is present (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available")
    return device


def prepare_scene(scene: Scene, config: RenderConfig,
                  device="cuda") -> dict:
    """Host scene -> sphere tables on ``device``, plus what the fused
    engine derives once per scene (``convert.scene_arrays_to_torch``)."""
    if scene.tex_kind is not None:
        raise NotImplementedError(
            "textured scenes are not ported yet (ROADMAP.md queue 2 item 5 "
            "and queue 1 item 3)")
    if config.intersector == "bvh":
        raise NotImplementedError(
            "the BVH intersector is not ported yet (ROADMAP.md queue 1 "
            "item 8)")
    arrays = {
        "centers": scene.centers,
        "radii": scene.radii,
        "mat_type": scene.mat_type,
        "albedo": scene.albedo,
        "fuzz": scene.fuzz,
        "refract_idx": scene.refract_idx,
    }
    return scene_arrays_to_torch(arrays, device)


@dataclasses.dataclass
class RenderResult:
    # (H, W, 3) radiance sum over samples, on the render device.
    accumulated_dev: torch.Tensor
    samples: int
    wall_time_s: float
    mrays_per_s: float
    rays_traced: float = 0.0
    _accum_np: Optional[np.ndarray] = dataclasses.field(default=None,
                                                        repr=False)

    @property
    def accumulated(self) -> np.ndarray:
        if self._accum_np is None:
            self._accum_np = self.accumulated_dev.cpu().numpy()
        return self._accum_np

    @property
    def image(self) -> np.ndarray:
        """Display transform: average + gamma 2.0."""
        avg = self.accumulated / max(1, self.samples)
        return np.sqrt(np.clip(avg, 0.0, None))


class Renderer:
    """Progressive renderer with accumulation-restart semantics, on the
    CUDA card unless ``device`` names another (``device="cpu"`` runs the
    plain PyTorch versions)."""

    def __init__(self, scene: Scene, camera: CameraController,
                 config: RenderConfig, *, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.camera = camera
        self._engine = get_engine(config.engine)
        self.scene_arrays = prepare_scene(scene, config, self.device)
        self._engine.check_supported(config, self.scene_arrays)
        self.progress = RenderProgress()
        self._prev_display = None
        self.last_delta = None
        self._converged = False
        self._accum = self._zeros()

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.config.num_pixels, 3), dtype=torch.float32,
                           device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- dirty-flag API --
    def camera_changed(self) -> None:
        self.reset_accumulation()

    def resize(self, width: int, height: int) -> None:
        self.config = self.config.replace(width=width, height=height)
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self.progress.reset()
        self._accum = self._zeros()
        self._prev_display = None
        self.last_delta = None
        self._converged = False

    def render_frame(self) -> Optional[RenderResult]:
        """Run one batch of samples; the running result, or None when the
        spp budget is already met."""
        cfg = self.config
        remaining = cfg.samples_per_pixel - self.progress.accumulated_samples
        if remaining <= 0 or self._converged:
            return None
        n_samples = min(cfg.samples_per_frame, remaining)
        view = self.camera.view_matrix()
        inv_proj = self.camera.inverse_projection(cfg.width, cfg.height)
        cam = self.camera.gpu_camera()

        self._sync()
        t0 = time.perf_counter()
        # The frame salt stays fixed for a whole accumulation run; batches
        # differ by sample_base, so progressive and batched renders
        # accumulate identical samples.
        rad, rays = self._engine.render_samples(
            self.scene_arrays, cam, view, inv_proj, cfg, cfg.frame,
            self.progress.accumulated_samples, n_samples)
        # Not in place: earlier results keep views of their accumulator.
        self._accum = self._accum + rad
        self._sync()
        dt = time.perf_counter() - t0
        rays = float(rays)

        self.progress.accumulated_samples += n_samples
        self.progress.frame += 1
        result = RenderResult(
            accumulated_dev=self._accum.reshape(cfg.height, cfg.width, 3),
            samples=self.progress.accumulated_samples,
            wall_time_s=dt,
            mrays_per_s=rays / dt / 1e6,
            rays_traced=rays,
        )
        if cfg.stop_delta > 0.0:
            # Adaptive stop on the mean absolute display-image change per
            # batch; only the scalar leaves the device.
            img = torch.sqrt(torch.clamp_min(
                self._accum / max(1, self.progress.accumulated_samples), 0.0))
            if self._prev_display is not None:
                self.last_delta = float(
                    torch.mean(torch.abs(img - self._prev_display)))
                if self.last_delta < cfg.stop_delta:
                    self._converged = True
            self._prev_display = img
        return result

    def render(self) -> RenderResult:
        """Render the full spp budget; the final result."""
        result = None
        while True:
            r = self.render_frame()
            if r is None:
                break
            result = r
        if result is None:
            raise RuntimeError("nothing to render: the spp budget is met")
        return result


def render(scene: Scene, camera: CameraController, config: RenderConfig,
           *, device="cuda") -> RenderResult:
    """One-shot convenience wrapper; renders on the card unless
    ``device`` names another."""
    return Renderer(scene, camera, config, device=device).render()
