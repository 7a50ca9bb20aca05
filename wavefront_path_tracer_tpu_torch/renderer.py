"""Progressive renderer on a torch device.

Port of ``wavefront_path_tracer_tpu/renderer.py``: it owns the scene
tables on the device, runs sample batches (samples per frame) until the
spp budget is met, keeps the accumulator resident on the device, and
restarts accumulation when the camera or the image size changes.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch
from wavefront_path_tracer_tpu_torch.models import get_engine
from wavefront_path_tracer_tpu_torch.ops.bvh_traverse import STACK_DEPTH
from wavefront_path_tracer_tpu_torch.ops.triangle import triangle_normals
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    Scene,
    build_bvh,
    build_flat_bvh_aabb,
    bvh_depth,
)
from wavefront_path_tracer_tpu_torch.utils.config import (
    RenderConfig,
    RenderProgress,
)

# Warned for intersector='bvh' on the XLA-style engines off the CPU, with
# the card's rates for that path (chip_smoke.py, phase wavefront, and the
# fused headline of its phase main).
BVH_WARNING = (
    "intersector='bvh' on the {engine} engine runs a lockstep traversal "
    "of small PyTorch kernels: 0.106 Mrays/s for wavefront/bvh on "
    "book_one_final at 400x224 on an NVIDIA H100 80GB HBM3 (700.00 W), "
    "5.5x below intersector='bruteforce' on the same engine (0.587 "
    "Mrays/s) and some 30,000x below engine='fused' (about 3,000 Mrays/s "
    "with intersector='baked', baked_clusters=16 at 1920x1080). Use "
    "engine='fused' (intersector='baked' or 'bruteforce' with "
    "baked_clusters>0), or intersector='bruteforce' on this engine; the "
    "BVH path is an oracle.")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no
    CUDA device is present (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available")
    return device


def off_cpu(device: torch.device) -> bool:
    """Whether ``device`` is an accelerator (the BVH warning's test)."""
    return device.type != "cpu"


def prepare_scene(scene: Scene, config: RenderConfig, device="cuda",
                  triangles=None) -> dict:
    """Host scene -> sphere tables on ``device``, with the triangle
    tables of a mesh (``triangles``, a :class:`TriangleSoA`) as the
    eight ``tri_*`` keys of the reference's ``prepare_scene``, the unit
    geometric normals ``tri_normal`` (its renderer.py:105) among them,
    and a textured scene's ``tex_kind``, ``tex_albedo2``, ``tex_scale``,
    ``tex_id`` and (with images) ``tex_data`` (its renderer.py:111-119),
    plus what the fused engine derives once per scene
    (``convert.scene_arrays_to_torch``).

    With ``intersector="bvh"`` (its renderer.py:47-99) the spheres are
    reordered by the BVH build, as the reference's
    ``build_bvh_tree(&mut spheres)`` reorders them, and the flat tree
    goes in as ``bvh_min``, ``bvh_max``, ``bvh_left_first`` and
    ``bvh_prim_count``; a mesh gets a second tree over its triangles'
    boxes (``tri_bvh_*``), with the triangle tables in its order.  Both
    trees' depths are checked against the traversal stack here."""
    arrays = {}
    if config.intersector == "bvh":
        bvh, scene = build_bvh(scene)
        depth = bvh_depth(bvh)
        if depth > STACK_DEPTH:
            raise ValueError(
                f"BVH depth {depth} exceeds the traversal stack "
                f"({STACK_DEPTH}); pushes would be silently dropped. "
                "Raise ops.bvh_traverse.STACK_DEPTH or rebalance the scene.")
        arrays.update({
            "bvh_min": bvh.aabb_min,
            "bvh_max": bvh.aabb_max,
            "bvh_left_first": bvh.left_first,
            "bvh_prim_count": bvh.prim_count,
        })
    arrays.update({
        "centers": scene.centers,
        "radii": scene.radii,
        "mat_type": scene.mat_type,
        "albedo": scene.albedo,
        "fuzz": scene.fuzz,
        "refract_idx": scene.refract_idx,
    })
    if triangles is not None and triangles.num_triangles > 0:
        if config.intersector == "bvh":
            v0 = np.asarray(triangles.v0)
            verts = np.stack([v0, v0 + np.asarray(triangles.e1),
                              v0 + np.asarray(triangles.e2)], axis=1)
            tbvh, tperm = build_flat_bvh_aabb(verts.min(axis=1),
                                              verts.max(axis=1))
            tdepth = bvh_depth(tbvh)
            if tdepth > STACK_DEPTH:
                raise ValueError(
                    f"triangle BVH depth {tdepth} exceeds the traversal "
                    f"stack ({STACK_DEPTH})")
            triangles = type(triangles)(*[np.asarray(t)[tperm]
                                          for t in triangles])
            arrays.update({
                "tri_bvh_min": tbvh.aabb_min,
                "tri_bvh_max": tbvh.aabb_max,
                "tri_bvh_left_first": tbvh.left_first,
                "tri_bvh_prim_count": tbvh.prim_count,
            })
        arrays.update({
            "tri_v0": triangles.v0,
            "tri_e1": triangles.e1,
            "tri_e2": triangles.e2,
            "tri_normal": triangle_normals(
                torch.from_numpy(np.asarray(triangles.e1, np.float32)),
                torch.from_numpy(np.asarray(triangles.e2, np.float32)),
            ).numpy(),
            "tri_albedo": triangles.albedo,
            "tri_fuzz": triangles.fuzz,
            "tri_refract": triangles.refract_idx,
            "tri_mat_type": triangles.mat_type,
        })
    if scene.tex_kind is not None:
        arrays.update({
            "tex_kind": scene.tex_kind,
            "tex_albedo2": scene.tex_albedo2,
            "tex_scale": scene.tex_scale,
            "tex_id": scene.tex_id,
        })
        if scene.tex_data is not None:
            arrays["tex_data"] = scene.tex_data
    return scene_arrays_to_torch(arrays, device)


@dataclasses.dataclass
class RenderResult:
    # (H, W, 3) radiance sum over samples, on the render device.
    accumulated_dev: torch.Tensor
    samples: int
    wall_time_s: float
    mrays_per_s: float
    rays_traced: float = 0.0
    # The fused engine's in-kernel counters (iterations, supers_entered,
    # clusters_entered) when a stage timer is on; else None.
    kernel_stats: Optional[dict] = None
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
    plain PyTorch versions).  ``triangles`` (a :class:`TriangleSoA`)
    adds a mesh to the scene, as in the reference.  ``stage_timer`` (a
    ``utils.profiling.KernelTimer``) turns on stage observability: the
    wavefront engine's per-stage wall times (its host-stepped loop,
    ``models/wavefront.render_samples_staged``), or the fused engine's
    in-kernel counters in ``RenderResult.kernel_stats``."""

    def __init__(self, scene: Scene, camera: CameraController,
                 config: RenderConfig, triangles=None, *, device="cuda",
                 stage_timer=None):
        self.device = resolve_device(device)
        if (config.intersector == "bvh"
                and config.engine in ("wavefront", "megakernel")
                and off_cpu(self.device)):
            warnings.warn(BVH_WARNING.format(engine=config.engine),
                          RuntimeWarning, stacklevel=2)
        self.config = config
        self.camera = camera
        self.stage_timer = stage_timer
        self._engine = get_engine(config.engine)
        self.scene_arrays = prepare_scene(scene, config, self.device,
                                          triangles)
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
        args = (self.scene_arrays, cam, view, inv_proj, cfg, cfg.frame,
                self.progress.accumulated_samples, n_samples)
        kernel_stats = None
        if self.stage_timer is not None and cfg.engine == "wavefront":
            rad, rays = self._engine.render_samples_staged(
                *args, timer=self.stage_timer)
        elif self.stage_timer is not None and cfg.engine == "fused":
            rad, rays, kernel_stats = self._engine.render_samples_with_stats(
                *args)
        else:
            rad, rays = self._engine.render_samples(*args)
        # Not in place: earlier results keep views of their accumulator.
        self._accum = self._accum + rad
        self._sync()
        dt = time.perf_counter() - t0
        rays = float(rays)
        if kernel_stats is not None:
            kernel_stats = {k: float(v) for k, v in kernel_stats.items()}

        self.progress.accumulated_samples += n_samples
        self.progress.frame += 1
        result = RenderResult(
            accumulated_dev=self._accum.reshape(cfg.height, cfg.width, 3),
            samples=self.progress.accumulated_samples,
            wall_time_s=dt,
            mrays_per_s=rays / dt / 1e6,
            rays_traced=rays,
            kernel_stats=kernel_stats,
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
           triangles=None, *, device="cuda") -> RenderResult:
    """One-shot convenience wrapper; renders on the card unless
    ``device`` names another."""
    return Renderer(scene, camera, config, triangles, device=device).render()
