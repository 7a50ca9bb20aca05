"""AOV (arbitrary output variable) passes: albedo / normal / depth.

Port of ``wavefront_path_tracer_tpu/aov.py``.  Production path tracers
emit first-hit feature planes alongside the beauty pass — they feed
denoisers, compositing, and debugging.  The reference renders radiance
only (its display pass is the whole output surface, display.rs:112-150);
this is a beyond-parity capability.

AOVs reuse the plain PyTorch ops the megakernel and wavefront engines
share (``ops/raygen.py``, ``ops/hit.py`` nearest-hit resolve,
``ops/intersect.py`` sky), as the reference's are the XLA ops its engines
share, averaged over ``spp`` anti-aliased primary samples with the same
per-(pixel, sample) RNG streams as the engines, so AOV edges are
filtered exactly like the beauty pass:

* ``albedo``  — first-hit material albedo (miss lanes contribute the
  sky color, matching what a denoiser wants to divide out),
* ``normal``  — first-hit geometric normal (zero on miss; averaged
  then re-normalized),
* ``depth``   — first-hit ray distance t (miss lanes contribute 0 and
  are excluded from the average; ``coverage`` holds the hit fraction).

They run on the device of the scene tables (a ``Renderer``'s
``scene_arrays``), on the card unless the caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.hit import intersect_and_resolve
from wavefront_path_tracer_tpu_torch.ops.intersect import sky_color
from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
from wavefront_path_tracer_tpu_torch.renderer import (
    prepare_scene,
    resolve_device,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig


def render_aovs(scene, camera, config: RenderConfig, triangles=None,
                spp: int | None = None, frame: int = 0,
                scene_arrays: dict | None = None, device="cuda") -> dict:
    """First-hit AOV planes as (H, W, C) numpy arrays.

    Returns ``{"albedo": (H,W,3), "normal": (H,W,3), "depth": (H,W),
    "coverage": (H,W)}``.  ``spp`` defaults to
    ``config.samples_per_pixel`` (AA averaging only — AOVs are
    first-hit quantities, so a handful of samples suffices).  Pass
    ``scene_arrays`` (an existing ``prepare_scene`` result, e.g. a
    ``Renderer``'s) to skip a second upload; the AOVs then run on its
    device and ``device`` is not read.  Pixels go in chunks of
    ``config.ray_chunk`` (131,072 when 0) so intersect intermediates
    stay bounded at any resolution; the planes are copied to the host
    once.
    """
    cfg = config
    if cfg.intersector not in ("bruteforce", "bvh"):
        # AOVs run on the shared plain ops; baked intersectors are a
        # fused-engine concept.
        cfg = cfg.replace(intersector="bruteforce")
    spp = int(spp if spp is not None else cfg.samples_per_pixel)
    if scene_arrays is None:
        scene_arrays = prepare_scene(scene, cfg, resolve_device(device),
                                     triangles)
    arrays = scene_arrays
    device = arrays["centers"].device
    view = torch.as_tensor(np.asarray(camera.view_matrix(), np.float32),
                           device=device)
    inv_proj = torch.as_tensor(np.asarray(
        camera.inverse_projection(cfg.width, cfg.height), np.float32),
        device=device)
    cam = camera.gpu_camera()
    num = cfg.num_pixels
    chunk = min(num, cfg.ray_chunk if cfg.ray_chunk > 0 else 131072)

    parts = []
    for start in range(0, num, chunk):
        pixel_idx = torch.arange(start, min(start + chunk, num),
                                 dtype=torch.int64, device=device)
        n = pixel_idx.shape[0]
        alb_a = torch.zeros((n, 3), dtype=torch.float32, device=device)
        nrm_a = torch.zeros_like(alb_a)
        dep_a = torch.zeros(n, dtype=torch.float32, device=device)
        cov_a = torch.zeros_like(dep_a)
        for s in range(spp):
            origin, direction = generate_rays(
                pixel_idx, cfg.width, cfg.height, frame, s, cam, view,
                inv_proj, sampler=cfg.sampler)
            t, hit, normal, albedo, _fz, _ri, _mt = intersect_and_resolve(
                origin, direction, arrays, cfg)
            h = hit[:, None]
            alb_a = alb_a + torch.where(h, albedo, sky_color(direction))
            nrm_a = nrm_a + torch.where(h, normal, 0.0)
            dep_a = dep_a + torch.where(hit, t, 0.0)
            cov_a = cov_a + hit.to(torch.float32)
        parts.append((alb_a, nrm_a, dep_a, cov_a))
    alb, nrm, dep, cov = (torch.cat([p[i] for p in parts]).cpu().numpy()
                          for i in range(4))

    alb /= spp
    nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(nlen, 1e-12)
    dep = dep / np.maximum(cov, 1e-12)       # mean over HIT samples
    cov /= spp

    shp = (cfg.height, cfg.width)
    return {
        "albedo": alb.reshape(shp + (3,)),
        "normal": nrm.reshape(shp + (3,)),
        "depth": dep.reshape(shp),
        "coverage": cov.reshape(shp),
    }


def write_aovs(prefix: str, aovs: dict) -> list:
    """Write AOVs: raw ``{prefix}.aov.npz`` plus viewable PNGs
    (normals remapped to [0,1]; depth as 1/(1+t) — white near, dark
    far, black sky).  Returns the paths written."""
    from wavefront_path_tracer_tpu_torch.utils.image import write_png

    paths = [f"{prefix}.aov.npz"]
    np.savez_compressed(paths[0], **aovs)
    ims = {
        "albedo": aovs["albedo"],
        "normal": aovs["normal"] * 0.5 + 0.5,
        "depth": np.where(aovs["coverage"][..., None] > 0.0,
                          1.0 / (1.0 + aovs["depth"][..., None]),
                          0.0) * np.ones(3),
    }
    for name, im in ims.items():
        p = f"{prefix}.{name}.png"
        write_png(p, np.clip(im, 0.0, 1.0))
        paths.append(p)
    return paths
