"""The megakernel oracle: a straight-line per-pixel path tracer.

Port of ``wavefront_path_tracer_tpu/models/megakernel.py``.  Every pixel
carries its own ray through the bounce loop: ray generation, the nearest
hit over every sphere and triangle (``ops/hit.py``: brute force, or
the BVH with ``intersector="bvh"``), the sky for a miss
(the sample's radiance, clamped per sample when ``clamp`` is set),
scattering for a hit (``ops/bsdf.py``), and Russian roulette when
``rr_start_bounce`` is set.  A path still alive at ``max_bounces``
contributes nothing.  It draws from the same (pixel, frame, sample,
bounce) streams as the fused kernels, so the two engines' Monte Carlo
noise cancels in a same-stream comparison; it is the oracle the fused
engine is gated against (``validate.py``).

It is plain PyTorch on tensors: the reference's megakernel is XLA, with
no Pallas kernel to port.  Pixels go in chunks of ``ray_chunk`` (or all
of them, up to 131,072), one sample at a time.  Where the reference's
``while_loop`` masks dead lanes until no lane is alive, this loop keeps
only the live paths: after each bounce the survivors are gathered
(``nonzero``, the loop's one host read a bounce), so a bounce costs what
its live paths cost, and the loop ends when none is left.  Each lane's
arithmetic is the masked loop's, so the image and the ray count are
those of the reference's loop.
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.ops import rng
from wavefront_path_tracer_tpu_torch.ops.bsdf import scatter
from wavefront_path_tracer_tpu_torch.ops.hit import intersect_and_resolve
from wavefront_path_tracer_tpu_torch.ops.intersect import sky_color
from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

MAX_CHUNK = 131072


def check_supported(config: RenderConfig, scene_arrays) -> None:
    """The engines' common refusal hook: the megakernel carries every
    configuration of the reference's, so it refuses none.
    ``config.num_devices`` is read only by ``parallel.render_sharded``, as
    in the reference: here it renders on one device."""


def trace_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                 config: RenderConfig, frame, sample):
    """One sample of the pixels ``pixel_idx`` (int64, on the scene's
    device): ((N, 3) radiance, rays traced as an int: the live paths
    summed over bounces)."""
    origin, direction = generate_rays(
        pixel_idx, config.width, config.height, frame, sample, cam, view,
        inv_proj, sampler=config.sampler)
    n = pixel_idx.shape[0]
    device = pixel_idx.device
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    pix = pixel_idx
    slot = torch.arange(n, device=device)   # each live path's row
    rays = 0
    for bounce in range(config.max_bounces):
        if pix.shape[0] == 0:
            break
        rays += pix.shape[0]
        t, hit, normal, albedo, fuzz, refract, mat = intersect_and_resolve(
            origin, direction, scene_arrays, config)

        # A miss ends the path with the sky; the path's only radiance.
        contrib = throughput * sky_color(direction)
        if config.clamp > 0.0:
            contrib = torch.clamp_max(contrib, config.clamp)
        radiance[slot] = torch.where(hit[:, None], 0.0, contrib)

        # A hit attenuates and scatters.
        p = origin + t[:, None] * direction
        state = rng.stream_state(pix, frame, sample, bounce + 1)
        direction = scatter(state, direction, normal, mat, fuzz, refract)
        throughput = throughput * albedo
        alive = hit
        if config.rr_start_bounce:
            throughput, alive = rng.roulette(
                pix, frame, sample, bounce + 1, throughput, alive,
                config.rr_start_bounce, config.rr_floor)
        keep = torch.nonzero(alive)[:, 0]
        pix, slot = pix[keep], slot[keep]
        origin, direction = p[keep], direction[keep]
        throughput = throughput[keep]
    return radiance, rays


def render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                  config: RenderConfig, frame, sample_base, n_samples: int):
    """Sum of ``n_samples`` radiance samples of the pixels ``pixel_idx``
    (int64, on the scene's device), in chunks of ``ray_chunk`` pixels (or
    all of them, up to 131,072); ((N, 3) float32 tensor on that device,
    rays traced as a 0-d int64 tensor)."""
    device = pixel_idx.device
    n = pixel_idx.shape[0]
    chunk = config.ray_chunk or min(n, MAX_CHUNK)
    view = torch.as_tensor(view, dtype=torch.float32, device=device)
    inv_proj = torch.as_tensor(inv_proj, dtype=torch.float32, device=device)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=device)
    rays = 0
    for s in range(n_samples):
        sample = (int(sample_base) + s) & rng.MASK32
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            rad, r = trace_pixels(pixel_idx[start:stop], scene_arrays, cam,
                                  view, inv_proj, config, frame, sample)
            acc[start:stop] += rad
            rays += r
    return acc, torch.tensor(rays, dtype=torch.int64)


def render_samples(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                   frame, sample_base, n_samples: int):
    """Sum of ``n_samples`` radiance samples per pixel; ((P, 3) float32
    tensor on the scene's device, rays traced as a 0-d int64 tensor)."""
    check_supported(config, scene_arrays)
    pixel_idx = torch.arange(config.num_pixels, dtype=torch.int64,
                             device=scene_arrays["centers"].device)
    return render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                         config, frame, sample_base, n_samples)
