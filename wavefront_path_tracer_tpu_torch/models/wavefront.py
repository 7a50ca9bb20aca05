"""Wavefront integrator: the reference's five-kernel architecture.

Port of ``wavefront_path_tracer_tpu/models/wavefront.py``.  The
reference (``gpu_wavefront_pt/src/path_tracer.rs:279-371``) runs
generate -> [extend -> counter readback -> shade + miss -> counter
readback -> buffer move] x bounces -> accumulate, with atomics
allocating queue slots.  Here:

* the ray queue is a set of SoA tensors (origin, direction, throughput,
  pixel id, radiance slot) holding the live paths only;
* each bounce runs K2 extend (nearest hit and its shading inputs,
  ``ops/hit.py``), K4 miss (the sky for the lanes that hit nothing,
  written to their radiance slots), K3 shade (attenuate and scatter, with
  the random draws keyed by pixel) and a compaction that moves the
  survivors to the queue's front in stable order (``ops/compact.py``, in
  place of the reference's atomic appends and extension-buffer move);
* the loop reads the live count back once a bounce, the reference's own
  counter readback (path_tracer.rs:327-345), and cuts the queues to it:
  extend, miss and shade run over the live prefix only, the analog of
  sizing the dispatch from the counter (path_tracer.rs:282-289).  With
  ``ray_chunk`` set, extend runs over the prefix in blocks of that many
  rays.

The radiance of a missed path is assigned to its slot, not added with
an atomic (``index_add_`` on CUDA flushes subnormals): a path misses at
most once, and the live prefix's slots are unique.  The draws are those
of the megakernel (``models/megakernel.py``) and every lane's arithmetic
is its, so the two engines' images and ray counts are bit-identical.

Termination is exact (live count 0 or the bounce cap) by default; the
reference's lossy drain on the previous bounce's miss count is
``config.drain_threshold``.  ``config.material_split`` sorts the queue
by the material each lane is about to shade before the shade stage.

``render_samples_staged`` is the same loop with each stage timed into a
``utils.profiling.KernelTimer`` (a device synchronisation after each).
"""

from __future__ import annotations

import contextlib

import torch

from wavefront_path_tracer_tpu_torch.models.megakernel import (  # noqa: F401
    check_supported,
)
from wavefront_path_tracer_tpu_torch.ops import rng
from wavefront_path_tracer_tpu_torch.ops.bsdf import scatter
from wavefront_path_tracer_tpu_torch.ops.compact import compaction_order
from wavefront_path_tracer_tpu_torch.ops.hit import intersect_and_resolve
from wavefront_path_tracer_tpu_torch.ops.intersect import sky_color
from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

# The key of a lane that shades nothing under material_split: after the
# three material types, so that such lanes sort last.
_NO_MATERIAL = 3


def _stage(timer, name: str, block_on):
    """The timer's context for a stage, or none without a timer."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.time(name, block_on=block_on)


def _extend(q_origin, q_dir, scene_arrays, config: RenderConfig):
    """K2 extend over the live queue: (t, hit, normal, albedo, fuzz,
    refract, mat), in blocks of ``config.ray_chunk`` rays when set."""
    count = q_origin.shape[0]
    chunk = config.ray_chunk
    if chunk <= 0 or chunk >= count:
        return intersect_and_resolve(q_origin, q_dir, scene_arrays, config)
    blocks = [intersect_and_resolve(q_origin[s:s + chunk],
                                    q_dir[s:s + chunk], scene_arrays, config)
              for s in range(0, count, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*blocks))


def material_order(hit, mat):
    """The stable order that groups the queue by the material each lane
    is about to shade, lanes that shade nothing last."""
    key = torch.where(hit, mat.to(torch.int32),
                      torch.full_like(mat, _NO_MATERIAL, dtype=torch.int32))
    return torch.argsort(key, stable=True)


def trace_wavefront(pixel_idx, scene_arrays, cam, view, inv_proj,
                    config: RenderConfig, frame, sample, timer=None):
    """One sample of the pixels ``pixel_idx`` (int64, on the scene's
    device) through the wavefront loop: ((N, 3) radiance, rays traced as
    an int: the live rays that extend and shade processed, summed over
    bounces).  With a ``timer``, each stage is timed into it."""
    n = pixel_idx.shape[0]
    device = pixel_idx.device
    # K1 generate: one primary ray per pixel fills the queue.
    with _stage(timer, "generate", pixel_idx):
        q_origin, q_dir = generate_rays(
            pixel_idx, config.width, config.height, frame, sample, cam,
            view, inv_proj, sampler=config.sampler)
    # Two ids per lane: the pixel id keys the random streams, the slot
    # addresses this batch's radiance rows.
    q_pixel = pixel_idx
    q_slot = torch.arange(n, device=device)
    q_throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)

    count, last_missed, rays = n, 0, 0
    for bounce in range(config.max_bounces):
        if count == 0 or (config.drain_threshold and bounce > 0
                          and last_missed < config.drain_threshold):
            break
        rays += count
        with _stage(timer, "extend", q_origin):
            t, hit, normal, albedo, fuzz, refract, mat = _extend(
                q_origin, q_dir, scene_arrays, config)
        missed = ~hit

        if config.material_split:
            # Shade over contiguous same-material runs.  Sorting the live
            # prefix alone gives its lanes the order that the reference
            # package's sort of the whole queue gives them (its dead
            # lanes all sort last).  Bit-identical results: the draws
            # are keyed by pixel, the radiance is slot-addressed.
            with _stage(timer, "split", q_origin):
                order0 = material_order(hit, mat)
                (q_pixel, q_slot, q_origin, q_dir, q_throughput, t, hit,
                 normal, albedo, fuzz, refract, mat, missed) = (
                    x[order0] for x in (
                        q_pixel, q_slot, q_origin, q_dir, q_throughput, t,
                        hit, normal, albedo, fuzz, refract, mat, missed))

        # K4 miss: the terminal sky, written to the path's slot.
        with _stage(timer, "miss", radiance):
            sky = q_throughput * sky_color(q_dir)
            if config.clamp > 0.0:
                sky = torch.clamp_max(sky, config.clamp)
            radiance[q_slot] = torch.where(missed[:, None], sky,
                                           radiance[q_slot])

        # K3 shade: attenuate and scatter, the draws keyed by pixel.
        with _stage(timer, "shade", q_dir):
            p = q_origin + t[:, None] * q_dir
            state = rng.stream_state(q_pixel, frame, sample, bounce + 1)
            new_dir = scatter(state, q_dir, normal, mat, fuzz, refract)
            q_throughput = torch.where(hit[:, None], q_throughput * albedo,
                                       q_throughput)
            q_origin = torch.where(hit[:, None], p, q_origin)
            q_dir = torch.where(hit[:, None], new_dir, q_dir)
            if config.rr_start_bounce:
                q_throughput, hit = rng.roulette(
                    q_pixel, frame, sample, bounce + 1, q_throughput, hit,
                    config.rr_start_bounce, config.rr_floor)

        # Compact: the survivors to the queue's front, then the queue cut
        # to them.  The live count is the loop's one host read a bounce.
        with _stage(timer, "compact", q_origin):
            order, new_count = compaction_order(hit)
            if config.drain_threshold:
                count, last_missed = torch.stack(
                    [new_count, missed.sum()]).tolist()
            else:
                count = int(new_count)
            keep = order[:count]
            q_pixel, q_slot = q_pixel[keep], q_slot[keep]
            q_origin, q_dir = q_origin[keep], q_dir[keep]
            q_throughput = q_throughput[keep]
    return radiance, rays


def render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                  config: RenderConfig, frame, sample_base, n_samples: int,
                  timer=None):
    """Sum of ``n_samples`` radiance samples of the pixels ``pixel_idx``
    (int64, on the scene's device), one :func:`trace_wavefront` a sample;
    ((N, 3) float32 tensor on that device, rays traced as a 0-d int64
    tensor).  With a ``timer``, each stage is timed into it."""
    device = pixel_idx.device
    view = torch.as_tensor(view, dtype=torch.float32, device=device)
    inv_proj = torch.as_tensor(inv_proj, dtype=torch.float32, device=device)
    acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32,
                      device=device)
    rays = 0
    for s in range(n_samples):
        sample = (int(sample_base) + s) & rng.MASK32
        rad, r = trace_wavefront(pixel_idx, scene_arrays, cam, view,
                                 inv_proj, config, frame, sample, timer)
        acc += rad
        rays += r
    return acc, torch.tensor(rays, dtype=torch.int64)


def _render(scene_arrays, cam, view, inv_proj, config: RenderConfig, frame,
            sample_base, n_samples: int, timer):
    check_supported(config, scene_arrays)
    pixel_idx = torch.arange(config.num_pixels, dtype=torch.int64,
                             device=scene_arrays["centers"].device)
    return render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                         config, frame, sample_base, n_samples, timer)


def render_samples(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                   frame, sample_base, n_samples: int):
    """Sum of ``n_samples`` radiance samples per pixel; ((P, 3) float32
    tensor on the scene's device, rays traced as a 0-d int64 tensor)."""
    return _render(scene_arrays, cam, view, inv_proj, config, frame,
                   sample_base, n_samples, None)


def render_samples_staged(scene_arrays, cam, view, inv_proj,
                          config: RenderConfig, frame, sample_base,
                          n_samples: int, timer):
    """:func:`render_samples` with each stage's wall time accumulated into
    ``timer`` (a ``utils.profiling.KernelTimer``) under the reference's
    kernel names: generate, extend, shade, miss, plus compact (which the
    reference folds into its atomics) and, with ``material_split``,
    split.  Each stage ends with a device synchronisation, so the stages
    do not overlap: a diagnostic path."""
    return _render(scene_arrays, cam, view, inv_proj, config, frame,
                   sample_base, n_samples, timer)


def bounce_histogram(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                     frame, sample):
    """Queue occupancy: the live-ray count entering each bounce of one
    sample, a (max_bounces,) int32 tensor, without roulette (as in the
    reference package).  A path lives while it hits."""
    device = scene_arrays["centers"].device
    view = torch.as_tensor(view, dtype=torch.float32, device=device)
    inv_proj = torch.as_tensor(inv_proj, dtype=torch.float32, device=device)
    pix = torch.arange(config.num_pixels, dtype=torch.int64, device=device)
    origin, direction = generate_rays(
        pix, config.width, config.height, frame, sample, cam, view,
        inv_proj, sampler=config.sampler)
    hist = [0] * config.max_bounces
    for bounce in range(config.max_bounces):
        hist[bounce] = pix.shape[0]
        if hist[bounce] == 0:
            break
        t, hit, normal, _albedo, fuzz, refract, mat = intersect_and_resolve(
            origin, direction, scene_arrays, config)
        p = origin + t[:, None] * direction
        state = rng.stream_state(pix, frame, sample, bounce + 1)
        direction = scatter(state, direction, normal, mat, fuzz, refract)
        keep = torch.nonzero(hit)[:, 0]
        pix, origin, direction = pix[keep], p[keep], direction[keep]
    return torch.tensor(hist, dtype=torch.int32)
