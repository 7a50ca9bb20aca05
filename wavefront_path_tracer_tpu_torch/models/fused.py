"""The fused engine: the whole render is one persistent-lane kernel.

Port of ``wavefront_path_tracer_tpu/models/fused.py`` for
``intersector="bruteforce"`` and ``baked_clusters=0``.  Pixels go to
lanes in 32x32 image-block order (``block_tiles``), each lane traces all
of its pixel's samples in one call of
:func:`~wavefront_path_tracer_tpu_torch.ops.fused_kernels.fused_render_persistent`,
and radiance is scattered back to natural pixel order.  The planes are
built on the scene's device, so nothing per pixel crosses to the host.

``tile_rows``, ``lane_rotate`` and ``lane_rotate_cols`` steer TPU
scheduling; they are accepted and do not change the image beyond the
parity rule (``tile_rows`` only pads the planes).  ``lane_split`` splits each pixel's samples over several
lanes, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.fused_kernels import (
    LANES,
    fused_render_persistent,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig


@functools.lru_cache(maxsize=32)
def _block_perm(width: int, height: int, block: int):
    """Pixel permutation grouping pixels into block x block image tiles.

    Returns (perm, inv) uint32 arrays: perm[i] = pixel id of lane i,
    inv = argsort(perm).  Bit-exact with the reference's ``_block_perm``.
    """
    ys, xs = np.mgrid[0:height, 0:width]
    nbx = -(-width // block)
    bidx = (ys // block) * nbx + (xs // block)
    within = (ys % block) * block + (xs % block)
    key = bidx.ravel().astype(np.int64) * (block * block) + within.ravel()
    perm = np.argsort(key, kind="stable").astype(np.uint32)
    inv = np.argsort(perm, kind="stable").astype(np.uint32)
    return perm, inv


def _effective_split(requested: int, n_samples: int) -> int:
    """Largest divisor of n_samples not exceeding the requested split."""
    split = max(1, requested)
    while split > 1 and n_samples % split:
        split -= 1
    return split


def check_supported(config: RenderConfig, scene_arrays) -> None:
    """Refuse what this slice of the port does not carry, naming the
    ROADMAP.md item that will."""
    if config.intersector in ("baked", "auto"):
        raise NotImplementedError(
            f"intersector={config.intersector!r} is not ported yet: the "
            "baked culled intersect is ROADMAP.md queue 2 item 2 (unculled "
            "baked: item 4); use intersector='bruteforce'")
    if config.intersector != "bruteforce":
        raise NotImplementedError(
            f"intersector={config.intersector!r} does not exist on the "
            "fused engine; the BVH runs on the wavefront/megakernel "
            "engines, not ported yet (ROADMAP.md queue 1 items 4 and 8)")
    if config.baked_clusters != 0:
        raise NotImplementedError(
            "baked_clusters != 0 (consensus culling) is not ported yet: "
            "the dynamic culled intersect is ROADMAP.md queue 2 item 3")
    if config.recluster > 0:
        raise NotImplementedError(
            "recluster > 0 is not ported yet (ROADMAP.md queue 2 item 6: "
            "the recluster segment kernels)")
    if config.winner_hint:
        raise NotImplementedError(
            "winner_hint is not ported yet: it belongs to the baked culled "
            "intersect (ROADMAP.md queue 2 item 2)")
    if config.num_devices != 1:
        raise NotImplementedError(
            "multi-device rendering is not ported yet (ROADMAP.md queue 1 "
            "item 10)")
    if "tex_kind" in scene_arrays:
        raise NotImplementedError(
            "textured scenes are not ported yet (ROADMAP.md queue 2 item 5 "
            "and queue 1 item 3)")
    if "tri_v0" in scene_arrays:
        raise NotImplementedError(
            "triangle meshes are not ported yet: they run on the dynamic "
            "culled intersect (ROADMAP.md queue 2 item 3)")


def camera_params(cam, view, inv_proj, config: RenderConfig) -> np.ndarray:
    """The (24,) float32 camera of the kernel's raygen, computed in
    float32 from the same matrices as the reference (render_pixels,
    models/fused.py:584-597)."""
    view = np.asarray(view, np.float32)
    inv_proj = np.asarray(inv_proj, np.float32)
    z_far = np.float32(1.0) / (inv_proj[3, 2] + inv_proj[3, 3])
    out = np.zeros(24, np.float32)
    out[0:9] = view[:3, :3].reshape(-1)
    out[9:12] = view[:3, 3]
    out[12:19] = [inv_proj[0, 0], inv_proj[1, 1], z_far,
                  np.float32(cam.defocus_radius),
                  np.float32(cam.focus_distance),
                  np.float32(config.width), np.float32(config.height)]
    return out


def lane_planes(pixel_idx: torch.Tensor, width: int, tile_rows: int,
                split: int = 1, n_per_lane: int = 0):
    """(pix, xs, ys, valid, soff) planes of (R, 128) lanes for the pixel
    ids ``pixel_idx`` (int64, on the target device), with R padded to a
    multiple of ``tile_rows``.  With ``split`` > 1 every pixel appears
    ``split`` times and copy k starts at sample offset k * n_per_lane."""
    device = pixel_idx.device
    num_pixels = pixel_idx.shape[0]
    soff = None
    if split > 1:
        pixel_idx = pixel_idx.repeat(split)
        soff = torch.arange(split, dtype=torch.int64, device=device
                            ).repeat_interleave(num_pixels) * n_per_lane
    lanes_total = pixel_idx.shape[0]
    rows = -(-lanes_total // LANES)
    rows_total = -(-rows // tile_rows) * tile_rows
    pad = rows_total * LANES - lanes_total

    def plane(x, dtype):
        x = torch.cat([x.to(dtype), torch.zeros(pad, dtype=dtype,
                                                device=device)])
        return x.reshape(rows_total, LANES)

    pix = plane(pixel_idx, torch.int32)
    xs = plane(pixel_idx % width, torch.float32)
    ys = plane(pixel_idx // width, torch.float32)
    valid = plane(torch.ones(lanes_total, device=device), torch.float32)
    soff = (plane(soff, torch.int32) if soff is not None
            else torch.zeros_like(pix))
    return pix, xs, ys, valid, soff


def render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                  config: RenderConfig, frame, sample_base, n_samples: int,
                  with_stats: bool = False, lane_split: int = 1):
    """Trace a subset of pixel ids (int64 tensor on the scene's device).

    Returns ((N, 3) radiance sum, rays traced) and, with ``with_stats``,
    a dict {iterations, supers_entered, clusters_entered} of 0-d tensors.
    """
    scene_packed = scene_arrays["scene_packed"]
    device = scene_packed.device
    num_pixels = pixel_idx.shape[0]
    split = lane_split
    n_per_lane = n_samples // split
    planes = lane_planes(pixel_idx, config.width, config.tile_rows,
                         split, n_per_lane)
    cam_params = torch.from_numpy(
        camera_params(cam, view, inv_proj, config)).to(device)
    salts = (int(frame), int(sample_base), config.max_bounces, n_per_lane)
    rad_r, rad_g, rad_b, stats = fused_render_persistent(
        scene_packed, scene_arrays["centers"].shape[0], salts, cam_params,
        *planes, rr_start=config.rr_start_bounce, rr_floor=config.rr_floor,
        clamp=config.clamp, sampler=config.sampler)
    lanes_total = num_pixels * split
    radiance = torch.stack([rad_r.reshape(-1), rad_g.reshape(-1),
                            rad_b.reshape(-1)], dim=-1)[:lanes_total]
    if split > 1:
        radiance = radiance.reshape(split, num_pixels, 3).sum(dim=0)
    if with_stats:
        return radiance, stats[0], {"iterations": stats[1],
                                    "supers_entered": stats[2],
                                    "clusters_entered": stats[3]}
    return radiance, stats[0]


def _render_samples_impl(scene_arrays, cam, view, inv_proj,
                         config: RenderConfig, frame, sample_base,
                         n_samples: int, with_stats: bool = False):
    check_supported(config, scene_arrays)
    device = scene_arrays["centers"].device
    split = _effective_split(config.lane_split, n_samples)
    if config.block_tiles:
        perm, _inv = _block_perm(config.width, config.height,
                                 config.block_tiles)
        perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
        out = render_pixels(perm_t, scene_arrays, cam, view, inv_proj,
                            config, frame, sample_base, n_samples,
                            with_stats=with_stats, lane_split=split)
        radiance = torch.empty_like(out[0])
        radiance[perm_t] = out[0]
        return (radiance,) + out[1:]
    pixel_idx = torch.arange(config.num_pixels, dtype=torch.int64,
                             device=device)
    return render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                         config, frame, sample_base, n_samples,
                         with_stats=with_stats, lane_split=split)


def render_samples(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                   frame, sample_base, n_samples: int):
    """Sum of ``n_samples`` radiance samples per pixel; ((P, 3) float32
    tensor, rays traced as a 0-d int64 tensor), both on the scene's
    device."""
    return _render_samples_impl(scene_arrays, cam, view, inv_proj, config,
                                frame, sample_base, n_samples)


def render_samples_with_stats(scene_arrays, cam, view, inv_proj,
                              config: RenderConfig, frame, sample_base,
                              n_samples: int):
    """Like :func:`render_samples`, plus the kernel's counters
    {iterations, supers_entered, clusters_entered}."""
    return _render_samples_impl(scene_arrays, cam, view, inv_proj, config,
                                frame, sample_base, n_samples,
                                with_stats=True)
