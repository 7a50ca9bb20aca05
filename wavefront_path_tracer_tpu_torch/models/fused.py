"""The fused engine: the whole render is one persistent-lane kernel.

Port of ``wavefront_path_tracer_tpu/models/fused.py`` for
``intersector="bruteforce"`` with ``baked_clusters=0`` (the (S, 16) table
swept in full, ``ops/fused_kernels.py``) and ``intersector="baked"``
with ``baked_clusters`` 0, N or -1 (auto): the scene baked once into
visit-ordered tables (``ops/bake.py``) and swept unculled or through
Morton clusters (``ops/baked_kernels.py``).  Pixels go to lanes in
32x32 image-block order (``block_tiles``), each lane traces all of its
pixel's samples in one kernel call, and radiance is scattered back to
natural pixel order.  The planes are built on the scene's device, so
nothing per pixel crosses to the host.

``tile_rows``, ``lane_rotate`` and ``lane_rotate_cols`` steer TPU
scheduling; they are accepted and do not change the image beyond the
parity rule (``tile_rows`` only pads the planes).  ``lane_split`` splits
each pixel's samples over several lanes, as in the reference.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.bake import (
    BakedScene,
    bake_culled,
    bake_unculled,
)
from wavefront_path_tracer_tpu_torch.ops.baked_kernels import (
    fused_render_baked,
)
from wavefront_path_tracer_tpu_torch.ops.fused_kernels import (
    LANES,
    fused_render_persistent,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

# Bakes keyed like the reference's _BAKED_CACHE (scene fingerprint,
# cluster size, quantized camera hint) plus the device; bounded LRU, so
# long sessions that change scenes do not grow it without end.
_BAKED_CACHE_MAX = 8
_BAKED_CACHE: OrderedDict = OrderedDict()


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
    """Refuse what this port does not carry yet, naming the ROADMAP.md
    item that will."""
    if config.intersector == "auto":
        raise ValueError(
            "the fused engine has no 'auto' intersector: the command line "
            "resolves it (cli.resolve_intersector); use 'baked' or "
            "'bruteforce'")
    if config.intersector not in ("bruteforce", "baked"):
        raise NotImplementedError(
            f"intersector={config.intersector!r} does not exist on the "
            "fused engine; the BVH runs on the wavefront/megakernel "
            "engines, not ported yet (ROADMAP.md queue 1 items 4 and 8)")
    if config.intersector == "bruteforce" and config.baked_clusters != 0:
        raise NotImplementedError(
            "intersector='bruteforce' with baked_clusters != 0 (the dynamic "
            "culled intersect) is not ported yet: ROADMAP.md queue 2 item 3; "
            "use intersector='baked' for culling")
    if config.recluster > 0:
        raise NotImplementedError(
            "recluster > 0 is not ported yet (ROADMAP.md queue 2 item 6: "
            "the recluster segment kernels)")
    if config.winner_hint:
        raise NotImplementedError(
            "winner_hint is not ported yet: the winner-hint shortlist is "
            "what remains of ROADMAP.md queue 2 item 2")
    if config.num_devices != 1:
        raise NotImplementedError(
            "multi-device rendering is not ported yet (ROADMAP.md queue 1 "
            "item 10)")
    if "tex_kind" in scene_arrays:
        raise NotImplementedError(
            "textured scenes are not ported yet: checker and image textures "
            "are ROADMAP.md queue 2 items 2, 4 and 5 (and queue 1 item 3)")
    if "tri_v0" in scene_arrays:
        raise NotImplementedError(
            "triangle meshes are not ported yet: the dynamic culled "
            "intersect and the baked intersects' triangle tests (ROADMAP.md "
            "queue 2 items 2, 3 and 4)")


def _concrete_eye(view) -> np.ndarray:
    """World-space eye position: the view matrix's translation."""
    return np.asarray(view, np.float64)[:3, 3]


def _resolve_clusters(config: RenderConfig, scene_arrays) -> int:
    """Effective leaf cluster size: -1 (auto) picks 16 below 2000
    primitives and 32 above, the reference's measured optimum."""
    if config.baked_clusters >= 0:
        return config.baked_clusters
    n = scene_arrays["centers"].shape[0]
    if "tri_v0" in scene_arrays:
        n += scene_arrays["tri_v0"].shape[0]
    return 16 if n < 2000 else 32


def _baked_scene(scene_arrays, clusters: int = 0,
                 camera_pos=None) -> BakedScene:
    """The bake for a scene, cluster size and camera hint, from a bounded
    LRU.  The hint (front-to-back order, a speed matter only) is
    quantized to 1/8 of the scene's diagonal, so small camera moves reuse
    the bake, as in the reference's ``_baked_fn``.  The host copy of the
    sphere tables and its fingerprint are ``scene_arrays["host_spheres"]``,
    made once with the scene (``convert.scene_arrays_to_torch``)."""
    host = scene_arrays["host_spheres"]
    centers = host["centers"]
    hint_key = None
    if camera_pos is not None and clusters > 0:
        camera_pos = np.asarray(camera_pos, np.float64).reshape(3)
        diag = (float(np.linalg.norm(centers.max(axis=0)
                                     - centers.min(axis=0)))
                if len(centers) else 1.0)
        quant = max(diag, 1e-6) / 8.0
        hint_key = tuple(
            np.round(camera_pos / quant).astype(np.int64).tolist())
        camera_pos = np.asarray(hint_key, np.float64) * quant
    device = scene_arrays["centers"].device
    key = (centers.shape[0], host["key"], clusters, hint_key, str(device))
    baked = _BAKED_CACHE.get(key)
    if baked is None:
        if clusters > 0:
            baked = bake_culled(host, cluster_size=clusters,
                                camera_hint=camera_pos, device=device)
        else:
            baked = bake_unculled(host, device=device)
        _BAKED_CACHE[key] = baked
        while len(_BAKED_CACHE) > _BAKED_CACHE_MAX:
            _BAKED_CACHE.popitem(last=False)
    else:
        _BAKED_CACHE.move_to_end(key)
    return baked


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
                  with_stats: bool = False, lane_split: int = 1,
                  baked: BakedScene | None = None):
    """Trace a subset of pixel ids (int64 tensor on the scene's device),
    over ``baked`` when given, else over the (S, 16) table.

    Returns ((N, 3) radiance sum, rays traced) and, with ``with_stats``,
    a dict {iterations, supers_entered, clusters_entered} of 0-d tensors.
    """
    device = scene_arrays["centers"].device
    num_pixels = pixel_idx.shape[0]
    split = lane_split
    n_per_lane = n_samples // split
    planes = lane_planes(pixel_idx, config.width, config.tile_rows,
                         split, n_per_lane)
    cam_params = torch.from_numpy(
        camera_params(cam, view, inv_proj, config)).to(device)
    salts = (int(frame), int(sample_base), config.max_bounces, n_per_lane)
    opts = {"rr_start": config.rr_start_bounce,
            "rr_floor": config.rr_floor, "clamp": config.clamp,
            "sampler": config.sampler}
    if baked is not None:
        rad_r, rad_g, rad_b, stats = fused_render_baked(
            baked, salts, cam_params, *planes, **opts)
    else:
        rad_r, rad_g, rad_b, stats = fused_render_persistent(
            scene_arrays["scene_packed"], scene_arrays["centers"].shape[0],
            salts, cam_params, *planes, **opts)
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
    baked = None
    if config.intersector == "baked":
        baked = _baked_scene(scene_arrays,
                             _resolve_clusters(config, scene_arrays),
                             camera_pos=_concrete_eye(view))
    if config.block_tiles:
        perm, _inv = _block_perm(config.width, config.height,
                                 config.block_tiles)
        perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
        out = render_pixels(perm_t, scene_arrays, cam, view, inv_proj,
                            config, frame, sample_base, n_samples,
                            with_stats=with_stats, lane_split=split,
                            baked=baked)
        radiance = torch.empty_like(out[0])
        radiance[perm_t] = out[0]
        return (radiance,) + out[1:]
    pixel_idx = torch.arange(config.num_pixels, dtype=torch.int64,
                             device=device)
    return render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                         config, frame, sample_base, n_samples,
                         with_stats=with_stats, lane_split=split,
                         baked=baked)


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
