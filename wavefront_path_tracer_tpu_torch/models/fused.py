"""The fused engine: the whole render is one persistent-lane kernel.

Port of ``wavefront_path_tracer_tpu/models/fused.py`` for
``intersector="bruteforce"`` with ``baked_clusters=0`` (the (S, 16) table
swept in full, ``ops/fused_kernels.py``) or ``baked_clusters`` N or -1
(auto: the dynamic culled intersect over runtime tables,
``ops/dyn_tables.py`` and ``ops/dynculled_kernels.py``), and
``intersector="baked"`` with ``baked_clusters`` 0, N or -1: the scene
baked once into visit-ordered tables (``ops/bake.py``) and swept unculled
or through Morton clusters (``ops/baked_kernels.py``).  Triangle meshes
and textured scenes (checker and image textures, ``ops/textures.py``)
run on the baked and dynamic culled paths, and the winner hint on the
baked culled one, as in the reference.  Pixels
go to lanes in 32x32 image-block order (``block_tiles``), each lane
traces all of its pixel's samples in one kernel call, and radiance is
scattered back to natural pixel order.  The planes are built on the
scene's device, so nothing per pixel crosses to the host.

With ``recluster`` K > 0 the render is segmented, as the reference's
``_render_recluster_impl``: per sample, primary rays from
``ops/raygen.py``, then segments of K, K, 2K, ... bounces, each one
launch of a segment kernel over lane state, with the lanes re-sorted by
origin Morton cell and direction octant between segments.

:func:`stage_timing` attributes a render's time to its stages with the
differential stage probes (``ops/stage_probes.py``), as the reference's
does.

``tile_rows``, ``lane_rotate`` and ``lane_rotate_cols`` steer TPU
scheduling; they are accepted and do not change the image beyond the
parity rule (``tile_rows`` only pads the planes).  ``lane_split`` splits
each pixel's samples over several lanes, as in the reference.
"""

from __future__ import annotations

import functools
import time
from collections import OrderedDict

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.bake import (
    GLOBAL_RADIUS_FACTOR,
    HIERARCHY_DEFAULTS,
    TEX_LUT_MAX,
    BakedScene,
    bake_culled,
    bake_unculled,
)
from wavefront_path_tracer_tpu_torch.ops.baked_kernels import (
    fused_render_baked,
    fused_segment_baked,
)
from wavefront_path_tracer_tpu_torch.ops.dyn_tables import (
    DynTables,
    device_tables,
    pack_culled_scene,
)
from wavefront_path_tracer_tpu_torch.ops.dynculled_kernels import (
    fused_render_dynculled,
    fused_segment_dynculled,
)
from wavefront_path_tracer_tpu_torch.ops.fused_kernels import (
    LANES,
    SEG_COUNTS,
    SEG_IDS,
    SEG_STATE,
    fused_render_persistent,
)
from wavefront_path_tracer_tpu_torch.ops import stage_probes
from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
from wavefront_path_tracer_tpu_torch.ops.rng import MASK32
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

# Bakes keyed like the reference's _BAKED_CACHE (scene fingerprint,
# cluster size, quantized camera hint) plus the device, and the dynamic
# culled tables keyed like its _DYN_CACHE; bounded LRUs, so long sessions
# that change scenes do not grow them without end.
_BAKED_CACHE_MAX = 8
_BAKED_CACHE: OrderedDict = OrderedDict()
_DYN_CACHE: OrderedDict = OrderedDict()
# Timed runs of each render in stage_timing and time_probes, and the
# between-call drift of a kernel's time (ROADMAP.md "Build flags"): a
# stage share below it is not resolved.
STAGE_REPS = 3
STAGE_DRIFT = 0.06


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
    item that will, and what the reference itself refuses, naming its
    refusal.  ``config.num_devices`` is read only by
    ``parallel.render_sharded``, as in the reference: here it renders on
    one device."""
    if config.intersector == "auto":
        raise ValueError(
            "the fused engine has no 'auto' intersector: the command line "
            "resolves it (cli.resolve_intersector); use 'baked' or "
            "'bruteforce'")
    if config.intersector not in ("bruteforce", "baked"):
        raise NotImplementedError(
            f"intersector={config.intersector!r} does not exist on the "
            "fused engine; the BVH runs on the wavefront and megakernel "
            "engines, as in the reference (its models/fused.py:338-343)")
    brute = config.intersector == "bruteforce"
    if (brute and "tex_kind" in scene_arrays
            and _resolve_clusters(config, scene_arrays) <= 0):
        # The reference's own refusal (models/fused.py:322-328).
        raise NotImplementedError(
            "the fused engine evaluates textures with intersector='baked' "
            "or the dynamic culled path (baked_clusters > 0); the plain "
            "brute-force kernel carries no texture winner fields, as in "
            "the reference (its models/fused.py:322-328)")
    if brute and config.winner_hint:
        # The reference's own refusal (models/fused.py:329-334).
        raise NotImplementedError(
            "winner_hint is implemented only for intersector='baked' (the "
            "dynamic culled path has no shortlist prepass), as in the "
            "reference (its models/fused.py:329-334)")
    if (config.intersector == "bruteforce" and "tri_v0" in scene_arrays
            and _resolve_clusters(config, scene_arrays) <= 0):
        # The reference's own refusal (models/fused.py:344-349).
        raise NotImplementedError(
            "the fused engine traces triangles with intersector='baked' "
            "or with the dynamic culled path (baked_clusters > 0); the "
            "plain brute-force kernel is spheres-only, as in the reference "
            "(ROADMAP.md queue 2 item 3)")
    if (config.intersector == "bruteforce"
            and _resolve_clusters(config, scene_arrays) % 8):
        raise ValueError(
            "the dynamic culled path takes clusters of a multiple of 8 "
            "(its tables are 8-row blocks, as in the reference), got "
            f"{config.baked_clusters}")
    if (brute and config.recluster > 0
            and _resolve_clusters(config, scene_arrays) <= 0):
        # The reference's own refusal (models/fused.py:359-364).
        raise NotImplementedError(
            "recluster > 0 needs a culling intersector; use "
            "intersector='baked' or baked_clusters > 0, as in the "
            "reference (its models/fused.py:359-364)")


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


def _quantized_hint(centers, camera_pos):
    """(cache key, hint) of a camera position: the hint (front-to-back
    order, a speed matter only) is quantized to 1/8 of the diagonal of
    the sphere centres, so small camera moves reuse a bake or a table,
    as in the reference's ``_baked_fn`` and ``_dyn_tables``."""
    if camera_pos is None:
        return None, None
    camera_pos = np.asarray(camera_pos, np.float64).reshape(3)
    diag = (float(np.linalg.norm(centers.max(axis=0) - centers.min(axis=0)))
            if len(centers) else 1.0)
    quant = max(diag, 1e-6) / 8.0
    hint_key = tuple(np.round(camera_pos / quant).astype(np.int64).tolist())
    return hint_key, np.asarray(hint_key, np.float64) * quant


def _cached(cache, key, make):
    """``cache[key]``, made by ``make()`` on a miss; the least recently
    used entries beyond ``_BAKED_CACHE_MAX`` are dropped."""
    value = cache.get(key)
    if value is None:
        value = cache[key] = make()
        while len(cache) > _BAKED_CACHE_MAX:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return value


def _baked_scene(scene_arrays, clusters: int = 0, camera_pos=None,
                 winner_hint: bool = False,
                 lut_max: int = TEX_LUT_MAX, **hierarchy) -> BakedScene:
    """The bake for a scene, cluster size, camera hint, winner hint and
    image-LUT budget, from a bounded LRU keyed as the reference's
    ``_baked_fn`` keys its cache.  The host copy of the scene's tables and
    its fingerprint (textures included) are ``scene_arrays["host_scene"]``,
    made once with the scene (``convert.scene_arrays_to_torch``).  The
    winner hint applies to a culled bake only; the reference's unculled
    bake takes the flag and ignores it (models/fused.py:247-255).
    ``hierarchy`` holds keyword parameters of ``bake_culled``
    (``super_factor``, ``super_gate``, ...; the hierarchy sweeps of
    ``probes/`` set them, the render path never does); those that differ
    from the defaults are part of the key, so that no bake is read for
    another's parameters."""
    host = scene_arrays["host_scene"]
    hint_key, camera_pos = (_quantized_hint(host["centers"], camera_pos)
                            if clusters > 0 else (None, None))
    winner_hint = bool(winner_hint) and clusters > 0
    device = scene_arrays["centers"].device
    key = (host["centers"].shape[0], host["key"], clusters, hint_key,
           winner_hint, lut_max, str(device),
           tuple(sorted((k, v) for k, v in hierarchy.items()
                        if v != HIERARCHY_DEFAULTS.get(k))))
    if clusters > 0:
        return _cached(_BAKED_CACHE, key, lambda: bake_culled(
            host, cluster_size=clusters, camera_hint=camera_pos,
            winner_hint=winner_hint, lut_max=lut_max, device=device,
            **hierarchy))
    if hierarchy:
        raise ValueError(f"{sorted(hierarchy)}: hierarchy parameters of a "
                         f"culled bake, not of an unculled one")
    return _cached(_BAKED_CACHE, key, lambda: bake_unculled(
        host, lut_max=lut_max, device=device))


def _dyn_tables(scene_arrays, cluster_size: int, camera_pos=None,
                lut_max: int = TEX_LUT_MAX,
                global_radius_factor: float = GLOBAL_RADIUS_FACTOR
                ) -> DynTables:
    """The dynamic culled tables for a scene, cluster size, camera hint,
    image-LUT budget and global radius factor (the reference's
    ``_dyn_tables`` and ``_static_image_luts``; the factor is set by the
    hierarchy sweeps of ``probes/`` only), from a bounded LRU.  The visit
    order lives in the tables, so the hint is quantized only to keep the
    cache from thrashing on small moves."""
    host = scene_arrays["host_scene"]
    hint_key, camera_pos = _quantized_hint(host["centers"], camera_pos)
    device = scene_arrays["centers"].device
    key = (host["key"], cluster_size, hint_key, lut_max, str(device),
           global_radius_factor)
    return _cached(_DYN_CACHE, key, lambda: device_tables(
        pack_culled_scene(host, cluster_size=cluster_size,
                          global_radius_factor=global_radius_factor,
                          camera_hint=camera_pos),
        cluster_size, device=device, scene_arrays=host, lut_max=lut_max))


def scene_tables(config: RenderConfig, scene_arrays, view) -> dict:
    """The bake (``intersector="baked"``) or the dynamic culled tables
    (brute force with clusters) of the scene on its device, from the
    caches, as keyword arguments of :func:`render_pixels`; {} for the
    (S, 16) table."""
    clusters = _resolve_clusters(config, scene_arrays)
    if config.intersector == "baked":
        return {"baked": _baked_scene(scene_arrays, clusters,
                                      camera_pos=_concrete_eye(view),
                                      winner_hint=config.winner_hint,
                                      lut_max=config.tex_lut_max)}
    if clusters > 0:
        return {"dyn": _dyn_tables(scene_arrays, clusters,
                                   camera_pos=_concrete_eye(view),
                                   lut_max=config.tex_lut_max)}
    return {}


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


def launch_planes(planes, scene_arrays, cam_params, config: RenderConfig,
                  frame, sample_base, n_per_lane: int,
                  baked: BakedScene | None = None,
                  dyn: DynTables | None = None, probe=frozenset()):
    """One launch of the fused kernel over the lane planes of
    :func:`lane_planes`, through ``baked``, ``dyn`` or the brute-force
    table; (rad_r, rad_g, rad_b, stats), the wrapper's outputs.
    ``probe``: a differential stage probe of the baked or the dynamic
    kernel (``ops/stage_probes.py``); the brute-force kernel has none."""
    salts = (int(frame), int(sample_base), config.max_bounces, n_per_lane)
    opts = {"rr_start": config.rr_start_bounce,
            "rr_floor": config.rr_floor, "clamp": config.clamp,
            "sampler": config.sampler}
    if baked is not None:
        return fused_render_baked(baked, salts, cam_params, *planes,
                                  probe=probe, **opts)
    if dyn is not None:
        return fused_render_dynculled(dyn, salts, cam_params, *planes,
                                      probe=probe, **opts)
    stage_probes.probe_bits(probe, "persistent")
    return fused_render_persistent(
        scene_arrays["scene_packed"], scene_arrays["centers"].shape[0],
        salts, cam_params, *planes, **opts)


def render_pixels(pixel_idx, scene_arrays, cam, view, inv_proj,
                  config: RenderConfig, frame, sample_base, n_samples: int,
                  with_stats: bool = False, lane_split: int = 1,
                  baked: BakedScene | None = None,
                  dyn: DynTables | None = None,
                  cam_params: torch.Tensor | None = None,
                  probe=frozenset()):
    """Trace a subset of pixel ids (int64 tensor on the scene's device),
    over ``baked`` or ``dyn`` when given, else over the (S, 16) table,
    with the differential stage probe ``probe`` where given
    (:func:`launch_planes`).
    ``cam_params``, the camera of :func:`camera_params` already on the
    device, saves the upload (a copy from pageable host memory, which
    waits for the device's stream).

    Returns ((N, 3) radiance sum, rays traced) and, with ``with_stats``,
    a dict {iterations, supers_entered, clusters_entered} of 0-d tensors;
    iterations are loop trips per warp of 32 lanes (the reference's
    ``niter`` counts them per tile of tile_rows x 128 lanes).
    """
    device = scene_arrays["centers"].device
    num_pixels = pixel_idx.shape[0]
    split = lane_split
    n_per_lane = n_samples // split
    planes = lane_planes(pixel_idx, config.width, config.tile_rows,
                         split, n_per_lane)
    if cam_params is None:
        cam_params = torch.from_numpy(
            camera_params(cam, view, inv_proj, config)).to(device)
    rad_r, rad_g, rad_b, stats = launch_planes(
        planes, scene_arrays, cam_params, config, frame, sample_base,
        n_per_lane, baked, dyn, probe=probe)
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


def _segment_schedule(k: int, max_bounces: int) -> tuple:
    """Segment lengths of the re-clustering path: K, K, 2K, 4K, ...
    clipped so that they sum to ``max_bounces`` (every path has ended
    after the last segment), as the reference's ``_segment_schedule``."""
    ks = [min(k, max_bounces)]
    tot = ks[0]
    step = k
    while tot < max_bounces:
        step_eff = min(step, max_bounces - tot)
        ks.append(step_eff)
        tot += step_eff
        step *= 2
    return tuple(ks)


def _coherence_key(ox, oy, oz, dx, dy, dz, alive, lo, inv_ext):
    """Sort key of each lane (int32), bit-exact with the reference's
    ``_coherence_key``: the 21-bit Morton cell of the origin on a 128^3
    grid over the scene box (``lo``, ``inv_ext``: float32 3-vectors)
    shifted by 3, OR the direction octant; a dead lane keys to int32 max,
    so one ascending stable sort compacts the live lanes to the front and
    groups them by cell and octant."""
    # The three axes at once: clip, then truncate (a NaN converts to 0,
    # as XLA converts it), then spread each cell's 7 bits 3 apart.
    s = (torch.stack([ox, oy, oz]) - lo[:, None]) * inv_ext[:, None] * 128.0
    s = torch.nan_to_num(torch.clamp(s, 0.0, 127.0), nan=0.0).to(torch.int32)
    s = (s | (s << 16)) & 0x030000FF
    s = (s | (s << 8)) & 0x0300F00F
    s = (s | (s << 4)) & 0x030C30C3
    s = (s | (s << 2)) & 0x09249249
    m = (s[0] << 2) | (s[1] << 1) | s[2]
    octant = ((dx < 0).to(torch.int32) * 4 + (dy < 0).to(torch.int32) * 2
              + (dz < 0).to(torch.int32))
    return torch.where(alive > 0, (m << 3) | octant,
                       torch.full_like(m, 0x7FFFFFFF))


def _scene_box(scene_arrays):
    """(lo, 1 / extent) of the scene's primitive box in float32: scatter
    origins lie on primitive surfaces, so it holds every live origin
    (the reference's render_pixels_recluster, 761-771)."""
    centers = scene_arrays["centers"].to(torch.float32)
    absr = torch.abs(scene_arrays["radii"].to(torch.float32))[:, None]
    lo = (centers - absr).min(dim=0).values
    hi = (centers + absr).max(dim=0).values
    if "tri_v0" in scene_arrays:
        v0 = scene_arrays["tri_v0"].to(torch.float32)
        v1 = v0 + scene_arrays["tri_e1"].to(torch.float32)
        v2 = v0 + scene_arrays["tri_e2"].to(torch.float32)
        lo = torch.minimum(lo, torch.minimum(
            v0, torch.minimum(v1, v2)).min(dim=0).values)
        hi = torch.maximum(hi, torch.maximum(
            v0, torch.maximum(v1, v2)).max(dim=0).values)
    return lo, 1.0 / torch.clamp_min(hi - lo, 1e-6)


def _i32(word: int) -> int:
    """A 32-bit word as the int32 value of the same bits."""
    word &= MASK32
    return word - (1 << 32) if word >= 1 << 31 else word


def segment_state(pixel_idx, n_pad: int, config: RenderConfig, frame,
                  sample: int, cam, view, inv_proj):
    """(ids, state) of one sample's primary rays for the segment path:
    the pixel ids ``pixel_idx`` (int64) in their lanes, then padding
    lanes up to ``n_pad``, which start dead with zero throughput,
    direction +z (a finite 1/d) and slot n (``ops/fused_kernels.py``
    SEG_STATE and SEG_IDS)."""
    device = pixel_idx.device
    n = pixel_idx.shape[0]
    origin, direction = generate_rays(
        pixel_idx, config.width, config.height, frame, sample, cam, view,
        inv_proj, sampler=config.sampler)
    state = torch.zeros((SEG_STATE, n_pad), dtype=torch.float32,
                        device=device)
    state[0:3, :n] = origin.T
    state[3:6, :n] = direction.T
    state[5, n:] = 1.0
    state[6:9, :n] = 1.0
    state[12, :n] = 1.0
    ids = torch.zeros((SEG_IDS, n_pad), dtype=torch.int32, device=device)
    ids[0, :n] = pixel_idx.to(torch.int32)
    ids[1] = _i32(sample)
    ids[3] = torch.arange(n_pad, dtype=torch.int32, device=device)
    ids[3, n:] = n
    return ids, state


def coherence_order(ids, state, lo, inv_ext):
    """The lanes of (ids, state) reordered by :func:`_coherence_key`:
    one stable sort, then one gather of each tensor."""
    key = _coherence_key(*state[0:6], state[12], lo, inv_ext)
    order = torch.sort(key, stable=True).indices
    return ids.index_select(1, order), state.index_select(1, order)


def render_pixels_recluster(pixel_idx, scene_arrays, cam, view, inv_proj,
                            config: RenderConfig, frame, sample_base,
                            n_samples: int, with_stats: bool = False,
                            baked: BakedScene | None = None,
                            dyn: DynTables | None = None,
                            probe=frozenset()):
    """The segmented re-clustering render (``config.recluster`` > 0) of
    a subset of pixel ids (int64 tensor on the scene's device), over
    ``baked`` or ``dyn``; radiance comes back in ``pixel_idx`` order.

    Per sample: raygen (:func:`segment_state`) in the caller's pixel
    order, then the segments of :func:`_segment_schedule`, each one
    launch of the segment kernel over every lane; before every segment
    but the first the lanes are reordered by :func:`coherence_order`.
    Each ray's radiance goes back to its pixel's slot once per sample;
    the padding lanes' slot n is dropped.  The RNG streams are keyed per
    (pixel, sample, bounce) and the cull is per ray, so a ray's result
    depends neither on its lane nor on where the segments end: every K,
    and any lane order, give the same image.

    Returns ((N, 3) radiance sum, rays traced) and, with ``with_stats``,
    {iterations, supers_entered, clusters_entered}, like
    :func:`render_pixels`; iterations sums each launch's loop trips per
    warp of 32 lanes (a TPU tile held 1024), so it also shows how full
    the sort keeps the warps.

    ``probe``: a differential stage probe of the segment kernel's
    intersect (``ops/stage_probes.py`` KERNEL_PROBES "segment_culled" or
    "segment_dynculled"), passed to every segment launch, as the
    reference's ``PROBE`` reaches its ``fused_segment_*`` kernels; the
    render is the unprobed one's, bit for bit."""
    if baked is not None:
        tables, segment = baked, fused_segment_baked
    else:
        tables, segment = dyn, fused_segment_dynculled
    return _recluster(segment, coherence_order, tables, pixel_idx,
                      scene_arrays, cam, view, inv_proj, config, frame,
                      sample_base, n_samples, with_stats, probe=probe)


def _recluster(segment, order, tables, pixel_idx, scene_arrays, cam, view,
               inv_proj, config: RenderConfig, frame, sample_base,
               n_samples: int, with_stats: bool, probe=frozenset()):
    """The loop of :func:`render_pixels_recluster` over the segment
    function ``segment`` (a segment wrapper, or its plain version) and
    the lane order ``order`` (:func:`coherence_order`'s signature); a
    ``probe`` goes to every call of ``segment``.

    Nothing in the loop waits for the device: the matrices go to it once,
    and the scatter indexes an (n + 1, 3) accumulator by slot, whose row
    n takes the padding lanes and is dropped, so no mask is read back."""
    device = scene_arrays["centers"].device
    n = pixel_idx.shape[0]
    rows = -(-n // LANES)
    n_pad = -(-rows // config.tile_rows) * config.tile_rows * LANES
    lo, inv_ext = _scene_box(scene_arrays)
    view = torch.as_tensor(view, dtype=torch.float32, device=device)
    inv_proj = torch.as_tensor(inv_proj, dtype=torch.float32, device=device)
    opts = {"rr_start": config.rr_start_bounce,
            "rr_floor": config.rr_floor, "clamp": config.clamp}
    # Passed only when set, so that a segment function without a probe
    # argument (a counting spy's) still runs the unprobed loop.
    if stage_probes.probe_names(probe):
        opts["probe"] = probe
    acc = torch.zeros((n + 1, 3), dtype=torch.float32, device=device)
    counts = torch.zeros((SEG_COUNTS, n_pad), dtype=torch.int32,
                         device=device)
    for s in range(n_samples):
        ids, state = segment_state(pixel_idx, n_pad, config, frame,
                                   (int(sample_base) + s) & MASK32, cam,
                                   view, inv_proj)
        for i, k in enumerate(_segment_schedule(config.recluster,
                                                config.max_bounces)):
            if i > 0:
                ids, state = order(ids, state, lo, inv_ext)
            segment(tables, (frame, config.max_bounces, k, 0), ids, state,
                    counts, **opts)
        # Gather, add, scatter by slot (no float atomics); the live slots
        # are unique, the padding lanes all write row n.
        slot = ids[3].to(torch.int64)
        acc[slot] = acc[slot] + state[9:12].T
    acc = acc[:n]
    rays, supers, clusters, iterations = counts.sum(dim=1,
                                                    dtype=torch.int64)
    if with_stats:
        return acc, rays, {"iterations": iterations,
                           "supers_entered": supers,
                           "clusters_entered": clusters}
    return acc, rays


def _render_samples_impl(scene_arrays, cam, view, inv_proj,
                         config: RenderConfig, frame, sample_base,
                         n_samples: int, with_stats: bool = False):
    check_supported(config, scene_arrays)
    device = scene_arrays["centers"].device
    split = _effective_split(config.lane_split, n_samples)
    tables = scene_tables(config, scene_arrays, view)
    if config.recluster > 0:
        # The reference's _render_recluster_impl: block order in, natural
        # order out; lane_split has no meaning there.
        def render(pixel_idx):
            return render_pixels_recluster(
                pixel_idx, scene_arrays, cam, view, inv_proj, config, frame,
                sample_base, n_samples, with_stats=with_stats, **tables)
    else:
        def render(pixel_idx):
            return render_pixels(pixel_idx, scene_arrays, cam, view,
                                 inv_proj, config, frame, sample_base,
                                 n_samples, with_stats=with_stats,
                                 lane_split=split, **tables)
    if config.block_tiles:
        perm, _inv = _block_perm(config.width, config.height,
                                 config.block_tiles)
        perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
        out = render(perm_t)
        radiance = torch.empty_like(out[0])
        radiance[perm_t] = out[0]
        return (radiance,) + out[1:]
    return render(torch.arange(config.num_pixels, dtype=torch.int64,
                               device=device))


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
    {iterations, supers_entered, clusters_entered}; clusters_entered
    includes the winner hint's prepass entries."""
    return _render_samples_impl(scene_arrays, cam, view, inv_proj, config,
                                frame, sample_base, n_samples,
                                with_stats=True)


def stage_stages(config: RenderConfig, scene_arrays) -> list:
    """The (label, probe) rows of :func:`stage_timing` for ``config``, in
    the reference's order and with its labels (its
    ``models/fused.py:455-469``); raises NotImplementedError where it
    does: an intersector other than baked and brute force, and brute
    force without clusters (the brute-force kernel has no probe points)."""
    culled = _resolve_clusters(config, scene_arrays) > 0
    dynamic = config.intersector != "baked"
    if dynamic and config.intersector != "bruteforce":
        raise NotImplementedError(
            "fused stage timing probes cover intersector='baked' and "
            "'bruteforce' (the production paths)")
    if dynamic and not culled:
        raise NotImplementedError(
            "the plain dynamic VMEM kernel has no probe points; use "
            "baked_clusters > 0")
    stages = [("generate (raygen)", "dbl_raygen")]
    if dynamic:
        stages += [("extend: primitive tests", "dyn_dbl_entry"),
                   ("extend: cull conds", "dyn_dbl_cond"),
                   ("extend: global sweep", "dyn_dbl_global")]
    elif culled:
        stages += [("extend: primitive tests", "dbl_entry"),
                   ("extend: cull conds", "dbl_cond")]
    stages += [("shade (BSDF)", "dbl_shade"),
               ("miss (sky accumulate)", "dbl_accum"),
               ("loop bookkeeping", "dbl_loopcond")]
    return stages


def _check_probe_render(probe, radiance, stats, base_radiance, base_stats,
                        n_samples: int) -> None:
    """Raise RuntimeError unless a probed render's radiance words and
    counters [rays, iterations, supers, clusters] equal the unprobed
    render's: bit for bit, ``dbl_accum``'s radiance within
    ``stage_probes``' tolerance; ``hint_count``'s supers higher by the
    prepass entries, which are some of the clusters entered, and at least
    one (a render with the winner hint whose rays hit anything enters the
    previous winner's cluster; the plain version counts the entries on
    its own, and the kernel is held to that count exactly there)."""
    same = stats == base_stats
    if stage_probes.probe_names(probe) == {"hint_count"}:
        extra = stats[2] - base_stats[2]
        same = (stats[:2] + stats[3:] == base_stats[:2] + base_stats[3:]
                and 0 < extra <= stats[3])
    if not same:
        raise RuntimeError(f"probe {probe} counted {stats}, the base render "
                           f"{base_stats} (rays, iterations, supers, "
                           f"clusters)")
    if stage_probes.probe_names(probe) == {"dbl_accum"}:
        same = torch.allclose(
            radiance, base_radiance, atol=stage_probes.ACCUM_ATOL,
            rtol=stage_probes.ACCUM_RTOL_PER_SAMPLE * n_samples)
    else:
        same = torch.equal(radiance.view(torch.int32),
                           base_radiance.view(torch.int32))
    if not same:
        err = float((radiance.double() - base_radiance.double()).abs().max())
        raise RuntimeError(f"probe {probe} changed the render's radiance "
                           f"(max abs error {err})")


def time_probes(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                probes, n_samples: int = 32, reps: int = STAGE_REPS):
    """The unprobed render and each probed one (``probes``: names of
    ``ops/stage_probes.py``), timed in turns: (rays, base seconds,
    [(probe, base seconds of its turns, probe seconds), ...]).

    Each time is wall seconds between ``torch.cuda.synchronize()`` calls
    (none needed on the CPU): the least of ``reps`` runs of
    :func:`render_pixels` over every pixel (in block order where
    ``config.block_tiles`` asks for it) at ``n_samples`` over the
    render's own tables (:func:`scene_tables`), after one warm run.  The
    base render runs in turns with each probed one (base, probe, base,
    probe, ...), since a kernel's time drifts between calls; the base
    seconds returned first are the least of all its runs.  So each probe
    launches 1 + ``reps`` times.  The warm runs check the probe: a probed
    render whose radiance words or counters differ from the base's
    (``dbl_accum``'s radiance: beyond its tolerance) raises RuntimeError."""
    device = scene_arrays["centers"].device
    tables = scene_tables(config, scene_arrays, view)
    if config.block_tiles:
        perm, _ = _block_perm(config.width, config.height,
                              config.block_tiles)
        pix = torch.from_numpy(perm.astype(np.int64)).to(device)
    else:
        pix = torch.arange(config.num_pixels, dtype=torch.int64,
                           device=device)
    cam_params = torch.from_numpy(
        camera_params(cam, view, inv_proj, config)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(probe, frame) -> tuple:
        sync()
        t0 = time.perf_counter()
        radiance, rays, stats = render_pixels(
            pix, scene_arrays, cam, view, inv_proj, config, frame, 0,
            n_samples, with_stats=True, cam_params=cam_params, probe=probe,
            **tables)
        rays = int(rays)     # waits for the launch
        sync()
        seconds = time.perf_counter() - t0
        return seconds, radiance, [rays, *(int(v) for v in stats.values())]

    _, base_radiance, base_stats = run((), 0)
    base = min(run((), 1)[0] for _ in range(reps))
    turns = []
    for probe in probes:
        _, radiance, stats = run(probe, 0)
        _check_probe_render(probe, radiance, stats, base_radiance,
                            base_stats, n_samples)
        t_base = t_probe = float("inf")
        for _ in range(reps):
            t_base = min(t_base, run((), 1)[0])
            t_probe = min(t_probe, run(probe, 1)[0])
        base = min(base, t_base)
        turns.append((probe, t_base, t_probe))
    return base_stats[0], base, turns


def stage_timing(scene_arrays, cam, view, inv_proj, config: RenderConfig,
                 n_samples: int = 32, reps: int = STAGE_REPS):
    """Per-stage wall-time attribution for the fused engine, the port of
    the reference's ``stage_timing`` (its ``models/fused.py:415-532``).

    The render is one kernel, so stage times are measured
    differentially: each stage runs twice in a kernel of its own (the
    differential stage probes, ``ops/stage_probes.py``; results
    unchanged), and the stage's share of the render's time is
    (t_probed - t_base) / t_base, at least 0, against the base timed in
    turns with it (:func:`time_probes`).  Both culled production
    intersectors are covered: the baked one (culled or unculled) and the
    dynamic culled one (brute force with clusters); the stages are
    :func:`stage_stages`'.

    The one departure from the reference: its baked branch bakes spheres
    only, so that on a mesh or a textured scene it times a kernel other
    than the one that renders; here the render's own bake (or tables)
    is timed, triangles and textures included.

    Returns (base_seconds, [(stage, seconds, share), ...]) where the
    final row is the unprobed residual, "other (winner selects,
    unprobed)", whose share is 1 less the probed shares, at least 0.
    """
    stages = stage_stages(config, scene_arrays)
    check_supported(config, scene_arrays)
    _rays, base, turns = time_probes(
        scene_arrays, cam, view, inv_proj, config,
        [probe for _label, probe in stages], n_samples, reps)
    rows = []
    for (label, _probe), (_p, t_base, t_probe) in zip(stages, turns):
        share = max(0.0, (t_probe - t_base) / t_base)
        rows.append((label, base * share, share))
    probed = sum(r[2] for r in rows)
    rows.append(("other (winner selects, unprobed)",
                 base * max(0.0, 1.0 - probed), max(0.0, 1.0 - probed)))
    return base, rows
