"""The persistent-lane render over a baked scene: the plain PyTorch
versions of the two baked intersects, and the wrapper that launches the
CUDA kernel.

Port of ``wavefront_path_tracer_tpu/ops/pallas_kernels.py``:
``fused_render_baked`` (3157) with ``baked_intersect`` (612, the
unculled sweep) or ``baked_culled_intersect`` (831, Morton clusters under
box conds), spheres only.  The tables come from ``ops/bake.py``; the
kernel is ``csrc/baked.cu``; the persistent loop, raygen and shade are
those of ``ops/fused_kernels.py``.

Culling is decided per ray, against the ray's own current nearest hit
(the TPU kernel decided per 1024-lane tile, by consensus, with a cap one
batch stale).  The plain version makes the same per-ray decisions in the
same order as the kernel, so the two agree bit for bit, cull counters
included.
"""

from __future__ import annotations

import torch

from wavefront_path_tracer_tpu_torch.ops.bake import ITEM_COLS, BakedScene
from wavefront_path_tracer_tpu_torch.ops.fused_kernels import (
    T_FAR,
    T_MIN,
    _salts,
    check_aligned,
    check_inputs,
    persistent_reference,
)

_ITEM_BLOCK = 64

# Kernel launches by fused_render_baked on CUDA tensors, per intersect.
LAUNCHES = {"culled": 0, "unculled": 0}

_MISS = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _col(v):
    return v[:, None]


def _winner(items, best_t, best_i):
    """The intersect tuple of the winners' rows: (best_t, cx, cy, cz,
    1/r sign, albedo rgb, fuzz, ior, mat_type); a miss carries
    (T_FAR, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)."""
    hit = best_i >= 0
    row = items[best_i.clamp_min(0)]
    # Columns of ops/bake.py's item table, in the tuple's order.
    row = row[:, [8, 9, 10, 16, 12, 13, 14, 15, 11, 17]]
    miss = torch.tensor(_MISS, dtype=torch.float32, device=items.device)
    row = torch.where(hit[:, None], row, miss)
    return (best_t, *row.unbind(dim=1))


def _take(t, offset, best_t, best_i, mask=None):
    """Fold a block of per-item ``t`` (rays x items, in sweep order) into
    the running nearest hit: the first minimal item wins, and it replaces
    the running best only when strictly nearer (the strict ``t < best_t``
    walk).  ``mask`` limits the update to the rays that swept the block."""
    k = torch.argmin(t, dim=1)
    t_k = torch.gather(t, 1, k[:, None])[:, 0]
    better = t_k < best_t
    if mask is not None:
        better = better & mask
    return (torch.where(better, t_k, best_t),
            torch.where(better, k + offset, best_i))


def baked_intersect_reference(baked: BakedScene, ox, oy, oz, dx, dy, dz):
    """Nearest hit over an unculled bake (``baked_intersect.intersect``,
    pallas_kernels.py:672-745): the generic quadratic with ``inv_a`` and
    the ``disc >= 0`` select, far root elided per sphere, in scene order.
    Returns the winner tuple and (None, None) for the cull counters."""
    items = baked.items
    a_q = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a_q
    best_t = torch.full_like(ox, T_FAR)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    for lo in range(0, items.shape[0], _ITEM_BLOCK):
        blk = items[lo:lo + _ITEM_BLOCK]
        ocx = _col(ox) - blk[:, 0]
        ocy = _col(oy) - blk[:, 1]
        ocz = _col(oz) - blk[:, 2]
        b_q = _col(dx) * ocx + _col(dy) * ocy + _col(dz) * ocz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - blk[:, 3]
        disc = b_q * b_q - _col(a_q) * c_q
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-b_q - sq) * _col(inv_a)
        t2 = (-b_q + sq) * _col(inv_a)
        far = torch.where(blk[:, 4] != 0.0, T_FAR,
                          torch.where(t2 > T_MIN, t2, T_FAR))
        t = torch.where(t1 > T_MIN, t1, far)
        t = torch.where(disc >= 0.0, t, T_FAR)
        best_t, best_i = _take(t, lo, best_t, best_i)
    return _winner(items, best_t, best_i) + (None, None)


def _box_range(lo, hi, ox, oy, oz, idx, idy, idz):
    """(entry, exit) of each ray against boxes (rows x 3 ``lo``/``hi``,
    or one box as 3-vectors) by the slab method; min/max propagate NaN,
    as jnp's do."""
    def axis(a, o, inv):
        t0 = (lo[..., a] - _col(o)) * _col(inv)
        t1 = (hi[..., a] - _col(o)) * _col(inv)
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    tmin, tmax = axis(0, ox, idx)
    for a, o, inv in ((1, oy, idy), (2, oz, idz)):
        lo_a, hi_a = axis(a, o, inv)
        tmin = torch.maximum(tmin, lo_a)
        tmax = torch.minimum(tmax, hi_a)
    return tmin, tmax


def _slim_t(items, oxp, oyp, ozp, dd_o, oo2, dx, dy, dz):
    """Per-item ``t`` of the slimmed quadratic (pallas_kernels.py:
    1090-1130), rays x items: unit directions, the expansion around the
    shifted centre, NaN from a negative disc falling through to T_FAR."""
    ts = []
    for lo in range(0, items.shape[0], _ITEM_BLOCK):
        blk = items[lo:lo + _ITEM_BLOCK]
        cxp, cyp, czp, kappa = blk[:, 0], blk[:, 1], blk[:, 2], blk[:, 3]
        nb = (_col(dx) * cxp + _col(dy) * cyp + _col(dz) * czp) - _col(dd_o)
        # Columns 5-7 hold 2c', as the reference's folded 2.0 * cxp.
        c_q = (_col(oo2) + kappa) - (_col(oxp) * blk[:, 5]
                                     + _col(oyp) * blk[:, 6]
                                     + _col(ozp) * blk[:, 7])
        disc = nb * nb - c_q
        sq = torch.sqrt(disc)
        t1 = nb - sq
        t2 = nb + sq
        far = torch.where(blk[:, 4] != 0.0, T_FAR,
                          torch.where(t2 > T_MIN, t2, T_FAR))
        ts.append(torch.where(t1 > T_MIN, t1, far))
    return torch.cat(ts, dim=1)


def culled_intersect_reference(baked: BakedScene, ox, oy, oz, dx, dy, dz,
                               *, ranges=None):
    """Nearest hit over a culled bake (``baked_culled_intersect.intersect``,
    pallas_kernels.py:1063-1466, spheres): globals first, then the
    clusters (under supers when the sweep is two-level) whose box cond
    holds for the ray against its own current nearest hit.  Returns the
    winner tuple and the per-ray supers and clusters entered (int64).

    ``ranges`` is (cluster ranges, super ranges) as host lists; they are
    read from the tables when not given."""
    if ranges is None:
        ranges = host_ranges(baked)
    cranges, sranges = ranges
    items, consts = baked.items, baked.consts
    oxp = ox - consts[0]
    oyp = oy - consts[1]
    ozp = oz - consts[2]
    dd_o = dx * oxp + dy * oyp + dz * ozp
    oo2 = oxp * oxp + oyp * oyp + ozp * ozp
    t = _slim_t(items, oxp, oyp, ozp, dd_o, oo2, dx, dy, dz)

    best_t = torch.full_like(ox, T_FAR)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    zeros = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    supers, clusters = zeros, zeros
    if baked.n_globals:
        best_t, best_i = _take(t[:, :baked.n_globals], 0, best_t, best_i)
    if not cranges:
        return _winner(items, best_t, best_i) + (supers, clusters)

    idx, idy, idz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    s_min, s_max = _box_range(consts[3:6], consts[6:9], ox, oy, oz, idx,
                              idy, idz)
    s_min, s_max = s_min[:, 0], s_max[:, 0]
    t_exit = torch.where((s_min <= s_max) & (s_max > T_MIN), s_max, -1.0)

    def conds(boxes):
        c_min, c_max = _box_range(boxes[:, 0:3], boxes[:, 4:7], ox, oy, oz,
                                  idx, idy, idz)
        return (c_min <= c_max) & (c_max > T_MIN), torch.clamp_min(c_min, 0.0)

    c_ok, c_entry = conds(baked.cluster_boxes)

    def sweep(c, gate):
        nonlocal best_t, best_i, clusters
        enter = gate & c_ok[:, c] & (c_entry[:, c]
                                     < torch.minimum(best_t, t_exit))
        clusters = clusters + enter
        first, count = cranges[c]
        best_t, best_i = _take(t[:, first:first + count], first, best_t,
                               best_i, enter)

    if sranges:
        s_ok, s_entry = conds(baked.super_boxes)
        for s, (first, count) in enumerate(sranges):
            enter = s_ok[:, s] & (s_entry[:, s]
                                  < torch.minimum(best_t, t_exit))
            supers = supers + enter
            for c in range(first, first + count):
                sweep(c, enter)
    else:
        everyone = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
        for c in range(len(cranges)):
            sweep(c, everyone)
    return _winner(items, best_t, best_i) + (supers, clusters)


def host_ranges(baked: BakedScene):
    """(cluster ranges, super ranges) of a bake as lists of (first,
    count), for the plain version's Python loops."""
    return (baked.cluster_ranges.cpu().tolist(),
            baked.super_ranges.cpu().tolist())


def fused_render_baked_reference(
        baked: BakedScene, salts, cam_params, pix, xs, ys, valid, soff, *,
        rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random"):
    """Plain PyTorch version of the baked kernel: the persistent loop of
    ``ops/fused_kernels.py`` over :func:`culled_intersect_reference` or
    :func:`baked_intersect_reference`, as ``baked.culled`` says.  Same
    arguments and results as :func:`fused_render_baked`."""
    if baked.culled:
        ranges = host_ranges(baked)

        def intersect(ox, oy, oz, dx, dy, dz):
            return culled_intersect_reference(baked, ox, oy, oz, dx, dy, dz,
                                              ranges=ranges)
    else:
        def intersect(ox, oy, oz, dx, dy, dz):
            return baked_intersect_reference(baked, ox, oy, oz, dx, dy, dz)

    return persistent_reference(
        intersect, salts, cam_params, pix, xs, ys, valid, soff,
        rr_start=rr_start, rr_floor=rr_floor, clamp=clamp, sampler=sampler)


def fused_render_baked(
        baked: BakedScene, salts, cam_params, pix, xs, ys, valid, soff, *,
        rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random"):
    """All samples x all bounces of every lane over a baked scene.

    Returns (rad_r, rad_g, rad_b, stats): radiance sums as (R, 128)
    float32 planes in lane order, and an int64 tensor [rays, iterations,
    supers entered, clusters entered].  ``iterations`` counts one per
    ray traced.  The cull counters count per-ray entries (a ray entering
    a cluster adds one), not the TPU kernel's per-tile consensus
    entries; they are zero for an unculled bake.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/baked.cu`` on the current stream; any other device raises.
    The kernel's results, counters included, are bit-identical to the
    plain version's.
    """
    planes = (pix, xs, ys, valid, soff)
    device = check_inputs(cam_params, planes, {
        "items": (baked.items, ITEM_COLS, torch.float32),
        "cluster_boxes": (baked.cluster_boxes, 8, torch.float32),
        "cluster_ranges": (baked.cluster_ranges, 2, torch.int32),
        "super_boxes": (baked.super_boxes, 8, torch.float32),
        "super_ranges": (baked.super_ranges, 2, torch.int32),
        "consts": (baked.consts.reshape(1, -1), 16, torch.float32),
    })
    if sampler not in ("random", "stratified"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if device.type == "cpu":
        return fused_render_baked_reference(
            baked, salts, cam_params, *planes, rr_start=rr_start,
            rr_floor=rr_floor, clamp=clamp, sampler=sampler)
    if device.type != "cuda":
        raise NotImplementedError(
            f"fused_render_baked runs on cpu or cuda, not {device}")
    from wavefront_path_tracer_tpu_torch.ops._build import load_library

    frame, sample_base, max_bounces, n_samples = _salts(salts)
    check_aligned(items=baked.items, cluster_boxes=baked.cluster_boxes,
                  cluster_ranges=baked.cluster_ranges,
                  super_boxes=baked.super_boxes,
                  super_ranges=baked.super_ranges, consts=baked.consts)
    lib = load_library()
    rad_r = torch.empty_like(xs)
    rad_g = torch.empty_like(xs)
    rad_b = torch.empty_like(xs)
    counts = torch.empty((3, *pix.shape), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wpt_baked_launch(
            baked.items.data_ptr(), baked.n_globals,
            baked.cluster_boxes.data_ptr(), baked.cluster_ranges.data_ptr(),
            baked.cluster_boxes.shape[0],
            baked.super_boxes.data_ptr(), baked.super_ranges.data_ptr(),
            baked.super_boxes.shape[0],
            baked.consts.data_ptr(), int(baked.culled),
            cam_params.data_ptr(), pix.data_ptr(), xs.data_ptr(),
            ys.data_ptr(), valid.data_ptr(), soff.data_ptr(),
            rad_r.data_ptr(), rad_g.data_ptr(), rad_b.data_ptr(),
            counts[0].data_ptr(), counts[1].data_ptr(), counts[2].data_ptr(),
            pix.numel(), frame, sample_base, max_bounces, n_samples,
            int(rr_start), float(rr_floor), float(clamp),
            int(sampler == "stratified"), stream)
    if rc != 0:
        raise RuntimeError(f"baked kernel launch failed: CUDA error {rc}")
    LAUNCHES["culled" if baked.culled else "unculled"] += 1
    rays, supers, clusters = counts.sum(dim=(1, 2), dtype=torch.int64)
    return rad_r, rad_g, rad_b, torch.stack([rays, rays, supers, clusters])
