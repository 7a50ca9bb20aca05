"""The persistent-lane render over a baked scene: the plain PyTorch
versions of the two baked intersects, and the wrapper that launches the
CUDA kernel.

Port of ``wavefront_path_tracer_tpu/ops/pallas_kernels.py``:
``fused_render_baked`` (3157) with ``baked_intersect`` (612, the
unculled sweep) or ``baked_culled_intersect`` (831, Morton clusters under
box conds), spheres and triangles (two-sided Moller-Trumbore, after the
spheres), checker and image textures, and the culled sweep's winner
hint.  The tables come from ``ops/bake.py``; the kernel is
``csrc/baked.cu``; the persistent loop, raygen, shade and the texture
step are those of ``ops/fused_kernels.py`` and ``ops/textures.py``.
``fused_segment_baked`` (2997, through ``_segment_impl``, 2785) runs one
recluster segment over the same tables (the same kernel file, its
segment instantiations).

Culling is decided per ray, against the ray's own current nearest hit
(the TPU kernel decided per 1024-lane tile, by consensus, with a cap one
batch stale).  The winner hint is per ray too: the ray's lane keeps the
cluster of its previous winner, the culled sweep tests that cluster
first (a cluster entered) and passes it over in the main sweep.  The
plain version makes the same per-ray decisions in the same order as the
kernel, so the two agree bit for bit, cull counters included.
"""

from __future__ import annotations

import contextlib

import torch

from wavefront_path_tracer_tpu_torch.ops.bake import (
    ITEM_COLS,
    TRI_COLS,
    BakedScene,
)
from wavefront_path_tracer_tpu_torch.ops import stage_probes
from wavefront_path_tracer_tpu_torch.ops.fused_kernels import (
    T_FAR,
    T_MIN,
    WARP,
    _salts,
    check_aligned,
    check_inputs,
    check_segment,
    persistent_reference,
    segment_reference,
    warp_trips,
)

_ITEM_BLOCK = 64

# Kernel launches on CUDA tensors, per intersect: fused_render_baked's,
# and fused_segment_baked's (one a segment).  COOP_LAUNCHES counts those
# of them in the shipped form SWEEP_COOP.
LAUNCHES = {"culled": 0, "unculled": 0, "segment_culled": 0,
            "segment_unculled": 0}
COOP_LAUNCHES = {"culled": 0, "unculled": 0, "segment_culled": 0,
                 "segment_unculled": 0}
# Launches of the stage probes' kernels (csrc/baked_probe*.cu) on CUDA
# tensors, per kernel and probe name (the segment kernels' one a
# segment); LAUNCHES does not count them.
PROBE_LAUNCHES = {kind: dict.fromkeys(stage_probes.KERNEL_PROBES[kind], 0)
                  for kind in ("culled", "culled_hint", "unculled",
                               "segment_culled")}

_MISS = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)

# The kernel's sweep forms (csrc/baked.cu launch_sweep and launch), all
# with the plain version's results.  Culled: SWEEP_SERIAL tests every
# entered cluster on its own thread (the lanes of a warp at unrelated
# points); SWEEP_COOP, the default, votes per cluster, and where few lanes
# of the warp enter it their rays share the warp's lanes.  Unculled:
# SWEEP_SERIAL runs each lane's samples and bounces on its own thread
# (common.cuh trace_lane); SWEEP_COOP, the default, runs the warp's lanes
# in step (trace_warp), each trip sweeping the whole table together, the
# triangle rows staged a warp at a time in shared memory.  A segment
# (fused_segment_baked) takes the same forms: SWEEP_SERIAL each lane on its
# own thread (trace_segment), SWEEP_COOP the warp's lanes in step
# (trace_segment_warp) with the culled vote or the staged rows.
SWEEP_SERIAL, SWEEP_COOP = 0, 1


def _col(v):
    return v[:, None]


def _winner(baked: BakedScene, best_t, best_i):
    """The intersect tuple of the winners' rows: (best_t, cx, cy, cz,
    1/r sign, albedo rgb, fuzz, ior, mat_type); a miss carries
    (T_FAR, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0).  With triangles the index
    space runs on past the spheres into the triangle table, and the
    tuple gains (nx, ny, nz, is_tri): a triangle winner carries its
    normal and a sphere winner zeros (shade reads one or the other).  A
    textured bake always has those four and then (albedo2 rgb, checker
    scale, image slot): a sphere winner's own, and (0, 0, 0, 0, -1) for a
    triangle or a miss."""
    items = baked.items
    tris = baked.tri_items if baked.n_triangles else None
    fields = _winner_rows(items, best_t, best_i, tris)
    if not baked.textured:
        return fields
    n = items.shape[0]
    if tris is None:
        zero = torch.zeros_like(best_t)
        fields = fields + (zero, zero, zero, zero)
    sph = (best_i >= 0) & (best_i < n)
    k = best_i.clamp(0, max(n - 1, 0))
    checker = torch.where(sph[:, None], baked.tex_items[k], 0.0)
    slot = torch.where(sph, items[k, 18].to(torch.int64), -1)
    return fields + (*checker.unbind(dim=1), slot)


def _winner_rows(items, best_t, best_i, tris=None):
    n = items.shape[0]
    hit = best_i >= 0
    miss = torch.tensor(_MISS, dtype=torch.float32, device=items.device)
    sph = best_i < n
    row = items[best_i.clamp(0, max(n - 1, 0))] if n else None
    # Columns of ops/bake.py's item table, in the tuple's order.
    row = (row[:, [8, 9, 10, 16, 12, 13, 14, 15, 11, 17]] if n
           else miss.expand(best_i.shape[0], -1))
    row = torch.where((hit & sph)[:, None], row, miss)
    if tris is None:
        return (best_t, *row.unbind(dim=1))
    is_tri = hit & ~sph
    trow = tris[(best_i - n).clamp(0, max(tris.shape[0] - 1, 0))]
    # (albedo rgb, fuzz, ior, mat_type) into the tuple's slots 5-10.
    tattr = trow[:, [12, 13, 14, 15, 16, 17]]
    row = torch.cat([row[:, :4], torch.where(is_tri[:, None], tattr,
                                             row[:, 4:])], dim=1)
    nrm = torch.where(is_tri[:, None], trow[:, 9:12], 0.0)
    return (best_t, *row.unbind(dim=1), *nrm.unbind(dim=1),
            is_tri.to(torch.float32))


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


def tri_t(tris, ox, oy, oz, dx, dy, dz):
    """Per-triangle ``t`` (rays x triangles) of the two-sided
    Moller-Trumbore test over ``TRI_COLS`` rows (``tri_tests``,
    pallas_kernels.py:1191-1210, in its order of operations): ``T_FAR``
    where |det| <= 1e-9, the barycentrics leave the triangle or ``t`` <=
    T_MIN.  A NaN padding row gives ``T_FAR``."""
    v0x, v0y, v0z = tris[:, 0], tris[:, 1], tris[:, 2]
    e1x, e1y, e1z = tris[:, 3], tris[:, 4], tris[:, 5]
    e2x, e2y, e2z = tris[:, 6], tris[:, 7], tris[:, 8]
    dx, dy, dz = _col(dx), _col(dy), _col(dz)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > 1e-9
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx = _col(ox) - v0x
    tvy = _col(oy) - v0y
    tvz = _col(oz) - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > T_MIN)
    return torch.where(valid, tt, T_FAR)


def take_subset(t_fn, rows, offset, best_t, best_i, enter, rays):
    """Fold the items ``rows`` into the running nearest hit of the rays
    where ``enter`` holds, computing ``t_fn(rows, *rays)`` for those rays
    only (elementwise, so the values are those of a full pass)."""
    r = torch.nonzero(enter)[:, 0]
    if r.numel():
        t = t_fn(rows, *(v[r] for v in rays))
        bt, bi = _take(t, offset, best_t[r], best_i[r])
        best_t = best_t.index_put((r,), bt)
        best_i = best_i.index_put((r,), bi)
    return best_t, best_i


def baked_intersect_reference(baked: BakedScene, ox, oy, oz, dx, dy, dz):
    """Nearest hit over an unculled bake (``baked_intersect.intersect``,
    pallas_kernels.py:672-797): the generic quadratic with ``inv_a`` and
    the ``disc >= 0`` select, far root elided per sphere, then the
    triangles, all in scene order.  Returns the winner tuple and (None,
    None) for the cull counters."""
    items, tris = baked.items, baked.tri_items
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
    for lo in range(0, tris.shape[0], _ITEM_BLOCK):
        t = tri_t(tris[lo:lo + _ITEM_BLOCK], ox, oy, oz, dx, dy, dz)
        best_t, best_i = _take(t, items.shape[0] + lo, best_t, best_i)
    return _winner(baked, best_t, best_i) + (None, None)


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


def on_face(lo, hi, ox, oy, oz, idx, idy, idz):
    """Rays parallel to an axis (1/d infinite) whose origin lies on a
    box's face plane on that axis, shaped as :func:`_box_range`'s
    results: their slab term (lo - o) * inf is NaN (``common.cuh
    on_face``).  NaN padding boxes compare false."""
    face = None
    for a, o, inv in ((0, ox, idx), (1, oy, idy), (2, oz, idz)):
        on = torch.isinf(_col(inv)) & ((lo[..., a] == _col(o))
                                       | (hi[..., a] == _col(o)))
        face = on if face is None else face | on
    return face


def box_conds(lo, hi, ox, oy, oz, idx, idy, idz):
    """(ok, entry) of each ray against boxes: the ray enters a box where
    ok and entry < its cap.  A cond made NaN by a ray on a face plane
    enters whatever the cap (ok, entry -inf), as ``common.cuh
    box_enters``: a per-ray cull must not drop the hits on the face that
    the unculled intersect finds."""
    c_min, c_max = _box_range(lo, hi, ox, oy, oz, idx, idy, idz)
    ok = (c_min <= c_max) & (c_max > T_MIN)
    entry = torch.clamp_min(c_min, 0.0)
    nan = torch.isnan(c_min)
    face = nan & on_face(lo, hi, ox, oy, oz, idx, idy, idz)
    return (torch.where(nan, face, ok),
            torch.where(face, -torch.inf, entry))


def slab_exit(lo, hi, ox, oy, oz, idx, idy, idz):
    """``slab_exit`` (pallas_kernels.py:1261-1267): the exit distance
    from the box that holds a hierarchy, which bounds every hit inside
    it; -1 for a ray that misses the box, T_FAR (no bound) for a ray on
    one of its face planes."""
    s_min, s_max = _box_range(lo, hi, ox, oy, oz, idx, idy, idz)
    s_min, s_max = s_min[:, 0], s_max[:, 0]
    exit_t = torch.where((s_min <= s_max) & (s_max > T_MIN), s_max, -1.0)
    face = on_face(lo, hi, ox, oy, oz, idx, idy, idz)[:, 0]
    return torch.where(torch.isnan(s_min), torch.where(face, T_FAR, -1.0),
                       exit_t)


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
                               *, ranges=None, hint=None, probe=frozenset()):
    """Nearest hit over a culled bake (``baked_culled_intersect.intersect``,
    pallas_kernels.py:1063-1466): globals first, then the sphere
    clusters and then the triangle clusters (each hierarchy under supers
    when its sweep is two-level) whose box cond holds for the ray against
    its own current nearest hit.  Returns the winner tuple and the
    per-ray supers and clusters entered (int64).

    With ``hint`` (int64 per ray: a cluster in sweep order, the triangle
    clusters numbered after the spheres', or -1) the winner hint runs
    (pallas_kernels.py:1330-1367): after the globals each ray tests its
    hinted cluster unconditionally, counted as entered, and the main
    sweep passes that cluster over; the tuple then gains, before the
    counters, each ray's winner cluster (-1 for a global win or a miss).

    ``ranges`` is :func:`host_ranges` of the bake; it is read from the
    tables when not given.

    ``probe`` (names of ``ops/stage_probes.py``) duplicates a stage as
    the kernel's probes do (``csrc/baked.cuh`` CulledIntersect):
    ``dbl_entry`` folds every entered cluster in a second time, from
    |o'|^2 (spheres) or the origin (triangles) plus 0, which never wins
    under the strict ``<``; ``dbl_entry2`` folds every entered sphere
    cluster in a second time from the origin plus 0, its shifted frame
    recomputed (triangle clusters once); ``dbl_cond`` takes every cluster
    and super cond a second time from the origin and the cap plus 0,
    ANDed; ``dbl_cond2`` every cluster cond a second time from the box's
    corners plus 0, ANDed; ``hint_count`` (with ``hint``) adds each
    prepass entry to the supers count too."""
    if ranges is None:
        ranges = host_ranges(baked)
    items, consts = baked.items, baked.consts
    tris = baked.tri_items if baked.n_triangles else None
    best_c = (torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
              if hint is not None else None)
    oxp = ox - consts[0]
    oyp = oy - consts[1]
    ozp = oz - consts[2]
    dd_o = dx * oxp + dy * oyp + dz * ozp
    oo2 = oxp * oxp + oyp * oyp + ozp * ozp
    t_sph = _slim_t(items, oxp, oyp, ozp, dd_o, oo2, dx, dy, dz)
    dup_entry = "dbl_entry" in probe
    dup_entry2 = "dbl_entry2" in probe
    dup_cond = "dbl_cond" in probe
    dup_cond2 = "dbl_cond2" in probe

    best_t = torch.full_like(ox, T_FAR)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    zeros = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    supers, clusters = zeros, zeros
    if baked.n_globals:
        best_t, best_i = _take(t_sph[:, :baked.n_globals], 0, best_t, best_i)
    keep = (best_c,) if hint is not None else ()
    if not (ranges[0][0] or ranges[1][0]):
        return _winner(baked, best_t, best_i) + keep + (supers, clusters)

    rays = (ox, oy, oz, dx, dy, dz)
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    everyone = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
    if dup_entry:
        t_sph2 = _slim_t(items, oxp, oyp, ozp, dd_o, oo2 + 0.0, dx, dy, dz)
        rays2 = (ox + 0.0, oy, oz, dx, dy, dz)
    if dup_entry2:
        # The shifted frame from the origin plus 0 (sphere_tests' per-ray
        # terms, recomputed).
        oxp2 = (ox + 0.0) - consts[0]
        oyp2 = (oy + 0.0) - consts[1]
        ozp2 = (oz + 0.0) - consts[2]
        t_sph3 = _slim_t(items, oxp2, oyp2, ozp2,
                         dx * oxp2 + dy * oyp2 + dz * ozp2,
                         oxp2 * oxp2 + oyp2 * oyp2 + ozp2 * ozp2, dx, dy, dz)

    def conds(boxes):
        return box_conds(boxes[:, 0:3], boxes[:, 4:7], ox, oy, oz, *inv)

    def conds2(boxes):
        return box_conds(boxes[:, 0:3], boxes[:, 4:7], ox + 0.0, oy + 0.0,
                         oz + 0.0, *inv)

    def conds3(boxes):
        return box_conds(boxes[:, 0:3] + 0.0, boxes[:, 4:7] + 0.0, ox, oy,
                         oz, *inv)

    def enters(ok, entry, ok2, entry2, k, cap, shifted=None):
        """The cond of box ``k`` against ``cap``; with dbl_cond, ANDed
        with its second evaluation; with ``shifted`` (dbl_cond2's (ok,
        entry) of the shifted boxes), ANDed with that too."""
        enter = ok[:, k] & (entry[:, k] < cap)
        if dup_cond:
            enter = enter & ok2[:, k] & (entry2[:, k] < cap + 0.0)
        if shifted is not None:
            enter = enter & shifted[0][:, k] & (shifted[1][:, k] < cap)
        return enter

    def fold_cluster(cid, fold, first, count, enter):
        """Fold one cluster in for the rays ``enter``; with a hint, a ray
        whose winner changed now has its winner in cluster ``cid``."""
        nonlocal best_t, best_i, best_c
        before = best_i
        best_t, best_i = fold(first, count, enter, best_t, best_i)
        if hint is not None:
            best_c = torch.where(best_i != before, cid, best_c)

    def hierarchy(boxes, sboxes, cranges, sranges, slab, fold, id0):
        nonlocal supers, clusters
        t_exit = slab_exit(slab[0:3], slab[3:6], ox, oy, oz, *inv)
        c_ok, c_entry = conds(boxes)
        c_ok2, c_entry2 = conds2(boxes) if dup_cond else (None, None)
        c_shifted = conds3(boxes) if dup_cond2 else None

        def sweep(c, gate):
            nonlocal clusters
            enter = gate & enters(c_ok, c_entry, c_ok2, c_entry2, c,
                                  torch.minimum(best_t, t_exit), c_shifted)
            if hint is not None:
                enter = enter & (hint != id0 + c)
            clusters = clusters + enter
            fold_cluster(id0 + c, fold, *cranges[c], enter)

        if sranges:
            s_ok, s_entry = conds(sboxes)
            s_ok2, s_entry2 = conds2(sboxes) if dup_cond else (None, None)
            for s, (first, count) in enumerate(sranges):
                enter = enters(s_ok, s_entry, s_ok2, s_entry2, s,
                               torch.minimum(best_t, t_exit))
                supers = supers + enter
                for c in range(first, first + count):
                    sweep(c, enter)
        else:
            for c in range(len(cranges)):
                sweep(c, everyone)

    def fold_spheres(first, count, enter, best_t, best_i):
        best_t, best_i = _take(t_sph[:, first:first + count], first, best_t,
                               best_i, enter)
        if dup_entry:
            best_t, best_i = _take(t_sph2[:, first:first + count], first,
                                   best_t, best_i, enter)
        if dup_entry2:
            best_t, best_i = _take(t_sph3[:, first:first + count], first,
                                   best_t, best_i, enter)
        return best_t, best_i

    def fold_triangles(first, count, enter, best_t, best_i):
        best_t, best_i = take_subset(tri_t, tris[first:first + count],
                                     items.shape[0] + first, best_t, best_i,
                                     enter, rays)
        if dup_entry:
            best_t, best_i = take_subset(tri_t, tris[first:first + count],
                                         items.shape[0] + first, best_t,
                                         best_i, enter, rays2)
        return best_t, best_i

    (cranges, sranges), (tcranges, tsranges) = ranges
    n_sph = len(cranges)
    if hint is not None:
        # The prepass: each ray's hinted cluster, whatever its box says.
        for cid in torch.unique(hint[hint >= 0]).tolist():
            m = hint == cid
            clusters = clusters + m
            if "hint_count" in probe:
                supers = supers + m
            if cid < n_sph:
                fold_cluster(cid, fold_spheres, *cranges[cid], m)
            else:
                fold_cluster(cid, fold_triangles, *tcranges[cid - n_sph], m)
    if cranges:
        hierarchy(baked.cluster_boxes, baked.super_boxes, cranges, sranges,
                  consts[3:9], fold_spheres, 0)
    if tcranges:
        hierarchy(baked.tri_cluster_boxes, baked.tri_super_boxes, tcranges,
                  tsranges, consts[9:15], fold_triangles, n_sph)
    keep = (best_c,) if hint is not None else ()
    return _winner(baked, best_t, best_i) + keep + (supers, clusters)


def host_ranges(baked: BakedScene):
    """((cluster ranges, super ranges) of the spheres, the same of the
    triangles) of a bake as lists of (first, count), for the plain
    version's Python loops."""
    return tuple((c.cpu().tolist(), s.cpu().tolist())
                 for c, s in ((baked.cluster_ranges, baked.super_ranges),
                              (baked.tri_cluster_ranges,
                               baked.tri_super_ranges)))


def fused_render_baked_reference(
        baked: BakedScene, salts, cam_params, pix, xs, ys, valid, soff, *,
        rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random", probe=frozenset(),
        lane_counts: bool = False):
    """Plain PyTorch version of the baked kernel: the persistent loop of
    ``ops/fused_kernels.py`` over :func:`culled_intersect_reference` (with
    the winner hint where ``baked.winner_hint``) or
    :func:`baked_intersect_reference`, as ``baked.culled`` says, with the
    texture step for a textured bake.  Same arguments and results as
    :func:`fused_render_baked` (``probe``: the loop's probes and the
    culled intersect's)."""
    probe = stage_probes.probe_names(probe)
    if baked.culled:
        ranges = host_ranges(baked)

        def intersect(ox, oy, oz, dx, dy, dz, hint=None):
            return culled_intersect_reference(baked, ox, oy, oz, dx, dy, dz,
                                              ranges=ranges, hint=hint,
                                              probe=probe)
    else:
        def intersect(ox, oy, oz, dx, dy, dz):
            return baked_intersect_reference(baked, ox, oy, oz, dx, dy, dz)

    return persistent_reference(
        intersect, salts, cam_params, pix, xs, ys, valid, soff,
        rr_start=rr_start, rr_floor=rr_floor, clamp=clamp, sampler=sampler,
        images=baked.images if baked.textured else None,
        hinted=baked.culled and baked.winner_hint, probe=probe,
        lane_counts=lane_counts)


def _lanes_in(keys, entered):
    """(trips, C) int64: how many lanes of each warp trip (the distinct
    ``keys``, in their order) entered each cluster."""
    _, trip = torch.unique(keys, return_inverse=True)
    n_trips = int(trip.max()) + 1 if trip.numel() else 0
    lanes_in = torch.zeros((n_trips, entered.shape[1]), dtype=torch.int64,
                           device=entered.device)
    lanes_in.index_add_(0, trip, entered.to(torch.int64))
    return lanes_in


def divergence_counts(keys, entered, sizes, warp: int = WARP) -> dict:
    """How the lanes of a warp diverge over a culled sweep's clusters.

    ``keys`` (R,) int64 names each ray's warp trip (one key per (warp,
    ordinal): trip k of a warp runs the k-th ray of each of its lanes),
    ``entered`` (R, C) bool the clusters each ray entered, ``sizes`` (C,)
    the clusters' item counts.  A trip runs the union of its lanes'
    clusters, and each of those clusters' pair tests on all ``warp``
    lanes.  Returns the rays, the trips, the warps' fullness (rays / (warp
    x trips)), clusters entered per ray, union clusters per trip, the
    issued and useful lane-pairs of the clusters and the useful share, and
    ``entering_lanes``: for n = 1 .. warp, how many (trip, cluster) pairs
    that some lane entered had n lanes entering."""
    sizes = torch.as_tensor(sizes, dtype=torch.int64, device=entered.device)
    lanes_in = _lanes_in(keys, entered)
    n_trips = lanes_in.shape[0]
    union = lanes_in > 0
    issued = int((union.to(torch.int64) * sizes).sum()) * warp
    useful = int((lanes_in * sizes).sum())
    hist = torch.bincount(lanes_in[union], minlength=warp + 1)[1:]
    rays = int(keys.numel())
    return {"rays": rays, "trips": n_trips,
            "warp_fullness": rays / max(warp * n_trips, 1),
            "clusters_per_ray": int(entered.sum()) / max(rays, 1),
            "union_clusters_per_trip": int(union.sum()) / max(n_trips, 1),
            "issued_pairs": issued, "useful_pairs": useful,
            "useful_share": useful / max(issued, 1),
            "entering_lanes": hist.tolist()}


def fold_steps(keys, entered, sizes, group: int = 8, t_max: int = 12,
               warp: int = WARP) -> dict:
    """The pair steps of the warp (one step: a pair test on every lane)
    that the two sweep forms spend on the clusters entered in the trips
    ``keys`` (:func:`divergence_counts`'s arguments).  The per-thread
    sweep runs every cluster that some lane of the trip entered once over
    its items (``serial_steps``: the union of the lanes' folds).  The
    shipped form (``common.cuh`` ``Sweep<group, t_max>``) votes: a cluster
    that at most ``t_max`` lanes entered takes the cooperative fold, in
    ``coop_passes`` passes of ``warp / group`` rays, each of ``ceil(size /
    group)`` steps; one that more entered, the serial fold
    (``coop_steps``, the passes' shuffles not counted); ``reach`` is the
    share of the entered (trip, cluster) pairs that take the cooperative
    fold."""
    sizes = torch.as_tensor(sizes, dtype=torch.int64, device=entered.device)
    lanes_in = _lanes_in(keys, entered)
    union = lanes_in > 0
    coop = union & (lanes_in <= t_max)
    rays_a_pass = warp // group
    passes = torch.where(coop, -(-lanes_in // rays_a_pass), 0)
    steps = torch.where(coop, passes * -(-sizes // group),
                        torch.where(union, sizes, 0))
    return {"serial_steps": int((union * sizes).sum()),
            "coop_steps": int(steps.sum()),
            "coop_passes": int(passes.sum()),
            "reach": int(coop.sum()) / max(int(union.sum()), 1)}


def cluster_sizes(baked: BakedScene) -> list[int]:
    """The item counts of a culled bake's clusters in sweep order, the
    triangle hierarchy's after the spheres'."""
    if not baked.culled:
        raise ValueError("a divergence count needs a culled bake")
    (cranges, _), (tcranges, _) = host_ranges(baked)
    return [n for _, n in cranges] + [n for _, n in tcranges]


@contextlib.contextmanager
def _entry_spy(baked: BakedScene):
    """A spy on the culled plain version, while the block runs: it records
    the clusters each ray entered (the masks of its folds, read through
    ``_take`` and ``take_subset``; a winner-hint prepass counts as an
    entry, as in the kernel).  Yields (intersect, drain):
    ``intersect(keys, ox, oy, oz, dx, dy, dz, hint=None)`` is
    :func:`culled_intersect_reference`, its rays' entries recorded under
    the trip ``keys`` (clusters numbered as :func:`cluster_sizes` lists
    them); ``drain()`` returns the (keys, entered) recorded since its last
    call.  The plain version's results are not changed; the spy is
    removed on exit."""
    ranges = host_ranges(baked)
    (cranges, _), (tcranges, _) = ranges
    n_items, n_sph = baked.items.shape[0], len(cranges)
    cluster_of = {first: c for c, (first, _) in enumerate(cranges)}
    cluster_of.update({n_items + first: n_sph + c
                       for c, (first, _) in enumerate(tcranges)})
    sizes = cluster_sizes(baked)
    device = baked.items.device
    keys, entered, rows = [], [], []
    take, subset = _take, take_subset

    def spy_take(t, offset, best_t, best_i, mask=None):
        if mask is not None:
            rows[0][:, cluster_of[offset]] |= mask
        return take(t, offset, best_t, best_i, mask)

    def spy_subset(t_fn, items, offset, best_t, best_i, enter, rays):
        rows[0][:, cluster_of[offset]] |= enter
        return subset(t_fn, items, offset, best_t, best_i, enter, rays)

    def intersect(ray_keys, ox, oy, oz, dx, dy, dz, hint=None):
        rows[:] = [torch.zeros((ox.shape[0], len(sizes)), dtype=torch.bool,
                               device=device)]
        out = culled_intersect_reference(baked, ox, oy, oz, dx, dy, dz,
                                         ranges=ranges, hint=hint)
        keys.append(ray_keys)
        entered.append(rows[0])
        return out

    def drain():
        out = (torch.cat([torch.zeros(0, dtype=torch.int64, device=device)]
                         + keys),
               torch.cat([torch.zeros((0, len(sizes)), dtype=torch.bool,
                                      device=device)] + entered))
        keys.clear()
        entered.clear()
        return out

    module = globals()
    module["_take"], module["take_subset"] = spy_take, spy_subset
    try:
        yield intersect, drain
    finally:
        module["_take"], module["take_subset"] = take, subset


def warp_divergence(baked: BakedScene, salts, cam_params, pix, xs, ys,
                    valid, soff, *, rr_start: int = 0,
                    rr_floor: float = 0.05, clamp: float = 0.0,
                    sampler: str = "random", warp: int = WARP) -> dict:
    """:func:`divergence_counts` of a culled bake's persistent loop over
    the given lane planes (a warp is ``warp`` consecutive lanes of them),
    from the plain version: :func:`fused_render_baked_reference`'s loop
    over :func:`_entry_spy`'s intersect, each ray keyed by its lane's warp
    and its ordinal among its lane's rays.  The plain version's results
    are not changed."""
    ordinal = torch.zeros(pix.numel(), dtype=torch.int64, device=pix.device)
    _, _, max_bounces, n_samples = _salts(salts)
    max_rays = max(max_bounces * n_samples, 1)
    seen = {}
    sizes = cluster_sizes(baked)
    with _entry_spy(baked) as (spied, drain):
        def intersect(ox, oy, oz, dx, dy, dz, hint=None):
            lanes = seen["lanes"]
            out = spied(lanes // warp * max_rays + ordinal[lanes], ox, oy,
                        oz, dx, dy, dz, hint=hint)
            ordinal[lanes] += 1
            return out

        persistent_reference(
            intersect, salts, cam_params, pix, xs, ys, valid, soff,
            rr_start=rr_start, rr_floor=rr_floor, clamp=clamp,
            sampler=sampler,
            images=baked.images if baked.textured else None,
            hinted=baked.winner_hint,
            observe=lambda lanes: seen.update(lanes=lanes))
        keys, entered = drain()
    return divergence_counts(keys, entered, sizes, warp)


def segment_launch_counts(spy, run, summarize, *, images=None,
                          warp: int = WARP) -> list[dict]:
    """Per segment launch, how the warps of a culled segment kernel
    diverge, counted from its plain version.  ``spy`` is a module's entry
    spy (:func:`_entry_spy`, or ``dynculled_kernels``'); ``run(segment)``
    runs a segmented render (``models/fused.py`` ``_recluster``) with
    ``segment`` as its segment function, which runs
    :func:`segment_reference` over the spy's intersect.  In a launch the
    warp's lanes run in step (``common.cuh`` trace_segment_warp): trip k of
    warp w runs the k-th ray of each lane of lanes w * warp .. w * warp +
    warp - 1 still live, and the lanes live at a trip are those whose
    alive word is set when the intersect is called.  Returns one dict a
    launch, in issue order: its index, ``k_iters``, the lanes live at its
    start, and ``summarize(keys, *recorded)`` of its trips (the spy's
    drain)."""
    out = []
    with spy as (spied, drain):
        def segment(tables, salts, ids, state, counts, *, rr_start=0,
                    rr_floor=0.05, clamp=0.0):
            k_iters = _salts(salts)[2]
            trip = [0]

            def intersect(ox, oy, oz, dx, dy, dz):
                lanes = torch.nonzero(state[12] > 0)[:, 0]
                res = spied(lanes // warp * (k_iters + 1) + trip[0], ox, oy,
                            oz, dx, dy, dz)
                trip[0] += 1
                return res

            live = int((state[12] > 0).sum())
            segment_reference(intersect, salts, ids, state, counts,
                              rr_start=rr_start, rr_floor=rr_floor,
                              clamp=clamp, images=images)
            out.append({"launch": len(out), "k_iters": k_iters,
                        "live_lanes": live, **summarize(*drain())})
            return ids, state, counts

        run(segment)
    return out


def segment_divergence(baked: BakedScene, run, *, warp: int = WARP,
                       group: int = 8, t_max: int = 12) -> list[dict]:
    """:func:`segment_launch_counts` of a culled bake's segments:
    :func:`divergence_counts` and :func:`fold_steps` (the sweep form
    ``Sweep<group, t_max>``) of each launch's trips."""
    sizes = cluster_sizes(baked)

    def summarize(keys, entered):
        return {**divergence_counts(keys, entered, sizes, warp),
                **fold_steps(keys, entered, sizes, group, t_max, warp)}

    return segment_launch_counts(
        _entry_spy(baked), run, summarize,
        images=baked.images if baked.textured else None, warp=warp)


def _tables(baked: BakedScene) -> dict:
    """The bake's device tables as check_inputs takes them."""
    return {
        "items": (baked.items, ITEM_COLS, torch.float32),
        "cluster_boxes": (baked.cluster_boxes, 8, torch.float32),
        "cluster_ranges": (baked.cluster_ranges, 2, torch.int32),
        "super_boxes": (baked.super_boxes, 8, torch.float32),
        "super_ranges": (baked.super_ranges, 2, torch.int32),
        "tri_items": (baked.tri_items, TRI_COLS, torch.float32),
        "tri_cluster_boxes": (baked.tri_cluster_boxes, 8, torch.float32),
        "tri_cluster_ranges": (baked.tri_cluster_ranges, 2, torch.int32),
        "tri_super_boxes": (baked.tri_super_boxes, 8, torch.float32),
        "tri_super_ranges": (baked.tri_super_ranges, 2, torch.int32),
        "consts": (baked.consts.reshape(1, -1), 16, torch.float32),
        "tex_items": (baked.tex_items, 4, torch.float32),
        "image centres": (baked.images.centres, 4, torch.float32),
        "image words": (baked.images.words, baked.images.words.shape[1],
                        torch.int32),
    }


def _table_args(baked: BakedScene) -> tuple:
    """The table arguments of both C entry points, checked for alignment:
    everything before ``textured``."""
    images = baked.images
    tables = (baked.items, baked.cluster_boxes, baked.cluster_ranges,
              baked.super_boxes, baked.super_ranges, baked.tri_items,
              baked.tri_cluster_boxes, baked.tri_cluster_ranges,
              baked.tri_super_boxes, baked.tri_super_ranges, baked.consts,
              baked.tex_items, images.centres, images.words)
    check_aligned(**{f"table {i}": t for i, t in enumerate(tables)})
    if baked.textured and baked.tex_items.shape[0] != baked.n_items:
        raise ValueError("a textured bake needs one tex_items row per item")
    return (baked.items.data_ptr(), baked.n_globals,
            baked.cluster_boxes.data_ptr(), baked.cluster_ranges.data_ptr(),
            baked.cluster_boxes.shape[0],
            baked.super_boxes.data_ptr(), baked.super_ranges.data_ptr(),
            baked.super_boxes.shape[0],
            baked.tri_items.data_ptr(), baked.n_triangles,
            baked.tri_cluster_boxes.data_ptr(),
            baked.tri_cluster_ranges.data_ptr(),
            baked.tri_cluster_boxes.shape[0],
            baked.tri_super_boxes.data_ptr(),
            baked.tri_super_ranges.data_ptr(),
            baked.tri_super_boxes.shape[0],
            baked.consts.data_ptr(), int(baked.culled),
            baked.tex_items.data_ptr(), images.centres.data_ptr(),
            images.words.data_ptr(), images.h, images.w)


def fused_render_baked(
        baked: BakedScene, salts, cam_params, pix, xs, ys, valid, soff, *,
        rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random", sweep: int = SWEEP_COOP, probe=frozenset(),
        lane_counts: bool = False):
    """All samples x all bounces of every lane over a baked scene.

    Returns (rad_r, rad_g, rad_b, stats): radiance sums as (R, 128)
    float32 planes in lane order, and an int64 tensor [rays, iterations,
    supers entered, clusters entered].  ``iterations`` counts loop trips
    per warp (``ops/fused_kernels.py`` :func:`warp_trips`: a warp of 32
    lanes where the TPU kernel's lockstep tile held 1024).  The cull
    counters count per-ray entries (a ray entering
    a cluster adds one, and so does a winner-hint prepass), not the TPU
    kernel's per-tile consensus entries; they are zero for an unculled
    bake.

    ``sweep`` picks the kernel's form (:data:`SWEEP_COOP` or
    :data:`SWEEP_SERIAL`): for a culled bake the sweep's, for an unculled
    one the loop's (the warp's lanes in step, or each on its own thread);
    both give the same results.

    ``probe`` (one name of ``ops/stage_probes.py``, as a name or a
    collection of one; empty: none) launches that differential stage
    probe's kernel (``csrc/baked_probe*.cu``): the culled kernel has
    raygen, shade, accum, loopcond, entry, cond, entry2 and cond2, the
    unculled one the first four, in the shipped form only; a culled bake
    with the winner hint has ``hint_count`` alone.  Its results equal the
    unprobed kernel's (``dbl_accum``: up to rounding; ``hint_count``:
    supers higher by the prepass entries) and its plain version's bit for
    bit.  Any other name, form or hint raises ValueError.

    With ``lane_counts`` a fifth value follows: the counters the kernel
    keeps a lane, [rays, supers, clusters] as a (3, R, 128) int64 tensor
    (``probes/cullstats.py`` reads them a warp at a time).

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/baked.cu`` on the current stream; any other device raises.
    The kernel's results, counters included, are bit-identical to the
    plain version's.
    """
    planes = (pix, xs, ys, valid, soff)
    device = check_inputs(cam_params, planes, _tables(baked))
    if sampler not in ("random", "stratified"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if sweep not in (SWEEP_SERIAL, SWEEP_COOP):
        raise ValueError(f"unknown sweep form {sweep}")
    kind = "culled" if baked.culled else "unculled"
    probe = stage_probes.probe_names(probe)
    probe_kind = ("culled_hint" if baked.culled and baked.winner_hint
                  else kind)
    bits = stage_probes.probe_bits(probe, probe_kind)
    if bits and sweep != SWEEP_COOP:
        raise ValueError("a stage probe runs in the shipped form only "
                         "(sweep SWEEP_COOP)")
    if device.type == "cpu":
        return fused_render_baked_reference(
            baked, salts, cam_params, *planes, rr_start=rr_start,
            rr_floor=rr_floor, clamp=clamp, sampler=sampler, probe=probe,
            lane_counts=lane_counts)
    if device.type != "cuda":
        raise NotImplementedError(
            f"fused_render_baked runs on cpu or cuda, not {device}")
    from wavefront_path_tracer_tpu_torch.ops._build import (
        load_library, load_probe_library)

    frame, sample_base, max_bounces, n_samples = _salts(salts)
    tables = _table_args(baked)
    lib = load_library()
    if bits:
        load_probe_library()
    rad_r = torch.empty_like(xs)
    rad_g = torch.empty_like(xs)
    rad_b = torch.empty_like(xs)
    counts = torch.empty((3, *pix.shape), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wpt_baked_launch(
            *tables,
            int(baked.textured), int(baked.culled and baked.winner_hint),
            int(sweep), bits, cam_params.data_ptr(), pix.data_ptr(),
            xs.data_ptr(),
            ys.data_ptr(), valid.data_ptr(), soff.data_ptr(),
            rad_r.data_ptr(), rad_g.data_ptr(), rad_b.data_ptr(),
            counts[0].data_ptr(), counts[1].data_ptr(), counts[2].data_ptr(),
            pix.numel(), frame, sample_base, max_bounces, n_samples,
            int(rr_start), float(rr_floor), float(clamp),
            int(sampler == "stratified"), stream)
    if rc != 0:
        raise RuntimeError(f"baked kernel launch failed (sweep {sweep}, "
                           f"probe {sorted(probe)}): CUDA error {rc}")
    if bits:
        PROBE_LAUNCHES[probe_kind][next(iter(probe))] += 1
    else:
        LAUNCHES[kind] += 1
        COOP_LAUNCHES[kind] += sweep == SWEEP_COOP
    rays, supers, clusters = counts.sum(dim=(1, 2), dtype=torch.int64)
    stats = torch.stack([rays, warp_trips(counts[0]), supers, clusters])
    if lane_counts:
        return rad_r, rad_g, rad_b, stats, counts.to(torch.int64)
    return rad_r, rad_g, rad_b, stats


def fused_segment_baked_reference(baked: BakedScene, salts, ids, state,
                                  counts, *, rr_start: int = 0,
                                  rr_floor: float = 0.05, clamp: float = 0.0,
                                  probe=frozenset()):
    """Plain PyTorch version of the baked segment kernel: the
    :func:`segment_reference` loop over :func:`culled_intersect_reference`
    (with the intersect's ``probe``) or :func:`baked_intersect_reference`,
    as ``baked.culled`` says, with the texture step for a textured bake.
    Same arguments and results as :func:`fused_segment_baked`."""
    probe = stage_probes.probe_names(probe)
    if baked.culled:
        ranges = host_ranges(baked)

        def intersect(ox, oy, oz, dx, dy, dz):
            return culled_intersect_reference(baked, ox, oy, oz, dx, dy, dz,
                                              ranges=ranges, probe=probe)
    else:
        def intersect(ox, oy, oz, dx, dy, dz):
            return baked_intersect_reference(baked, ox, oy, oz, dx, dy, dz)

    return segment_reference(
        intersect, salts, ids, state, counts, rr_start=rr_start,
        rr_floor=rr_floor, clamp=clamp,
        images=baked.images if baked.textured else None)


def fused_segment_baked(baked: BakedScene, salts, ids, state, counts, *,
                        rr_start: int = 0, rr_floor: float = 0.05,
                        clamp: float = 0.0, sweep: int = SWEEP_COOP,
                        probe=frozenset()):
    """One recluster segment over a baked scene (the reference's
    ``fused_segment_baked``): at most ``k_iters`` bounces of every live
    lane, from and back into ``state`` (SEG_STATE, N) float32 and ``ids``
    (SEG_IDS, N) int32 (``ops/fused_kernels.py``), updated in place;
    ``counts`` (SEG_COUNTS, N) int32 gains each lane's rays, supers and
    clusters entered, and each warp's loop trips in the launch
    (``ops/fused_kernels.py`` :func:`segment_reference`).  ``salts`` are [frame, max_bounces, k_iters, 0].  Returns
    (ids, state, counts).  A bake with the winner hint is refused: the
    reference's ``RenderConfig`` keeps recluster and the hint apart.

    ``sweep`` picks the kernel's form (:data:`SWEEP_COOP`, the warp's
    lanes in step, or :data:`SWEEP_SERIAL`, each lane on its own thread);
    both give the same results, row 3's trips included.

    ``probe`` (one name of ``ops/stage_probes.py``; empty: none) launches
    that stage probe's segment kernel (``csrc/baked_probe_seg*.cu``): the
    culled intersect's entry, cond, entry2 and cond2, in the shipped form;
    the loop's probes and any probe of the unculled segment raise
    ValueError.  Its results equal the unprobed kernel's and its plain
    version's bit for bit.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/baked.cu``'s segment kernel on the current stream; any other
    device raises.  The kernel's results, counters included, are
    bit-identical to the plain version's.
    """
    device = check_segment(ids, state, counts, _tables(baked))
    if baked.culled and baked.winner_hint:
        raise ValueError("a segment runs no winner hint (recluster and "
                         "winner_hint exclude each other)")
    if sweep not in (SWEEP_SERIAL, SWEEP_COOP):
        raise ValueError(f"unknown sweep form {sweep}")
    kind = "segment_culled" if baked.culled else "segment_unculled"
    probe = stage_probes.probe_names(probe)
    bits = stage_probes.probe_bits(probe, kind)
    if bits and sweep != SWEEP_COOP:
        raise ValueError("a stage probe runs in the shipped form only "
                         "(sweep SWEEP_COOP)")
    if device.type == "cpu":
        return fused_segment_baked_reference(
            baked, salts, ids, state, counts, rr_start=rr_start,
            rr_floor=rr_floor, clamp=clamp, probe=probe)
    if device.type != "cuda":
        raise NotImplementedError(
            f"fused_segment_baked runs on cpu or cuda, not {device}")
    from wavefront_path_tracer_tpu_torch.ops._build import (
        load_library, load_probe_library)

    frame, max_bounces, k_iters, _ = _salts(salts)
    table_args = _table_args(baked)
    lib = load_library()
    if bits:
        load_probe_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wpt_baked_segment_launch(
            *table_args, int(baked.textured), int(sweep), bits,
            state.data_ptr(),
            ids.data_ptr(), counts.data_ptr(), state.shape[1], frame,
            max_bounces, k_iters, int(rr_start), float(rr_floor),
            float(clamp), stream)
    if rc != 0:
        raise RuntimeError(f"baked segment kernel launch failed (sweep "
                           f"{sweep}, probe {sorted(probe)}): CUDA error "
                           f"{rc}")
    if bits:
        PROBE_LAUNCHES[kind][next(iter(probe))] += 1
    else:
        LAUNCHES[kind] += 1
        COOP_LAUNCHES[kind] += sweep == SWEEP_COOP
    return ids, state, counts
