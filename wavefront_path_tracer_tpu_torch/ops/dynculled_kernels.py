"""The persistent-lane render over the dynamic culled tables: the plain
PyTorch version of the dynamic culled intersect, and the wrapper that
launches the CUDA kernel.

Port of ``wavefront_path_tracer_tpu/ops/pallas_kernels.py``:
``fused_render_dynculled`` (3211) with ``make_dynamic_culled_intersect``
(1772) as its nearest-hit function, spheres and triangles, with checker
and image textures, and ``fused_segment_dynculled`` (3027, through
``_segment_impl``, 2785), one recluster segment over the same tables.
The tables are ``ops/dyn_tables.py``'s; the kernel is
``csrc/dynculled.cu``; the persistent and segment loops, raygen, shade
and the texture step are those of ``ops/fused_kernels.py`` and
``ops/textures.py``.

What the intersect computes, per ray:

- every global sphere, unconditionally and in table order;
- then the sphere hierarchy and then the triangle hierarchy, each capped
  by the exit distance from its own slab.  At or below 64 clusters a
  hierarchy is swept flat, clusters in camera-hint order, in batches of
  16: every cluster's box cond is taken against the cap
  ``min(best_t, t_exit)`` at its batch's start.  Above 64 clusters the
  sweep is over supers of 16 clusters in hint order: a super's cond is
  taken against the running cap when the sweep reaches it, and its 16
  children's conds against the cap at its entry;
- a sphere pair is the slimmed quadratic in the shifted frame with both
  roots; a triangle pair is the two-sided Moller-Trumbore test.

The TPU kernel decided each cond by tile consensus, one batch stale;
here each ray decides against its own nearest hit.  Within a batch
(or a super) the conds are fixed, so the sequential strict ``t <
best_t`` walk of the kernel over the entered clusters in visit order
equals a masked ``argmin`` over the batch (first minimum, then strictly
better than the running best), which is how the plain version batches
it.  The two agree bit for bit, cull counters included.
"""

from __future__ import annotations

import contextlib

import torch

from wavefront_path_tracer_tpu_torch.ops import stage_probes
from wavefront_path_tracer_tpu_torch.ops.bake import TRI_COLS
from wavefront_path_tracer_tpu_torch.ops.baked_kernels import (
    SWEEP_COOP,
    SWEEP_SERIAL,
    _col,
    _take,
    box_conds,
    divergence_counts,
    fold_steps,
    segment_launch_counts,
    slab_exit,
    tri_t,
)
from wavefront_path_tracer_tpu_torch.ops.dyn_tables import (
    _DYN_SUPER,
    SPHERE_COLS,
    DynTables,
)
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

# Clusters per cond batch of the flat sweep (the reference's refresh).
REFRESH = 16

# Kernel launches on CUDA tensors by fused_render_dynculled (of which
# COOP_LAUNCHES in sweep form SWEEP_COOP), and by fused_segment_dynculled
# (one a segment; SEGMENT_COOP_LAUNCHES of them in SWEEP_COOP).
LAUNCHES = 0
COOP_LAUNCHES = 0
SEGMENT_LAUNCHES = 0
SEGMENT_COOP_LAUNCHES = 0
# Launches of the stage probes' kernels (csrc/dynculled_probe*.cu) on CUDA
# tensors, per probe name: the persistent kernel's and the segment
# kernel's (one a segment); LAUNCHES and SEGMENT_LAUNCHES do not count
# them.
PROBE_LAUNCHES = dict.fromkeys(stage_probes.KERNEL_PROBES["dynculled"], 0)
SEGMENT_PROBE_LAUNCHES = dict.fromkeys(
    stage_probes.KERNEL_PROBES["segment_dynculled"], 0)


def _winner(tab: DynTables, best_t, best_i):
    """The 15-field intersect tuple of the winners (index space: sphere
    rows, then triangle rows): (best_t, cx, cy, cz, 1/r, albedo rgb, fuzz,
    ior, mat_type, nx, ny, nz, is_tri).  A sphere winner carries zeros
    for the normal and a triangle winner the miss's sphere fields (shade
    reads one or the other); a miss carries (T_FAR, 0, 0, 0, 1, 0, 0, 0,
    0, 1, 0, 0, 0, 0, 0).  Textured tables add (albedo2 rgb, checker
    scale, image slot): a sphere winner's own, (0, 0, 0, 0, -1) for a
    triangle or a miss."""
    sph, tris = tab.spheres, tab.triangles
    n = sph.shape[0]
    hit = best_i >= 0
    is_sph = hit & (best_i < n)
    is_tri = hit & (best_i >= n)
    srow = sph[best_i.clamp(0, n - 1)]
    trow = tris[(best_i - n).clamp(0, tris.shape[0] - 1)]
    zero = torch.zeros_like(best_t)
    one = torch.ones_like(best_t)

    def pick(s, t, miss):
        return torch.where(is_sph, s, torch.where(is_tri, t, miss))

    tex = ()
    if tab.textured:
        k = best_i.clamp(0, n - 1)
        checker = torch.where(is_sph[:, None], tab.sphere_tex[k], 0.0)
        tex = (*checker.unbind(dim=1),
               torch.where(is_sph, srow[:, 14].to(torch.int64), -1))
    return (best_t,
            pick(srow[:, 4], zero, zero), pick(srow[:, 5], zero, zero),
            pick(srow[:, 6], zero, zero), pick(srow[:, 7], one, one),
            pick(srow[:, 8], trow[:, 12], zero),
            pick(srow[:, 9], trow[:, 13], zero),
            pick(srow[:, 10], trow[:, 14], zero),
            pick(srow[:, 11], trow[:, 15], zero),
            pick(srow[:, 12], trow[:, 16], one),
            pick(srow[:, 13], trow[:, 17], zero),
            torch.where(is_tri, trow[:, 9], zero),
            torch.where(is_tri, trow[:, 10], zero),
            torch.where(is_tri, trow[:, 11], zero),
            is_tri.to(torch.float32), *tex)


def dynculled_intersect_reference(tab: DynTables, ox, oy, oz, dx, dy, dz,
                                  *, probe=frozenset()):
    """Nearest hit over the dynamic tables (``make_dynamic_culled_
    intersect.intersect``, pallas_kernels.py:1983-2408; the sweep rules
    are the module docstring's).  Returns the 15-field winner tuple and
    the per-ray supers and clusters entered (int64).

    ``probe`` (names of ``ops/stage_probes.py``) duplicates a stage as
    the kernel's probes do (``csrc/dynculled.cuh`` DynIntersect):
    ``dyn_dbl_global`` sweeps the globals a second time and
    ``dyn_dbl_entry`` folds every entered cluster in a second time, from
    |o'|^2 (spheres) or the origin (triangles) plus 0, which never wins
    under the strict ``<``; ``dyn_dbl_cond`` takes every cluster and
    super cond a second time from the origin and the cap plus 0, ANDed."""
    shx, shy, shz = tab.slab[1, 0], tab.slab[1, 1], tab.slab[1, 2]
    oxp = ox - shx
    oyp = oy - shy
    ozp = oz - shz
    quad = (oxp, oyp, ozp, 0.5 * dx, 0.5 * dy, 0.5 * dz,
            dx * oxp + dy * oyp + dz * ozp,
            oxp * oxp + oyp * oyp + ozp * ozp)
    # The probes' second inputs: |o'|^2 plus 0, the origin plus 0.
    quad2 = quad[:7] + (quad[7] + 0.0,)
    dup_entry = "dyn_dbl_entry" in probe
    dup_cond = "dyn_dbl_cond" in probe

    def sphere_t(rows, oxp, oyp, ozp, hdx, hdy, hdz, dd_o, oo2):
        # sphere_block (1854-1864): both roots; NaN from a negative disc
        # or a padding row falls through to T_FAR.
        c2x, c2y, c2z, kappa = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
        nb = (_col(hdx) * c2x + _col(hdy) * c2y + _col(hdz) * c2z) \
            - _col(dd_o)
        c_q = (_col(oo2) + kappa) - (_col(oxp) * c2x + _col(oyp) * c2y
                                     + _col(ozp) * c2z)
        disc = nb * nb - c_q
        sq = torch.sqrt(disc)
        t1 = nb - sq
        t2 = nb + sq
        return torch.where(t1 > T_MIN, t1,
                           torch.where(t2 > T_MIN, t2, T_FAR))

    best_t = torch.full_like(ox, T_FAR)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    zeros = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    supers, clusters = zeros, zeros
    best_t, best_i = _take(sphere_t(tab.spheres[:tab.n_globals], *quad), 0,
                           best_t, best_i)
    if "dyn_dbl_global" in probe:
        best_t, best_i = _take(sphere_t(tab.spheres[:tab.n_globals], *quad2),
                               0, best_t, best_i)
    if tab.n_clusters == 0 and tab.n_tri_clusters == 0:
        return _winner(tab, best_t, best_i) + (supers, clusters)

    rays = (ox, oy, oz, dx, dy, dz)
    rays2 = (ox + 0.0,) + rays[1:]
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    cs = tab.cluster_size

    def conds(lo, hi, r, cap):
        """The conds of boxes ``lo``/``hi`` for the rays ``r`` (indices,
        or a slice) against their caps ``cap``; with dyn_dbl_cond, ANDed
        with their second evaluation (origin and cap plus 0)."""
        ok, entry = box_conds(lo, hi, ox[r], oy[r], oz[r], inv[0][r],
                              inv[1][r], inv[2][r])
        enter = ok & (entry < _col(cap))
        if dup_cond:
            ok2, entry2 = box_conds(lo, hi, ox[r] + 0.0, oy[r] + 0.0,
                                    oz[r] + 0.0, inv[0][r], inv[1][r],
                                    inv[2][r])
            enter = enter & ok2 & (entry2 < _col(cap + 0.0))
        return enter

    def box_cond(box, cap):
        """cluster_cond (2156-2157) of one box for every ray (a ray on a
        face plane of the box enters: ``baked_kernels.box_conds``)."""
        if dup_cond:
            return conds(box[0:3], box[3:6], slice(None), cap)[:, 0]
        ok, entry = box_conds(box[0:3], box[3:6], ox, oy, oz, *inv)
        return ok[:, 0] & (entry[:, 0] < cap)

    def batch(k0, k1, boxes, table, row0, offset, t_fn, ray_args, cap,
              rows_of, ray_args2):
        """Enter the clusters k0..k1-1 of a hierarchy where their conds
        hold against ``cap`` (per ray, for the rays ``rows_of``) and fold
        their items in (with dyn_dbl_entry a second time, from
        ``ray_args2``): returns the entered (rays x clusters) mask."""
        nonlocal best_t, best_i
        r = rows_of
        box = boxes[k0:k1]
        if dup_cond:
            enter = conds(box[:, 0:3], box[:, 3:6], r, cap[r])
        else:
            ok, entry = box_conds(box[:, 0:3], box[:, 3:6], ox[r], oy[r],
                                  oz[r], inv[0][r], inv[1][r], inv[2][r])
            enter = ok & (entry < _col(cap[r]))
        any_in = enter.any(dim=1)
        rr = r[any_in]
        if rr.numel():
            rows = table[row0 + k0 * cs:row0 + k1 * cs]
            mask = enter[any_in].repeat_interleave(cs, dim=1)
            for args in (ray_args, ray_args2) if dup_entry else (ray_args,):
                t = t_fn(rows, *(v[rr] for v in args))
                t = torch.where(mask, t, T_FAR)
                bt, bi = _take(t, offset + row0 + k0 * cs, best_t[rr],
                               best_i[rr])
                best_t = best_t.index_put((rr,), bt)
                best_i = best_i.index_put((rr,), bi)
        return enter

    def hierarchy(n, n_sup, boxes, sboxes, slab, table, row0, offset,
                  t_fn, ray_args, ray_args2):
        nonlocal supers, clusters
        t_exit = slab_exit(slab[0:3], slab[3:6], ox, oy, oz, *inv)
        everyone = torch.arange(ox.shape[0], device=ox.device)
        if not n_sup:
            for k0 in range(0, n, REFRESH):
                k1 = min(n, k0 + REFRESH)
                cap = torch.minimum(best_t, t_exit)
                enter = batch(k0, k1, boxes, table, row0, offset, t_fn,
                              ray_args, cap, everyone, ray_args2)
                clusters = clusters + enter.sum(dim=1)
            return
        for s in range(n_sup):
            cap = torch.minimum(best_t, t_exit)
            s_enter = box_cond(sboxes[s], cap)
            supers = supers + s_enter
            r = torch.nonzero(s_enter)[:, 0]
            if r.numel():
                k0 = s * _DYN_SUPER
                enter = batch(k0, k0 + _DYN_SUPER, boxes, table, row0,
                              offset, t_fn, ray_args, cap, r, ray_args2)
                clusters = clusters.index_add(0, r, enter.sum(dim=1))

    if tab.n_clusters:
        hierarchy(tab.n_clusters, tab.n_supers, tab.boxes, tab.super_boxes,
                  tab.slab[0], tab.spheres, tab.n_globals, 0, sphere_t, quad,
                  quad2)
    if tab.n_tri_clusters:
        hierarchy(tab.n_tri_clusters, tab.n_tri_supers, tab.tri_boxes,
                  tab.tri_super_boxes, tab.tri_slab[0], tab.triangles, 0,
                  tab.spheres.shape[0], tri_t, rays, rays2)
    return _winner(tab, best_t, best_i) + (supers, clusters)


def fused_render_dynculled_reference(
        tab: DynTables, salts, cam_params, pix, xs, ys, valid, soff, *,
        rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random", probe=frozenset(),
        lane_counts: bool = False):
    """Plain PyTorch version of the dynamic culled kernel: the
    persistent loop of ``ops/fused_kernels.py`` over
    :func:`dynculled_intersect_reference`.  Same arguments and results
    as :func:`fused_render_dynculled` (``probe``: the loop's probes and
    the intersect's)."""
    probe = stage_probes.probe_names(probe)

    def intersect(ox, oy, oz, dx, dy, dz):
        return dynculled_intersect_reference(tab, ox, oy, oz, dx, dy, dz,
                                             probe=probe)

    return persistent_reference(
        intersect, salts, cam_params, pix, xs, ys, valid, soff,
        rr_start=rr_start, rr_floor=rr_floor, clamp=clamp, sampler=sampler,
        images=tab.images if tab.textured else None, probe=probe,
        lane_counts=lane_counts)


class _NonzeroSpy:
    """The module's ``torch`` during :func:`warp_divergence`: ``real``,
    with ``nonzero`` also calling ``seen(x, result)`` (the rolled sweep's
    rays that entered a super)."""

    def __init__(self, real, seen):
        self._real, self._seen = real, seen

    def __getattr__(self, name):
        return getattr(self._real, name)

    def nonzero(self, x, *args, **kwargs):
        out = self._real.nonzero(x, *args, **kwargs)
        self._seen(x, out)
        return out


def _columns(tab: DynTables) -> tuple[list, list]:
    """The cluster columns and the super columns of each hierarchy of
    the tables (spheres, triangles) in a divergence count: its box rows
    and its supers, or none where it has no clusters."""
    levels = ((tab.boxes, tab.n_clusters, tab.n_supers),
              (tab.tri_boxes, tab.n_tri_clusters, tab.n_tri_supers))
    return ([boxes.shape[0] if n else 0 for boxes, n, _ in levels],
            [n_sup if n else 0 for _, n, n_sup in levels])


@contextlib.contextmanager
def _entry_spy(tab: DynTables):
    """A spy on :func:`dynculled_intersect_reference`, while the block
    runs: it records the clusters each ray entered (its batches' conds,
    read where the plain version reads them: ``box_conds`` and then
    ``_col`` of the cap) and the supers (the rays that ``nonzero`` is
    given).  Clusters are numbered by box row, the triangle hierarchy's
    after the spheres'; every cluster has ``cluster_size`` items.  Yields
    (intersect, drain): ``intersect(keys, ox, oy, oz, dx, dy, dz)`` is the
    plain intersect, its rays' entries recorded under the trip ``keys``;
    ``drain()`` returns the (keys, entered clusters, entered supers)
    recorded since its last call.  The plain version's results are not
    changed; the spy is removed on exit."""
    levels = [(tab.boxes, tab.slab, tab.n_clusters, tab.n_supers),
              (tab.tri_boxes, tab.tri_slab, tab.n_tri_clusters,
               tab.n_tri_supers)]
    n_cols, n_sups = _columns(tab)
    col0, sup0 = [0, n_cols[0]], [0, n_sups[0]]
    device = tab.spheres.device
    keys, entered, entered_sup = [], [], []
    cur = {"level": 0, "super": 0, "rows": None, "conds": None}
    col, conds_of, exit_of = _col, box_conds, slab_exit

    def level_of(t, which):
        ptr = t.untyped_storage().data_ptr()
        return next(k for k, lv in enumerate(levels)
                    if lv[2] and lv[which].untyped_storage().data_ptr() == ptr)

    def spy_slab_exit(lo, hi, *rays):
        cur.update(level=level_of(lo, 1), super=0, rows=None)
        return exit_of(lo, hi, *rays)

    def seen_super(s_enter, nonzero):
        lv = cur["level"]
        cur["rows"] = nonzero[:, 0]
        col = sup0[lv] + cur["super"]
        entered_sup[-1][:, col] |= s_enter
        cur["super"] += 1

    def spy_box_conds(lo, hi, *rays):
        ok, entry = conds_of(lo, hi, *rays)
        if lo.dim() == 2:               # a batch's clusters
            lv = level_of(lo, 0)
            boxes = levels[lv][0]
            k0 = (lo.storage_offset() - boxes.storage_offset()) \
                // boxes.stride(0)
            cur["conds"] = (lv, k0, ok, entry)
        return ok, entry

    def spy_col(v):
        pending, cur["conds"] = cur["conds"], None
        if pending is not None:         # the batch's cap: its conds
            lv, k0, ok, entry = pending
            enter = ok & (entry < col(v))
            c0 = col0[lv] + k0
            cols = slice(c0, c0 + enter.shape[1])
            if levels[lv][3]:
                rows = cur["rows"]
                entered[-1][rows, cols] = entered[-1][rows, cols] | enter
            else:
                entered[-1][:, cols] |= enter
        return col(v)

    def intersect(ray_keys, ox, oy, oz, dx, dy, dz):
        n = ox.shape[0]
        entered.append(torch.zeros((n, sum(n_cols)), dtype=torch.bool,
                                   device=device))
        entered_sup.append(torch.zeros((n, sum(n_sups)), dtype=torch.bool,
                                       device=device))
        out = dynculled_intersect_reference(tab, ox, oy, oz, dx, dy, dz)
        keys.append(ray_keys)
        return out

    def drain():
        out = (torch.cat([torch.zeros(0, dtype=torch.int64, device=device)]
                         + keys),
               *(torch.cat([torch.zeros((0, m), dtype=torch.bool,
                                        device=device)] + parts)
                 for m, parts in ((sum(n_cols), entered),
                                  (sum(n_sups), entered_sup))))
        for parts in (keys, entered, entered_sup):
            parts.clear()
        return out

    module = globals()
    saved = {k: module[k] for k in ("box_conds", "_col", "slab_exit",
                                    "torch")}
    module.update(box_conds=spy_box_conds, _col=spy_col,
                  slab_exit=spy_slab_exit,
                  torch=_NonzeroSpy(torch, seen_super))
    try:
        yield intersect, drain
    finally:
        module.update(saved)


def _with_supers(tab: DynTables, keys, entered, entered_sup,
                 warp: int) -> dict:
    """``divergence_counts`` of the clusters, and of the rolled sweeps'
    super boxes: ``super_boxes_per_ray`` (every ray tests each super box
    of a rolled hierarchy), ``supers_per_ray`` (entered) and
    ``union_supers_per_trip`` (the supers whose children a warp trip
    walks)."""
    n_cols, n_sups = _columns(tab)
    counts = divergence_counts(keys, entered,
                               [tab.cluster_size] * sum(n_cols), warp)
    sup = divergence_counts(keys, entered_sup, [1] * sum(n_sups), warp)
    return {**counts, "super_boxes_per_ray": sum(n_sups),
            "supers_per_ray": sup["clusters_per_ray"],
            "union_supers_per_trip": sup["union_clusters_per_trip"]}


def warp_divergence(tab: DynTables, salts, cam_params, pix, xs, ys, valid,
                    soff, *, rr_start: int = 0, rr_floor: float = 0.05,
                    clamp: float = 0.0, sampler: str = "random",
                    warp: int = WARP) -> dict:
    """``baked_kernels.divergence_counts`` of the dynamic culled
    persistent loop over the given lane planes (a warp is ``warp``
    consecutive lanes of them), from the plain version:
    :func:`fused_render_dynculled_reference`'s loop over
    :func:`_entry_spy`'s intersect, each ray keyed by its lane's warp and
    its ordinal among its lane's rays; with the super counts of
    :func:`_with_supers`.  The plain version's results are not
    changed."""
    ordinal = torch.zeros(pix.numel(), dtype=torch.int64, device=pix.device)
    _, _, max_bounces, n_samples = _salts(salts)
    max_rays = max(max_bounces * n_samples, 1)
    seen = {}
    with _entry_spy(tab) as (spied, drain):
        def intersect(ox, oy, oz, dx, dy, dz):
            lanes = seen["lanes"]
            out = spied(lanes // warp * max_rays + ordinal[lanes], ox, oy,
                        oz, dx, dy, dz)
            ordinal[lanes] += 1
            return out

        persistent_reference(
            intersect, salts, cam_params, pix, xs, ys, valid, soff,
            rr_start=rr_start, rr_floor=rr_floor, clamp=clamp,
            sampler=sampler, images=tab.images if tab.textured else None,
            observe=lambda lanes: seen.update(lanes=lanes))
        recorded = drain()
    return _with_supers(tab, *recorded, warp)


def segment_divergence(tab: DynTables, run, *, warp: int = WARP,
                       group: int = 8, t_max: int = 12) -> list[dict]:
    """``baked_kernels.segment_launch_counts`` of the dynamic culled
    segments: :func:`_with_supers` and ``fold_steps`` (the sweep form
    ``Sweep<group, t_max>``) of each launch's trips."""
    sizes = [tab.cluster_size] * sum(_columns(tab)[0])

    def summarize(keys, entered, entered_sup):
        return {**_with_supers(tab, keys, entered, entered_sup, warp),
                **fold_steps(keys, entered, sizes, group, t_max, warp)}

    return segment_launch_counts(
        _entry_spy(tab), run, summarize,
        images=tab.images if tab.textured else None, warp=warp)


def _tables(tab: DynTables) -> dict:
    """The tables as check_inputs takes them."""
    images = tab.images
    return {
        "spheres": (tab.spheres, SPHERE_COLS, torch.float32),
        "boxes": (tab.boxes, 8, torch.float32),
        "super_boxes": (tab.super_boxes, 8, torch.float32),
        "slab": (tab.slab, 8, torch.float32),
        "triangles": (tab.triangles, TRI_COLS, torch.float32),
        "tri_boxes": (tab.tri_boxes, 8, torch.float32),
        "tri_super_boxes": (tab.tri_super_boxes, 8, torch.float32),
        "tri_slab": (tab.tri_slab, 8, torch.float32),
        "sphere_tex": (tab.sphere_tex, 4, torch.float32),
        "image centres": (images.centres, 4, torch.float32),
        "image words": (images.words, images.words.shape[1], torch.int32),
    }


def _table_args(tab: DynTables) -> tuple:
    """The table arguments of both C entry points, checked for
    alignment."""
    images = tab.images
    tables = (tab.spheres, tab.boxes, tab.super_boxes, tab.slab,
              tab.triangles, tab.tri_boxes, tab.tri_super_boxes,
              tab.tri_slab)
    check_aligned(**{f"table {i}": t for i, t in enumerate(
        tables + (tab.sphere_tex, images.centres, images.words))})
    if tab.textured and tab.sphere_tex.shape[0] != tab.spheres.shape[0]:
        raise ValueError("textured tables need one sphere_tex row per "
                         "sphere row")
    return (*(t.data_ptr() for t in tables),
            tab.n_globals, tab.n_clusters, tab.n_supers, tab.n_tri_clusters,
            tab.n_tri_supers, tab.cluster_size,
            tab.sphere_tex.data_ptr(), images.centres.data_ptr(),
            images.words.data_ptr(), images.h, images.w, int(tab.textured))


def fused_render_dynculled(
        tab: DynTables, salts, cam_params, pix, xs, ys, valid, soff, *,
        rr_start: int = 0, rr_floor: float = 0.05, clamp: float = 0.0,
        sampler: str = "random", sweep: int = SWEEP_COOP, probe=frozenset(),
        lane_counts: bool = False):
    """All samples x all bounces of every lane over the dynamic culled
    tables.

    Returns (rad_r, rad_g, rad_b, stats): radiance sums as (R, 128)
    float32 planes in lane order, and an int64 tensor [rays, iterations,
    supers entered, clusters entered]: ``iterations`` counts loop trips
    per warp (``ops/fused_kernels.py`` :func:`warp_trips`: a warp of 32
    lanes where the TPU kernel's lockstep tile held 1024), and a ray
    entering a cluster adds one.

    ``sweep`` picks the kernel's sweep form (:data:`SWEEP_COOP`, the warp's
    lanes in step with a vote per cluster, or :data:`SWEEP_SERIAL`, the
    per-thread sweep); both give the same results.

    ``probe`` (one name of ``ops/stage_probes.py``, as a name or a
    collection of one; empty: none) launches that differential stage
    probe's kernel (``csrc/dynculled_probe*.cu``: raygen, shade, accum,
    loopcond, dyn entry, dyn cond and dyn global), in the shipped sweep
    form only.  Its results equal the unprobed kernel's (``dbl_accum``:
    up to rounding) and its plain version's bit for bit.  Any other name
    or form raises ValueError.

    With ``lane_counts`` a fifth value follows: the counters the kernel
    keeps a lane, [rays, supers, clusters] as a (3, R, 128) int64 tensor.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/dynculled.cu`` on the current stream; any other device raises.
    The kernel's results, counters included, are bit-identical to the
    plain version's.
    """
    global LAUNCHES, COOP_LAUNCHES
    planes = (pix, xs, ys, valid, soff)
    device = check_inputs(cam_params, planes, _tables(tab))
    if sampler not in ("random", "stratified"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if sweep not in (SWEEP_SERIAL, SWEEP_COOP):
        raise ValueError(f"unknown sweep form {sweep}")
    probe = stage_probes.probe_names(probe)
    bits = stage_probes.probe_bits(probe, "dynculled")
    if bits and sweep != SWEEP_COOP:
        raise ValueError("a stage probe runs in the shipped form only "
                         "(sweep SWEEP_COOP)")
    if device.type == "cpu":
        return fused_render_dynculled_reference(
            tab, salts, cam_params, *planes, rr_start=rr_start,
            rr_floor=rr_floor, clamp=clamp, sampler=sampler, probe=probe,
            lane_counts=lane_counts)
    if device.type != "cuda":
        raise NotImplementedError(
            f"fused_render_dynculled runs on cpu or cuda, not {device}")
    from wavefront_path_tracer_tpu_torch.ops._build import (
        load_library, load_probe_library)

    frame, sample_base, max_bounces, n_samples = _salts(salts)
    table_args = _table_args(tab)
    lib = load_library()
    if bits:
        load_probe_library()
    rad_r = torch.empty_like(xs)
    rad_g = torch.empty_like(xs)
    rad_b = torch.empty_like(xs)
    counts = torch.empty((3, *pix.shape), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wpt_dynculled_launch(
            *table_args, int(sweep), bits,
            cam_params.data_ptr(), pix.data_ptr(), xs.data_ptr(),
            ys.data_ptr(), valid.data_ptr(), soff.data_ptr(),
            rad_r.data_ptr(), rad_g.data_ptr(), rad_b.data_ptr(),
            counts[0].data_ptr(), counts[1].data_ptr(), counts[2].data_ptr(),
            pix.numel(), frame, sample_base, max_bounces, n_samples,
            int(rr_start), float(rr_floor), float(clamp),
            int(sampler == "stratified"), stream)
    if rc != 0:
        raise RuntimeError(f"dynculled kernel launch failed (sweep {sweep}, "
                           f"probe {sorted(probe)}): CUDA error {rc}")
    if bits:
        PROBE_LAUNCHES[next(iter(probe))] += 1
    else:
        LAUNCHES += 1
        COOP_LAUNCHES += sweep == SWEEP_COOP
    rays, supers, clusters = counts.sum(dim=(1, 2), dtype=torch.int64)
    stats = torch.stack([rays, warp_trips(counts[0]), supers, clusters])
    if lane_counts:
        return rad_r, rad_g, rad_b, stats, counts.to(torch.int64)
    return rad_r, rad_g, rad_b, stats


def fused_segment_dynculled_reference(tab: DynTables, salts, ids, state,
                                      counts, *, rr_start: int = 0,
                                      rr_floor: float = 0.05,
                                      clamp: float = 0.0, probe=frozenset()):
    """Plain PyTorch version of the dynamic culled segment kernel: the
    :func:`segment_reference` loop over
    :func:`dynculled_intersect_reference` (with the intersect's
    ``probe``).  Same arguments and results as
    :func:`fused_segment_dynculled`."""
    probe = stage_probes.probe_names(probe)

    def intersect(ox, oy, oz, dx, dy, dz):
        return dynculled_intersect_reference(tab, ox, oy, oz, dx, dy, dz,
                                             probe=probe)

    return segment_reference(
        intersect, salts, ids, state, counts, rr_start=rr_start,
        rr_floor=rr_floor, clamp=clamp,
        images=tab.images if tab.textured else None)


def fused_segment_dynculled(tab: DynTables, salts, ids, state, counts, *,
                            rr_start: int = 0, rr_floor: float = 0.05,
                            clamp: float = 0.0, sweep: int = SWEEP_COOP,
                            probe=frozenset()):
    """One recluster segment over the dynamic culled tables (the
    reference's ``fused_segment_dynculled``): at most ``k_iters`` bounces
    of every live lane, from and back into ``state`` (SEG_STATE, N)
    float32 and ``ids`` (SEG_IDS, N) int32 (``ops/fused_kernels.py``),
    updated in place; ``counts`` (SEG_COUNTS, N) int32 gains each lane's
    rays, supers and clusters entered, and each warp's loop trips in the
    launch (``ops/fused_kernels.py`` :func:`segment_reference`).
    ``salts`` are [frame, max_bounces, k_iters, 0].  Returns (ids, state,
    counts).

    ``sweep`` picks the kernel's form (:data:`SWEEP_COOP`, the warp's
    lanes in step with a vote per cluster, or :data:`SWEEP_SERIAL`, each
    lane on its own thread with the serial fold); both give the same
    results, row 3's trips included.

    ``probe`` (one name of ``ops/stage_probes.py``; empty: none) launches
    that stage probe's segment kernel (``csrc/dynculled_probe_seg*.cu``:
    the intersect's dyn entry, dyn cond and dyn global), in the shipped
    form; the loop's probes raise ValueError.  Its results equal the
    unprobed kernel's and its plain version's bit for bit.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/dynculled.cu``'s segment kernel on the current stream; any
    other device raises.  The kernel's results, counters included, are
    bit-identical to the plain version's.
    """
    global SEGMENT_LAUNCHES, SEGMENT_COOP_LAUNCHES
    device = check_segment(ids, state, counts, _tables(tab))
    if sweep not in (SWEEP_SERIAL, SWEEP_COOP):
        raise ValueError(f"unknown sweep form {sweep}")
    probe = stage_probes.probe_names(probe)
    bits = stage_probes.probe_bits(probe, "segment_dynculled")
    if bits and sweep != SWEEP_COOP:
        raise ValueError("a stage probe runs in the shipped form only "
                         "(sweep SWEEP_COOP)")
    if device.type == "cpu":
        return fused_segment_dynculled_reference(
            tab, salts, ids, state, counts, rr_start=rr_start,
            rr_floor=rr_floor, clamp=clamp, probe=probe)
    if device.type != "cuda":
        raise NotImplementedError(
            f"fused_segment_dynculled runs on cpu or cuda, not {device}")
    from wavefront_path_tracer_tpu_torch.ops._build import (
        load_library, load_probe_library)

    frame, max_bounces, k_iters, _ = _salts(salts)
    table_args = _table_args(tab)
    lib = load_library()
    if bits:
        load_probe_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wpt_dynculled_segment_launch(
            *table_args, int(sweep), bits, state.data_ptr(), ids.data_ptr(),
            counts.data_ptr(), state.shape[1], frame, max_bounces, k_iters,
            int(rr_start), float(rr_floor), float(clamp), stream)
    if rc != 0:
        raise RuntimeError(f"dynculled segment kernel launch failed (sweep "
                           f"{sweep}, probe {sorted(probe)}): CUDA error "
                           f"{rc}")
    if bits:
        SEGMENT_PROBE_LAUNCHES[next(iter(probe))] += 1
    else:
        SEGMENT_LAUNCHES += 1
        SEGMENT_COOP_LAUNCHES += sweep == SWEEP_COOP
    return ids, state, counts
