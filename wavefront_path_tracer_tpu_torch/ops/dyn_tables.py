"""Host tables of the dynamic culled intersect, and their device layout.

``pack_culled_scene`` and ``_super_group`` are the port's copies of
``wavefront_path_tracer_tpu/ops/pallas_kernels.py:1534`` and ``:1490``:
numpy on the host, byte-identical to the reference's tables, ints and
flags (``tests/test_torch_dynculled.py``).  Their packed 16:16 attribute
words are int32 bit patterns stored in float32 columns, some of them NaN
patterns.

:func:`device_tables` derives the layout that the CUDA kernel
(``csrc/dynculled.cu``) and its plain version
(``ops/dynculled_kernels.py``) read: row for row the same tables, with
the packed words decoded on the host exactly as the reference's kernel
decodes them (``_unpack_albedo_mat``: ``float32(q) * float32(1/65535)``)
and the columns regrouped into float4 rows, so that no float op ever
touches a bit pattern.  Sphere rows (16 float32)::

    0-2 2c' (xyz, in the frame shifted by slab row 1), 3 kappa
    4-6 centre, 7 1/r
    8-10 albedo rgb, 11 fuzz
    12 ior, 13 mat_type, 14 image slot (-1 = none; 0 untextured), 15 0

The pair loop reads the first float4.  A textured scene's 24-column
reference table gives its columns 16-19 (checker albedo2 rgb, scale) as a
separate (N_pad, 4) table, one float4 read for the winner only, and the
scene's image LUTs come from ``ops/textures.py``.  Triangle rows are
``ops/bake.py``'s ``TRI_COLS`` layout.  NaN padding rows stay NaN in
every column, so they never win a nearest-hit compare; NaN box rows are
never entered.  The box tables (lo xyz, hi xyz, 0, 0), the slabs and the
counts are the reference's as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.bake import (
    TEX_LUT_MAX,
    TRI_COLS,
    _morton_order,
    _unpack_albedo_mat,
    on_device,
)
from wavefront_path_tracer_tpu_torch.ops.textures import ImageLuts, image_luts

_DYN_UNROLL_CLUSTERS = 64
_DYN_SUPER = 16
SPHERE_COLS = 16


def _super_group(clu_tabs, aabbs, cluster_size, ncols, hint_order):
    """Order clusters for the dynamic sweep and build its super level.

    At or below _DYN_UNROLL_CLUSTERS clusters the camera hint orders
    individual clusters (the statically unrolled sweep) and no supers
    are built.  Above it, clusters stay Morton-consecutive (spatially
    tight) inside superclusters of _DYN_SUPER, the camera hint orders
    the SUPERS front-to-back, and the cluster list is NaN-padded to a
    super multiple so the rolled sweep's dynamic indexing never leaves
    the tables (NaN AABBs compare false -> padded clusters are never
    entered).  Returns (clu_tabs, aabbs, sup_aabbs, n_supers).
    """
    n = len(clu_tabs)
    if n == 0:
        return clu_tabs, aabbs, [], 0
    if n <= _DYN_UNROLL_CLUSTERS:
        visit = hint_order(aabbs)
        return ([clu_tabs[i] for i in visit],
                [aabbs[i] for i in visit], [], 0)
    pad_tab = np.full((cluster_size, ncols), np.nan, np.float32)
    pad_box = np.full((8,), np.nan, np.float32)
    clu_tabs = list(clu_tabs)
    aabbs = list(aabbs)
    while len(clu_tabs) % _DYN_SUPER:
        clu_tabs.append(pad_tab)
        aabbs.append(pad_box)
    groups = [(clu_tabs[s:s + _DYN_SUPER], aabbs[s:s + _DYN_SUPER])
              for s in range(0, len(clu_tabs), _DYN_SUPER)]
    sup_aabbs = []
    for _tabs, boxes in groups:
        real = np.stack([b for b in boxes if not np.isnan(b[0])])
        sup_aabbs.append(np.concatenate([
            real[:, 0:3].min(axis=0), real[:, 3:6].max(axis=0),
            [0.0, 0.0]]).astype(np.float32))
    visit = hint_order(sup_aabbs)
    clu_tabs, aabbs = [], []
    for i in visit:
        clu_tabs.extend(groups[i][0])
        aabbs.extend(groups[i][1])
    return clu_tabs, aabbs, [sup_aabbs[i] for i in visit], len(groups)


def pack_culled_scene(scene_arrays, cluster_size: int = 16,
                      global_radius_factor: float = 10.0,
                      camera_hint=None, pack_attrs: bool = True):
    """Host-side tables for the dynamic culled intersector (the
    reference's ``pack_culled_scene``).

    Returns (scn (N_pad, 16) f32 NaN-padded reordered sphere table: cols
    0-2 centre, 3 radius, 4-6 albedo, 7 fuzz, 8 ior, 9 mat_type, 10
    kappa, 11 1/r, 12-14 2c', 15 NaN; (N_pad, 24) when the scene has
    textures, cols 16-18 checker albedo2 rgb and 19 checker scale (0 =
    untextured sphere), 20-23 NaN; clu (C, 8) f32 cluster AABBs [lo
    xyz, hi xyz, 0, 0]; sup (S, 8) f32 supercluster AABBs (built only
    above _DYN_UNROLL_CLUSTERS clusters; a NaN placeholder otherwise);
    slab (2, 8) f32 [row 0: cluster-slab lo xyz, hi xyz; row 1: the
    conditioning shift]; tri (T_pad, 24) f32 NaN-padded triangle table
    (v0 xyz, e1 xyz, e2 xyz, unit normal xyz, albedo rgb, fuzz, ior,
    mat_type); tri_clu (TC, 8), tri_sup (TS, 8), tri_slab (1, 8);
    n_global_blocks, n_clusters, n_supers, n_tri_clusters,
    n_tri_supers, attrs_packed).  With supers, n_clusters counts NaN
    padding up to a super multiple.

    ``attrs_packed``: with ``pack_attrs`` and every albedo in [0, 1],
    the winner (albedo rgb, material id) is packed 16:16 into two int32
    words whose bits ride the f32 table: sphere cols 4-5 and triangle
    cols 12-13.
    """
    centers = np.asarray(scene_arrays["centers"], np.float32)
    radii = np.asarray(scene_arrays["radii"], np.float32)
    albedo = np.asarray(scene_arrays["albedo"], np.float32)
    fuzz = np.asarray(scene_arrays["fuzz"], np.float32)
    refract = np.asarray(scene_arrays["refract_idx"], np.float32)
    mat = np.asarray(scene_arrays["mat_type"], np.float32)
    textured = "tex_kind" in scene_arrays
    ncols = 24 if textured else 16
    if textured:
        tex_a2 = np.asarray(scene_arrays["tex_albedo2"], np.float32)
        tex_sc = np.asarray(scene_arrays["tex_scale"], np.float32)

    def _pk_words(alb, mt_col):
        """16:16 albedo+mat words as f32 BIT patterns (see docstring)."""
        q = np.clip(np.round(alb.astype(np.float64) * 65535.0),
                    0, 65535).astype(np.int64)
        pk1 = (q[:, 0] << 16) | q[:, 1]
        pk2 = (q[:, 2] << 16) | mt_col.astype(np.int64)
        pk = np.stack([pk1, pk2], axis=1)
        pk = np.where(pk >= (1 << 31), pk - (1 << 32), pk)
        return pk.astype(np.int32).view(np.float32)

    attrs_packed = bool(pack_attrs) and bool(
        (albedo >= 0.0).all() and (albedo <= 1.0).all())
    if attrs_packed and "tri_v0" in scene_arrays \
            and scene_arrays["tri_v0"].shape[0] > 0:
        _ta = np.asarray(scene_arrays["tri_albedo"], np.float64)
        attrs_packed = bool((_ta >= 0.0).all() and (_ta <= 1.0).all())

    med_r = float(np.median(radii))
    is_global = radii > global_radius_factor * med_r
    g_idx = np.nonzero(is_global)[0]
    rest = np.nonzero(~is_global)[0]
    if rest.size <= 2 * cluster_size:
        g_idx = np.arange(centers.shape[0])
        rest = np.zeros((0,), np.int64)
    order = rest[_morton_order(centers[rest])] if rest.size else rest

    # Conditioning shift for the expanded quadratic: the per-axis median
    # of sphere centers, as in the baked bake.
    _cc = centers[rest] if rest.size else centers
    if _cc.shape[0]:
        sh = np.median(_cc.astype(np.float64), axis=0)
    else:
        sh = np.zeros(3, np.float64)

    def rows(idx, pad_to):
        n = idx.size
        out = np.full((max(pad_to, ((n + 7) // 8) * 8), ncols), np.nan,
                      np.float32)
        out[:n, 0:3] = centers[idx]
        out[:n, 3] = radii[idx]
        out[:n, 4:7] = albedo[idx]
        out[:n, 7] = fuzz[idx]
        out[:n, 8] = refract[idx]
        out[:n, 9] = mat[idx]
        # Slimmed-quadratic columns in the frame c' = c - shift: kappa =
        # |c'|^2 - r^2 in exact f64, 1/r, 2c'.  Padding rows stay NaN.
        c64 = centers[idx].astype(np.float64) - sh
        out[:n, 10] = (np.sum(c64 * c64, axis=1)
                       - radii[idx].astype(np.float64) ** 2)
        out[:n, 11] = 1.0 / radii[idx]
        out[:n, 12:15] = 2.0 * c64
        if textured:
            out[:n, 16:19] = tex_a2[idx]
            out[:n, 19] = tex_sc[idx]
        if attrs_packed:
            out[:n, 4:6] = _pk_words(albedo[idx], mat[idx])
        return out

    g_tab = rows(g_idx, 8)
    n_global_blocks = g_tab.shape[0] // 8

    def hint_order(aabbs_list):
        if camera_hint is None or not aabbs_list:
            return list(range(len(aabbs_list)))
        eye = np.asarray(camera_hint, np.float64).reshape(3)
        d = [float(np.sum((np.minimum(np.maximum(eye, a[0:3]), a[3:6])
                           - eye) ** 2)) for a in aabbs_list]
        return list(np.argsort(d))

    clu_tabs = []
    aabbs = []
    for start in range(0, order.size, cluster_size):
        idx = order[start:start + cluster_size]
        clu_tabs.append(rows(idx, cluster_size))
        # |r|: a negative (inside-out) radius spans the same box.
        lo = (centers[idx] - np.abs(radii[idx, None])).min(axis=0)
        hi = (centers[idx] + np.abs(radii[idx, None])).max(axis=0)
        aabbs.append(np.concatenate([lo, hi, [0.0, 0.0]]).astype(np.float32))
    clu_tabs, aabbs, sup_aabbs, n_supers = _super_group(
        clu_tabs, aabbs, cluster_size, ncols, hint_order)
    n_clusters = len(clu_tabs)
    scn = np.concatenate([g_tab] + clu_tabs) if clu_tabs else g_tab

    def pad8(tab):
        # NaN padding rows compare false -> never live.
        n = tab.shape[0]
        out = np.full((max(8, ((n + 7) // 8) * 8), tab.shape[1]),
                      np.nan, np.float32)
        out[:n] = tab
        return out

    clu = pad8(np.stack(aabbs) if aabbs
               else np.zeros((0, 8), np.float32))
    sup = pad8(np.stack(sup_aabbs)) if n_supers else np.full(
        (8, 8), np.nan, np.float32)
    # Row 0: cluster-slab AABB (exit cap).  Row 1: the conditioning
    # shift, read by the kernel to move ray origins into the
    # scene-centered frame.
    slab = np.zeros((2, 8), np.float32)
    slab[1, 0:3] = sh
    if order.size:
        slab[0, 0:3] = (centers[order]
                        - np.abs(radii[order, None])).min(axis=0)
        slab[0, 3:6] = (centers[order]
                        + np.abs(radii[order, None])).max(axis=0)

    # Triangles: Morton-clustered by centroid into their own tables.
    tri = np.full((8, 24), np.nan, np.float32)
    tri_clu = np.zeros((1, 8), np.float32)
    tri_sup = np.full((8, 8), np.nan, np.float32)
    tri_slab = np.zeros((1, 8), np.float32)
    n_tri_clusters = 0
    n_tri_supers = 0
    if "tri_v0" in scene_arrays and scene_arrays["tri_v0"].shape[0] > 0:
        v0 = np.asarray(scene_arrays["tri_v0"], np.float32)
        e1 = np.asarray(scene_arrays["tri_e1"], np.float32)
        e2 = np.asarray(scene_arrays["tri_e2"], np.float32)
        t_alb = np.asarray(scene_arrays["tri_albedo"], np.float32)
        t_fz = np.asarray(scene_arrays["tri_fuzz"], np.float32)
        t_io = np.asarray(scene_arrays["tri_refract"], np.float32)
        t_mt = np.asarray(scene_arrays["tri_mat_type"], np.float32)
        t_ord = _morton_order(v0 + (e1 + e2) / 3.0)
        v0, e1, e2 = v0[t_ord], e1[t_ord], e2[t_ord]
        t_alb, t_fz = t_alb[t_ord], t_fz[t_ord]
        t_io, t_mt = t_io[t_ord], t_mt[t_ord]
        nrm = np.cross(e1, e2)
        nrm = nrm / np.maximum(
            np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
        verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)   # (T, 3, 3)
        t_tabs, t_aabbs = [], []
        n_t = v0.shape[0]
        for start in range(0, n_t, cluster_size):
            idx = slice(start, min(start + cluster_size, n_t))
            tab = np.full((cluster_size, 24), np.nan, np.float32)
            m = verts[idx].shape[0]
            tab[:m, 0:3] = v0[idx]
            tab[:m, 3:6] = e1[idx]
            tab[:m, 6:9] = e2[idx]
            tab[:m, 9:12] = nrm[idx]
            tab[:m, 12:15] = t_alb[idx]
            tab[:m, 15] = t_fz[idx]
            tab[:m, 16] = t_io[idx]
            tab[:m, 17] = t_mt[idx]
            if attrs_packed:
                tab[:m, 12:14] = _pk_words(t_alb[idx], t_mt[idx])
            t_tabs.append(tab)
            lo = verts[idx].min(axis=(0, 1))
            hi = verts[idx].max(axis=(0, 1))
            t_aabbs.append(np.concatenate([lo, hi, [0.0, 0.0]])
                           .astype(np.float32))
        t_tabs, t_aabbs, t_sup_aabbs, n_tri_supers = _super_group(
            t_tabs, t_aabbs, cluster_size, 24, hint_order)
        n_tri_clusters = len(t_tabs)
        tri = np.concatenate(t_tabs)
        tri_clu = pad8(np.stack(t_aabbs))
        if n_tri_supers:
            tri_sup = pad8(np.stack(t_sup_aabbs))
        tri_slab = np.zeros((1, 8), np.float32)
        tri_slab[0, 0:3] = verts.min(axis=(0, 1))
        tri_slab[0, 3:6] = verts.max(axis=(0, 1))

    return (scn, clu, sup, slab, tri, tri_clu, tri_sup, tri_slab,
            n_global_blocks, n_clusters, n_supers,
            n_tri_clusters, n_tri_supers, attrs_packed)


def _attrs(tab, cols, b_col, mt_col, packed):
    """(rows, 4) float32 [ar, ag, ab, mt] of a reference table: decoded
    from the packed words in ``cols`` when ``packed``, else the float
    columns; NaN where the row is NaN padding."""
    if packed:
        words = np.ascontiguousarray(tab[:, cols]).view(np.int32)
        out = np.stack(_unpack_albedo_mat(words[:, 0], words[:, 1]), axis=1)
    else:
        out = np.stack([tab[:, cols[0]], tab[:, cols[1]], tab[:, b_col],
                        tab[:, mt_col]], axis=1)
    out[np.isnan(tab[:, 0])] = np.nan
    return out


def sphere_rows(scn, packed: bool, slot=None) -> np.ndarray:
    """The device layout (module docstring) of a reference sphere
    table, row for row, with the rows' image ``slot`` (a textured
    scene's) in column 14."""
    out = np.full((scn.shape[0], SPHERE_COLS), np.nan, np.float32)
    real = ~np.isnan(scn[:, 0])
    attrs = _attrs(scn, [4, 5], 6, 9, packed)
    out[:, 0:3] = scn[:, 12:15]
    out[:, 3] = scn[:, 10]
    out[:, 4:7] = scn[:, 0:3]
    out[:, 7] = scn[:, 11]
    out[:, 8:11] = attrs[:, 0:3]
    out[:, 11] = scn[:, 7]
    out[:, 12] = scn[:, 8]
    out[:, 13] = attrs[:, 3]
    out[real, 14:16] = 0.0
    if slot is not None:
        out[real, 14] = slot[real]
    return out


def row_slots(scn, scene_arrays, sphere_slot) -> np.ndarray:
    """The image slot of each row of a reference sphere table (-1: none,
    or a padding row): the slot of the image sphere whose centre and
    radius the row carries bit for bit, the last one where several do.
    The reference's kernel identifies an image sphere the same way, by
    its centre and 1/r (``_apply_image_textures``, pallas_kernels.py:
    322-325)."""
    out = np.full(scn.shape[0], -1, np.int32)
    img = np.nonzero(sphere_slot >= 0)[0]
    keys = np.concatenate([np.asarray(scene_arrays["centers"], np.float32),
                           np.asarray(scene_arrays["radii"],
                                      np.float32)[:, None]], axis=1)
    rows = np.ascontiguousarray(scn[:, 0:4]).view(np.int32)
    for i in img:
        hit = (rows == keys[i].view(np.int32)).all(axis=1)
        out[hit] = sphere_slot[i]
    return out


def triangle_rows(tri, packed: bool) -> np.ndarray:
    """The device layout (``ops/bake.py`` ``TRI_COLS``) of a reference
    triangle table, row for row."""
    out = np.full((tri.shape[0], TRI_COLS), np.nan, np.float32)
    real = ~np.isnan(tri[:, 0])
    attrs = _attrs(tri, [12, 13], 14, 17, packed)
    out[:, 0:12] = tri[:, 0:12]
    out[:, 12:15] = attrs[:, 0:3]
    out[:, 15:17] = tri[:, 15:17]
    out[:, 17] = attrs[:, 3]
    out[real, 18:20] = 0.0
    return out


@dataclasses.dataclass(frozen=True)
class DynTables:
    """The dynamic intersect's tables on one device (module docstring):
    ``spheres`` (N_pad, 16), ``boxes`` / ``super_boxes`` (C, 8) /
    (S, 8), ``slab`` (2, 8) with the shift in row 1, and the same for
    triangles (``tri_slab`` (1, 8)), plus the reference's counts.
    ``cluster_size`` rows per cluster, globals first in ``spheres``.
    ``sphere_tex`` (N_pad, 4) checker rows and ``images`` are empty
    unless ``textured``."""

    spheres: torch.Tensor
    sphere_tex: torch.Tensor
    images: ImageLuts
    boxes: torch.Tensor
    super_boxes: torch.Tensor
    slab: torch.Tensor
    triangles: torch.Tensor
    tri_boxes: torch.Tensor
    tri_super_boxes: torch.Tensor
    tri_slab: torch.Tensor
    n_globals: int          # n_global_blocks * 8 rows, padding included
    n_clusters: int
    n_supers: int
    n_tri_clusters: int
    n_tri_supers: int
    cluster_size: int
    attrs_packed: bool
    textured: bool = False

    def to(self, device) -> "DynTables":
        return on_device(self, device)


def device_tables(packed, cluster_size: int, device="cpu", scene_arrays=None,
                  lut_max: int = TEX_LUT_MAX) -> DynTables:
    """:class:`DynTables` on ``device`` from the 14 values that
    :func:`pack_culled_scene` returns for ``cluster_size``; a textured
    (24-column) table also needs the host ``scene_arrays``, for its image
    LUTs of at most ``lut_max`` texels."""
    (scn, clu, sup, slab, tri, tri_clu, tri_sup, tri_slab, ngb, ncl, nsup,
     ntc, ntsup, pkd) = packed

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    textured = scn.shape[1] >= 20
    luts, rows = ImageLuts.empty(), None
    if textured:
        luts, slot = image_luts(scene_arrays, lut_max)
        rows = row_slots(scn, scene_arrays, slot)
    return DynTables(
        spheres=t(sphere_rows(scn, pkd, rows)),
        sphere_tex=t(scn[:, 16:20] if textured else np.zeros((0, 4))),
        images=luts, textured=textured, boxes=t(clu), super_boxes=t(sup),
        slab=t(slab), triangles=t(triangle_rows(tri, pkd)),
        tri_boxes=t(tri_clu), tri_super_boxes=t(tri_sup),
        tri_slab=t(tri_slab), n_globals=ngb * 8, n_clusters=ncl,
        n_supers=nsup, n_tri_clusters=ntc, n_tri_supers=ntsup,
        cluster_size=cluster_size, attrs_packed=pkd).to(device)
