"""Host bake of a scene (spheres and triangles) for the baked intersects.

Port of the bake halves of ``wavefront_path_tracer_tpu/ops/pallas_kernels.py``:
the attribute pack rule (``_pack_albedo_mat`` and friends, 374-458),
``_t2_elidable`` (532), ``_morton_order`` (811), and what
``baked_intersect`` (612) and ``baked_culled_intersect`` (831) compute at
bake time.  The TPU kernel closed over these values as vector immediates;
here they become device tables (:class:`BakedScene`) that the CUDA kernel
(``csrc/baked.cu``) and its plain version (``ops/baked_kernels.py``) sweep.
Everything here is numpy and runs once per scene, camera hint and
cluster size.

The item table holds 20 float32 columns per sphere, in visit order::

    0-3   culled: c' = c - shift (xyz), kappa = |c'|^2 - r^2
          unculled: centre (xyz), r * r
    4-7   far-root elision flag (1 = elided); culled: 2c' (xyz), which
          the reference folded into its constants; unculled: 0
    8-11  world centre (xyz), ior
    12-15 albedo rgb (decoded from the pack where it applies), fuzz
    16-19 1/r sign (the true 1/r in a scene with image textures),
          mat_type, image slot (-1 = none; 0 in an untextured bake), 0

The pair loop reads columns 0-7 only; the rest is read for the winner.
A textured bake (the scene has ``tex_kind``) adds ``tex_items``, one
float4 row per item in the same order: the checker's second albedo rgb
and its scale (0 = no checker), read once for the winner by the textured
kernels only; and the scene's image LUTs (``ops/textures.py``).
Every constant is rounded to float32 as the JAX closure's Python floats
are when they meet float32 arrays (doubling is exact, so 2c' is the
rounding of the reference's ``2.0 * cxp``).

The triangle table (``TRI_COLS`` columns, the same layout for the
dynamic tables of ``ops/dyn_tables.py``) holds, per triangle::

    0-2 v0, 3-5 e1 = v1 - v0, 6-8 e2 = v2 - v0, 9-11 unit normal,
    12-14 albedo rgb (decoded), 15 fuzz, 16 ior, 17 mat_type, 18-19 0

so its first three float4 are what the pair test reads.  The culled bake
sweeps triangles in a hierarchy of their own (Morton order of centroids,
its own slab), after the spheres; triangles are never globals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops.textures import ImageLuts, image_luts
from wavefront_path_tracer_tpu_torch.scene.mesh import TriangleSoA

T_MIN = 0.001
# bake_culled's hierarchy parameters' defaults, the reference's
# (baked_culled_intersect, pallas_kernels.py:831-841).
SUPER_FACTOR = 8
SUPER_GATE = 48
GLOBAL_RADIUS_FACTOR = 10.0
REFRESH = 16
HIERARCHY_DEFAULTS = {"super_factor": SUPER_FACTOR,
                      "global_radius_factor": GLOBAL_RADIUS_FACTOR,
                      "super_gate": SUPER_GATE, "refresh": REFRESH,
                      "pack_attrs": True}
TEX_LUT_MAX = 8192        # RenderConfig.tex_lut_max's default
HINT_MAX_CLUSTERS = 64    # the winner hint is off above this estimate

ITEM_COLS = 20
TRI_COLS = 20

SPHERE_KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx",
               "mat_type")
TRI_KEYS = ("tri_v0", "tri_e1", "tri_e2", "tri_albedo", "tri_fuzz",
            "tri_refract", "tri_mat_type")
TEX_KEYS = ("tex_kind", "tex_albedo2", "tex_scale", "tex_id", "tex_data")


def _signed32(word):
    return word - (1 << 32) if word >= (1 << 31) else word


def _pack_albedo_mat(ar, ag, ab, mt, width: str = "16"):
    """Bake-time pack of a winner's (albedo rgb, material id) into int32
    words, the reference's rule bit for bit: "16", the default, gives
    (r:16|g:16) and (b:16|mat) on a 1/65535 grid; "10" gives one word,
    r:g:b on a 1/1023 grid and the material in bits 30-31."""
    if width == "10":
        q = [int(round(min(max(float(v), 0.0), 1.0) * 1023.0))
             for v in (ar, ag, ab)]
        return (_signed32((q[0] << 20) | (q[1] << 10) | q[2]
                          | (int(mt) << 30)),)
    q = [int(round(min(max(float(v), 0.0), 1.0) * 65535.0))
         for v in (ar, ag, ab)]
    return (_signed32((q[0] << 16) | q[1]),
            _signed32((q[2] << 16) | int(mt)))


def _unpack_albedo_mat(pk1, pk2=None):
    """The kernel-side decode of :func:`_pack_albedo_mat`, on int32
    numpy arrays: (ar, ag, ab, mt) as float32; a lone word is the "10"
    pack."""
    f32 = np.float32
    if pk2 is None:
        inv = f32(1.0 / 1023.0)
        return (((pk1 >> 20) & 1023).astype(f32) * inv,
                ((pk1 >> 10) & 1023).astype(f32) * inv,
                (pk1 & 1023).astype(f32) * inv,
                ((pk1 >> 30) & 3).astype(f32))
    inv = f32(1.0 / 65535.0)
    return (((pk1 >> 16) & 65535).astype(f32) * inv,
            (pk1 & 65535).astype(f32) * inv,
            ((pk2 >> 16) & 65535).astype(f32) * inv,
            (pk2 & 3).astype(f32))


def _pack_albedo_ok(albedo, triangles=None):
    """Packing precondition: every albedo (spheres and triangles) in
    [0, 1], the quantization grid's domain; other scenes keep exact
    floats."""
    a = np.asarray(albedo, np.float64)
    ok = bool((a >= 0.0).all() and (a <= 1.0).all())
    if ok and triangles is not None and triangles.num_triangles:
        ta = np.asarray(triangles.albedo, np.float64)
        ok = bool((ta >= 0.0).all() and (ta <= 1.0).all())
    return ok


def _resolve_pack(albedo, triangles=None, pack_attrs=True):
    """The pack width of a bake, as the reference's ``_resolve_pack``
    resolves the ``pack_attrs`` of its intersects: True means "16";
    "10" and "16" are kept; a falsy value, or an albedo outside [0, 1],
    gives None (exact floats)."""
    if pack_attrs is True:
        pack_attrs = "16"
    if not pack_attrs or not _pack_albedo_ok(albedo, triangles):
        return None
    if pack_attrs not in ("10", "16"):
        raise ValueError(f"pack_attrs must be '10', '16' or falsy, "
                         f"got {pack_attrs!r}")
    return pack_attrs


def decoded_attributes(albedo, mat_type, packed):
    """(N, 4) float32 [ar, ag, ab, mt] as the kernel sees a winner's:
    packed at width ``packed`` ("16" or "10"; True is "16") and decoded,
    exact where it is falsy."""
    albedo = np.asarray(albedo, np.float32)
    mat_type = np.asarray(mat_type, np.float32)
    if not packed:
        return np.concatenate([albedo, mat_type[:, None]], axis=1)
    width = "10" if packed == "10" else "16"
    words = np.array([_pack_albedo_mat(*albedo[i], mat_type[i], width)
                      for i in range(albedo.shape[0])],
                     np.int64).reshape(albedo.shape[0], -1)
    return np.stack(_unpack_albedo_mat(
        *(words[:, k].astype(np.int32) for k in range(words.shape[1]))),
        axis=1)


def _t2_elidable(centers, radii, mat_type, fuzz, triangles=None):
    """Per-sphere flag: the far-root (t2) select can be elided, because no
    reachable ray starts inside the sphere (the reference's
    ``_t2_elidable``; see its docstring for the rule and its known
    near-graze divergence).  A triangle whose box comes within reach of a
    sphere's interior keeps that sphere's far root."""
    c = np.asarray(centers, np.float64)
    r = np.abs(np.asarray(radii, np.float64))
    mt = np.asarray(mat_type, np.float64)
    fz = np.asarray(fuzz, np.float64)
    n = c.shape[0]
    # Negative radius (inside-out) spheres are hit from inside: keep t2.
    safe = ((mt != 2.0) & ~((mt == 1.0) & (fz > 0.0))
            & (np.asarray(radii, np.float64) > 0.0))
    eps8 = 8.0 * 1.1920929e-07
    for s in range(0, n, 256):
        e = min(n, s + 256)
        d = np.sqrt(((c[s:e, None, :] - c[None, :, :]) ** 2).sum(-1))
        pen = r[s:e, None] - np.abs(d - r[None, :])
        tol = np.maximum(T_MIN * T_MIN / (8.0 * np.maximum(r[s:e, None],
                                                           1e-30)),
                         eps8 * (d + r[None, :] + r[s:e, None]))
        safe[s:e] &= ~(pen > tol).any(axis=1)
    if triangles is not None and triangles.num_triangles:
        v0 = np.asarray(triangles.v0, np.float64)
        v1 = v0 + np.asarray(triangles.e1, np.float64)
        v2 = v0 + np.asarray(triangles.e2, np.float64)
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        for s in range(0, n, 256):
            e = min(n, s + 256)
            near = np.clip(c[s:e, None, :], lo[None], hi[None])
            d = np.sqrt(((near - c[s:e, None, :]) ** 2).sum(-1))
            tol = np.maximum(T_MIN * T_MIN / (8.0 * np.maximum(r[s:e, None],
                                                               1e-30)),
                             eps8 * (d + r[s:e, None]))
            safe[s:e] &= ~(d < r[s:e, None] - tol).any(axis=1)
    return safe


def _morton_order(centers):
    """Morton (Z-curve) order of centres, stable: spatial neighbours end
    up in one cluster, so cluster boxes stay tight."""
    lo = centers.min(axis=0)
    span = np.maximum(centers.max(axis=0) - lo, 1e-6)
    q = np.clip(((centers - lo) / span * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


@dataclasses.dataclass(frozen=True)
class BakedScene:
    """Device tables of one bake (layout: the module docstring and
    ``csrc/baked.cu``).

    ``items`` are the spheres in visit order: for a culled bake the
    globals in scene order, then each cluster's spheres (Morton order)
    cluster by cluster in sweep order; for an unculled bake every sphere
    in scene order.  ``cluster_boxes``/``cluster_ranges`` hold one row
    per sphere cluster in sweep order; ``super_boxes``/``super_ranges``
    are empty unless that sweep is two-level (more than the bake's
    ``super_gate`` clusters).  The ``tri_*`` tables are the same for the triangles
    (``tri_items`` in scene order for an unculled bake; all empty without
    triangles).  ``consts`` is (16,) float32: shift xyz, sphere slab lo
    xyz, hi xyz, triangle slab lo xyz, hi xyz, 0.  The metadata match
    the reference closure's attributes of the same names, both
    hierarchies together; ``cluster_aabbs`` lists (lo, hi) per cluster
    in the one-level visit order (nearest box to the camera hint first),
    spheres first.  ``tex_items`` (n_items, 4) and ``images`` are
    empty unless ``textured``; ``winner_hint`` says whether the culled
    kernel runs the winner-hint prepass (asked for, and at most
    ``HINT_MAX_CLUSTERS`` clusters estimated, as in the reference).
    """

    culled: bool
    items: torch.Tensor
    tex_items: torch.Tensor
    images: ImageLuts
    cluster_boxes: torch.Tensor
    cluster_ranges: torch.Tensor
    super_boxes: torch.Tensor
    super_ranges: torch.Tensor
    tri_items: torch.Tensor
    tri_cluster_boxes: torch.Tensor
    tri_cluster_ranges: torch.Tensor
    tri_super_boxes: torch.Tensor
    tri_super_ranges: torch.Tensor
    consts: torch.Tensor
    n_globals: int
    n_clusters: int
    n_supers: int
    n_clustered_items: int
    pack_attrs: str | None
    cluster_aabbs: tuple
    textured: bool = False
    winner_hint: bool = False

    @property
    def n_items(self) -> int:
        return self.items.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_items.shape[0]

    @property
    def mean_cluster_size(self) -> float:
        return self.n_clustered_items / max(self.n_clusters, 1)

    def to(self, device) -> "BakedScene":
        return on_device(self, device)


def on_device(tables, device):
    """A frozen dataclass of tables with every tensor (and
    :class:`ImageLuts`) field moved to ``device``."""
    moved = {f.name: getattr(tables, f.name).to(device)
             for f in dataclasses.fields(tables)
             if isinstance(getattr(tables, f.name),
                           (torch.Tensor, ImageLuts))}
    return dataclasses.replace(tables, **moved)


def host_scene(scene_arrays) -> dict:
    """The sphere tables of ``scene_arrays`` (tensors on any device, or
    anything ``np.asarray`` takes), its triangle tables when it has
    triangles and its texture tables when it has textures, as numpy
    arrays (float32, the texture kinds and ids int32), plus ``"key"``:
    one fingerprint of all their bytes, for the bake and dynamic-table
    caches.  Made once per scene (``convert.scene_arrays_to_torch``)."""
    keys = SPHERE_KEYS
    if "tri_v0" in scene_arrays and scene_arrays["tri_v0"].shape[0]:
        keys = keys + TRI_KEYS
    keys = keys + tuple(k for k in TEX_KEYS if k in scene_arrays)
    out = {}
    for key in keys:
        v = scene_arrays[key]
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        out[key] = np.asarray(v, np.int32 if key in ("tex_kind", "tex_id")
                              else np.float32)
    out["key"] = hash(b"".join(k.encode() + out[k].tobytes() for k in keys))
    return out


def _host(scene_arrays) -> dict:
    return scene_arrays if "key" in scene_arrays else host_scene(scene_arrays)


def host_triangles(host) -> TriangleSoA | None:
    """The triangles of a :func:`host_scene` copy, or None."""
    if "tri_v0" not in host:
        return None
    return TriangleSoA(*(host[k] for k in TRI_KEYS))


def _item_rows(a, idx, q0, any_neg, elide, attrs, culled, slot=None):
    """(len(idx), 20) float32 rows for spheres ``idx`` with the given
    first four columns.  With the per-sphere image ``slot`` of a textured
    scene, column 18 holds it; a scene with an image texture keeps the
    true 1/r in column 16 (the reference's ``full_inv_r``, whose winner
    identity reads it), rounded once from float64."""
    rows = np.zeros((len(idx), ITEM_COLS), np.float32)
    rows[:, 0:4] = q0
    rows[:, 4] = elide[idx].astype(np.float32)
    if culled:
        rows[:, 5:8] = 2.0 * q0[:, 0:3]
    rows[:, 8:11] = a["centers"][idx]
    rows[:, 11] = a["refract_idx"][idx]
    rows[:, 12:15] = attrs[idx, 0:3]
    rows[:, 15] = a["fuzz"][idx]
    if slot is not None and (slot >= 0).any():
        rows[:, 16] = 1.0 / a["radii"][idx].astype(np.float64)
    elif any_neg:
        rows[:, 16] = np.where(a["radii"][idx] > 0, 1.0, -1.0)
    else:
        rows[:, 16] = 1.0
    rows[:, 17] = attrs[idx, 3]
    if slot is not None:
        rows[:, 18] = slot[idx]
    return rows


def _textures(a, lut_max):
    """(per-sphere image slot, (n, 4) checker rows: albedo2 rgb and
    scale, ImageLuts) of a host scene; (None, None, no LUTs) for an
    untextured one."""
    luts, slot = image_luts(a, lut_max)
    if "tex_kind" not in a:
        return None, None, luts
    checker = np.concatenate([a["tex_albedo2"], a["tex_scale"][:, None]],
                             axis=1).astype(np.float32)
    return slot, checker, luts


def tri_rows(tris: TriangleSoA, nrm, packed) -> np.ndarray:
    """(T, TRI_COLS) float32 rows of the triangles in scene order, with
    the unit normals ``nrm`` and the attributes decoded from the pack of
    width ``packed`` (:func:`decoded_attributes`)."""
    rows = np.zeros((tris.num_triangles, TRI_COLS), np.float32)
    rows[:, 0:3] = tris.v0
    rows[:, 3:6] = tris.e1
    rows[:, 6:9] = tris.e2
    rows[:, 9:12] = nrm
    attrs = decoded_attributes(tris.albedo, tris.mat_type, packed)
    rows[:, 12:15] = attrs[:, 0:3]
    rows[:, 15] = tris.fuzz
    rows[:, 16] = tris.refract_idx
    rows[:, 17] = attrs[:, 3]
    return rows


def _hierarchy(aabb_lo, aabb_hi, members, cluster_size, camera_hint,
               super_factor: int = SUPER_FACTOR):
    """Clusters of ``cluster_size`` consecutive members, supers of
    ``super_factor`` clusters and the slab over per-member boxes (the
    reference's ``build_hierarchy``, pallas_kernels.py:991-1024).
    Membership follows the given (Morton) order, so boxes stay tight;
    with a camera hint the visit order is nearest box first at both
    levels, clusters re-sorted within their super.  Returns (clusters,
    supers, slab): clusters as (lo, hi, members, key) and supers as (lo,
    hi, clusters, key), each list in visit order."""
    def key(lo, hi, start):
        if camera_hint is None:
            return float(start)
        # Squared distance from the hint to the box; 0 inside it.
        p = np.minimum(np.maximum(np.asarray(camera_hint, np.float64),
                                  lo), hi)
        return float(np.sum((p - camera_hint) ** 2))

    clusters = []
    for start in range(0, len(members), cluster_size):
        sl = slice(start, start + cluster_size)
        lo = aabb_lo[sl].min(axis=0)
        hi = aabb_hi[sl].max(axis=0)
        clusters.append((lo.tolist(), hi.tolist(), members[sl],
                         key(lo, hi, start)))
    supers = []
    for start in range(0, len(clusters), super_factor):
        grp = sorted(clusters[start:start + super_factor],
                     key=lambda c: c[3])
        lo = np.min([c[0] for c in grp], axis=0)
        hi = np.max([c[1] for c in grp], axis=0)
        supers.append((lo.tolist(), hi.tolist(), grp, key(lo, hi, start)))
    supers.sort(key=lambda s: s[3])
    clusters.sort(key=lambda c: c[3])
    return clusters, supers, (aabb_lo.min(axis=0), aabb_hi.max(axis=0))


def _sweep(clusters, supers, first, super_gate: int = SUPER_GATE):
    """A hierarchy's sweep: the flat sorted clusters, or super by super
    above ``super_gate`` clusters (clusters sorted within their super),
    as the reference gates each hierarchy (pallas_kernels.py:1442).
    Returns (members in sweep order, cluster rows, super rows); a row is
    (lo, hi, (first, count)), cluster item ranges counted from
    ``first``."""
    two_level = len(clusters) > super_gate
    sweep = [c for s in supers for c in s[2]] if two_level else clusters
    members, cluster_rows = [], []
    for lo, hi, mem, _ in sweep:
        cluster_rows.append((lo, hi, (first, len(mem))))
        members.append(mem)
        first += len(mem)
    super_rows = []
    if two_level:
        k = 0
        for lo, hi, grp, _ in supers:
            super_rows.append((lo, hi, (k, len(grp))))
            k += len(grp)
    return members, cluster_rows, super_rows


def _tables(culled, items, tex_items, clusters, supers, tris, tri_clusters,
            tri_supers, consts, **meta):
    def f32(rows, width):
        return torch.from_numpy(
            np.asarray(rows, np.float32).reshape(-1, width))

    def i32(rows):
        return torch.from_numpy(np.asarray(rows, np.int32).reshape(-1, 2))

    def boxes(entries):
        return f32([[*lo, 0.0, *hi, 0.0] for lo, hi, _ in entries], 8)

    return BakedScene(
        culled=culled, items=f32(items, ITEM_COLS),
        tex_items=f32(tex_items, 4),
        cluster_boxes=boxes(clusters),
        cluster_ranges=i32([rng for _, _, rng in clusters]),
        super_boxes=boxes(supers),
        super_ranges=i32([rng for _, _, rng in supers]),
        tri_items=f32(tris, TRI_COLS),
        tri_cluster_boxes=boxes(tri_clusters),
        tri_cluster_ranges=i32([rng for _, _, rng in tri_clusters]),
        tri_super_boxes=boxes(tri_supers),
        tri_super_ranges=i32([rng for _, _, rng in tri_supers]),
        consts=f32(consts, 16).reshape(16), **meta)


def bake_unculled(scene_arrays, *, lut_max: int = TEX_LUT_MAX,
                  device="cpu") -> BakedScene:
    """The bake of ``baked_intersect`` (pallas_kernels.py:632-670):
    every sphere, then every triangle, in scene order, with elision
    flags, sign-only 1/r and the attribute pack, and a textured scene's
    checker rows and image LUTs of at most ``lut_max`` texels.  The
    triangle normals are normalised without a floor, as the reference's
    are (663)."""
    a = _host(scene_arrays)
    tris = host_triangles(a)
    n = a["centers"].shape[0]
    pack_w = _resolve_pack(a["albedo"], tris)
    elide = _t2_elidable(a["centers"], a["radii"], a["mat_type"], a["fuzz"],
                         tris)
    attrs = decoded_attributes(a["albedo"], a["mat_type"], pack_w)
    slot, checker, luts = _textures(a, lut_max)
    r64 = a["radii"].astype(np.float64)
    q0 = np.concatenate([a["centers"],
                         (r64 * r64).astype(np.float32)[:, None]], axis=1)
    idx = np.arange(n)
    items = _item_rows(a, idx, q0, bool((a["radii"] < 0).any()), elide,
                       attrs, culled=False, slot=slot)
    t_rows = np.zeros((0, TRI_COLS), np.float32)
    if tris is not None:
        nrm = np.cross(tris.e1, tris.e2)
        nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        t_rows = tri_rows(tris, nrm, pack_w)
    return _tables(False, items, checker[idx] if slot is not None else [],
                   [], [], t_rows, [], [], np.zeros(16, np.float32),
                   images=luts, n_globals=n, n_clusters=0, n_supers=0,
                   n_clustered_items=0, pack_attrs=pack_w, cluster_aabbs=(),
                   textured=slot is not None).to(device)


def bake_culled(scene_arrays, cluster_size: int = 16, camera_hint=None, *,
                super_factor: int = SUPER_FACTOR,
                global_radius_factor: float = GLOBAL_RADIUS_FACTOR,
                super_gate: int = SUPER_GATE, refresh: int = REFRESH,
                winner_hint: bool = False, pack_attrs=True,
                lut_max: int = TEX_LUT_MAX, device="cpu") -> BakedScene:
    """The bake of ``baked_culled_intersect`` (pallas_kernels.py:831-1061,
    1468-1486), with its hierarchy parameters under its names and
    defaults.

    Giant spheres (radius above ``global_radius_factor`` x the median;
    0 makes every sphere of positive radius one) are globals, swept
    first; the rest go into Morton clusters of ``cluster_size`` and
    supers of ``super_factor`` clusters, visited nearest box first from
    ``camera_hint`` (a world-space point), or in Morton order without
    one.  A hierarchy of more than ``super_gate`` clusters is swept
    super by super (the two-level sweep of ``csrc/baked.cuh``), else
    flat; the supers are built and counted either way, as in the
    reference.  A scene with at most ``2 * cluster_size`` non-global
    spheres is all globals.  The slimmed quadratic runs in a frame
    shifted to the per-axis median of the clustered centres.  Triangles
    get a hierarchy of their own, built the same way over the Morton
    order of their centroids, swept after the spheres.  A textured scene
    gets its checker rows and image LUTs (``lut_max`` texels);
    ``winner_hint`` asks for the winner-hint prepass, which stays off
    above ``HINT_MAX_CLUSTERS`` estimated clusters (pallas_kernels.py:
    921-928).  ``pack_attrs`` is the reference's: True ("16"), "10" or
    False (exact albedos); the item table holds the decoded values.  The
    reference's ``full_inv_r`` is derived, as its ``models/fused.py``
    derives it: the true 1/r where the scene has an image texture.

    ``refresh`` is accepted and changes nothing: in the reference it
    batches the TPU's consensus cap, refreshed from the running nearest
    hit every ``refresh`` clusters because each refresh stalls the
    scalar pipeline (pallas_kernels.py:1368-1407).  The CUDA sweep culls
    each ray against its own running nearest hit at every cluster, so it
    has no stale cap to batch; like ``lane_rotate``, it is a TPU
    scheduling parameter, taken so that the reference's calls run.
    """
    if int(super_factor) < 1:
        raise ValueError(f"super_factor must be at least 1, not "
                         f"{super_factor}")
    if int(refresh) < 1:
        raise ValueError(f"refresh must be at least 1, not {refresh}")
    a = _host(scene_arrays)
    tris = host_triangles(a)
    centers, radii = a["centers"], a["radii"]
    n = centers.shape[0]
    pack_w = _resolve_pack(a["albedo"], tris, pack_attrs)
    elide = _t2_elidable(centers, radii, a["mat_type"], a["fuzz"], tris)
    any_neg = bool((radii < 0).any())
    attrs = decoded_attributes(a["albedo"], a["mat_type"], pack_w)
    slot, checker, luts = _textures(a, lut_max)
    n_tris = tris.num_triangles if tris is not None else 0
    est_clusters = -(-n // cluster_size) + -(-n_tris // cluster_size)

    med_r = float(np.median(radii))
    is_global = radii > global_radius_factor * med_r
    global_idx = np.nonzero(is_global)[0]
    rest = np.nonzero(~is_global)[0]
    if rest.size <= 2 * cluster_size:
        global_idx = np.arange(n)
        rest = np.zeros((0,), np.int64)

    # Conditioning shift: the per-axis median of the clustered centres,
    # in float64 (it reaches the kernel rounded to float32).
    cc = centers[rest] if rest.size else centers
    if cc.shape[0]:
        shift = tuple(np.median(cc.astype(np.float64), axis=0))
    else:
        shift = (0.0, 0.0, 0.0)

    consts = np.zeros(16, np.float32)
    consts[0:3] = shift
    clusters, supers = [], []
    if rest.size:
        order = rest[_morton_order(centers[rest])]
        # |r|: negative (inside-out) radii span the same box.
        clusters, supers, slab = _hierarchy(
            centers[order] - np.abs(radii[order, None]),
            centers[order] + np.abs(radii[order, None]), order,
            cluster_size, camera_hint, super_factor)
        consts[3:6], consts[6:9] = slab
    members, cluster_rows, super_rows = _sweep(clusters, supers,
                                               len(global_idx), super_gate)
    idx = np.concatenate([global_idx] + members).astype(np.int64)

    q0 = np.zeros((len(idx), 4), np.float32)
    for k, i in enumerate(idx):
        cx, cy, cz = (float(centers[i, 0]), float(centers[i, 1]),
                      float(centers[i, 2]))
        r = float(radii[i])
        q0[k, 0] = float(np.float64(cx) - shift[0])
        q0[k, 1] = float(np.float64(cy) - shift[1])
        q0[k, 2] = float(np.float64(cz) - shift[2])
        q0[k, 3] = float((np.float64(cx) - shift[0]) ** 2
                         + (np.float64(cy) - shift[1]) ** 2
                         + (np.float64(cz) - shift[2]) ** 2
                         - np.float64(r) * r)
    items = _item_rows(a, idx, q0, any_neg, elide, attrs, culled=True,
                       slot=slot)

    t_clusters, t_supers = [], []
    t_items = np.zeros((0, TRI_COLS), np.float32)
    t_cluster_rows, t_super_rows = [], []
    if tris is not None:
        v0, e1, e2 = tris.v0, tris.e1, tris.e2
        nrm = np.cross(e1, e2)
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-20)
        t_order = _morton_order(v0 + (e1 + e2) / 3.0)
        verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)[t_order]
        t_clusters, t_supers, t_slab = _hierarchy(
            verts.min(axis=1), verts.max(axis=1), t_order, cluster_size,
            camera_hint, super_factor)
        consts[9:12], consts[12:15] = t_slab
        t_members, t_cluster_rows, t_super_rows = _sweep(
            t_clusters, t_supers, 0, super_gate)
        t_items = tri_rows(tris, nrm, pack_w)[
            np.concatenate(t_members)]

    all_clusters = clusters + t_clusters
    return _tables(
        True, items, checker[idx] if slot is not None else [], cluster_rows,
        super_rows, t_items, t_cluster_rows, t_super_rows, consts,
        images=luts, n_globals=len(global_idx),
        n_clusters=len(all_clusters), n_supers=len(supers) + len(t_supers),
        n_clustered_items=sum(len(c[2]) for c in all_clusters),
        pack_attrs=pack_w,
        cluster_aabbs=tuple((c[0], c[1]) for c in all_clusters),
        textured=slot is not None,
        winner_hint=(bool(winner_hint) and bool(all_clusters)
                     and est_clusters <= HINT_MAX_CLUSTERS)).to(device)
