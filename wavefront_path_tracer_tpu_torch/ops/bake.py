"""Host bake of a sphere scene for the baked intersects.

Port of the bake halves of ``wavefront_path_tracer_tpu/ops/pallas_kernels.py``:
the attribute pack rule (``_pack_albedo_mat`` and friends, 374-458),
``_t2_elidable`` (532, spheres), ``_morton_order`` (811), and what
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
    16-19 1/r sign, mat_type, 0, 0

The pair loop reads columns 0-7 only; the rest is read for the winner.
Every constant is rounded to float32 as the JAX closure's Python floats
are when they meet float32 arrays (doubling is exact, so 2c' is the
rounding of the reference's ``2.0 * cxp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

T_MIN = 0.001
SUPER_FACTOR = 8
SUPER_GATE = 48
GLOBAL_RADIUS_FACTOR = 10.0

ITEM_COLS = 20

SPHERE_KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx",
               "mat_type")


def _signed32(word):
    return word - (1 << 32) if word >= (1 << 31) else word


def _pack_albedo_mat(ar, ag, ab, mt):
    """Bake-time pack of a winner's (albedo rgb, material id) into two
    int32 words, (r:16|g:16) and (b:16|mat) on a 1/65535 grid: the
    reference's default ("16") rule, bit for bit."""
    q = [int(round(min(max(float(v), 0.0), 1.0) * 65535.0))
         for v in (ar, ag, ab)]
    return (_signed32((q[0] << 16) | q[1]),
            _signed32((q[2] << 16) | int(mt)))


def _unpack_albedo_mat(pk1, pk2):
    """The kernel-side decode of :func:`_pack_albedo_mat`, on int32
    numpy arrays: (ar, ag, ab, mt) as float32."""
    f32 = np.float32
    inv = f32(1.0 / 65535.0)
    return (((pk1 >> 16) & 65535).astype(f32) * inv,
            (pk1 & 65535).astype(f32) * inv,
            ((pk2 >> 16) & 65535).astype(f32) * inv,
            (pk2 & 3).astype(f32))


def _pack_albedo_ok(albedo):
    """Packing precondition: every albedo in [0, 1], the quantization
    grid's domain; other scenes keep exact floats."""
    a = np.asarray(albedo, np.float64)
    return bool((a >= 0.0).all() and (a <= 1.0).all())


def _resolve_pack(albedo):
    """The pack width the reference's bake uses by default: "16", or
    None (exact floats) when some albedo leaves [0, 1]."""
    return "16" if _pack_albedo_ok(albedo) else None


def decoded_attributes(albedo, mat_type, packed: bool):
    """(N, 4) float32 [ar, ag, ab, mt] as the kernel sees a winner's:
    packed and decoded when ``packed``, exact otherwise."""
    albedo = np.asarray(albedo, np.float32)
    mat_type = np.asarray(mat_type, np.float32)
    if not packed:
        return np.concatenate([albedo, mat_type[:, None]], axis=1)
    words = np.array([_pack_albedo_mat(*albedo[i], mat_type[i])
                      for i in range(albedo.shape[0])], np.int64)
    return np.stack(_unpack_albedo_mat(words[:, 0].astype(np.int32),
                                       words[:, 1].astype(np.int32)), axis=1)


def _t2_elidable(centers, radii, mat_type, fuzz):
    """Per-sphere flag: the far-root (t2) select can be elided, because no
    reachable ray starts inside the sphere (the reference's
    ``_t2_elidable`` for sphere scenes; see its docstring for the rule
    and its known near-graze divergence)."""
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

    ``items`` are in visit order: for a culled bake the globals in scene
    order, then each cluster's spheres (Morton order) cluster by cluster
    in sweep order; for an unculled bake every sphere in scene order.
    ``cluster_boxes``/``cluster_ranges`` hold one row per cluster in
    sweep order; ``super_boxes``/``super_ranges`` are empty unless the
    sweep is two-level (more than ``SUPER_GATE`` clusters).  ``consts`` is
    (16,) float32: shift xyz, slab lo xyz, slab hi xyz, zeros.  The
    metadata match the reference closure's attributes of the same names;
    ``cluster_aabbs`` lists (lo, hi) per cluster in the one-level visit
    order (nearest box to the camera hint first).
    """

    culled: bool
    items: torch.Tensor
    cluster_boxes: torch.Tensor
    cluster_ranges: torch.Tensor
    super_boxes: torch.Tensor
    super_ranges: torch.Tensor
    consts: torch.Tensor
    n_globals: int
    n_clusters: int
    n_supers: int
    n_clustered_items: int
    pack_attrs: str | None
    cluster_aabbs: tuple

    @property
    def n_items(self) -> int:
        return self.items.shape[0]

    @property
    def mean_cluster_size(self) -> float:
        return self.n_clustered_items / max(self.n_clusters, 1)

    def to(self, device) -> "BakedScene":
        tensors = {f.name: getattr(self, f.name).to(device)
                   for f in dataclasses.fields(self)
                   if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **tensors)


def host_spheres(scene_arrays) -> dict:
    """The sphere tables of ``scene_arrays`` (tensors on any device, or
    anything ``np.asarray`` takes) as float32 numpy arrays, plus
    ``"key"``, a fingerprint of their bytes for the bake cache."""
    out = {}
    for key in SPHERE_KEYS:
        v = scene_arrays[key]
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        out[key] = np.asarray(v, np.float32)
    out["key"] = hash(b"".join(out[k].tobytes() for k in SPHERE_KEYS))
    return out


def _item_rows(a, idx, q0, any_neg, elide, attrs, culled):
    """(len(idx), 20) float32 rows for spheres ``idx`` with the given
    first four columns."""
    rows = np.zeros((len(idx), ITEM_COLS), np.float32)
    rows[:, 0:4] = q0
    rows[:, 4] = elide[idx].astype(np.float32)
    if culled:
        rows[:, 5:8] = 2.0 * q0[:, 0:3]
    rows[:, 8:11] = a["centers"][idx]
    rows[:, 11] = a["refract_idx"][idx]
    rows[:, 12:15] = attrs[idx, 0:3]
    rows[:, 15] = a["fuzz"][idx]
    if any_neg:
        rows[:, 16] = np.where(a["radii"][idx] > 0, 1.0, -1.0)
    else:
        rows[:, 16] = 1.0
    rows[:, 17] = attrs[idx, 3]
    return rows


def _tables(culled, items, clusters, supers, consts, **meta):
    def f32(rows, width):
        return torch.from_numpy(
            np.asarray(rows, np.float32).reshape(-1, width))

    def i32(rows):
        return torch.from_numpy(np.asarray(rows, np.int32).reshape(-1, 2))

    def boxes(entries):
        return f32([[*lo, 0.0, *hi, 0.0] for lo, hi, _ in entries], 8)

    return BakedScene(
        culled=culled, items=f32(items, ITEM_COLS),
        cluster_boxes=boxes(clusters),
        cluster_ranges=i32([rng for _, _, rng in clusters]),
        super_boxes=boxes(supers),
        super_ranges=i32([rng for _, _, rng in supers]),
        consts=f32(consts, 16).reshape(16), **meta)


def bake_unculled(scene_arrays, *, device="cpu") -> BakedScene:
    """The bake of ``baked_intersect`` (pallas_kernels.py:632-670, spheres):
    every sphere in scene order, with elision flags, sign-only 1/r and
    the attribute pack."""
    a = host_spheres(scene_arrays)
    n = a["centers"].shape[0]
    pack_w = _resolve_pack(a["albedo"])
    elide = _t2_elidable(a["centers"], a["radii"], a["mat_type"], a["fuzz"])
    attrs = decoded_attributes(a["albedo"], a["mat_type"], pack_w is not None)
    r64 = a["radii"].astype(np.float64)
    q0 = np.concatenate([a["centers"],
                         (r64 * r64).astype(np.float32)[:, None]], axis=1)
    idx = np.arange(n)
    items = _item_rows(a, idx, q0, bool((a["radii"] < 0).any()), elide,
                       attrs, culled=False)
    return _tables(False, items, [], [], np.zeros(16, np.float32),
                   n_globals=n, n_clusters=0, n_supers=0,
                   n_clustered_items=0, pack_attrs=pack_w,
                   cluster_aabbs=()).to(device)


def bake_culled(scene_arrays, cluster_size: int = 16, camera_hint=None, *,
                device="cpu") -> BakedScene:
    """The bake of ``baked_culled_intersect`` (pallas_kernels.py:906-1061,
    1468-1486; spheres, no textures, no winner hint).

    Giant spheres (radius above ``GLOBAL_RADIUS_FACTOR`` x the median)
    are globals, swept first; the rest go into Morton clusters of
    ``cluster_size`` and supers of ``SUPER_FACTOR`` clusters, visited
    nearest box first from ``camera_hint`` (a world-space point), or in
    Morton order without one.  A scene with at most ``2 * cluster_size``
    non-global spheres is all globals.  The slimmed quadratic runs in a
    frame shifted to the per-axis median of the clustered centres.
    """
    a = host_spheres(scene_arrays)
    centers, radii = a["centers"], a["radii"]
    n = centers.shape[0]
    pack_w = _resolve_pack(a["albedo"])
    elide = _t2_elidable(centers, radii, a["mat_type"], a["fuzz"])
    any_neg = bool((radii < 0).any())
    attrs = decoded_attributes(a["albedo"], a["mat_type"], pack_w is not None)

    med_r = float(np.median(radii))
    is_global = radii > GLOBAL_RADIUS_FACTOR * med_r
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

    def hint_dist(lo, hi):
        # Squared distance from the hint to the box; 0 inside it.
        p = np.minimum(np.maximum(np.asarray(camera_hint, np.float64),
                                  lo), hi)
        return float(np.sum((p - camera_hint) ** 2))

    clusters, supers, slab = [], [], None
    if rest.size:
        order = rest[_morton_order(centers[rest])]
        # |r|: negative (inside-out) radii span the same box.
        aabb_lo = centers[order] - np.abs(radii[order, None])
        aabb_hi = centers[order] + np.abs(radii[order, None])
        for start in range(0, len(order), cluster_size):
            sl = slice(start, start + cluster_size)
            lo = aabb_lo[sl].min(axis=0)
            hi = aabb_hi[sl].max(axis=0)
            clusters.append((lo.tolist(), hi.tolist(), order[sl],
                             hint_dist(lo, hi) if camera_hint is not None
                             else float(start)))
        for start in range(0, len(clusters), SUPER_FACTOR):
            grp = sorted(clusters[start:start + SUPER_FACTOR],
                         key=lambda c: c[3])
            lo = np.min([c[0] for c in grp], axis=0)
            hi = np.max([c[1] for c in grp], axis=0)
            supers.append((lo.tolist(), hi.tolist(), grp,
                           hint_dist(lo, hi) if camera_hint is not None
                           else float(start)))
        supers.sort(key=lambda s: s[3])
        clusters.sort(key=lambda c: c[3])
        slab = (aabb_lo.min(axis=0), aabb_hi.max(axis=0))

    # Sweep order: the flat sorted clusters, or super by super above the
    # gate (clusters sorted within their super).
    two_level = len(clusters) > SUPER_GATE
    sweep = ([c for s in supers for c in s[2]] if two_level else clusters)
    visit = [global_idx] + [c[2] for c in sweep]
    idx = np.concatenate(visit).astype(np.int64)

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
    items = _item_rows(a, idx, q0, any_neg, elide, attrs, culled=True)

    first = len(global_idx)
    cluster_rows = []
    for lo, hi, members, _ in sweep:
        cluster_rows.append((lo, hi, (first, len(members))))
        first += len(members)
    super_rows = []
    if two_level:
        first = 0
        for lo, hi, grp, _ in supers:
            super_rows.append((lo, hi, (first, len(grp))))
            first += len(grp)

    consts = np.zeros(16, np.float32)
    consts[0:3] = shift
    if slab is not None:
        consts[3:6] = slab[0]
        consts[6:9] = slab[1]
    return _tables(
        True, items, cluster_rows, super_rows, consts,
        n_globals=len(global_idx), n_clusters=len(clusters),
        n_supers=len(supers),
        n_clustered_items=sum(len(c[2]) for c in clusters),
        pack_attrs=pack_w,
        cluster_aabbs=tuple((c[0], c[1]) for c in clusters)).to(device)
