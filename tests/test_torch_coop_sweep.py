"""The cooperative culled sweeps' reduction rule, and the warp-divergence
counts, on the CPU.

``csrc/baked.cu`` and ``csrc/dynculled.cu`` let the lanes of a warp share
the rays of the few lanes that enter a cluster (``common.cuh``
``coop_fold``): G lanes test one ray's items, a shuffle tree keeps the
least (t, index), and the ray's own lane takes the result where it is
strictly below its best.  The kernels run only on the card; here a plain
emulation of that fold (its lane shares, its tree's order, the owner's
strict-< take) and of the per-cluster choice (a vote: the cooperative fold
where at most T lanes enter) is held bit for bit to the serial fold, to
``culled_intersect_reference`` (ties built within a lane's share and
across lanes, a 5-item cluster at G = 8, NaN pad rows, rays that enter no
cluster, two-level sweeps and the winner hint's cluster) and to
``dynculled_intersect_reference`` (the flat sweep's batches of 16 and
their cap, the rolled sweep's children capped at their super's entry,
spheres with exact ties, triangles, NaN pad rows, a textured table) on
numpy-seeded rays.  The divergence counts are held to the plain versions'
own counters.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.ops.fused_kernels import T_FAR, T_MIN
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    get_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

WARP = 32
INT_MAX = 2**31 - 1


def coop_fold(t, first, best_t, best_i, enter, g_lanes):
    """The kernel's cooperative fold (csrc/baked.cu coop_fold) of one
    cluster for one warp: ``t`` (32, count) float32 holds each lane's
    ray's t against the cluster's items, ``enter`` (32,) bool the entering
    lanes.  Returns (best_t, best_i, took) after the fold."""
    t = np.asarray(t, dtype=np.float32)
    best_t = np.array(best_t, dtype=np.float32)
    best_i = np.array(best_i, dtype=np.int64)
    took = np.zeros(WARP, dtype=bool)
    groups = WARP // g_lanes
    rem = [lane for lane in range(WARP) if enter[lane]]
    partner = np.arange(WARP)
    while rem:
        owners = rem[:groups]
        t_min = np.full(WARP, T_FAR, dtype=np.float32)
        i_min = np.full(WARP, INT_MAX, dtype=np.int64)
        for lane in range(WARP):
            g, j = divmod(lane, g_lanes)
            if g >= len(owners):
                continue
            for i in range(j, t.shape[1], g_lanes):
                if t[owners[g], i] < t_min[lane]:
                    t_min[lane], i_min[lane] = t[owners[g], i], first + i
        off = g_lanes // 2
        while off:
            t2, i2 = t_min[partner ^ off], i_min[partner ^ off]
            better = (t2 < t_min) | ((t2 == t_min) & (i2 < i_min))
            t_min = np.where(better, t2, t_min)
            i_min = np.where(better, i2, i_min)
            off //= 2
        for k, owner in enumerate(owners):
            if t_min[k * g_lanes] < best_t[owner]:
                best_t[owner] = t_min[k * g_lanes]
                best_i[owner] = i_min[k * g_lanes]
                took[owner] = True
        rem = rem[groups:]
    return best_t, best_i, took


def serial_fold(t, first, best_t, best_i, enter):
    """The plain version's fold of one cluster (``_take`` with a mask)."""
    bt, bi = tbk._take(torch.from_numpy(np.asarray(t, dtype=np.float32)),
                       first, torch.from_numpy(np.array(best_t,
                                                        dtype=np.float32)),
                       torch.from_numpy(np.array(best_i, dtype=np.int64)),
                       torch.from_numpy(np.asarray(enter)))
    return bt.numpy(), bi.numpy()


def assert_same(a_t, a_i, b_t, b_i):
    assert np.array_equal(np.asarray(a_t, np.float32).view(np.int32),
                          np.asarray(b_t, np.float32).view(np.int32))
    assert np.array_equal(a_i, b_i)


def _items(rng, n, nan_rows=0):
    """A culled item table of ``n`` random spheres (slimmed columns, the
    bake's layout) and ``nan_rows`` NaN pad rows."""
    items = np.zeros((n + nan_rows, tbk.ITEM_COLS), dtype=np.float32)
    c = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    r = rng.uniform(0.2, 0.8, n).astype(np.float32)
    items[:n, 0:3] = c
    items[:n, 3] = (c * c).sum(1) - r * r
    items[:n, 5:8] = 2.0 * c
    items[n:] = np.nan
    return torch.from_numpy(items)


def _rays(rng, n):
    o = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]


def _slim(items, ox, oy, oz, dx, dy, dz):
    """Each ray's t against every item, as the plain version computes it
    (shift 0)."""
    dd_o = dx * ox + dy * oy + dz * oz
    oo2 = ox * ox + oy * oy + oz * oz
    return tbk._slim_t(items, ox, oy, oz, dd_o, oo2, dx, dy,
                       dz).numpy()


@pytest.mark.parametrize("g_lanes", [2, 4, 8, 16, 32])
def test_coop_fold_equals_serial_fold(g_lanes):
    """Random rays and items, random entering lanes and prior bests."""
    rng = np.random.default_rng(5 + g_lanes)
    items = _items(rng, 16, nan_rows=3)
    for trial in range(40):
        t = _slim(items, *_rays(rng, WARP))
        first = int(rng.integers(60, 200))   # prior winners lie below
        best_t = np.where(rng.random(WARP) < 0.3, T_FAR,
                          rng.uniform(0.5, 6.0, WARP)).astype(np.float32)
        best_i = rng.integers(-1, 50, WARP)
        enter = rng.random(WARP) < rng.uniform(0.05, 1.0)
        c_t, c_i, took = coop_fold(t, first, best_t, best_i, enter, g_lanes)
        s_t, s_i = serial_fold(t, first, best_t, best_i, enter)
        assert_same(c_t, c_i, s_t, s_i)
        assert np.array_equal(took, s_i != best_i)
        # NaN pad rows give T_FAR and never win.
        assert not np.isin(s_i[took], first + np.arange(16, 19)).any()


@pytest.mark.parametrize("g_lanes", [2, 4, 8])
def test_ties_go_to_the_smaller_index(g_lanes):
    """Exact ties within one lane's share (items j and j + G) and across
    the lanes of a group go to the smaller index, as in the serial
    fold's first minimum."""
    rng = np.random.default_rng(11)
    count = 16
    t = rng.uniform(1.0, 9.0, (WARP, count)).astype(np.float32)
    for lane in range(WARP):
        lo = np.float32(0.5 + lane / 64)
        if lane % 3 == 0:
            t[lane, [3, 3 + g_lanes]] = lo               # one lane's share
        elif lane % 3 == 1:
            t[lane, [2, 5, 14]] = lo                     # across lanes
        else:
            t[lane, :] = lo                              # every item
    enter = np.ones(WARP, dtype=bool)
    best = np.full(WARP, T_FAR, dtype=np.float32)
    none = np.full(WARP, -1)
    c_t, c_i, _ = coop_fold(t, 40, best, none, enter, g_lanes)
    s_t, s_i = serial_fold(t, 40, best, none, enter)
    assert_same(c_t, c_i, s_t, s_i)
    expect = [43 if lane % 3 == 0 else 42 if lane % 3 == 1 else 40
              for lane in range(WARP)]
    assert c_i.tolist() == expect
    # A prior best equal to the cluster's least t keeps its own winner.
    c_t, c_i, took = coop_fold(t, 40, c_t, none, enter, g_lanes)
    assert (c_i == -1).all() and not took.any()


def test_five_item_cluster_at_g8_and_empty_votes():
    """A cluster of 5 items (the headline bake's smallest) at G = 8 leaves
    three lanes of each group without an item; they hold (T_FAR, INT_MAX)
    and never win.  A warp where no lane enters changes nothing."""
    rng = np.random.default_rng(3)
    items = _items(rng, 5)
    t = _slim(items, *_rays(rng, WARP))
    best_t = np.full(WARP, T_FAR, dtype=np.float32)
    best_i = np.full(WARP, -1)
    enter = np.zeros(WARP, dtype=bool)
    enter[[0, 7, 8, 30]] = True
    c_t, c_i, took = coop_fold(t, 20, best_t, best_i, enter, 8)
    s_t, s_i = serial_fold(t, 20, best_t, best_i, enter)
    assert_same(c_t, c_i, s_t, s_i)
    assert (c_i[~enter] == -1).all() and not took[~enter].any()
    none = np.zeros(WARP, dtype=bool)
    c_t, c_i, took = coop_fold(t, 20, best_t, best_i, none, 8)
    assert_same(c_t, c_i, best_t, best_i)
    assert not took.any()


def _bake(scene_name, clusters, copies=1):
    scene = get_scene(scene_name)
    if copies > 1:
        scene = scene.permuted(np.repeat(np.arange(scene.num_spheres),
                                         copies))
    arrays = {k: getattr(scene, k) for k in ("centers", "radii", "albedo",
                                             "fuzz", "refract_idx",
                                             "mat_type")}
    cc = CameraController.book_one_final()
    eye = tfused._concrete_eye(cc.view_matrix())
    return bake.bake_culled(arrays, clusters, camera_hint=eye)


def _scene_rays(rng, n):
    """Rays over book_one_final's spheres: the first half incoherent
    (origins above the ground, random unit directions, some up and away
    so that they enter nothing), the second a narrow beam from the book's
    camera position, whose warps enter the same clusters."""
    half = n // 2
    o = np.stack([rng.uniform(-12, 12, n), rng.uniform(0.05, 2.5, n),
                  rng.uniform(-12, 12, n)], axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 8, 1] = np.abs(d[: n // 8, 1]) + 2.0      # up and away
    o[half:] = (13.0, 2.0, 3.0)
    d[half:] = (np.float32((-13.0, -1.8, -3.0))
                + rng.normal(0.0, 0.02, (n - half, 3)).astype(np.float32))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]


def coop_sweep(baked, rays, g_lanes, t_max, hint=None, live=None):
    """The kernel's warp sweep (csrc/baked.cu nearest with a voting form)
    emulated warp by warp: globals, the hint's prepass, then each cluster
    in visit order (supers front to back, a super's clusters walked when
    any lane entered it) with the lane conds of the plain version, a vote,
    and the serial fold where more than ``t_max`` lanes enter, the
    cooperative fold otherwise.  A lane that is not ``live`` (bool per
    ray; all are by default) tests and enters nothing, but its warp still
    sweeps.  Returns (best_t, best_i, best_c, supers, clusters) per ray,
    and the count of folds of each kind."""
    (cranges, sranges), _ = tbk.host_ranges(baked)
    consts = baked.consts
    ox, oy, oz, dx, dy, dz = rays
    oxp, oyp, ozp = ox - consts[0], oy - consts[1], oz - consts[2]
    dd_o = dx * oxp + dy * oyp + dz * ozp
    oo2 = oxp * oxp + oyp * oyp + ozp * ozp
    t_all = tbk._slim_t(baked.items, oxp, oyp, ozp, dd_o, oo2, dx, dy,
                        dz).numpy()
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    boxes, sboxes = baked.cluster_boxes, baked.super_boxes
    c_ok, c_entry = (v.numpy() for v in tbk.box_conds(
        boxes[:, 0:3], boxes[:, 4:7], ox, oy, oz, *inv))
    s_ok, s_entry = (v.numpy() for v in tbk.box_conds(
        sboxes[:, 0:3], sboxes[:, 4:7], ox, oy, oz, *inv))
    t_exit = tbk.slab_exit(consts[3:6], consts[6:9], ox, oy, oz,
                           *inv).numpy()
    n = ox.shape[0]
    out_t = np.full(n, T_FAR, dtype=np.float32)
    out_i = np.full(n, -1, dtype=np.int64)
    out_c = np.full(n, -1, dtype=np.int64)
    supers = np.zeros(n, dtype=np.int64)
    clusters = np.zeros(n, dtype=np.int64)
    hints = (np.full(n, -1) if hint is None else hint.numpy())
    live = np.ones(n, dtype=bool) if live is None else np.asarray(live)
    kinds = {"coop": 0, "serial": 0}
    for w in range(0, n, WARP):
        lanes = np.arange(w, w + WARP)
        t = t_all[lanes]
        on = live[lanes]
        b_t, b_i = serial_fold(t[:, :baked.n_globals], 0,
                               out_t[lanes], out_i[lanes], on)
        b_c = np.full(WARP, -1)
        h = hints[lanes]

        def fold(c, enter, vote):
            nonlocal b_t, b_i
            first, count = cranges[c]
            tc = t[:, first:first + count]
            if vote and enter.sum() <= t_max:
                kinds["coop"] += 1
                b_t, b_i, took = coop_fold(tc, first, b_t, b_i, enter,
                                           g_lanes)
            else:
                kinds["serial"] += vote
                before = b_i
                b_t, b_i = serial_fold(tc, first, b_t, b_i, enter)
                took = b_i != before
            b_c[took] = c

        for lane in range(WARP):          # the prepass, per lane
            if on[lane] and h[lane] >= 0:
                clusters[w + lane] += 1
                one = np.arange(WARP) == lane
                fold(int(h[lane]), one, vote=False)

        def visit(c, gate):
            cap = np.minimum(b_t, t_exit[lanes])
            enter = (on & gate & c_ok[lanes, c] & (c_entry[lanes, c] < cap)
                     & (h != c))
            clusters[lanes] += enter
            if enter.any():
                fold(c, enter, vote=True)

        if sranges:
            for s, (first, count) in enumerate(sranges):
                cap = np.minimum(b_t, t_exit[lanes])
                es = on & s_ok[lanes, s] & (s_entry[lanes, s] < cap)
                supers[lanes] += es
                if es.any():
                    for c in range(first, first + count):
                        visit(c, es)
        else:
            for c in range(len(cranges)):
                visit(c, np.ones(WARP, dtype=bool))
        out_t[lanes], out_i[lanes], out_c[lanes] = b_t, b_i, b_c
    return out_t, out_i, out_c, supers, clusters, kinds


@pytest.mark.parametrize("case", [
    ("book_one_final", 16, 1, 8, 16),
    ("book_one_final", 16, 1, 4, 32),
    ("book_one_final", 16, 1, 2, 4),
    ("book_one_final", 16, 2, 8, 16),     # every sphere twice: exact ties
    ("book_one_final", 2, 1, 8, 16),      # two-level: supers
], ids=["g8t16", "g4t32", "g2t4", "doubled-g8t16", "two-level-g8t16"])
def test_coop_sweep_equals_plain_version(case):
    """The emulated warp sweep gives, ray by ray, the serial form's winner
    index bit for bit (its T = 0 form), and both give
    culled_intersect_reference's winner, t and cull counters."""
    scene_name, clusters, copies, g_lanes, t_max = case
    baked = _bake(scene_name, clusters, copies)
    rng = np.random.default_rng(clusters * 10 + copies + g_lanes)
    rays = _scene_rays(rng, 4 * WARP)
    c_t, c_i, _, c_sup, c_clu, kinds = coop_sweep(baked, rays, g_lanes,
                                                  t_max)
    s_t, s_i, _, s_sup, s_clu, _ = coop_sweep(baked, rays, g_lanes, 0)
    assert_same(c_t, c_i, s_t, s_i)
    assert np.array_equal(c_sup, s_sup) and np.array_equal(c_clu, s_clu)
    ref = tbk.culled_intersect_reference(baked, *rays)
    *fields, supers, clusters_ref = ref
    assert np.array_equal(c_t.view(np.int32),
                          fields[0].numpy().view(np.int32))
    winner = tbk._winner(baked, torch.from_numpy(c_t),
                         torch.from_numpy(c_i))
    for a, b in zip(winner, fields):
        assert torch.equal(a, b)
    assert np.array_equal(c_sup, supers.numpy())
    assert np.array_equal(c_clu, clusters_ref.numpy())
    # The vote took both branches (only the cooperative one at T = 32),
    # and some rays entered nothing.
    assert kinds["coop"] > 0 and (kinds["serial"] > 0) == (t_max < WARP)
    assert (c_clu == 0).any() and c_clu.max() > 0
    if copies > 1:
        assert (c_i >= 0).sum() > WARP


def test_coop_sweep_hint_cluster_equals_plain_version():
    """With the winner hint: the prepass per lane, the hinted cluster
    skipped in the sweep, and each ray's winner cluster (best_c) as the
    plain version reports it."""
    baked = _bake("book_one_final", 16)
    rng = np.random.default_rng(21)
    rays = _scene_rays(rng, 4 * WARP)
    n_clusters = baked.cluster_boxes.shape[0]
    hint = torch.from_numpy(rng.integers(-1, n_clusters, 4 * WARP))
    c_t, c_i, c_c, _, c_clu, _ = coop_sweep(baked, rays, 8, 16, hint=hint)
    *fields, best_c, _, clusters = tbk.culled_intersect_reference(
        baked, *rays, hint=hint)
    assert np.array_equal(c_t.view(np.int32),
                          fields[0].numpy().view(np.int32))
    assert np.array_equal(c_c, best_c.numpy())
    assert np.array_equal(c_clu, clusters.numpy())
    assert (c_c >= 0).any()


def test_divergence_counts_hand_made():
    """Three trips of a 4-lane warp over clusters of 3 and 5 items."""
    keys = torch.tensor([0, 0, 0, 1, 1, 5])
    entered = torch.tensor([[1, 0], [1, 1], [0, 0], [0, 1], [0, 0], [1, 1]],
                           dtype=torch.bool)
    got = tbk.divergence_counts(keys, entered, [3, 5], warp=4)
    assert got == {
        "rays": 6, "trips": 3, "warp_fullness": 0.5,
        "clusters_per_ray": 1.0, "union_clusters_per_trip": 5 / 3,
        "issued_pairs": (8 + 5 + 8) * 4, "useful_pairs": 11 + 5 + 8,
        "useful_share": 24 / 84, "entering_lanes": [4, 1, 0, 0]}


@pytest.mark.parametrize("hint", [False, True], ids=["plain", "hint"])
def test_warp_divergence_matches_counters(hint):
    """The count over a small render agrees with the plain version's own
    counters: its rays, its loop trips per warp and its clusters entered;
    and the plain version's results are untouched by the spy."""
    baked = _bake("book_one_final", 16)
    if hint:
        baked = dataclasses.replace(baked, winner_hint=True)
    w, h = 32, 16
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=w, height=h, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h), cfg))
    perm, _ = tfused._block_perm(w, h, 32)
    planes = tfused.lane_planes(torch.from_numpy(perm.astype(np.int64)), w,
                                8)
    salts = (0, 0, 50, 2)
    before = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
    got = tbk.warp_divergence(baked, salts, cam, *planes)
    after = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
    rays, trips, _, clusters = before[3].tolist()
    assert got["rays"] == rays and got["trips"] == trips
    assert round(got["clusters_per_ray"] * rays) == clusters
    assert sum(got["entering_lanes"]) > 0
    assert got["useful_pairs"] <= got["issued_pairs"]
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert tbk._take.__name__ == "_take"


def test_sweep_form_is_checked_and_changes_nothing_on_cpu():
    baked = _bake("book_one_final", 16)
    w, h = 16, 8
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=w, height=h, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h), cfg))
    perm, _ = tfused._block_perm(w, h, 32)
    planes = tfused.lane_planes(torch.from_numpy(perm.astype(np.int64)), w,
                                8)
    salts = (0, 0, 8, 1)
    a = tbk.fused_render_baked(baked, salts, cam, *planes)
    b = tbk.fused_render_baked(baked, salts, cam, *planes,
                               sweep=tbk.SWEEP_SERIAL)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="sweep form"):
        tbk.fused_render_baked(baked, salts, cam, *planes,
                               sweep=tbk.SWEEP_COOP + 1)


# --- the dynamic culled sweep (csrc/dynculled.cu) ------------------------------


def _dyn_case(name):
    """Dynamic culled tables (``models/fused.py`` ``_dyn_tables``, the book
    camera's hint) and the camera, for a scene at a cluster size: spheres
    swept flat (book_one_final/16, 31 clusters in two batches of 16) or
    rolled (the book with every sphere twice, /8: 128 clusters in 8 supers,
    exact ties), triangles flat (terrain 11x11 quads /8: 31 clusters, the
    last padded) or rolled (terrain 19x19 /8: 91 clusters in 6 supers),
    textured (book_checker/16)."""
    book = get_scene("book_one_final")
    scene, tris, cs = {
        "flat": (book, None, 16),
        "rolled": (book.permuted(np.repeat(np.arange(book.num_spheres), 2)),
                   None, 8),
        "tri-flat": (*mesh_terrain_scene(n_quads=11), 8),
        "tri-rolled": (*mesh_terrain_scene(n_quads=19), 8),
        "textured": (get_scene("book_checker"), None, 16),
    }[name]
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=16, height=8, engine="fused")
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    eye = tfused._concrete_eye(cc.view_matrix())
    return tfused._dyn_tables(arrays, cs, camera_pos=eye), cc


def _dyn_rays(tab, rng, n):
    """Rays over a hierarchy's slab box: the first half incoherent
    (origins in and around the box, random unit directions, a quarter of
    them straight up from above the box, so that they enter nothing), the
    second a narrow beam from outside the box at its centre, whose warps
    enter the same clusters."""
    slab = (tab.tri_slab if tab.n_tri_clusters else tab.slab)[0].numpy()
    lo, hi = slab[0:3], slab[3:6]
    mid, ext = (lo + hi) / 2, (hi - lo) / 2
    half = n // 2
    o = (mid + ext * rng.uniform(-1.2, 1.2, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    up = slice(0, n // 8)
    o[up, 1] = hi[1] + 1.0
    d[up] = (0.0, 1.0, 0.0) + rng.normal(0.0, 0.1, (n // 8, 3))
    eye = mid + np.float32((0.9, 0.5, 1.1)) * np.maximum(ext, 1.0) * 2.5
    o[half:] = eye
    d[half:] = (mid - eye) + rng.normal(0.0, 0.05, (n - half, 3)) \
        * np.linalg.norm(mid - eye)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(v, np.float32)) for v in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]


def _dyn_sphere_t(tab, ox, oy, oz, dx, dy, dz):
    """Each ray's t against every sphere row (rays x rows): the slimmed
    quadratic in the shifted frame with both roots, in the kernel's order
    of operations (csrc/dynculled.cu sphere_t)."""
    sh = tab.slab[1]
    oxp, oyp, ozp = ox - sh[0], oy - sh[1], oz - sh[2]
    hdx, hdy, hdz = 0.5 * dx, 0.5 * dy, 0.5 * dz
    dd_o = dx * oxp + dy * oyp + dz * ozp
    oo2 = oxp * oxp + oyp * oyp + ozp * ozp
    rows = tab.spheres
    c2x, c2y, c2z, kappa = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    col = tbk._col
    nb = (col(hdx) * c2x + col(hdy) * c2y + col(hdz) * c2z) - col(dd_o)
    c_q = (col(oo2) + kappa) - (col(oxp) * c2x + col(oyp) * c2y
                                + col(ozp) * c2z)
    disc = nb * nb - c_q
    sq = torch.sqrt(disc)
    t1, t2 = nb - sq, nb + sq
    return torch.where(t1 > T_MIN, t1,
                       torch.where(t2 > T_MIN, t2, T_FAR)).numpy()


def dyn_coop_sweep(tab, rays, g_lanes, t_max, live=None):
    """The kernel's warp sweep over the dynamic tables (csrc/dynculled.cu
    nearest with a voting form) emulated warp by warp: the globals per
    lane, then each hierarchy with each lane's conds (a flat sweep in
    batches of 16 whose conds take the cap at the batch's start; a rolled
    one over supers of 16, a super's cond against the running cap, its
    children's against the cap at its entry, walked when any lane entered
    it), a vote per cluster, and the serial fold where more than ``t_max``
    lanes enter, the cooperative fold otherwise.  A lane that is not
    ``live`` (bool per ray; all are by default) tests and enters nothing.
    Winners in the plain version's index space (sphere rows, then triangle
    rows).  Returns (best_t, best_i, supers, clusters) per ray, the count
    of folds of each kind, and the count of entries that the cap rules let
    in where the running cap would not."""
    ox, oy, oz, dx, dy, dz = rays
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    cs = tab.cluster_size
    levels = []
    for n, n_sup, boxes, sboxes, slab, t_all, row0, offset in (
            (tab.n_clusters, tab.n_supers, tab.boxes, tab.super_boxes,
             tab.slab[0], _dyn_sphere_t(tab, *rays), tab.n_globals, 0),
            (tab.n_tri_clusters, tab.n_tri_supers, tab.tri_boxes,
             tab.tri_super_boxes, tab.tri_slab[0],
             tbk.tri_t(tab.triangles, *rays).numpy(), 0,
             tab.spheres.shape[0])):
        if not n:
            continue
        c_ok, c_entry = (v.numpy() for v in tbk.box_conds(
            boxes[:, 0:3], boxes[:, 3:6], ox, oy, oz, *inv))
        s_ok, s_entry = (v.numpy() for v in tbk.box_conds(
            sboxes[:, 0:3], sboxes[:, 3:6], ox, oy, oz, *inv))
        t_exit = tbk.slab_exit(slab[0:3], slab[3:6], ox, oy, oz,
                               *inv).numpy()
        levels.append((n, n_sup, c_ok, c_entry, s_ok, s_entry, t_exit, t_all,
                       row0, offset))
    t_glob = _dyn_sphere_t(tab, *rays)[:, :tab.n_globals]
    n = ox.shape[0]
    out_t = np.full(n, T_FAR, dtype=np.float32)
    out_i = np.full(n, -1, dtype=np.int64)
    supers = np.zeros(n, dtype=np.int64)
    clusters = np.zeros(n, dtype=np.int64)
    kinds = {"coop": 0, "serial": 0, "stale": 0}
    live = np.ones(n, dtype=bool) if live is None else np.asarray(live)
    for w in range(0, n, WARP):
        lanes = np.arange(w, w + WARP)
        on = live[lanes]
        b_t, b_i = serial_fold(t_glob[lanes], 0, out_t[lanes], out_i[lanes],
                               on)
        for (n_cl, n_sup, c_ok, c_entry, s_ok, s_entry, t_exit, t_all, row0,
             offset) in levels:

            def visit(k, gate, cap):
                nonlocal b_t, b_i
                enter = (gate & c_ok[lanes, k] & (c_entry[lanes, k] < cap))
                running = np.minimum(b_t, t_exit[lanes])
                kinds["stale"] += int((enter & ~(c_entry[lanes, k]
                                                 < running)).sum())
                clusters[lanes] += enter
                if not enter.any():
                    return
                first = row0 + k * cs
                tc = t_all[lanes, first:first + cs]
                if enter.sum() <= t_max:
                    kinds["coop"] += 1
                    b_t, b_i, _ = coop_fold(tc, offset + first, b_t, b_i,
                                            enter, g_lanes)
                else:
                    kinds["serial"] += 1
                    b_t, b_i = serial_fold(tc, offset + first, b_t, b_i,
                                           enter)

            if not n_sup:
                for k0 in range(0, n_cl, 16):
                    cap = np.minimum(b_t, t_exit[lanes])
                    for k in range(k0, min(n_cl, k0 + 16)):
                        visit(k, on, cap)
                continue
            for s in range(n_sup):
                cap = np.minimum(b_t, t_exit[lanes])
                es = on & s_ok[lanes, s] & (s_entry[lanes, s] < cap)
                supers[lanes] += es
                if es.any():
                    for k in range(s * 16, (s + 1) * 16):
                        visit(k, es, cap)
        out_t[lanes], out_i[lanes] = b_t, b_i
    return out_t, out_i, supers, clusters, kinds


@pytest.mark.parametrize("case", [
    ("flat", 8, 12), ("flat", 4, 32), ("rolled", 8, 12), ("rolled", 2, 4),
    ("tri-flat", 8, 12), ("tri-rolled", 8, 12), ("textured", 8, 12),
], ids=["flat-g8t12", "flat-g4t32", "rolled-g8t12", "rolled-g2t4",
        "tri-flat-g8t12", "tri-rolled-g8t12", "textured-g8t12"])
def test_dyn_coop_sweep_equals_plain_version(case):
    """The emulated warp sweep over the dynamic tables gives, ray by ray,
    the serial form's (T = 0) winner bit for bit, and both give
    dynculled_intersect_reference's winner fields and cull counters; the
    vote took the cooperative branch (and the serial one below T = 32),
    the cap rules let in entries that a running cap would not, some rays
    entered nothing, and the tables hold NaN pad rows."""
    name, g_lanes, t_max = case
    tab, _ = _dyn_case(name)
    rng = np.random.default_rng(len(name) * 100 + g_lanes)
    rays = _dyn_rays(tab, rng, 4 * WARP)
    c_t, c_i, c_sup, c_clu, kinds = dyn_coop_sweep(tab, rays, g_lanes,
                                                   t_max)
    s_t, s_i, s_sup, s_clu, _ = dyn_coop_sweep(tab, rays, g_lanes, 0)
    assert_same(c_t, c_i, s_t, s_i)
    assert np.array_equal(c_sup, s_sup) and np.array_equal(c_clu, s_clu)
    *fields, supers, clusters = tdk.dynculled_intersect_reference(tab,
                                                                  *rays)
    winner = tdk._winner(tab, torch.from_numpy(c_t), torch.from_numpy(c_i))
    assert len(winner) == len(fields)
    for a, b in zip(winner, fields):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    assert np.array_equal(c_sup, supers.numpy())
    assert np.array_equal(c_clu, clusters.numpy())
    assert kinds["coop"] > 0 and (kinds["serial"] > 0) == (t_max < WARP)
    assert kinds["stale"] > 0
    assert (c_clu == 0).any() and c_clu.max() > 0 and (c_i >= 0).any()
    rolled = tab.n_supers or tab.n_tri_supers
    assert bool(rolled) == name.endswith("rolled")
    if rolled:
        assert (c_sup > 0).any() and (c_sup < c_sup.max()).any()
    pads = (tab.triangles if tab.n_tri_clusters else tab.spheres)[:, 0]
    assert torch.isnan(pads).any()
    assert tab.textured == (name == "textured")


def test_dyn_coop_sweep_exact_ties():
    """The book with every sphere twice: each sphere hit is an exact tie of
    two rows, and the winner is the first of them (the smaller row index),
    in the cooperative fold as in the serial walk."""
    tab, _ = _dyn_case("rolled")
    rng = np.random.default_rng(17)
    rays = _dyn_rays(tab, rng, 4 * WARP)
    c_t, c_i, *_ = dyn_coop_sweep(tab, rays, 8, 32)   # always cooperative
    t = _dyn_sphere_t(tab, *rays)
    hit = c_i >= 0
    twins = (t[hit] == c_t[hit, None]).sum(axis=1)
    assert (twins >= 2).sum() > WARP
    first = np.argmax(t[hit] == c_t[hit, None], axis=1)
    assert np.array_equal(c_i[hit], first)


@pytest.mark.parametrize("name", ["flat", "tri-rolled"])
def test_dyn_warp_divergence_matches_counters(name):
    """The dynamic count over a small render agrees with the plain
    version's own counters: its rays, its loop trips per warp, its
    clusters and supers entered; and the plain version's results are
    untouched by the spy."""
    tab, cc = _dyn_case(name)
    w, h = 16, 8
    cfg = RenderConfig(width=w, height=h, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h), cfg))
    perm, _ = tfused._block_perm(w, h, 32)
    planes = tfused.lane_planes(torch.from_numpy(perm.astype(np.int64)), w,
                                8)
    salts = (0, 0, 6, 2)
    before = tdk.fused_render_dynculled_reference(tab, salts, cam, *planes)
    got = tdk.warp_divergence(tab, salts, cam, *planes)
    after = tdk.fused_render_dynculled_reference(tab, salts, cam, *planes)
    rays, trips, supers, clusters = before[3].tolist()
    assert got["rays"] == rays and got["trips"] == trips
    assert round(got["clusters_per_ray"] * rays) == clusters
    assert round(got["supers_per_ray"] * rays) == supers
    assert got["super_boxes_per_ray"] == tab.n_supers + tab.n_tri_supers
    assert (supers > 0) == name.endswith("rolled")
    assert sum(got["entering_lanes"]) > 0
    assert got["useful_pairs"] <= got["issued_pairs"]
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    assert tdk._col is tbk._col and tdk.torch is torch


def test_dyn_sweep_form_is_checked_and_changes_nothing_on_cpu():
    tab, cc = _dyn_case("tri-flat")
    w, h = 16, 8
    cfg = RenderConfig(width=w, height=h, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h), cfg))
    perm, _ = tfused._block_perm(w, h, 32)
    planes = tfused.lane_planes(torch.from_numpy(perm.astype(np.int64)), w,
                                8)
    salts = (0, 0, 8, 1)
    a = tdk.fused_render_dynculled(tab, salts, cam, *planes)
    b = tdk.fused_render_dynculled(tab, salts, cam, *planes,
                                   sweep=tdk.SWEEP_SERIAL)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="sweep form"):
        tdk.fused_render_dynculled(tab, salts, cam, *planes,
                                   sweep=tdk.SWEEP_COOP + 1)
    assert tdk.LAUNCHES == tdk.COOP_LAUNCHES == 0


def test_row_divergence_command_on_cpu(capsys):
    """``profile_frame --row NAME --divergence LANES --spp N --device cpu``
    counts a mesh row's window from the plain version on the host: one
    block of the knot row at 1 spp, its counts consistent with themselves
    (every ray tests the row's 196 super boxes)."""
    from wavefront_path_tracer_tpu_torch import profile_frame

    assert profile_frame.main(["--row", "knot50k_dynamic", "--divergence",
                               "1024", "--spp", "1", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["row"] == "knot50k_dynamic" and rep["spp"] == 1
    assert rep["lanes"][1] - rep["lanes"][0] == 1024
    assert rep["rays"] >= 1024 and rep["trips"] >= 1024 // WARP
    assert rep["super_boxes_per_ray"] == 196
    assert 0 < rep["supers_per_ray"] <= rep["union_supers_per_trip"]
    with pytest.raises(ValueError, match="32x32"):
        profile_frame.row_divergence("knot50k_dynamic", 1000, "cpu", 1)
