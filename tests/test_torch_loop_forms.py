"""The unculled kernels' loop forms, on the CPU.

The persistent (brute-force) kernel and the unculled baked kernel run
the warp's lanes in step (``csrc/common.cuh`` trace_warp) or each lane on
its own thread (trace_lane), and the unculled kernel in step stages the
triangle table a warp at a time in shared memory
(``csrc/baked.cu`` UnculledIntersect::stage_triangles).  Here: the count
model of the two loops (``fused_kernels.sample_trips`` against
``warp_trips``), the wrappers' form arguments, and a torch emulation of
the staged triangle sweep held bit for bit to the plain version's
winners.  The kernels themselves are checked on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase loop).
"""

import dataclasses

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.ops.fused_kernels import T_FAR, T_MIN
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    get_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

WARP = 32


def test_sample_trips_hand_made():
    """Two warps, two samples: regrouping at each sample end costs each
    warp its busiest lane per sample; the loop of trips only its busiest
    lane over both."""
    rays = np.zeros((2, 2 * WARP), dtype=np.int64)
    rays[:, 0] = (5, 1)          # warp 0: lanes 0 and 1 busy in turn
    rays[:, 1] = (1, 5)
    rays[:, WARP + 3] = (2, 2)   # warp 1: one lane, the same either way
    rays = torch.from_numpy(rays)
    assert int(tfk.sample_trips(rays)) == 5 + 5 + 2 + 2
    assert int(tfk.warp_trips(rays.sum(dim=0))) == 6 + 4
    for s in range(2):
        assert int(tfk.sample_trips(rays[s:s + 1])) == int(
            tfk.warp_trips(rays[s]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_trips_bounds_warp_trips(seed):
    """Random planes with a ragged last warp: never fewer trips than the
    loop of trips, and equal at one sample."""
    rng = np.random.default_rng(seed)
    rays = torch.from_numpy(rng.integers(0, 9, size=(5, 3 * WARP + 7)))
    assert int(tfk.sample_trips(rays)) >= int(tfk.warp_trips(rays.sum(0)))
    assert int(tfk.sample_trips(rays[:1])) == int(tfk.warp_trips(rays[0]))


def _book_case(w=16, h=8):
    """book_one_final's packed table, camera and block-order planes with
    padding lanes, as models/fused.py builds them."""
    scene = get_scene("book_one_final")
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=w, height=h, engine="fused")
    arrays = prepare_scene(scene, cfg, "cpu")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h), cfg))
    perm, _ = tfused._block_perm(w, h, 32)
    planes = tfused.lane_planes(torch.from_numpy(perm.astype(np.int64)), w,
                                8)
    return arrays, len(scene.radii), cam, planes


def test_sample_trips_of_a_plain_render():
    """``sample_rays`` of a small plain render, one sample at a time: its
    rays and trips are those of the plain version's own counters, over
    all samples at once (the loop of trips) and over each sample alone
    (the loop that regroups at every sample end)."""
    arrays, n, cam, planes = _book_case()
    table = arrays["scene_packed"]

    def intersect(*ray):
        return tfk.intersect_tile(table, n, *ray) + (None, None)

    salts = (3, 0, 8, 3)
    per = tfk.sample_rays(intersect, salts, cam, *planes)
    assert per.shape == (3, planes[0].numel())
    whole = tfk.fused_render_persistent_reference(table, n, salts, cam,
                                                  *planes)[3]
    assert int(per.sum()) == int(whole[0])
    assert int(tfk.warp_trips(per.sum(dim=0))) == int(whole[1])
    by_sample = sum(int(tfk.fused_render_persistent_reference(
        table, n, (3, s, 8, 1), cam, *planes)[3][1]) for s in range(3))
    assert int(tfk.sample_trips(per)) == by_sample
    assert by_sample > int(whole[1])


def test_loop_form_is_checked_and_changes_nothing_on_cpu():
    """Both wrappers take the form as one keyword argument, refuse an
    unknown one, and on the CPU run the plain version whatever the
    form."""
    arrays, n, cam, planes = _book_case()
    table = arrays["scene_packed"]
    salts = (0, 0, 8, 1)
    a = tfk.fused_render_persistent(table, n, salts, cam, *planes)
    b = tfk.fused_render_persistent(table, n, salts, cam, *planes,
                                    loop=tfk.LOOP_LANE)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="loop form"):
        tfk.fused_render_persistent(table, n, salts, cam, *planes, loop=-1)
    baked = tfused._baked_scene(arrays, 0)
    c = tbk.fused_render_baked(baked, salts, cam, *planes)
    for sweep in (tbk.SWEEP_SERIAL, tbk.SWEEP_COOP):
        d = tbk.fused_render_baked(baked, salts, cam, *planes, sweep=sweep)
        for x, y in zip(c, d):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="sweep form"):
        tbk.fused_render_baked(baked, salts, cam, *planes, sweep=-1)
    assert tfk.LAUNCHES == tfk.WARP_LAUNCHES == 0
    assert tbk.COOP_LAUNCHES == {"culled": 0, "unculled": 0,
                                 "segment_culled": 0, "segment_unculled": 0}


# --- the staged triangle sweep (csrc/baked.cu stage_triangles) -------------


def staged_sweep(baked, rays, live):
    """The unculled intersect's call of trace_warp with the triangle table
    staged a warp at a time, emulated: each live lane sweeps the spheres
    item by item in scene order (the generic quadratic), then the triangle
    rows in chunks of 32, each chunk copied as the kernel's shared slice
    holds it (the three float4 of a row that the pair test reads) and
    tested row by row in index order with the strict ``<``.  A lane that
    is not live tests nothing.  Returns the winner tuple."""
    ox, oy, oz, dx, dy, dz = rays
    items = baked.items
    best_t = torch.full_like(ox, T_FAR)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64)

    def take(t, i):
        nonlocal best_t, best_i
        better = live & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, i, best_i)

    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    for i in range(items.shape[0]):
        q = items[i]
        ocx, ocy, ocz = ox - q[0], oy - q[1], oz - q[2]
        b = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - q[3]
        disc = b * b - a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
        far = (torch.full_like(t2, T_FAR) if q[4] != 0.0
               else torch.where(t2 > T_MIN, t2, T_FAR))
        t = torch.where(t1 > T_MIN, t1, far)
        take(torch.where(disc >= 0.0, t, T_FAR), i)
    n_items, n_tris = items.shape[0], baked.n_triangles
    for c0 in range(0, n_tris, WARP):
        stage = baked.tri_items[c0:c0 + WARP, :12].clone()
        for k in range(stage.shape[0]):
            t = tbk.tri_t(stage[k:k + 1], ox, oy, oz, dx, dy, dz)[:, 0]
            take(t, n_items + c0 + k)
    return tbk._winner(baked, best_t, best_i), best_i


def _terrain_bake(case):
    """An unculled bake of a small terrain (5 x 5 quads: 50 triangles, 3
    spheres) with its triangle table changed for ``case``: "ragged" as it
    is (50 rows, the last chunk of 18), "ties" every row twice (each hit
    an exact tie of two rows, which the smaller index must win),
    "nan_pads" a NaN row after every sixth, "miss" as it is."""
    scene, tris = mesh_terrain_scene(n_quads=5)
    cfg = RenderConfig(width=8, height=8, engine="fused")
    baked = tfused._baked_scene(prepare_scene(scene, cfg, "cpu", tris), 0)
    rows = baked.tri_items
    if case == "ties":
        rows = torch.repeat_interleave(rows, 2, dim=0)
    elif case == "nan_pads":
        pad = torch.full((1, rows.shape[1]), float("nan"))
        rows = torch.cat([torch.cat([rows[k:k + 6], pad])
                          for k in range(0, rows.shape[0], 6)])
    return dataclasses.replace(baked, tri_items=rows.contiguous())


def _terrain_rays(rng, n, up=False):
    """Rays from above the terrain (heights 0.6-1.5 over 20 x 20), aimed
    down and across it; with ``up`` from above the spheres too (their tops
    at 3.2 and 3.4) and aimed at the sky, so that they hit nothing."""
    o = np.stack([rng.uniform(-9, 9, n),
                  rng.uniform(4.0, 6.0, n) if up else rng.uniform(2.0, 4.0, n),
                  rng.uniform(-9, 9, n)], axis=1)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 0.5
    if up:
        d[:, 1] = np.abs(d[:, 1]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for v in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]


@pytest.mark.parametrize("case", ["ragged", "ties", "nan_pads", "miss"])
def test_staged_triangle_sweep_equals_plain_version(case):
    """The emulated staged sweep over 8 warps of rays, a quarter of the
    lanes not live, against ``baked_intersect_reference``: every field of
    every live ray's winner bit for bit, a miss for the others."""
    rng = np.random.default_rng({"ragged": 1, "ties": 2, "nan_pads": 3,
                                 "miss": 4}[case])
    baked = _terrain_bake(case)
    n = 8 * WARP
    rays = _terrain_rays(rng, n, up=case == "miss")
    live = torch.from_numpy(rng.uniform(size=n) > 0.25)
    got, best_i = staged_sweep(baked, rays, live)
    want = tbk.baked_intersect_reference(baked, *rays)[:-2]
    miss = tbk._winner(baked, torch.full((n,), T_FAR),
                       torch.full((n,), -1, dtype=torch.int64))
    assert len(got) == len(want)
    for g, w, m in zip(got, want, miss):
        expect = torch.where(live, w, m)
        assert torch.equal(g.view(torch.int32), expect.view(torch.int32))
    n_items = baked.items.shape[0]
    tri = best_i >= n_items
    if case == "miss":
        assert (best_i[live] == -1).all()
        return
    assert tri[live].float().mean() > 0.5       # mostly triangle winners
    j = best_i[tri] - n_items
    if case == "ragged":
        assert baked.n_triangles % WARP and j.max() >= WARP
    if case == "ties":
        assert (j % 2 == 0).all()                # the first of each twin
    if case == "nan_pads":
        assert not torch.isnan(baked.tri_items[j, 0]).any()
        assert (j % 7 != 6).all()
