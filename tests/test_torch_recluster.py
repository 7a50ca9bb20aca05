"""The port's recluster path (plain versions, CPU) against the JAX
package: the segment schedule, the coherence key and its sort
permutation bit for bit, the segment path's raygen to a few ulps, one
segment of each segment kernel against the JAX kernels in interpret mode
on a hand-made tile, and whole renders at recluster 2 under the
statistical parity rule; within the port, recluster 1, recluster 2 and
no sort give the same bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.ops.raygen import generate_rays as jax_rays
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu.scene import CameraController as JaxCamera
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dyn_tables as dt
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
from wavefront_path_tracer_tpu_torch.renderer import Renderer, prepare_scene
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    MeshSceneBuilder,
    get_scene,
    mesh_demo_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

BASE = RenderConfig(width=32, height=16, samples_per_pixel=2,
                    samples_per_frame=2, max_bounces=8, engine="fused")
KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")


def _cover_camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 35.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


def _clustered_scene():
    """The reference's recluster stats scene (tests/test_fused.py:
    551-562): a ground and 96 small spheres, which form clusters."""
    b = MeshSceneBuilder()
    ground = b.lambertian([0.5, 0.5, 0.5])
    b.sphere([0.0, -1000.0, 0.0], 1000.0, ground)
    rs = np.random.RandomState(3)
    for i in range(96):
        m = b.lambertian(rs.uniform(0.2, 0.9, 3).tolist())
        b.sphere([float(i % 10) - 5.0, 0.2, float(i // 10) - 5.0], 0.2, m)
    return b.build()


def _small_clustered_scene():
    """A ground and 32 small spheres in a grid before the cover camera's
    target: clusters of 4 and 8 with a quicker trace than the 97-sphere
    scene's."""
    b = MeshSceneBuilder()
    b.sphere([0.0, -1000.0, 0.0], 1000.0, b.lambertian([0.5, 0.5, 0.5]))
    rs = np.random.RandomState(3)
    for i in range(32):
        m = b.lambertian(rs.uniform(0.2, 0.9, 3).tolist())
        b.sphere([0.5 * (i % 8) - 1.75, 0.2, 0.5 * (i // 8) - 2.5], 0.2, m)
    return b.build()


def _arrays(scene, tris=None):
    a = {k: np.asarray(getattr(scene, k)) for k in KEYS}
    if tris is not None:
        a.update(tri_v0=tris.v0, tri_e1=tris.e1, tri_e2=tris.e2)
    return a


# --- host pieces, bit for bit -------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_segment_schedule_matches_jax(k):
    for max_bounces in (1, 2, 3, 5, 8, 13, 50, 64):
        ks = tfused._segment_schedule(k, max_bounces)
        assert ks == jfused._segment_schedule(k, max_bounces)
        assert sum(ks) == max_bounces
    assert tfused._segment_schedule(2, 50) == (2, 2, 4, 8, 16, 18)


def _jax_scene_box(a):
    """The reference's Morton bounds (render_pixels_recluster, 761-771)."""
    centers = jnp.asarray(a["centers"])
    absr = jnp.abs(jnp.asarray(a["radii"]))[:, None]
    lo = jnp.min(centers - absr, axis=0)
    hi = jnp.max(centers + absr, axis=0)
    if "tri_v0" in a:
        v0 = jnp.asarray(a["tri_v0"])
        v1 = v0 + jnp.asarray(a["tri_e1"])
        v2 = v0 + jnp.asarray(a["tri_e2"])
        lo = jnp.minimum(lo, jnp.minimum(v0, jnp.minimum(v1, v2)).min(0))
        hi = jnp.maximum(hi, jnp.maximum(v0, jnp.maximum(v1, v2)).max(0))
    return lo, 1.0 / jnp.maximum(hi - lo, 1e-6)


@pytest.mark.parametrize("name", ["book_bubble", "terrain", "procedural"])
def test_coherence_key_and_order_bit_exact(name):
    """Random planes with dead lanes, origins inside and outside the box
    (the clip), a few NaN origins, zero and negative-zero directions; a
    scene box with a negative radius (book_bubble) and one with
    triangles (terrain).  The box, the key and the stable sort's
    permutation are the reference's, bit for bit."""
    if name == "terrain":
        scene, tris = mesh_terrain_scene(n_quads=4)
        a = _arrays(scene, tris)
    else:
        kw = {"n": 40, "seed": 5} if name == "procedural" else {}
        a = _arrays(get_scene(name, **kw))
    if name == "book_bubble":
        assert (a["radii"] < 0).any()
    lo_j, ie_j = _jax_scene_box(a)
    lo_t, ie_t = tfused._scene_box(
        {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()})
    np.testing.assert_array_equal(lo_t.numpy().view(np.int32),
                                  np.asarray(lo_j).view(np.int32))
    np.testing.assert_array_equal(ie_t.numpy().view(np.int32),
                                  np.asarray(ie_j).view(np.int32))
    rng = np.random.default_rng(7)
    n = 4096
    lo, hi = np.asarray(lo_j), np.asarray(lo_j) + 1.0 / np.asarray(ie_j)
    o = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n, 3))
    o = o.astype(np.float32)
    o[:8, 1] = np.nan
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[8:16] = 0.0
    d[16:24] = -0.0
    alive = (rng.uniform(size=n) < 0.7).astype(np.float32)
    planes = [*o.T, *d.T, alive]
    key_j = np.asarray(jfused._coherence_key(
        *(jnp.asarray(np.ascontiguousarray(p)) for p in planes), lo_j, ie_j))
    key_t = tfused._coherence_key(
        *(torch.from_numpy(np.ascontiguousarray(p)) for p in planes), lo_t,
        ie_t)
    assert key_t.dtype == torch.int32
    np.testing.assert_array_equal(key_t.numpy(), key_j)
    assert (key_j == 0x7FFFFFFF).sum() == (alive == 0).sum()
    assert len(np.unique(key_j)) > 100
    np.testing.assert_array_equal(
        torch.sort(key_t, stable=True).indices.numpy(),
        np.asarray(jnp.argsort(jnp.asarray(key_j))))


@pytest.mark.parametrize("lens", [True, False], ids=["lens", "pinhole"])
@pytest.mark.parametrize("sampler", ["random", "stratified"])
def test_generate_rays_matches_jax(sampler, lens):
    """The segment path's raygen against the reference's XLA raygen.
    The 4x4 products are elementwise float32 sums in the port and an XLA
    dot in the reference (its own order and multiply-add contraction),
    so origins agree to 1 ulp and unit directions to 2.4e-7 (two ulps at
    1.0; components near zero differ by more ulps of their own)."""
    w, h = 48, 27
    jc, tc = JaxCamera.book_one_final(), CameraController.book_one_final()
    if not lens:
        jc.defocus_angle_deg = 0.0
        tc.defocus_angle_deg = 0.0
    pix = np.arange(w * h, dtype=np.int64)[::-1].copy()
    jo, jd = jax_rays(jnp.asarray(pix, jnp.uint32), w, h, jnp.uint32(3),
                      jnp.uint32(21), jc.gpu_camera(),
                      jnp.asarray(jc.view_matrix()),
                      jnp.asarray(jc.inverse_projection(w, h)),
                      sampler=sampler)
    to, td = generate_rays(torch.from_numpy(pix), w, h, 3, 21,
                           tc.gpu_camera(), tc.view_matrix(),
                           tc.inverse_projection(w, h), sampler=sampler)
    jo = np.broadcast_to(np.asarray(jo), to.shape)
    np.testing.assert_array_max_ulp(to.numpy(), jo, maxulp=1)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=2.4e-7)
    assert (to.numpy() != to.numpy()[0]).any() == lens


# --- one segment against the JAX kernels --------------------------------------

def _state_tile(seed=0):
    """A hand-made (8, 128) tile of segment state from the 97-sphere
    scene's camera: primary rays of 1024 pixels at mixed samples, then
    mixed bounce counts, throughputs and radiance; a quarter of the
    lanes dead.  Returns the port's (ids, state)."""
    rng = np.random.default_rng(seed)
    cc = _cover_camera()
    n = 1024
    pix = torch.from_numpy(rng.permutation(40 * 40)[:n].astype(np.int64))
    o, d = generate_rays(pix, 40, 40, 0, 5, cc.gpu_camera(),
                         cc.view_matrix(), cc.inverse_projection(40, 40))
    state = torch.zeros((13, n), dtype=torch.float32)
    state[0:3] = o.T
    state[3:6] = d.T
    state[6:9] = torch.from_numpy(rng.uniform(0.3, 1.0, (3, n))
                                  .astype(np.float32))
    state[9:12] = torch.from_numpy(rng.uniform(0.0, 0.2, (3, n))
                                   .astype(np.float32))
    state[12] = torch.from_numpy((rng.uniform(size=n) > 0.25)
                                 .astype(np.float32))
    ids = torch.zeros((4, n), dtype=torch.int32)
    ids[0] = pix.to(torch.int32)
    ids[1] = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    ids[2] = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    ids[3] = torch.arange(n, dtype=torch.int32)
    return ids, state


def _jax_state(ids, state):
    """The reference's planes: pix, sample (u32) and the 14 _SEG_STATE
    planes (bounce as f32 first), copied (JAX on the CPU may alias a numpy
    buffer, and the port updates its state in place)."""
    def plane(v, dtype=np.float32):
        return jnp.asarray(v.numpy().astype(dtype).reshape(8, 128))

    pix, samp = plane(ids[0], np.uint32), plane(ids[1], np.uint32)
    seg = (plane(ids[2]),) + tuple(plane(state[k]) for k in range(13))
    return pix, samp, seg


@pytest.mark.parametrize("kind", ["culled", "unculled", "dynculled"])
def test_one_segment_matches_jax(kind):
    """One segment (K=2, roulette from bounce 2, clamp 0.5) of the plain
    segment versions against the JAX segment kernels in interpret mode on
    the same tile.  Alive is exact everywhere; bounce is exact on the
    lanes alive after the segment (the reference's tile loop keeps
    counting a dead lane's, which nothing reads); rays agree.  The floats
    agree to 1e-4 (relative, absolute below 1) on 99% of the lanes and to
    1e-3 on all: XLA:CPU contracts multiply-adds and the port does not,
    and the hit distance's cancellation magnifies that rounding (as for
    the intersects' own tiles, test_torch_baked.py)."""
    _segment_vs_jax(kind, _clustered_scene())


@pytest.mark.parametrize("kind,probe", [
    ("culled", "dbl_entry"), ("culled", "dbl_cond"),
    ("culled", "dbl_entry2"), ("culled", "dbl_cond2"),
    ("dynculled", "dyn_dbl_entry"), ("dynculled", "dyn_dbl_cond"),
    ("dynculled", "dyn_dbl_global")])
def test_one_probed_segment_matches_jax(kind, probe):
    """The same segment with a stage probe of the segment kernel's
    intersect: the JAX segment kernel traced with PROBE = {probe} (the
    baked closure reads it when traced; the dynamic kernel also takes it
    as its static ``probe``) against the port's plain segment with
    ``probe=``, by the rule of test_one_segment_matches_jax, on 33
    spheres (clusters of 4 baked, 8 dynamic) to keep the trace short."""
    jpk.PROBE = frozenset({probe})
    try:
        _segment_vs_jax(kind, _small_clustered_scene(), probe=probe,
                        cluster_size=4)
    finally:
        jpk.PROBE = frozenset()


def _segment_vs_jax(kind, scene, probe=None, cluster_size=16):
    """test_one_segment_matches_jax's comparison on ``scene``: the baked
    culled kernels with clusters of ``cluster_size``, the dynamic one with
    clusters of 8; ``probe`` goes to the port's plain segment and to the
    JAX dynamic kernel's static argument (the caller sets PROBE)."""
    a = _arrays(scene)
    ids, state = _state_tile()
    pix, samp, seg = _jax_state(ids, state)
    opts = {"rr_start": 2, "clamp": 0.5}
    probes = {"probe": probe} if probe else {}
    salts = (0, 8, 2, 0)
    counts = torch.zeros((tfk.SEG_COUNTS, 1024), dtype=torch.int32)
    hint = np.array([-2.0, 2.0, 1.0])
    if kind == "dynculled":
        cs = 8
        packed = dt.pack_culled_scene(a, cluster_size=cs, camera_hint=hint)
        tab = dt.device_tables(packed, cs)
        tdk.fused_segment_dynculled(tab, salts, ids, state, counts, **opts,
                                    **probes)
        (*tables, ngb, ncl, nsup, ntc, ntsup, pkd) = packed
        out, aux = jpk.fused_segment_dynculled(
            *[jnp.asarray(t) for t in tables], jnp.asarray(salts), pix,
            samp, seg, n_global_blocks=ngb, n_clusters=ncl, n_supers=nsup,
            n_tri_clusters=ntc, n_tri_supers=ntsup, cluster_size=cs,
            interpret=True, packed_attrs=pkd,
            probe=frozenset(probes.values()), **opts)
    else:
        if kind == "culled":
            baked = bake.bake_culled(a, cluster_size, camera_hint=hint)
            fn = jpk.baked_culled_intersect(*(a[k] for k in KEYS),
                                            cluster_size=cluster_size,
                                            camera_hint=hint)
        else:
            baked = bake.bake_unculled(a)
            fn = jpk.baked_intersect(*(a[k] for k in KEYS))
        tbk.fused_segment_baked(baked, salts, ids, state, counts, **opts,
                                **probes)
        out, aux = jpk.fused_segment_baked(fn, jnp.asarray(salts), pix, samp,
                                           seg, interpret=True, **opts)
    ref = [np.asarray(p).reshape(-1) for p in out]
    alive = state[12].numpy()
    np.testing.assert_array_equal(alive, ref[13])
    live = alive > 0
    assert 30 < live.sum() < 1000
    np.testing.assert_array_equal(ids[2].numpy()[live],
                                  ref[0][live].astype(np.int32))
    for k in range(12):
        port, want = state[k].numpy(), ref[k + 1]
        np.testing.assert_allclose(port, want, rtol=1e-3, atol=1e-3)
        err = np.abs(port - want) / np.maximum(np.abs(want), 1.0)
        assert np.quantile(err, 0.99) < 1e-4, (k, np.quantile(err, 0.99))
    assert int(counts[0].sum()) == int(np.asarray(aux)[:, 0].sum())
    if kind != "unculled":
        assert int(counts[2].sum()) > 0
    # Loop trips: each warp's entry of row 3 is the largest ray count of
    # its 32 lanes (a numpy reduction of the per-lane rays); grouped as
    # the reference's tile (all 1024 lanes), the largest count is the
    # tile's lockstep trips, its `niter`.
    rays = counts[0].numpy()
    want = rays.reshape(-1, 32).max(axis=1)
    np.testing.assert_array_equal(counts[3, :32].numpy(), want)
    assert not counts[3, 32:].any()
    assert rays.max() == int(np.asarray(aux)[:, 1].sum())


# --- whole renders -------------------------------------------------------------

def _both(scene, cc, cfg, tris=None):
    j = jax_render(scene, cc, cfg, tris)
    t = torch_render(scene, cc, cfg, tris, device="cpu")
    assert t.samples == j.samples == cfg.samples_per_pixel
    check_parity(t.accumulated / t.samples, j.accumulated / j.samples,
                 t.rays_traced, j.rays_traced)
    return t, j


@pytest.mark.parametrize("change", [
    {"intersector": "baked", "baked_clusters": 16},
    {"intersector": "bruteforce", "baked_clusters": 16},
], ids=["baked-cull16", "dynamic16"])
def test_recluster_render_matches_jax(change):
    t, _ = _both(_clustered_scene(), _cover_camera(),
                 BASE.replace(recluster=2, **change))
    assert t.image.mean() > 0.05


def test_mesh_demo_recluster_matches_persistent():
    """Triangles through the segments against the port's persistent path
    (the reference's own pairing, tests/test_fused.py:512-534): the
    statistical rule, and the ray counts within 1e-3 (the two raygens
    differ by ulps, so a few near-tie paths change length)."""
    scene, tris = mesh_demo_scene()
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([0.0, 1.2, 3.0], [0.0, 0.3, -0.5])
    cc.vfov_deg = 45.0
    cc.defocus_angle_deg = 0.0
    cfg = BASE.replace(width=48, height=32, samples_per_pixel=4,
                       samples_per_frame=4, intersector="bruteforce",
                       baked_clusters=16)
    pers = torch_render(scene, cc, cfg, tris, device="cpu")
    seg = torch_render(scene, cc, cfg.replace(recluster=2), tris,
                       device="cpu")
    check_parity(seg.accumulated / 4, pers.accumulated / 4,
                 seg.rays_traced, pers.rays_traced)
    assert abs(seg.rays_traced - pers.rays_traced) / pers.rays_traced < 1e-3


@pytest.mark.parametrize("change", [
    {"intersector": "baked", "baked_clusters": 16},
    {"intersector": "baked", "baked_clusters": 0},
    {"intersector": "bruteforce", "baked_clusters": 8},
], ids=["baked-cull16", "baked-unculled", "dynamic8"])
def test_recluster_invariant_to_order_and_k(change):
    """A ray's result depends neither on its lane nor on the segment
    boundaries: recluster 1, recluster 2 and recluster 2 with no sort
    give the same radiance words and per-ray counters (rays, supers and
    clusters entered); the loop trips per warp lie between rays / 32 and
    rays."""
    scene, cc = _clustered_scene(), _cover_camera()
    cfg = BASE.replace(width=40, height=24, **change)
    r = Renderer(scene, cc, cfg, device="cpu")
    args = (r.scene_arrays, cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(40, 24))
    outs = [tfused.render_samples_with_stats(*args, cfg.replace(recluster=k),
                                             0, 0, 2) for k in (1, 2)]
    clusters = cfg.baked_clusters
    eye = tfused._concrete_eye(args[2])
    if cfg.intersector == "baked":
        tables = tfused._baked_scene(r.scene_arrays, clusters,
                                     camera_pos=eye)
        segment = tbk.fused_segment_baked
    else:
        tables = tfused._dyn_tables(r.scene_arrays, clusters, camera_pos=eye)
        segment = tdk.fused_segment_dynculled
    perm = torch.from_numpy(tfused._block_perm(40, 24, 32)[0]
                            .astype(np.int64))
    rad, rays, stats = tfused._recluster(
        segment, lambda ids, state, lo, inv_ext: (ids, state), tables, perm,
        *args, cfg.replace(recluster=2), 0, 0, 2, True)
    unsorted = torch.empty_like(rad)
    unsorted[perm] = rad
    outs.append((unsorted, rays, stats))
    ref = outs[0]
    # Loop trips per warp depend on which lanes share a warp at each
    # launch, so they are the one counter that K and the sort may move.
    per_ray = ("supers_entered", "clusters_entered")
    for rad, rays, stats in outs[1:]:
        assert torch.equal(rad.view(torch.int32), ref[0].view(torch.int32))
        assert int(rays) == int(ref[1])
        assert {k: int(stats[k]) for k in per_ray} == {
            k: int(ref[2][k]) for k in per_ray}
    for _rad, rays, stats in outs:
        assert int(rays) / 32 <= int(stats["iterations"]) <= int(rays)
    assert (int(ref[2]["clusters_entered"]) > 0) == (clusters > 0)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_recluster_iterations_sum_launch_warps(sort):
    """The segmented path's iterations: over every launch, the sum over
    32-lane groups, in the launch's lane order, of each group's largest
    count of rays traced in that launch (numpy, from the per-lane counts
    around each launch)."""
    scene, cc = _clustered_scene(), _cover_camera()
    cfg = BASE.replace(width=40, height=24, intersector="baked",
                       baked_clusters=16, recluster=2)
    r = Renderer(scene, cc, cfg, device="cpu")
    args = (r.scene_arrays, cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(40, 24))
    tables = tfused._baked_scene(r.scene_arrays, 16,
                                 camera_pos=tfused._concrete_eye(args[2]))
    want = []

    def segment(tables, salts, ids, state, counts, **kw):
        before = counts[0].numpy().copy()
        out = tbk.fused_segment_baked(tables, salts, ids, state, counts, **kw)
        rays = counts[0].numpy() - before
        want.append(rays.reshape(-1, 32).max(axis=1).sum())
        return out

    order = tfused.coherence_order if sort else (
        lambda ids, state, lo, inv_ext: (ids, state))
    _, rays, stats = tfused._recluster(segment, order, tables,
                                       torch.arange(40 * 24), *args, cfg, 0,
                                       0, 2, True)
    assert len(want) == 2 * len(tfused._segment_schedule(2, cfg.max_bounces))
    assert int(stats["iterations"]) == sum(want)
    assert int(rays) / 32 <= sum(want) < int(rays)


def test_refuses_bruteforce_without_clusters():
    """The reference's own refusal (models/fused.py:359-364): the plain
    brute-force kernel has no segment form."""
    with pytest.raises(NotImplementedError, match="culling intersector"):
        Renderer(get_scene("book_cover"), _cover_camera(),
                 BASE.replace(recluster=2), device="cpu")
    arrays = prepare_scene(get_scene("book_cover"), BASE, "cpu")
    tfused.check_supported(BASE.replace(recluster=2, baked_clusters=8),
                           arrays)
    tfused.check_supported(BASE.replace(recluster=1, intersector="baked"),
                           arrays)
