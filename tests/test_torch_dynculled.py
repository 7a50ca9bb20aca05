"""The dynamic culled intersect of the port (plain version, CPU) against
the JAX package: ``pack_culled_scene`` byte for byte, whole renders with
``intersector="bruteforce"`` and clusters (Pallas in interpret mode, or
the XLA megakernel for the big scenes) under the statistical parity
rule, and one tile of the intersect closure itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu.utils.image import rmse
from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import dyn_tables as dt
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.renderer import Renderer
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    get_scene,
    knot_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

BASE = RenderConfig(width=32, height=16, samples_per_pixel=2,
                    samples_per_frame=2, max_bounces=8, engine="fused",
                    intersector="bruteforce")
KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")


def _cover_camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 35.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


def _knot_camera():
    # The reference's own knot test view (tests/test_mesh.py:179-182).
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([0.0, 1.5, 4.0], [0.0, 0.0, 0.0])
    cc.vfov_deg = 45.0
    cc.defocus_angle_deg = 0.0
    return cc


def _arrays(scene, tris=None):
    a = {k: np.asarray(getattr(scene, k)) for k in KEYS}
    if tris is not None:
        a.update(tri_v0=tris.v0, tri_e1=tris.e1, tri_e2=tris.e2,
                 tri_albedo=tris.albedo, tri_fuzz=tris.fuzz,
                 tri_refract=tris.refract_idx, tri_mat_type=tris.mat_type)
    return a


# name -> (arrays, cluster size, camera hint)
PACK_SCENES = {
    "terrain6": lambda: (_arrays(*mesh_terrain_scene(n_quads=6)), 16, None),
    "knot1120": lambda: (_arrays(*knot_scene(1120)), 16,
                         np.array([0.0, 1.5, 4.0])),
    "procedural96": lambda: (_arrays(get_scene("procedural", n=96, seed=3)),
                             8, None),
    "book_one_final_hint": lambda: (_arrays(get_scene("book_one_final")), 16,
                                    np.array([13.0, 2.0, 3.0])),
    "procedural1200": lambda: (_arrays(get_scene("procedural", n=1200,
                                                 seed=3)), 16,
                               np.array([-2.0, 2.0, 1.0])),
}


@pytest.mark.parametrize("name", sorted(PACK_SCENES))
def test_pack_culled_scene_byte_identical(name):
    a, cs, hint = PACK_SCENES[name]()
    port = dt.pack_culled_scene(a, cluster_size=cs, camera_hint=hint)
    ref = jpk.pack_culled_scene(a, cluster_size=cs, camera_hint=hint)
    assert len(port) == len(ref) == 14
    for p, r in zip(port[:8], ref[:8]):
        assert p.dtype == r.dtype and p.shape == r.shape
        assert p.tobytes() == r.tobytes()
    assert port[8:] == ref[8:]
    assert [type(v) for v in port[8:]] == [type(v) for v in ref[8:]]
    ngb, ncl, nsup, ntc, ntsup, packed = port[8:]
    assert packed
    if name == "knot1120":
        assert ntc > dt._DYN_UNROLL_CLUSTERS and ntsup > 0
    if name == "procedural1200":
        assert ncl > dt._DYN_UNROLL_CLUSTERS and nsup > 0


def test_nan_words_survive_torch_round_trip():
    """Packed words that are NaN patterns as float32 keep their bits
    through a torch tensor (and its int32 view)."""
    a, cs, _ = PACK_SCENES["terrain6"]()
    a["tri_albedo"] = a["tri_albedo"].copy()
    a["tri_albedo"][:, 0] = 1.0          # r = 65535: 0xFFFF.... words
    tri = dt.pack_culled_scene(a, cluster_size=cs)[4]
    words = np.ascontiguousarray(tri[:, 12:14])
    assert np.isnan(words[:72, 0]).all()  # r:16|g:16, a NaN pattern
    t = torch.from_numpy(words).clone()
    assert np.array_equal(t.numpy().view(np.int32), words.view(np.int32))
    assert np.array_equal(t.view(torch.int32).numpy(), words.view(np.int32))


@pytest.mark.parametrize("name", ["terrain6", "procedural96"])
def test_device_tables_decode_as_reference(name):
    """The device layout is the reference tables row for row, with the
    packed words decoded as the reference's kernel decodes them."""
    a, cs, hint = PACK_SCENES[name]()
    packed = dt.pack_culled_scene(a, cluster_size=cs, camera_hint=hint)
    tab = dt.device_tables(packed, cs)
    scn, tri = packed[0], packed[4]
    sph = tab.spheres.numpy()
    real = ~np.isnan(scn[:, 0])
    assert np.isnan(sph[~real]).all()
    words = [jnp.asarray(np.ascontiguousarray(scn[real, c]).view(np.int32))
             for c in (4, 5)]
    ref = np.stack([np.asarray(v) for v in
                    jpk._unpack_albedo_mat(words, "16")], axis=1)
    np.testing.assert_array_equal(sph[real][:, [8, 9, 10, 13]], ref)
    np.testing.assert_array_equal(sph[real][:, 0:3], scn[real, 12:15])
    np.testing.assert_array_equal(sph[real][:, 3], scn[real, 10])
    np.testing.assert_array_equal(sph[real][:, 4:8], scn[real][:, [0, 1, 2,
                                                                  11]])
    t = tab.triangles.numpy()
    treal = ~np.isnan(tri[:, 0])
    assert t.shape[0] == tri.shape[0] and np.isnan(t[~treal]).all()
    np.testing.assert_array_equal(t[treal, 0:12], tri[treal, 0:12])
    np.testing.assert_array_equal(t[treal, 15:17], tri[treal, 15:17])
    if treal.any():
        words = [jnp.asarray(np.ascontiguousarray(tri[treal, c])
                             .view(np.int32)) for c in (12, 13)]
        ref = np.stack([np.asarray(v) for v in
                        jpk._unpack_albedo_mat(words, "16")], axis=1)
        np.testing.assert_array_equal(t[treal][:, [12, 13, 14, 17]], ref)


@pytest.mark.parametrize("view", ["reference", "cover"])
def test_dyn_tables_quantized_as_reference(view):
    """The render path's tables (hint quantized to 1/8 of the sphere
    centres' diagonal, even for a mesh) are the JAX package's
    ``_dyn_tables``."""
    scene, tris = mesh_terrain_scene(n_quads=6)
    a = _arrays(scene, tris)
    cc = CameraController.book_one_final()
    if view == "cover":
        cc = _cover_camera()
    eye = jfused._concrete_eye(cc.view_matrix())
    ref_tabs, ref_ints = jfused._dyn_tables(a, 8, camera_pos=eye)
    port = tfused._dyn_tables(scene_arrays_to_torch(a, "cpu"), 8,
                              camera_pos=tfused._concrete_eye(
                                  cc.view_matrix()))
    assert (port.n_globals // 8, port.n_clusters, port.n_supers,
            port.n_tri_clusters, port.n_tri_supers,
            port.attrs_packed) == ref_ints
    np.testing.assert_array_equal(port.tri_boxes.numpy(),
                                  np.asarray(ref_tabs[5]))
    again = tfused._dyn_tables(scene_arrays_to_torch(a, "cpu"), 8,
                               camera_pos=tfused._concrete_eye(
                                   cc.view_matrix()))
    assert again is port                 # from the cache


def _both(scene, cc, cfg, tris=None):
    j = jax_render(scene, cc, cfg, tris)
    t = torch_render(scene, cc, cfg, tris, device="cpu")
    assert t.samples == j.samples == cfg.samples_per_pixel
    check_parity(t.accumulated / t.samples, j.accumulated / j.samples,
                 t.rays_traced, j.rays_traced)
    return t, j


@pytest.mark.parametrize("case", ["procedural96/8", "book_bubble/16",
                                  "terrain5/8"])
def test_dynamic_render_matches_jax(case):
    cfg = BASE
    tris = None
    if case == "procedural96/8":
        scene = get_scene("procedural", n=96, seed=3)
        cfg = cfg.replace(baked_clusters=8)
    elif case == "book_bubble/16":
        # A negative radius (the reference's tests/test_fused.py:460).
        scene = get_scene("book_bubble")
        cfg = cfg.replace(baked_clusters=16, samples_per_pixel=8,
                          samples_per_frame=8)
    else:
        scene, tris = mesh_terrain_scene(n_quads=5)
        cfg = cfg.replace(baked_clusters=8)
    t, _ = _both(scene, _cover_camera(), cfg, tris)
    assert np.isfinite(t.accumulated).all()


@pytest.mark.parametrize("case", ["knot1120", "procedural1200"])
def test_big_scenes_match_megakernel(case):
    """Above 64 clusters the sweep is over supers (rolled): against the
    JAX XLA megakernel, as the reference's own tests hold it
    (tests/test_mesh.py:161-193)."""
    cfg = BASE.replace(width=40, height=24, max_bounces=5,
                       baked_clusters=16)
    if case == "knot1120":
        (scene, tris), cc = knot_scene(1120), _knot_camera()
    else:
        scene, tris = get_scene("procedural", n=1200, seed=3), None
        cc = _cover_camera()
    mk = jax_render(scene, cc, cfg.replace(engine="megakernel"), tris)
    r = Renderer(scene, cc, cfg, tris, device="cpu")
    _, rays, stats = tfused.render_samples_with_stats(
        r.scene_arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(cfg.width, cfg.height), cfg, 0, 0, 2)
    assert int(stats["supers_entered"]) > 0
    assert int(stats["clusters_entered"]) > 0
    t = r.render()
    assert mk.image.std() > 0.01
    assert rmse(t.image, mk.image) < 5e-3
    assert abs(t.accumulated.mean() / 2 - mk.accumulated.mean() / 2) < 2e-3


# --- one tile of the intersect closure ---------------------------------------

def _jax_dyn_tile(packed, cluster_size, rays):
    """The JAX dynamic intersect on one (8, 128) tile, in interpret mode:
    its winner tuple (15 fields with triangles, else 11) as flat numpy
    arrays."""
    (*tables, ngb, ncl, nsup, ntc, ntsup, pkd) = packed
    nf = 15 if ntc else 11

    def kernel(scn, clu, sup, slab, tri, tri_clu, tri_sup, tri_slab,
               ox, oy, oz, dx, dy, dz, *outs):
        fn = jpk.make_dynamic_culled_intersect(
            scn, clu, slab, ngb, ncl, cluster_size, tri_ref=tri,
            tri_clu_ref=tri_clu, tri_slab_ref=tri_slab, n_tri_clusters=ntc,
            sup_ref=sup, n_supers=nsup, tri_sup_ref=tri_sup,
            n_tri_supers=ntsup, packed_attrs=pkd)
        res = fn(ox[:], oy[:], oz[:], dx[:], dy[:], dz[:])
        for o, v in zip(outs, res[:nf]):
            o[:] = v

    shape = jax.ShapeDtypeStruct((8, 128), jnp.float32)
    outs = pl.pallas_call(kernel, out_shape=[shape] * nf, interpret=True)(
        *[jnp.asarray(t) for t in tables],
        *[jnp.asarray(r.reshape(8, 128)) for r in rays])
    return [np.asarray(o).reshape(-1) for o in outs]


def _tile_rays(centers, radii, boxes, seed=0):
    """1024 rays from free space: 512 aimed at primitives, 256
    axis-parallel, and 256 axis-parallel from a box face (NaN box
    entries)."""
    rng = np.random.default_rng(seed)
    c, r = centers, np.abs(radii)
    o = c[rng.integers(0, len(c), 1024)] + rng.normal(size=(1024, 3)) * 3
    o[:, 1] = np.abs(o[:, 1]) + 1.5
    d = c[rng.integers(0, len(c), 1024)] - o
    for k in range(512, 1024):
        d[k] = 0.0
        d[k, k % 3] = 1.0 if (k // 3) % 2 else -1.0
    for k in range(768, 1024):
        box = boxes[k % len(boxes)]
        axis = 2 if k % 3 == 0 else 0
        o[k, axis] = box[axis] if (k // 2) % 2 else box[3 + axis]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(v, np.float32) for v in (*o.T, *d.T)]


@pytest.mark.parametrize("name", ["procedural96", "terrain6"])
def test_one_tile_matches_jax_closure(name):
    """The plain dynamic intersect against the JAX closure on hand-made
    rays: winners bit for bit (the JAX tile culls by consensus and the
    port per ray; both are conservative, so the winners agree); ``t``
    to float noise (XLA:CPU contracts multiply-adds).  Terrain in
    clusters of 8 sweeps nine triangle clusters after its globals.

    One exception, on terrain: an axis-parallel ray whose origin lies on
    a box face gets (lo - o) * inf = NaN, so its own cond for that box
    is false in the reference (its per-lane cond); the JAX tile still
    enters the box when another lane's cond holds, and then finds the
    terrain-edge triangles that lie in that face plane.  The port, which
    decides per ray, enters every box whose cond such a ray makes NaN
    (``box_conds``; tests/test_torch_mesh.py holds it to the unculled
    intersect), so it finds them too, and may enter boxes the tile does
    not.  Such rays are measure zero in a render; here they are compared
    only for hit or miss."""
    a, cs, hint = PACK_SCENES[name]()
    if name == "terrain6":
        cs = 8
    packed = dt.pack_culled_scene(a, cluster_size=cs, camera_hint=hint)
    tab = dt.device_tables(packed, cs)
    tri = "tri_v0" in a
    if tri:
        # Aim at triangle centroids, from above the terrain.
        prims = a["tri_v0"] + (a["tri_e1"] + a["tri_e2"]) / 3.0
        radii = np.full(len(prims), 0.2, np.float32)
        boxes = packed[5][:packed[11]]
    else:
        prims, radii = a["centers"], a["radii"]
        boxes = packed[1][:packed[9]]
    rays = _tile_rays(prims, radii, boxes)
    port = [v.numpy() for v in tdk.dynculled_intersect_reference(
        tab, *map(torch.from_numpy, rays))]
    ref = _jax_dyn_tile(packed, cs, rays)
    hit = ref[0] < jpk.T_FAR
    np.testing.assert_array_equal(port[0] < jpk.T_FAR, hit)
    assert hit[:512].mean() > 0.5 and hit[512:].any()
    assert int(port[16].sum()) > 0       # clusters entered
    if tri:
        hit = hit & (np.arange(hit.size) < 768)
    # Albedo and material of every winner; sphere fields of sphere
    # winners, normals of triangle winners (the others are stale).
    is_tri = hit & (ref[14] > 0) if tri else np.zeros_like(hit)
    checks = [((5, 6, 7, 10), hit), ((1, 2, 3, 4), hit & ~is_tri)]
    if tri:
        np.testing.assert_array_equal(port[14][hit], ref[14][hit])
        assert is_tri.sum() > 100
        checks.append(((11, 12, 13), is_tri))
    for fields, where in checks:
        for k in fields:
            np.testing.assert_array_equal(port[k][where].view(np.int32),
                                          ref[k][where].view(np.int32))
    rel = np.abs(port[0] - ref[0])[hit] / ref[0][hit]
    assert np.quantile(rel, 0.9) < 1e-4 and rel.max() < 1e-2


# --- refusals -----------------------------------------------------------------

def test_refusals():
    scene, tris = mesh_terrain_scene(n_quads=2)
    # Brute force with no clusters is spheres-only, as in the reference.
    with pytest.raises(NotImplementedError, match="spheres-only"):
        Renderer(scene, _cover_camera(), BASE, tris, device="cpu")
    # The dynamic tables are 8-row blocks.
    with pytest.raises(ValueError, match="multiple of 8"):
        Renderer(scene, _cover_camera(), BASE.replace(baked_clusters=4),
                 tris, device="cpu")
    # The winner hint is the baked path's, as in the reference
    # (models/fused.py:329-334).
    with pytest.raises(NotImplementedError, match="intersector='baked'"):
        Renderer(scene, _cover_camera(),
                 BASE.replace(baked_clusters=8, winner_hint=True), tris,
                 device="cpu")
