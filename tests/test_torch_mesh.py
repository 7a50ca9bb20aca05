"""Triangle meshes in the port against the JAX package: the mesh builders
and the knot generator byte for byte, the triangle half of the bake, and
the baked intersects' triangle tests (plain versions, CPU): whole renders
under the statistical parity rule and one tile of the intersect closures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from examples import gen_obj
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu.scene import mesh as jmesh
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    MeshSceneBuilder,
    TriangleSoA,
    knot_scene,
    load_obj,
    mesh_demo_scene,
    mesh_terrain_scene,
    torus_knot,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

BASE = RenderConfig(width=32, height=16, samples_per_pixel=2,
                    samples_per_frame=2, max_bounces=8, engine="fused",
                    intersector="baked")
KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")


def _cover_camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 35.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


def _equal_scenes(port, ref):
    (ps, pt), (rs, rt) = port, ref
    assert type(pt) is TriangleSoA
    for field in rs._fields:
        a, b = getattr(ps, field), getattr(rs, field)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for a, b in zip(pt, rt):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _ref_knot(tris):
    # The reference's knot row scene (bench.py:150-162).
    b = jmesh.MeshSceneBuilder()
    b.sphere([0.0, -1000.0, 0.0], 1000.0, b.lambertian([0.5, 0.5, 0.5]))
    v, f = gen_obj.torus_knot(tris)
    b.mesh(v, f, b.lambertian([0.7, 0.3, 0.2]))
    return b.build_mesh_scene()


BUILDERS = {
    "mesh_demo": (mesh_demo_scene, jmesh.mesh_demo_scene),
    "terrain_default": (mesh_terrain_scene, jmesh.mesh_terrain_scene),
    "terrain_6_seed42": (lambda: mesh_terrain_scene(6, seed=42),
                         lambda: jmesh.mesh_terrain_scene(6, seed=42)),
    "knot1120": (lambda: knot_scene(1120), lambda: _ref_knot(1120)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_mesh_scenes_byte_identical(name):
    port, ref = BUILDERS[name]
    _equal_scenes(port(), ref())


@pytest.mark.parametrize("tris", [600, 1120, 50000])
def test_torus_knot_byte_identical(tris):
    v, f = torus_knot(tris)
    rv, rf = gen_obj.torus_knot(tris)
    assert v.dtype == rv.dtype and v.tobytes() == rv.tobytes()
    assert f.dtype == rf.dtype and f.tobytes() == rf.tobytes()


def test_load_obj_byte_identical(tmp_path):
    v, f = torus_knot(600)
    obj = tmp_path / "knot.obj"
    gen_obj.write_obj(str(obj), v, f)
    (tmp_path / "m.mtl").write_text(
        "newmtl glass\nNi 1.5\nnewmtl steel\nKs 0.8 0.8 0.8\nNs 900\n")
    obj.write_text("mtllib m.mtl\nusemtl steel\n" + obj.read_text()
                   + "usemtl glass\nf 1 2 3 4\n")
    port = load_obj(str(obj), scale=2.0).build_mesh_scene()
    ref = jmesh.load_obj(str(obj), scale=2.0).build_mesh_scene()
    _equal_scenes(port, ref)
    assert port[1].num_triangles == len(f) + 2


def _arrays(scene, tris):
    a = {k: np.asarray(getattr(scene, k)) for k in KEYS}
    a.update(tri_v0=tris.v0, tri_e1=tris.e1, tri_e2=tris.e2,
             tri_albedo=tris.albedo, tri_fuzz=tris.fuzz,
             tri_refract=tris.refract_idx, tri_mat_type=tris.mat_type)
    return a


def _ref_tris(tris):
    return jmesh.TriangleSoA(*tris)


@pytest.mark.parametrize("name", ["mesh_demo", "terrain6"])
def test_t2_elidable_with_triangles(name):
    scene, tris = (mesh_demo_scene() if name == "mesh_demo"
                   else mesh_terrain_scene(6))
    a = _arrays(scene, tris)
    args = [a[k] for k in ("centers", "radii", "mat_type", "fuzz")]
    port = bake._t2_elidable(*args, tris)
    ref = jpk._t2_elidable(*args, _ref_tris(tris))
    np.testing.assert_array_equal(port, ref)
    # On terrain, triangles within reach of the ground sphere's interior
    # disable the elision that the sphere-only rule keeps.
    lost = bake._t2_elidable(*args) & ~port
    assert lost.any() == (name == "terrain6")


@pytest.mark.parametrize("case", ["terrain6/8", "knot1120/16"])
def test_bake_culled_triangle_metadata(case):
    """The culled bake's triangle hierarchy against the JAX closure's
    metadata: counts, pack width and every cluster box in visit order
    (spheres first); knot1120 in clusters of 16 is two-level."""
    name, cs = case.split("/")
    cs = int(cs)
    scene, tris = mesh_terrain_scene(6) if name == "terrain6" \
        else knot_scene(1120)
    hint = np.array([0.0, 1.5, 4.0])
    a = _arrays(scene, tris)
    port = bake.bake_culled(a, cs, camera_hint=hint)
    ref = jpk.baked_culled_intersect(*(a[k] for k in KEYS), cluster_size=cs,
                                     triangles=_ref_tris(tris),
                                     camera_hint=hint)
    assert port.n_globals == ref.n_globals
    assert port.n_clusters == ref.n_clusters
    assert port.n_supers == ref.n_supers
    assert port.n_clustered_items == ref.n_clustered_items
    assert port.pack_attrs == ref.pack_attrs == "16"
    assert [(list(lo), list(hi)) for lo, hi in port.cluster_aabbs] == [
        (list(lo), list(hi)) for lo, hi in ref.cluster_aabbs]
    assert port.n_triangles == tris.num_triangles
    ranges = port.tri_cluster_ranges.numpy()
    assert ranges[:, 1].sum() == tris.num_triangles
    assert (port.tri_super_ranges.shape[0] > 0) == (name == "knot1120")
    # Every triangle sits inside its cluster's box.
    items = port.tri_items.numpy()
    boxes = port.tri_cluster_boxes.numpy()
    for (first, count), box in zip(ranges, boxes):
        v0 = items[first:first + count, 0:3]
        for vert in (v0, v0 + items[first:first + count, 3:6],
                     v0 + items[first:first + count, 6:9]):
            assert (vert >= box[0:3]).all() and (vert <= box[4:7]).all()


def test_bake_unculled_triangle_rows():
    """The unculled bake keeps the triangles in scene order, normalised
    without the culled bake's 1e-20 floor, attributes decoded."""
    scene, tris = mesh_demo_scene()
    port = bake.bake_unculled(_arrays(scene, tris))
    rows = port.tri_items.numpy()
    nrm = np.cross(tris.e1, tris.e2)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    np.testing.assert_array_equal(rows[:, 0:3], tris.v0)
    np.testing.assert_array_equal(rows[:, 9:12], nrm)
    np.testing.assert_array_equal(
        rows[:, [12, 13, 14, 17]],
        bake.decoded_attributes(tris.albedo, tris.mat_type, True))
    assert port.n_clusters == 0 and port.tri_cluster_boxes.shape == (0, 8)


@pytest.mark.parametrize("clusters", [8, 0], ids=["culled8", "unculled"])
def test_baked_terrain_render_matches_jax(clusters):
    scene, tris = mesh_terrain_scene(n_quads=5)
    cfg = BASE.replace(baked_clusters=clusters)
    j = jax_render(scene, _cover_camera(), cfg, tris)
    t = torch_render(scene, _cover_camera(), cfg, tris, device="cpu")
    check_parity(t.accumulated / 2, j.accumulated / 2, t.rays_traced,
                 j.rays_traced)


def _stats(scene, tris, cfg, cc):
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    return tfused.render_samples_with_stats(
        arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(cfg.width, cfg.height), cfg, 0, 0,
        cfg.samples_per_pixel)


def test_dynamic_equals_baked_and_culled_equals_unculled():
    """On terrain, the dynamic culled, baked culled and baked unculled
    intersects agree by the statistical rule (their quadratics, visit
    orders and cull rules differ; the reference's tests/test_fused.py:
    203-214 holds its own two alike), and the culled ones enter
    clusters."""
    scene, tris = mesh_terrain_scene(n_quads=12)
    cc = CameraController.book_one_final()
    cfg = BASE.replace(width=40, height=24, samples_per_pixel=4,
                       samples_per_frame=4)
    out = {}
    for name, change in (("dynamic", {"intersector": "bruteforce",
                                      "baked_clusters": 16}),
                         ("culled", {"baked_clusters": 16}),
                         ("unculled", {"baked_clusters": 0})):
        out[name] = _stats(scene, tris, cfg.replace(**change), cc)
    for a, b in (("dynamic", "culled"), ("culled", "unculled"),
                 ("dynamic", "unculled")):
        (ra, na, _), (rb, nb, _) = out[a], out[b]
        check_parity(ra.numpy() / 4, rb.numpy() / 4, na, nb)
    assert int(out["dynamic"][2]["clusters_entered"]) > 0
    assert int(out["culled"][2]["clusters_entered"]) > 0
    assert int(out["unculled"][2]["clusters_entered"]) == 0


# --- one tile of the baked intersect closures --------------------------------

def _jax_tile(fn, rays):
    """The JAX baked closure on one (8, 128) tile, in interpret mode: its
    15-field winner tuple as flat numpy arrays."""
    def kernel(ox, oy, oz, dx, dy, dz, *outs):
        res = fn(ox[:], oy[:], oz[:], dx[:], dy[:], dz[:])
        for o, v in zip(outs, res[:15]):
            o[:] = v

    shape = jax.ShapeDtypeStruct((8, 128), jnp.float32)
    outs = pl.pallas_call(kernel, out_shape=[shape] * 15, interpret=True)(
        *[jnp.asarray(r.reshape(8, 128)) for r in rays])
    return [np.asarray(o).reshape(-1) for o in outs]


def _tile_rays(tris, seed=0):
    """768 rays from above a terrain: 512 aimed at triangle centroids
    and 256 axis-parallel, down or sideways."""
    rng = np.random.default_rng(seed)
    cen = tris.v0 + (tris.e1 + tris.e2) / 3.0
    o = cen[rng.integers(0, len(cen), 1024)] + rng.normal(size=(1024, 3))
    o[:, 1] = np.abs(o[:, 1]) + 1.5
    d = cen[rng.integers(0, len(cen), 1024)] - o
    for k in range(512, 1024):
        d[k] = 0.0
        d[k, k % 3] = 1.0 if (k // 3) % 2 else -1.0
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(v, np.float32) for v in (*o.T, *d.T)]


@pytest.mark.parametrize("culled", [True, False], ids=["culled", "unculled"])
def test_one_tile_matches_jax_closure(culled):
    """The plain baked intersects with triangles against the JAX
    closures on hand-made rays: hit or miss, is-triangle, albedo and
    material of every winner, and the normal of every triangle winner,
    bit for bit; ``t`` to float noise (XLA:CPU contracts
    multiply-adds)."""
    scene, tris = mesh_terrain_scene(n_quads=4)
    a = _arrays(scene, tris)
    hint = np.array([0.0, 6.0, 12.0])
    if culled:
        baked = bake.bake_culled(a, 4, camera_hint=hint)
        fn = jpk.baked_culled_intersect(*(a[k] for k in KEYS),
                                        cluster_size=4,
                                        triangles=_ref_tris(tris),
                                        camera_hint=hint)
        ref_fn = tbk.culled_intersect_reference
    else:
        baked = bake.bake_unculled(a)
        fn = jpk.baked_intersect(*(a[k] for k in KEYS),
                                 triangles=_ref_tris(tris))
        ref_fn = tbk.baked_intersect_reference
    rays = _tile_rays(tris)
    port = [v.numpy() for v in ref_fn(baked, *map(torch.from_numpy,
                                                  rays))[:15]]
    ref = _jax_tile(fn, rays)
    hit = ref[0] < jpk.T_FAR
    np.testing.assert_array_equal(port[0] < jpk.T_FAR, hit)
    np.testing.assert_array_equal(port[14][hit], ref[14][hit])
    is_tri = hit & (ref[14] > 0)
    assert is_tri.sum() > 400 and (hit & ~is_tri).any()
    for fields, where in (((5, 6, 7, 10), hit), ((1, 2, 3), hit & ~is_tri),
                          ((11, 12, 13), is_tri)):
        for k in fields:
            np.testing.assert_array_equal(port[k][where].view(np.int32),
                                          ref[k][where].view(np.int32))
    rel = np.abs(port[0] - ref[0])[hit] / ref[0][hit]
    assert np.quantile(rel, 0.9) < 1e-4 and rel.max() < 1e-2


def test_mesh_builder_without_spheres():
    b = MeshSceneBuilder()
    b.quad([0, 0, 0], [1, 0, 0], [0, 1, 0], b.lambertian([0.5, 0.5, 0.5]))
    scene, tris = b.build_mesh_scene()
    assert scene.num_spheres == 1 and tris.num_triangles == 2


def test_face_rays_culled_equal_unculled():
    """Axis-parallel rays whose origin lies on a face of a box they test
    (``ROADMAP.md`` F3): straight down in the plane of each triangle
    cluster box's x and z faces, onto the terrain edges that the box
    face holds.  Their slab term is (lo - o) * inf = NaN.  The plain
    culled intersects (baked in clusters of 4, dynamic in clusters of 8)
    must find the unculled intersect's hit for every ray: t bit for bit
    and a triangle: culling never drops a hit.  (A ray on an interior
    face plane meets the edge two triangles share at one t; the
    intersects break that tie in their own visit orders, and the culled
    bake packs its attributes, so the winners' other fields are not
    compared.)"""
    scene, tris = mesh_terrain_scene(n_quads=4)
    cfg = BASE.replace(intersector="bruteforce", baked_clusters=8)
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    hint = np.array([0.0, 6.0, 12.0])
    dyn = tfused._dyn_tables(arrays, 8, camera_pos=hint)
    boxes = dyn.tri_boxes[:dyn.n_tri_clusters, :6].numpy()
    o = []
    for lo, hi in zip(boxes[:, :3], boxes[:, 3:6]):
        a, b = lo + 0.37 * (hi - lo), lo + 0.61 * (hi - lo)
        for x, z in ((lo[0], a[2]), (hi[0], b[2]), (a[0], lo[2]),
                     (b[0], hi[2])):
            o.append((x, hi[1] + 2.0, z))
    o = torch.tensor(np.array(o, np.float32))
    n = o.shape[0]
    d = torch.zeros((3, n))
    d[1] = -1.0
    rays = (o[:, 0], o[:, 1], o[:, 2], d[0], d[1], d[2])
    unculled = tbk.baked_intersect_reference(tfused._baked_scene(arrays, 0),
                                             *rays)
    culled = tbk.culled_intersect_reference(
        tfused._baked_scene(arrays, 4, camera_pos=hint), *rays)
    dynamic = tdk.dynculled_intersect_reference(dyn, *rays)
    hit = unculled[0] < 1e29
    assert hit.float().mean() > 0.9
    for name, out in (("baked culled/4", culled), ("dynamic/8", dynamic)):
        assert torch.equal(out[0] < 1e29, hit), name
        for k in (0, 14):
            assert torch.equal(out[k][hit].view(torch.int32),
                               unculled[k][hit].view(torch.int32)), (name, k)
