"""Textures and the winner hint in the port (plain versions, CPU) against
the JAX package: the scene-file loader, the image LUTs and their packed
words, the polynomial acos/atan2, the 24-column dynamic tables, one tile
of the textured culled closure, and whole renders (Pallas in interpret
mode, or the XLA megakernel for book_checker) under the statistical
parity rule."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu.scene import file as jfile
from wavefront_path_tracer_tpu.scene.camera import (
    CameraController as JCameraController,
)
from wavefront_path_tracer_tpu.utils.image import rmse, write_png
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dyn_tables as dt
from wavefront_path_tracer_tpu_torch.ops import textures as ttex
from wavefront_path_tracer_tpu_torch.probes import texstep
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    MeshSceneBuilder,
    apply_camera_dict,
    get_scene,
    load_scene_file,
    torus_knot,
)
from wavefront_path_tracer_tpu_torch.scene.scene import SceneBuilder
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

BASE = RenderConfig(width=32, height=16, samples_per_pixel=2,
                    samples_per_frame=2, max_bounces=8, engine="fused",
                    intersector="baked")
KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")
SCENE_FIELDS = ("centers", "radii", "mat_idx", "mat_type", "albedo", "fuzz",
                "refract_idx", "table_albedo", "table_fuzz", "table_refract",
                "table_type", "tex_kind", "tex_albedo2", "tex_scale",
                "tex_id", "tex_data")


def _uv_image(w=16, h=8):
    u = np.linspace(0.0, 1.0, w)[None, :, None]
    v = np.linspace(0.15, 1.0, h)[:, None, None]
    return (np.concatenate([u, 1.0 - u, np.full_like(u, 0.35)], -1)
            * v).astype(np.float32)


def _add_textured_spheres(b, seed=5, n=36):
    """A checker ground, ``n`` small spheres (a quarter of them checker
    textured), a glass shell with a negative-radius bubble, an image
    sphere and a mirror: at most 60 spheres, so the JAX closures stay
    quick to compile."""
    b.sphere([0.0, -1000.0, 0.0], 1000.0,
             b.lambertian([0.5, 0.5, 0.5],
                          texture=("checker", [0.9, 0.9, 0.9], 3.0)))
    rng = np.random.RandomState(seed)
    for k in range(n):
        c = [rng.uniform(-4, 4), 0.2, rng.uniform(-3, 3)]
        kind = k % 4
        if kind == 0:
            mat = b.lambertian(rng.rand(3) * 0.8)
        elif kind == 1:
            mat = b.metal(0.5 + 0.5 * rng.rand(3), 0.3 * rng.rand())
        elif kind == 2:
            mat = b.dielectric(1.5)
        else:
            mat = b.lambertian(rng.rand(3),
                               texture=("checker", rng.rand(3), 10.0))
        b.sphere(c, 0.2, mat)
    glass = b.dielectric(1.5)
    b.sphere([0.0, 1.0, 0.0], 1.0, glass)
    b.sphere([0.0, 1.0, 0.0], -0.9, glass)
    b.sphere([-2.2, 1.0, 0.0], 1.0,
             b.lambertian([1.0, 1.0, 1.0], texture=_uv_image()))
    b.sphere([2.2, 1.0, 0.0], 1.0, b.metal([0.7, 0.6, 0.5], 0.0))


def _textured_scene():
    b = SceneBuilder()
    _add_textured_spheres(b)
    return b.build()


def _textured_mesh():
    """The textured spheres (fewer) and a wall of 3x3 quads (18
    triangles, three materials) behind them."""
    b = MeshSceneBuilder()
    _add_textured_spheres(b, n=8)
    mats = (b.lambertian([0.8, 0.3, 0.2]), b.metal([0.8, 0.8, 0.9], 0.1),
            b.lambertian([0.2, 0.6, 0.3]))
    for i in range(3):
        for j in range(3):
            b.quad([-3.0 + 2.0 * i, 0.1 + 1.0 * j, -2.5 - 0.3 * i],
                   [2.0, 0.0, 0.0], [0.0, 1.0, 0.2], mats[(i + j) % 3])
    return b.build_mesh_scene()


def _camera():
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([0.0, 2.0, 7.0], [0.0, 0.8, 0.0])
    cc.vfov_deg = 40.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 7.0
    return cc


def _arrays(scene, tris=None):
    a = {k: np.asarray(getattr(scene, k)) for k in KEYS}
    a.update(tex_kind=scene.tex_kind, tex_albedo2=scene.tex_albedo2,
             tex_scale=scene.tex_scale, tex_id=scene.tex_id)
    if scene.tex_data is not None:
        a["tex_data"] = scene.tex_data
    if tris is not None:
        a.update(tri_v0=tris.v0, tri_e1=tris.e1, tri_e2=tris.e2,
                 tri_albedo=tris.albedo, tri_fuzz=tris.fuzz,
                 tri_refract=tris.refract_idx, tri_mat_type=tris.mat_type)
    return a


# --- the scene-file loader ------------------------------------------------------

def _scene_file(tmp_path):
    """A scene file with an image PNG, a checker, a negative radius, an
    OBJ and a partial camera block."""
    write_png(str(tmp_path / "img.png"),
              (_uv_image(8, 4) * 255).astype(np.uint8))
    verts, faces = torus_knot(64)
    (tmp_path / "k.obj").write_text(
        "".join(f"v {x} {y} {z}\n" for x, y, z in verts)
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces))
    doc = {
        "camera": {"look_at": [0, 1, 0], "vfov": 30},
        "spheres": [
            {"center": [0, -1000, 0], "radius": 1000,
             "material": {"type": "lambertian", "albedo": [0.5, 0.5, 0.5],
                          "texture": {"checker": [0.9, 0.1, 0.1],
                                      "scale": 5}}},
            {"center": [-2, 1, 0], "radius": 1,
             "material": {"type": "lambertian", "albedo": [1, 1, 1],
                          "texture": {"image": "img.png"}}},
            {"center": [2, 1, 0], "radius": -0.8,
             "material": {"type": "dielectric", "ior": 1.5}},
        ],
        "objs": [{"path": "k.obj", "scale": 0.5, "translate": [0, 1, 2]}],
    }
    path = tmp_path / "s.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("which", ["examples", "image_checker_obj"])
def test_scene_file_matches_jax(which, tmp_path):
    path = ("examples/scene.json" if which == "examples"
            else _scene_file(tmp_path))
    port, ref = load_scene_file(path), jfile.load_scene_file(path)
    for k in SCENE_FIELDS:
        p, r = getattr(port[0], k), getattr(ref[0], k)
        assert (p is None) == (r is None), k
        if p is not None:
            assert p.dtype == r.dtype and p.tobytes() == r.tobytes(), k
    assert (port[1] is None) == (ref[1] is None)
    if port[1] is not None:
        for p, r in zip(port[1], ref[1]):
            assert p.tobytes() == r.tobytes()
    assert port[2] == ref[2]
    assert port[0].tex_kind is not None
    pc, rc = CameraController.book_one_final(), JCameraController.book_one_final()
    apply_camera_dict(pc, port[2])
    jfile.apply_camera_dict(rc, ref[2])
    np.testing.assert_array_equal(pc.view_matrix(), rc.view_matrix())
    assert (pc.vfov_deg, pc.defocus_angle_deg, pc.focus_distance) == (
        rc.vfov_deg, rc.defocus_angle_deg, rc.focus_distance)


# --- image LUTs -------------------------------------------------------------------

def _odd_image_scene():
    rng = np.random.RandomState(1)
    b = SceneBuilder()
    b.sphere([0.0, -100.0, 0.0], 100.0, b.lambertian([0.5, 0.5, 0.5]))
    b.sphere([0.0, 1.0, 0.0], 1.0, b.lambertian(
        [1, 1, 1], texture=rng.uniform(-0.1, 1.1, (3, 5, 3))))
    b.sphere([2.0, 1.0, 0.0], -0.7, b.lambertian(
        [1, 1, 1], texture=rng.uniform(0.0, 1.0, (3, 5, 3))))
    return b.build()


@pytest.mark.parametrize("lut_max", [8192, 512, 100, 4])
@pytest.mark.parametrize("name", ["book_checker", "odd3x5"])
def test_image_luts_match_jax(name, lut_max):
    """The pooled LUTs and (cx, cy, cz, 1/r) byte for byte; the packed
    words are the reference's 10:10:10 rule (pallas_kernels.py:346-349)
    applied to the reference's LUT."""
    scene = get_scene("book_checker") if name == "book_checker" \
        else _odd_image_scene()
    a = _arrays(scene)
    port = ttex.bake_image_luts(a, a["centers"], lut_max=lut_max)
    ref = jfused._bake_image_luts(a, a["centers"], lut_max=lut_max)
    assert len(port) == len(ref) >= 1
    for p, r in zip(port, ref):
        assert p[:4] == r[:4]
        assert p[4].dtype == r[4].dtype and p[4].tobytes() == r[4].tobytes()
        q = np.round(np.clip(np.asarray(r[4], np.float64), 0.0, 1.0)
                     * 1023.0).astype(np.int64)
        words = ((q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]).ravel()
        assert ttex.pack_lut(p[4]).tolist() == words.tolist()
    luts, slot = ttex.image_luts(a, lut_max)
    assert luts.n_slots == len(ref)
    assert luts.h * luts.w <= max(lut_max, 1)
    np.testing.assert_array_equal(
        luts.centres.numpy(),
        np.array([r[:4] for r in ref], np.float32))
    assert sorted(slot[slot >= 0].tolist()) == list(range(len(ref)))
    if name == "book_checker" and lut_max == 8192:
        assert (luts.h, luts.w) == (32, 64)        # the full image


def _approx_inputs():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 1.0, 4096).astype(np.float32)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 1e-7, -1e-7]
    y = rng.normal(size=4096).astype(np.float32)
    z = rng.normal(size=4096).astype(np.float32)
    axes = [(0.0, 1.0), (0.0, -1.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 0.0),
            (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0), (1.0, 1.0), (-1.0, -1.0)]
    for k, (a, b) in enumerate(axes):
        y[k], z[k] = a, b
    return x, y, z


def test_approximations_match_jax():
    """``_acos_approx`` / ``_atan2_approx`` on 4096 seeded inputs with
    ±0, ±1 and the axes.  Tolerance 4e-7 absolute (about 2 ulp at pi):
    XLA:CPU contracts the polynomials' multiply-adds into FMAs, the port
    rounds each operation; the signs and the branch choices are exact."""
    x, y, z = _approx_inputs()
    port_acos = ttex.acos_approx(torch.from_numpy(x)).numpy()
    ref_acos = np.asarray(jpk._acos_approx(jnp.asarray(x)))
    np.testing.assert_allclose(port_acos, ref_acos, rtol=0, atol=4e-7)
    port_at = ttex.atan2_approx(torch.from_numpy(y),
                                torch.from_numpy(z)).numpy()
    ref_at = np.asarray(jpk._atan2_approx(jnp.asarray(y), jnp.asarray(z)))
    np.testing.assert_allclose(port_at, ref_at, rtol=0, atol=4e-7)
    assert np.array_equal(np.signbit(port_at[:10]), np.signbit(ref_at[:10]))
    # Away from the signed zeros, where the reference's branch on y < 0
    # and numpy's on the sign bit part, both approximate the true values.
    assert np.abs(port_at - np.arctan2(y, z))[10:].max() < 2e-5
    assert np.abs(port_acos - np.arccos(x)).max() < 1e-4


# --- the 24-column dynamic tables ---------------------------------------------

@pytest.mark.parametrize("name", ["book_checker", "textured_mesh"])
def test_textured_dyn_tables_byte_identical(name):
    if name == "book_checker":
        a, cs, hint = _arrays(get_scene("book_checker")), 16, np.array(
            [13.0, 2.0, 3.0])
    else:
        a, cs, hint = _arrays(*_textured_mesh()), 8, None
    port = dt.pack_culled_scene(a, cluster_size=cs, camera_hint=hint)
    ref = jpk.pack_culled_scene(a, cluster_size=cs, camera_hint=hint)
    assert port[0].shape[1] == 24
    for p, r in zip(port[:8], ref[:8]):
        assert p.dtype == r.dtype and p.tobytes() == r.tobytes()
    assert port[8:] == ref[8:]
    tab = dt.device_tables(port, cs, scene_arrays=a)
    assert tab.textured and tab.sphere_tex.shape == (port[0].shape[0], 4)
    assert tab.sphere_tex.numpy().tobytes() == \
        np.ascontiguousarray(ref[0][:, 16:20]).tobytes()
    # The image sphere's row, and no other, carries slot 0.
    slots = tab.spheres[:, 14].numpy()
    img = np.nonzero(a["tex_kind"] == 2)[0][0]
    rows = np.nonzero(slots == 0)[0]
    assert len(rows) == 1
    np.testing.assert_array_equal(ref[0][rows[0], 0:3], a["centers"][img])
    assert ((slots == -1) | (slots == 0) | np.isnan(slots)).all()


# --- one tile of the textured culled closure -------------------------------

def _jax_tile(fn, rays, n_fields):
    def kernel(ox, oy, oz, dx, dy, dz, *outs):
        res = fn(ox[:], oy[:], oz[:], dx[:], dy[:], dz[:])
        for o, v in zip(outs, res[:n_fields]):
            o[:] = v

    shape = jax.ShapeDtypeStruct((8, 128), jnp.float32)
    outs = pl.pallas_call(kernel, out_shape=[shape] * n_fields,
                          interpret=True)(
        *[jnp.asarray(r.reshape(8, 128)) for r in rays])
    return [np.asarray(o).reshape(-1) for o in outs]


def _tile_rays(centers, radii, seed=0):
    """1024 rays from free space near the small spheres (not from the
    ground sphere's far-away centre), aimed at their centres, every
    seventh tilted down onto the ground."""
    rng = np.random.default_rng(seed)
    c, r = centers, np.abs(radii)
    near = c[r < 10.0]
    o = near[rng.integers(0, len(near), 1024)] + rng.normal(size=(1024, 3)) * 4
    o[:, 1] = np.abs(o[:, 1]) + 0.3
    d = near[rng.integers(0, len(near), 1024)] - o
    d[::7, 1] -= 3.0                   # some rays down onto the ground
    inside = (np.linalg.norm(o[:, None] - c[None], axis=-1) < r).any(axis=1)
    o[inside, 1] += 20.0
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(v, np.float32) for v in (*o.T, *d.T)]


def test_one_tile_matches_jax_closure():
    """The plain culled intersect of a textured bake against the JAX
    closure (``tex`` and ``full_inv_r``) on one (8, 128) tile: winners,
    their true 1/r, albedo and material, and their checker fields (the
    scale always; the second albedo where the scale is not 0, since the
    reference leaves it stale for a solid winner) bit for bit.  With a
    winner hint the winners do not change, every hinted ray enters one
    more cluster, and the returned hint is the winner's cluster."""
    scene = _textured_scene()
    a = _arrays(scene)
    hint_eye = np.array([0.0, 2.0, 7.0])
    baked = bake.bake_culled(a, 4, camera_hint=hint_eye)
    fn = jpk.baked_culled_intersect(
        *(a[k] for k in KEYS), cluster_size=4, camera_hint=hint_eye,
        tex=(a["tex_albedo2"], a["tex_scale"]), full_inv_r=True)
    rays = _tile_rays(a["centers"], a["radii"])
    port = [v.numpy() for v in tbk.culled_intersect_reference(
        baked, *map(torch.from_numpy, rays))]
    ref = _jax_tile(fn, rays, 19)
    hit = ref[0] < jpk.T_FAR
    np.testing.assert_array_equal(port[0] < jpk.T_FAR, hit)
    assert hit.mean() > 0.8
    for k in (1, 2, 3, 4, 5, 6, 7, 10, 18):
        np.testing.assert_array_equal(port[k][hit].view(np.int32),
                                      ref[k][hit].view(np.int32))
    checker = hit & (ref[18] != 0.0)
    assert checker.sum() > 50
    for k in (15, 16, 17):
        np.testing.assert_array_equal(port[k][checker], ref[k][checker])
    slot = port[19]
    assert (slot[hit] >= 0).sum() > 10 and (slot[~hit] == -1).all()
    # The winner hint: a random cluster for half of the rays.
    n_clusters = baked.cluster_ranges.shape[0]
    rng = np.random.default_rng(3)
    hint = torch.from_numpy(np.where(rng.random(1024) < 0.5,
                                     rng.integers(0, n_clusters, 1024), -1))
    hinted = tbk.culled_intersect_reference(
        baked, *map(torch.from_numpy, rays), hint=hint)
    plain = tbk.culled_intersect_reference(baked,
                                           *map(torch.from_numpy, rays))
    for k in range(20):
        assert torch.equal(hinted[k], plain[k]), k
    new_hint, clusters = hinted[20], hinted[22]
    assert (clusters >= (hint >= 0)).all()
    # The new hint is the cluster whose items hold the winner; a global
    # winner (or a miss) leaves -1.
    items, ranges = baked.items, baked.cluster_ranges
    won = torch.nonzero(new_hint >= 0)[:, 0]
    assert won.numel() > 100
    for i in won.tolist():
        first, count = ranges[new_hint[i]].tolist()
        centre = torch.stack([plain[1][i], plain[2][i], plain[3][i]])
        assert (items[first:first + count, 8:11] == centre).all(dim=1).any()
    for i in torch.nonzero((new_hint < 0) & torch.from_numpy(hit))[:, 0]:
        centre = torch.stack([plain[1][i], plain[2][i], plain[3][i]])
        assert (items[:baked.n_globals, 8:11] == centre).all(dim=1).any()


# --- renders -----------------------------------------------------------------

def _both(scene, cc, cfg, tris=None):
    j = jax_render(scene, cc, cfg, tris)
    t = torch_render(scene, cc, cfg, tris, device="cpu")
    assert t.samples == j.samples == cfg.samples_per_pixel
    check_parity(t.accumulated / t.samples, j.accumulated / j.samples,
                 t.rays_traced, j.rays_traced)
    return t, j


@pytest.mark.parametrize("case", [
    "baked8", "unculled", "dynamic8", "baked8_hint", "mesh_baked8",
    "mesh_dynamic8"])
def test_textured_render_matches_jax(case):
    """A textured scene of at most 60 spheres (checker ground, an image
    sphere, a negative radius) through every textured path, and a
    textured mesh through the baked and dynamic culled paths, at 32x16@2
    spp, 8 bounces, against the JAX fused engine in interpret mode."""
    tris = None
    if case.startswith("mesh"):
        scene, tris = _textured_mesh()
    else:
        scene = _textured_scene()
    cfg = {"baked8": BASE.replace(baked_clusters=8),
           "unculled": BASE.replace(baked_clusters=0),
           "dynamic8": BASE.replace(intersector="bruteforce",
                                    baked_clusters=8),
           "baked8_hint": BASE.replace(baked_clusters=8, winner_hint=True),
           "mesh_baked8": BASE.replace(baked_clusters=8),
           "mesh_dynamic8": BASE.replace(intersector="bruteforce",
                                         baked_clusters=8)}[case]
    t, _ = _both(scene, _camera(), cfg, tris)
    assert np.isfinite(t.accumulated).all() and t.image.mean() > 0.05


@pytest.mark.parametrize("path", ["baked16", "dynamic16"])
def test_book_checker_matches_megakernel(path):
    """book_checker (486 spheres) against the JAX XLA megakernel, which
    samples the full-resolution image; at the default 8192 texels the
    port's LUT is the whole 64x32 image, so only the 10:10:10
    quantization and the polynomial UV differ.  48x27@4 spp, the
    parity rule's image limits."""
    cfg = BASE.replace(width=48, height=27, samples_per_pixel=4,
                       samples_per_frame=4, max_bounces=8,
                       baked_clusters=16)
    if path == "dynamic16":
        cfg = cfg.replace(intersector="bruteforce")
    cc = CameraController.book_one_final()
    scene = get_scene("book_checker")
    mk = jax_render(scene, cc, cfg.replace(engine="megakernel"))
    t = torch_render(scene, cc, cfg, device="cpu")
    assert mk.image.std() > 0.01
    assert rmse(t.image, mk.image) < 5e-3
    assert abs(t.accumulated.mean() / 4 - mk.accumulated.mean() / 4) < 2e-3


# --- which sphere gets the image texture ------------------------------------------

def _twin_scene_file(tmp_path, textured_first: bool) -> str:
    """A scene file with two spheres that share a centre and a signed
    radius, one of them green and one image-textured (a red PNG the test
    writes), on a grey ground: every ray that hits one hits both at the
    same t, so the winner is whichever the sweep visits first."""
    write_png(str(tmp_path / "red.png"),
              np.tile(np.array([230, 25, 25], np.uint8), (4, 8, 1)))
    green = {"center": [0, 1, 0], "radius": 1,
             "material": {"type": "lambertian", "albedo": [0.1, 0.9, 0.1]}}
    image = {"center": [0, 1, 0], "radius": 1,
             "material": {"type": "lambertian", "albedo": [1, 1, 1],
                          "texture": {"image": "red.png"}}}
    twins = [image, green] if textured_first else [green, image]
    doc = {"spheres": [
        {"center": [0, -1000, 0], "radius": 1000,
         "material": {"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}},
        *twins]}
    path = tmp_path / "twins.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("order", ["green-first", "image-first"])
@pytest.mark.parametrize("path", ["baked8", "unculled", "dynamic8"])
def test_shared_centre_image_sphere_matches_jax(tmp_path, path, order):
    """The reference picks the image sphere by exact equality of the
    winner's centre and 1/r with the LUT's (``_apply_image_textures``,
    pallas_kernels.py:322-325), so a sphere that shares both with an
    image sphere takes its texture too, whichever of the two wins.  The
    port follows that rule on every textured path: its render of the
    twins matches the JAX fused engine's under the parity rule, and the
    sphere in the middle of the frame is red (the texture), not green."""
    file = _twin_scene_file(tmp_path, order == "image-first")
    port, ref = load_scene_file(file), jfile.load_scene_file(file)
    cc = _camera()
    cfg = {"baked8": BASE.replace(baked_clusters=8),
           "unculled": BASE.replace(baked_clusters=0),
           "dynamic8": BASE.replace(intersector="bruteforce",
                                    baked_clusters=8)}[path]
    j = jax_render(ref[0], cc, cfg)
    t = torch_render(port[0], cc, cfg, device="cpu")
    check_parity(t.accumulated / t.samples, j.accumulated / j.samples,
                 t.rays_traced, j.rays_traced)
    for img in (t.accumulated, j.accumulated):
        centre = img[5:11, 12:20].mean(axis=(0, 1))
        assert centre[0] > 2.0 * centre[1], centre


@pytest.mark.parametrize("row", ["culled16", "dynculled16"])
def test_textured_untextured_ab_traces_the_same_rays(row):
    """The premise of the A/B that gives the texture step its own time on
    the card (``probes/texstep.py``): the plain baked culled and dynamic
    culled versions, on one book_checker bake (or table) with
    ``textured`` true and false, give equal counters [rays, iterations,
    supers, clusters] (roulette is off and albedo steers no ray) and
    different radiance (the step runs only in the first)."""
    r = texstep.Row(row, 16, 8, 2, 8, "cpu")
    assert r.tables.textured and not r.plain_tables.textured
    assert r.plain_tables.images is r.tables.images
    rep = texstep.ab(r, 1)
    textured, plain = rep["outs"][True], rep["outs"][False]
    assert textured[3].tolist() == plain[3].tolist() == rep["stats"]
    assert rep["stats"][0] > 0 and rep["stats"][3] > 0
    assert any(not torch.equal(a, b) for a, b in zip(textured[:3], plain[:3]))
    assert rep["textured_ms"] is None and "own_ms" not in rep


def _device_function(src: str, name: str) -> str:
    """The text of the device function ``name`` of a CUDA source, from its
    name to the closing brace at the start of a line."""
    start = src.index(f" {name}(")
    return src[start:src.index("\n}\n", start)]


def test_texture_step_takes_no_slow_path_branch():
    """The texture step's redesign (csrc/common.cuh): apply_textures calls
    no sinf.  The checker's three sines are fastmath.cuh's sinf_fast
    behind one range test of the three arguments, and sinf (with its
    slow path) only past it, inline (no call of a function of its own);
    sinf_fast calls nothing."""
    from pathlib import Path

    csrc = Path(texstep.__file__).resolve().parents[1] / "csrc"
    common = (csrc / "common.cuh").read_text()
    assert '#include "fastmath.cuh"' in common
    step = _device_function(common, "apply_textures")
    assert "sinf(" not in step
    assert "checker_select(s * px, s * py, s * pz)" in step
    select = _device_function(common, "checker_select")
    assert select.count("sinf_fast(") == 3
    slow = [m.start() for m in re.finditer(r"(?<!\w)sinf\(", select)]
    assert len(slow) == 3
    assert select.index("kSinFastMax") < slow[0] < select.index("sinf_fast(")
    assert not re.search(r"__noinline__\s+(static\s+)?(__device__\s+)?"
                         r"(bool|float|void)", common)
    fast = (csrc / "fastmath.cuh").read_text()
    assert "constexpr float kSinFastMax = 105615.0f;" in fast
    body = _device_function(fast, "sinf_fast")
    assert "sinf(" not in body and "sqrtf(" not in body


def test_sin_fast_claims_its_range_and_the_nans():
    """The count of floats that sinf_fast claims, which the card's check
    of it over all 2^32 floats must find (``texstep.SIN_FAST_CLAIMED``):
    the magnitudes below fastmath.cuh's kSinFastMax under both signs, +-0
    and the subnormals among them, and every NaN."""
    assert texstep.SIN_FAST_MAX == 105615.0
    top = int(np.float32(texstep.SIN_FAST_MAX).view(np.uint32))
    below = np.arange(top - 3, top + 3, dtype=np.uint32).view(np.float32)
    assert list(below < texstep.SIN_FAST_MAX) == [True] * 3 + [False] * 3
    nans = np.array([0x7F800001, 0x7FFFFFFF, 0xFF800001, 0x7F800000],
                    dtype=np.uint32).view(np.float32)
    assert list(np.isnan(nans)) == [True, True, True, False]
    assert texstep.SIN_FAST_CLAIMED == 2 * top + 2 * (0x7FFFFFFF - 0x7F800000)
    assert texstep.SIN_FAST_CLAIMED == 2_426_179_326


def test_plain_step_over_a_frame_is_its_calls_in_one():
    """The plain step's time on the card is taken over one frame's hits
    (``probes/texstep.py``): the calls of ``apply_textures`` recorded in
    a plain render, merged into one call over all their hits.  That call
    gives each hit the albedo that its own bounce's call gave it, and
    counts the same texture events."""
    r = texstep.Row("culled16", 16, 8, 1, 6, "cpu")
    with texstep.recording() as calls:
        r.reference(r.tables, r.salts, r.cam, *r.planes)
    events = dict(ttex.EVENTS)
    assert len(calls) > 1 and events["checker"] > 0
    apart = [ttex.apply_textures(*c) for c in calls]
    ttex.EVENTS.update(checker=0, image=0)
    merged = texstep.merged(calls)
    together = ttex.apply_textures(*merged)
    assert ttex.EVENTS == events
    assert merged[6].numel() == sum(c[6].numel() for c in calls)
    for k in range(3):
        assert torch.equal(together[k], torch.cat([a[k] for a in apart]))
