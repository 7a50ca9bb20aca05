"""The port's megakernel oracle and its ops against the JAX package's, on
the CPU: ``ops/rng.py`` (the rest), ``ops/intersect.py``,
``ops/triangle.py``, ``ops/texture.py``, ``ops/hit.py``, ``ops/bsdf.py``
and ``models/megakernel.py`` through ``Renderer``.

Integer states are held bit for bit.  Float results are held to a stated
tolerance: XLA on the CPU contracts multiply-adds (about 89% of the
sphere hit parameters below match a fused-multiply-add order bit for
bit, 28% the plain order that the port computes), and its ``pow``,
``sin``, ``cos``, ``acos`` and ``atan2`` differ from PyTorch's by ulps.
Ill-conditioned hits magnify those ulps: a quadratic's near root
cancels where it is small beside the distance to the centre, and a
triangle's t divides by a small determinant at a grazing angle (measured
at most 2.7e-4 relative on the rays below), so the winners are held
exactly and ``t`` to rtol 1e-3.  Whole renders are held to the parity
rule of ``utils/parity.py`` with rays within 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.ops import bsdf as jbsdf
from wavefront_path_tracer_tpu.ops import hit as jhit
from wavefront_path_tracer_tpu.ops import intersect as jintersect
from wavefront_path_tracer_tpu.ops import rng as jrng
from wavefront_path_tracer_tpu.ops import texture as jtexture
from wavefront_path_tracer_tpu.ops import triangle as jtriangle
from wavefront_path_tracer_tpu.renderer import prepare_scene as jprepare
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser
from wavefront_path_tracer_tpu_torch.cli import run as cli_run
from wavefront_path_tracer_tpu_torch.models import get_engine
from wavefront_path_tracer_tpu_torch.models import megakernel as tmega
from wavefront_path_tracer_tpu_torch.ops import bsdf as tbsdf
from wavefront_path_tracer_tpu_torch.ops import hit as thit
from wavefront_path_tracer_tpu_torch.ops import intersect as tintersect
from wavefront_path_tracer_tpu_torch.ops import rng as trng
from wavefront_path_tracer_tpu_torch.ops import texture as ttexture
from wavefront_path_tracer_tpu_torch.ops import triangle as ttriangle
from wavefront_path_tracer_tpu_torch.renderer import Renderer
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import get_scene, mesh_terrain_scene
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

N = 4096
T_RTOL = 1e-3        # hit parameters (the conditioning above)
DIR_RTOL = 1e-5      # unit directions, normals, albedos, sky colours
DIR_ATOL = 1e-5      # components near zero

BASE = RenderConfig(width=32, height=16, samples_per_pixel=4,
                    samples_per_frame=4, max_bounces=8, engine="megakernel",
                    intersector="bruteforce")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _u32(j):
    return np.asarray(j, np.uint32)


def _close(port, ref, rtol=DIR_RTOL, atol=DIR_ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(1313)
    o = rng.uniform(-6.0, 6.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


# --- ops/rng.py ---------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(7)
    return rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("delta", [0, 1, 2, 3, 10, 150, 2**31 + 5,
                                   2**32 - 1])
def test_advance_bit_exact(states, delta):
    np.testing.assert_array_equal(
        trng.advance(_t(states.astype(np.int64)), delta).numpy()
        .astype(np.uint32),
        _u32(jrng.advance(jnp.asarray(states), delta)))


def test_advance_equals_repeated_draws(states):
    s = _t(states.astype(np.int64))
    stepped = s
    for _ in range(5):
        stepped, _ = trng.next_u32(stepped)
    assert torch.equal(trng.advance(s, 5), stepped)


def test_sample_unit_sphere(states):
    js, jx, jy, jz = jrng.sample_unit_sphere(jnp.asarray(states))
    ts, tx, ty, tz = trng.sample_unit_sphere(_t(states.astype(np.int64)))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), _u32(js))
    for t, j in ((tx, jx), (ty, jy), (tz, jz)):
        _close(t, j)
    r2 = tx * tx + ty * ty + tz * tz
    assert float(r2.max()) <= 1.0 + 1e-5


@pytest.mark.parametrize("bounce", [1, 3, "lanes"])
def test_roulette(bounce):
    """The survivor mask exactly, the throughput within rtol 1e-6 (one
    division each side)."""
    rng = np.random.default_rng(11)
    pix = rng.integers(0, 1 << 20, N).astype(np.uint32)
    tp = rng.uniform(0.0, 1.2, (N, 3)).astype(np.float32)
    tp[::5] *= 0.02                              # below the floor
    alive = rng.random(N) < 0.8
    b = (rng.integers(0, 6, N).astype(np.uint32) if bounce == "lanes"
         else bounce)
    jb = jnp.asarray(b) if bounce == "lanes" else b
    tb = _t(b.astype(np.int64)) if bounce == "lanes" else b
    jt, ja = jrng.roulette(jnp.asarray(pix), 5, 9, jb, jnp.asarray(tp),
                           jnp.asarray(alive), 2, 0.05)
    tt, ta = trng.roulette(_t(pix.astype(np.int64)), 5, 9, tb, _t(tp),
                           _t(alive), 2, 0.05)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tt, jt, rtol=1e-6, atol=0)
    if bounce == 1:                              # before the start: as given
        assert torch.equal(tt, _t(tp)) and torch.equal(ta, _t(alive))


# --- ops/intersect.py ---------------------------------------------------

@pytest.fixture(scope="module")
def spheres():
    """40 spheres, every seventh inside out, then the first 10 again
    beside them (exact ties), and one of zero radius: 51, so padding at
    any block of 16 or more."""
    rng = np.random.default_rng(5)
    c = rng.uniform(-4.0, 4.0, (40, 3)).astype(np.float32)
    r = rng.uniform(0.2, 1.5, 40).astype(np.float32)
    r[::7] *= -1.0
    c = np.concatenate([c, c[:10], [[0.0, 0.0, 0.0]]]).astype(np.float32)
    r = np.concatenate([r, r[:10], [0.0]]).astype(np.float32)
    return c, r


@pytest.mark.parametrize("chunk", [16, 128])
def test_intersect_bruteforce(rays, spheres, chunk):
    o, d = rays
    c, r = spheres
    jt, ji, jh = jintersect.intersect_bruteforce(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(r),
        sphere_chunk=chunk)
    tt, ti, th = tintersect.intersect_bruteforce(_t(o), _t(d), _t(c), _t(r),
                                                 sphere_chunk=chunk)
    hit = np.asarray(jh)
    assert 500 < hit.sum() < N
    np.testing.assert_array_equal(th.numpy(), hit)
    np.testing.assert_array_equal(ti.numpy()[hit], np.asarray(ji)[hit])
    assert not np.isin(ti.numpy()[hit], np.arange(40, 51)).any(), \
        "a duplicate or the zero-radius sphere won"
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=T_RTOL)
    assert (tt.numpy()[~hit] == np.float32(1e30)).all()


def test_sky_color(rays):
    _, d = rays
    _close(tintersect.sky_color(_t(d)), jintersect.sky_color(jnp.asarray(d)))


# --- ops/triangle.py ----------------------------------------------------

@pytest.fixture(scope="module")
def triangles():
    rng = np.random.default_rng(9)
    v0 = rng.uniform(-4.0, 4.0, (150, 3)).astype(np.float32)
    e1 = rng.normal(0.0, 1.5, (150, 3)).astype(np.float32)
    e2 = rng.normal(0.0, 1.5, (150, 3)).astype(np.float32)
    e2[:5] = 0.0                                 # zero area: never hit
    return v0, e1, e2


def test_intersect_triangles(rays, triangles):
    o, d = rays
    v0, e1, e2 = triangles
    jt, ji, jh = jtriangle.intersect_triangles(
        *(jnp.asarray(x) for x in (o, d, v0, e1, e2)))
    tt, ti, th = ttriangle.intersect_triangles(
        *(_t(x) for x in (o, d, v0, e1, e2)))
    hit = np.asarray(jh)
    assert 300 < hit.sum() < N
    np.testing.assert_array_equal(th.numpy(), hit)
    np.testing.assert_array_equal(ti.numpy()[hit], np.asarray(ji)[hit])
    assert (ti.numpy()[hit] >= 5).all()
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=T_RTOL)


def test_triangle_t_and_normals(rays, triangles):
    """Each ray aimed at a point of its own triangle, at barycentrics
    that sum to at most 0.9 (a hit) or at least 1.1 (a miss past an
    edge): at an edge itself an ulp decides."""
    o, _ = rays
    v0, e1, e2 = (np.resize(x, (N, 3)) for x in triangles)
    rng = np.random.default_rng(6)
    uv = rng.uniform(0.0, 0.45, (N, 2)).astype(np.float32)
    uv[::3] += 0.55
    d = v0 + uv[:, :1] * e1 + uv[:, 1:] * e2 - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jt = np.asarray(jtriangle.triangle_t(
        *(jnp.asarray(x) for x in (o, d, v0, e1, e2))))
    tt = ttriangle.triangle_t(*(_t(x) for x in (o, d, v0, e1, e2))).numpy()
    hit = jt < 1e30
    assert N // 2 < hit.sum() < N
    np.testing.assert_array_equal(tt < 1e30, hit)
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=T_RTOL)
    ok = np.arange(150) >= 5
    _close(ttriangle.triangle_normals(_t(triangles[1]), _t(triangles[2]))[ok],
           np.asarray(jtriangle.triangle_normals(
               jnp.asarray(triangles[1]), jnp.asarray(triangles[2])))[ok])


# --- ops/texture.py ------------------------------------------------------

def test_texture_ops(rays):
    o, d = rays
    rng = np.random.default_rng(3)
    scale = rng.uniform(1.0, 12.0, N).astype(np.float32)
    sel_j = np.asarray(jtexture.checker_select(
        *(jnp.asarray(o[:, k]) for k in range(3)), jnp.asarray(scale)))
    sel_t = ttexture.checker_select(*(_t(o[:, k]) for k in range(3)),
                                    _t(scale)).numpy()
    assert (sel_j != sel_t).sum() <= 2           # ulps at a cell's edge
    ju, jv = jtexture.sphere_uv(jnp.asarray(d))
    tu, tv = ttexture.sphere_uv(_t(d))
    _close(tu, ju)
    _close(tv, jv)
    tex = rng.random((2, 8, 16, 3)).astype(np.float32)
    tid = rng.integers(0, 2, N).astype(np.int32)
    np.testing.assert_array_equal(
        ttexture.image_lookup(_t(tex), _t(tid), tu, tv).numpy(),
        np.asarray(jtexture.image_lookup(jnp.asarray(tex), jnp.asarray(tid),
                                         tu.numpy(), tv.numpy())))


def test_resolve_albedo(rays):
    """All three kinds on one set of lanes; away from checker edges and
    texel borders the albedo is exact, so at most a few lanes differ."""
    o, d = rays
    rng = np.random.default_rng(4)
    kind = rng.integers(0, 3, N).astype(np.int32)
    args = (rng.random((N, 3)).astype(np.float32), kind,
            rng.random((N, 3)).astype(np.float32),
            rng.uniform(1.0, 12.0, N).astype(np.float32),
            rng.integers(0, 2, N).astype(np.int32), o, d,
            rng.random((2, 8, 16, 3)).astype(np.float32))
    j = np.asarray(jtexture.resolve_albedo(*(jnp.asarray(a) for a in args)))
    t = ttexture.resolve_albedo(*(_t(a) for a in args)).numpy()
    differ = np.abs(t - j).max(axis=1) > 0
    assert differ.sum() <= 4
    np.testing.assert_allclose(t[~differ], j[~differ], rtol=0, atol=0)


# --- ops/hit.py ----------------------------------------------------------

def _scene_arrays(name):
    if name == "terrain":
        scene, tris = mesh_terrain_scene(n_quads=4)
    else:
        scene, tris = get_scene(name), None
    return jprepare(scene, BASE, tris), prepare_scene(scene, BASE, "cpu",
                                                     tris)


@pytest.mark.parametrize("name", ["book_bubble", "book_checker", "terrain"])
def test_intersect_and_resolve(name):
    """Camera-like rays from above the ground: hit, material and the
    winner's attributes exact on all but a few lanes, normals within
    rtol 1e-5 where the winners agree."""
    ja, ta = _scene_arrays(name)
    rng = np.random.default_rng(2)
    o = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.2
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    j = [np.asarray(x) for x in jhit.intersect_and_resolve(
        jnp.asarray(o), jnp.asarray(d), ja, BASE)]
    t = [x.numpy() for x in thit.intersect_and_resolve(_t(o), _t(d), ta,
                                                       BASE)]
    hit = j[1]
    np.testing.assert_array_equal(t[1], hit)
    np.testing.assert_array_equal(t[6][hit], j[6][hit])
    same = hit & (np.abs(t[3] - j[3]).max(axis=1) == 0)
    assert hit.sum() - same.sum() <= 4          # checker edges only
    # The grounds' radii (100 and 1000) put t's rounding at ulps of 1000.
    np.testing.assert_allclose(t[0][hit], j[0][hit], rtol=T_RTOL, atol=2e-4)
    np.testing.assert_allclose(t[2][same], j[2][same], rtol=1e-3, atol=1e-3)
    for k in (4, 5):
        np.testing.assert_array_equal(t[k][hit], j[k][hit])


def test_bvh_refused():
    """Once refused, now ported: hit resolution through the BVH on
    book_one_final's tables (BVH order) picks the brute-force sweep's
    winners on the same tables, and the JAX package's BVH winners."""
    cfg = BASE.replace(intersector="bvh")
    scene = get_scene("book_one_final")
    ja, ta = jprepare(scene, cfg), prepare_scene(scene, cfg, "cpu")
    assert "bvh_min" in ta
    rng = np.random.default_rng(8)
    o = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.2
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bvh = thit.intersect_and_resolve(_t(o), _t(d), ta, cfg)
    brute = thit.intersect_and_resolve(_t(o), _t(d), ta, BASE)
    j = [np.asarray(x) for x in jhit.intersect_and_resolve(
        jnp.asarray(o), jnp.asarray(d), ja, cfg)]
    hit = bvh[1].numpy()
    assert 0.5 < hit.mean() < 1.0
    for k in (1, 3, 4, 5, 6):     # hit and the winner's attributes
        assert torch.equal(bvh[k], brute[k])
        np.testing.assert_array_equal(bvh[k].numpy()[hit], j[k][hit])
    assert torch.equal(bvh[0], brute[0])


# --- ops/bsdf.py ---------------------------------------------------------

@pytest.fixture(scope="module")
def shading():
    rng = np.random.default_rng(21)
    state = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    mat = rng.integers(0, 3, N).astype(np.int32)
    fuzz = rng.uniform(0.0, 1.0, N).astype(np.float32)
    ior = np.where(rng.random(N) < 0.5, 1.5, 1.0 / 1.5).astype(np.float32)
    return state, d, n, mat, fuzz, ior


def test_reflect_and_schlick(shading):
    _, d, n, _, _, ior = shading
    _close(tbsdf.reflect(_t(d), _t(n)),
           jbsdf.reflect(jnp.asarray(d), jnp.asarray(n)))
    cos = np.abs(d[:, 0])
    _close(tbsdf.schlick(_t(cos), _t(ior)),
           jbsdf.schlick(jnp.asarray(cos), jnp.asarray(ior)))


@pytest.mark.parametrize("material", [0, 1, 2, "all"])
def test_scatter(shading, material):
    """Unit directions within rtol 1e-5 (atol 1e-5): the draws' states
    are exact; pow, cos, sin and the norms differ by ulps.  A dielectric
    lane whose reflectance sits within an ulp of its draw could flip; on
    these lanes none does."""
    state, d, n, mat, fuzz, ior = shading
    ts = _t(state.astype(np.int64))
    if material == "all":
        j = jbsdf.scatter(jnp.asarray(state), jnp.asarray(d), jnp.asarray(n),
                          jnp.asarray(mat), jnp.asarray(fuzz),
                          jnp.asarray(ior))
        t = tbsdf.scatter(ts, _t(d), _t(n), _t(mat), _t(fuzz), _t(ior))
    else:
        j = jbsdf.SCATTER_BY_MATERIAL[material](
            jnp.asarray(state), jnp.asarray(d), jnp.asarray(n),
            jnp.asarray(fuzz), jnp.asarray(ior))
        t = tbsdf.SCATTER_BY_MATERIAL[material](ts, _t(d), _t(n), _t(fuzz),
                                                _t(ior))
    _close(t, j)
    np.testing.assert_allclose(torch.linalg.vector_norm(t, dim=1).numpy(),
                               1.0, atol=1e-5)


# --- models/megakernel.py ------------------------------------------------

def _camera(name):
    scene = "mesh_terrain" if name == "terrain" else name
    return build_camera(build_parser().parse_args(["--scene", scene]))


RR = {"rr_start_bounce": 2}
CLAMP = {"clamp": 0.5}
STRAT = {"sampler": "stratified"}


@pytest.mark.parametrize("name,opts", [
    ("book_cover", {}), ("book_bubble", {}), ("book_checker", {}),
    ("terrain", {}), ("book_cover", RR), ("book_cover", CLAMP),
    ("book_cover", STRAT), ("terrain", {**RR, **CLAMP, **STRAT}),
], ids=["book_cover", "book_bubble", "book_checker", "terrain",
        "book_cover-rr2", "book_cover-clamp", "book_cover-stratified",
        "terrain-rr2-clamp-stratified"])
def test_engine_matches_jax_megakernel(name, opts):
    """32x16@4 spp, 8 bounces, each scene's camera of the CLI.  On
    book_checker only the default options: its ground (radius 1000)
    cancels in its root to ~1e-4 of t, which moves hit points across
    checker edges, and at this size one diverged path moves the display
    RMSE by ~6e-3 (RR, clamp and stratified read 1.4e-5 to 7.4e-3)."""
    if name == "terrain":
        scene, tris = mesh_terrain_scene(n_quads=4)
    else:
        scene, tris = get_scene(name), None
    cc = _camera(name)
    cfg = BASE.replace(**opts)
    j = jax_render(scene, cc, cfg, tris)
    t = torch_render(scene, cc, cfg, tris, device="cpu")
    assert t.samples == j.samples == 4
    check_parity(t.accumulated / 4, j.accumulated / 4, t.rays_traced,
                 j.rays_traced)
    assert t.image.mean() > 0.05


def test_bubble_renders_the_cover():
    """book_bubble's inside-out sphere (radius -0.4, index 1.5) bends
    light as book_cover's (radius 0.4, index 1/1.5): the same image."""
    cc = _camera("book_cover")
    a = torch_render(get_scene("book_cover"), cc, BASE, device="cpu")
    b = torch_render(get_scene("book_bubble"), cc, BASE, device="cpu")
    np.testing.assert_allclose(a.accumulated, b.accumulated, atol=1e-5)


def test_progressive_equals_batched_and_chunks():
    """Frames of one sample add what one frame of four adds, bit for bit;
    chunks of 100 pixels give the same rays and, on the CPU, the same
    image up to the ulps of vectorized against scalar ``sin`` / ``pow``
    (which lanes fall in a vector's tail moves with the chunk)."""
    scene, cc = get_scene("book_cover"), _camera("book_cover")
    batched = torch_render(scene, cc, BASE, device="cpu")
    prog = torch_render(scene, cc, BASE.replace(samples_per_frame=1),
                        device="cpu")
    np.testing.assert_array_equal(prog.accumulated, batched.accumulated)
    chunked = torch_render(scene, cc, BASE.replace(ray_chunk=100),
                           device="cpu")
    np.testing.assert_allclose(chunked.accumulated, batched.accumulated,
                               rtol=0, atol=1e-5)
    assert chunked.rays_traced == batched.rays_traced


def test_rays_count_live_paths():
    """One bounce: every pixel's camera ray and nothing more."""
    res = torch_render(get_scene("book_cover"), _camera("book_cover"),
                       BASE.replace(max_bounces=1), device="cpu")
    assert res.rays_traced == 32 * 16 * 4


def test_engine_registry_and_refusals():
    assert get_engine("megakernel") is tmega
    # Once refused: the BVH runs, at 8x8@1 spp here.
    cfg = BASE.replace(width=8, height=8, samples_per_pixel=1,
                       samples_per_frame=1)
    bvh = Renderer(get_scene("book_cover"), _camera("book_cover"),
                   cfg.replace(intersector="bvh"), device="cpu").render()
    brute = Renderer(get_scene("book_cover"), _camera("book_cover"), cfg,
                     device="cpu").render()
    check_parity(bvh.accumulated, brute.accumulated, bvh.rays_traced,
                 brute.rays_traced)
    assert bvh.image.shape == (8, 8, 3) and bvh.rays_traced >= 64
    # Once refused: num_devices is read only by parallel.render_sharded,
    # so a render renders on one device, the same bits as num_devices=1.
    two = Renderer(get_scene("book_cover"), _camera("book_cover"),
                   cfg.replace(num_devices=2), device="cpu").render()
    np.testing.assert_array_equal(two.accumulated, brute.accumulated)
    assert two.rays_traced == brute.rays_traced
    if not torch.cuda.is_available():
        # The default device is the card, with no fallback to the CPU.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Renderer(get_scene("book_cover"), _camera("book_cover"), BASE)


def test_cli_engine(tmp_path):
    out = str(tmp_path / "mk.png")
    renderer, res = cli_run(["--engine", "megakernel", "--device", "cpu",
                             "--scene", "mesh_terrain", "--width", "16",
                             "--height", "8", "--spp", "1", "--max-bounces",
                             "3", "--intersector", "auto", "--quiet",
                             "--out", out])
    assert renderer.config.engine == "megakernel"
    assert renderer.config.intersector == "bruteforce"
    assert res.image.shape == (8, 16, 3) and (tmp_path / "mk.png").exists()
    # Once refused: the wavefront engine, bit-identical to the megakernel.
    renderer, wf = cli_run(["--engine", "wavefront", "--device", "cpu",
                            "--scene", "mesh_terrain", "--width", "16",
                            "--height", "8", "--spp", "1", "--max-bounces",
                            "3", "--intersector", "auto", "--quiet",
                            "--out", str(tmp_path / "wf.png")])
    assert renderer.config.engine == "wavefront"
    np.testing.assert_array_equal(wf.accumulated, res.accumulated)
    assert wf.rays_traced == res.rays_traced
