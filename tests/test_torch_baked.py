"""The baked intersects of the port (plain versions, CPU) against the JAX
package: whole renders with ``intersector="baked"`` (Pallas in interpret
mode) under the statistical parity rule, and one tile of the intersect
closures themselves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.renderer import Renderer, prepare_scene
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import CameraController, get_scene
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


def _both(scene, cc, cfg):
    j = jax_render(scene, cc, cfg)
    t = torch_render(scene, cc, cfg, device="cpu")
    assert t.samples == j.samples == cfg.samples_per_pixel
    check_parity(t.accumulated / t.samples, j.accumulated / j.samples,
                 t.rays_traced, j.rays_traced)
    return t, j


@pytest.mark.parametrize("clusters", [0, 8])
def test_procedural_matches_jax(clusters):
    # The JAX package's own culled-vs-unculled scene (test_fused.py).
    t, _ = _both(get_scene("procedural", n=96, seed=3), _cover_camera(),
                 BASE.replace(baked_clusters=clusters))
    assert np.isfinite(t.accumulated).all()


def test_two_level_matches_jax():
    # 120 spheres in clusters of 2: 60 clusters > 48, so supers engage.
    _both(get_scene("procedural", n=120, seed=3), _cover_camera(),
          BASE.replace(baked_clusters=2))


def test_options_match_jax():
    _both(get_scene("procedural", n=96, seed=3), _cover_camera(),
          BASE.replace(baked_clusters=8, rr_start_bounce=3, clamp=0.5,
                       sampler="stratified", lane_split=2))


def test_headline_config_matches_jax():
    # book_one_final, reference camera (thin lens), culled in clusters of
    # 16 ordered from the camera hint: the headline path at a small size.
    _both(get_scene("book_one_final"), CameraController.book_one_final(),
          BASE.replace(baked_clusters=16))


def test_culled_equals_unculled(monkeypatch):
    """Culling is conservative: the port's culled image is its unculled
    image up to near-tie winners (the statistical rule; the two sweep in
    different orders with different quadratics), and only the culled
    bake enters clusters."""
    scene, cc = get_scene("procedural", n=96, seed=3), _cover_camera()
    arrays = prepare_scene(scene, BASE, "cpu")
    view = cc.view_matrix()
    inv_proj = cc.inverse_projection(BASE.width, BASE.height)
    seen, real = [], tfk.warp_trips

    def spy(lane_rays):
        seen.append(lane_rays.clone())
        return real(lane_rays)

    monkeypatch.setattr(tfk, "warp_trips", spy)
    out = {}
    for clusters in (0, 8):
        cfg = BASE.replace(baked_clusters=clusters)
        out[clusters] = tfused.render_samples_with_stats(
            arrays, cc.gpu_camera(), view, inv_proj, cfg, 0, 0, 2)
    (rad0, rays0, st0), (rad8, rays8, st8) = out[0], out[8]
    check_parity(rad8.numpy() / 2, rad0.numpy() / 2, rays8, rays0)
    assert int(st0["clusters_entered"]) == 0
    assert int(st8["clusters_entered"]) > 0
    # Loop trips per warp: the 32-lane groups' largest ray counts.
    lane_rays = seen[-1].numpy()
    assert lane_rays.sum() == int(rays8)
    assert int(st8["iterations"]) == lane_rays.reshape(-1, 32).max(1).sum()


def test_clusters_auto_resolves_as_reference():
    for scene in (get_scene("book_one_final"),
                  get_scene("procedural", n=2500, seed=1)):
        arrays = {k: np.asarray(getattr(scene, k)) for k in KEYS}
        cfg = BASE.replace(baked_clusters=-1)
        want = jfused._resolve_clusters(cfg, arrays)
        assert tfused._resolve_clusters(cfg, arrays) == want
        assert want == (16 if len(scene.radii) < 2000 else 32)


def test_two_level_counts_supers():
    scene, cc = get_scene("procedural", n=120, seed=3), _cover_camera()
    r = Renderer(scene, cc, BASE.replace(baked_clusters=2), device="cpu")
    _, rays, stats = tfused.render_samples_with_stats(
        r.scene_arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(BASE.width, BASE.height), r.config, 0, 0, 2)
    # A ray may enter a super and then none of its clusters.
    assert int(stats["supers_entered"]) > 0
    assert int(stats["clusters_entered"]) > 0


# --- one tile of the intersect closures -------------------------------------

def _jax_tile(fn, rays):
    """The JAX intersect closure on one (8, 128) tile, in interpret mode:
    its 11-field winner tuple as flat numpy arrays."""
    def kernel(ox, oy, oz, dx, dy, dz, *outs):
        res = fn(ox[:], oy[:], oz[:], dx[:], dy[:], dz[:])
        for o, v in zip(outs, res[:11]):
            o[:] = v

    shape = jax.ShapeDtypeStruct((8, 128), jnp.float32)
    outs = pl.pallas_call(kernel, out_shape=[shape] * 11, interpret=True)(
        *[jnp.asarray(r.reshape(8, 128)) for r in rays])
    return [np.asarray(o).reshape(-1) for o in outs]


def _tile_rays(scene_arrays, boxes, seed=0):
    """1024 rays from origins in free space (above the ground, outside
    every sphere: a ray starting inside an opaque sphere is outside the
    kernels' contract): 512 aimed at sphere centres, 256 axis-parallel,
    and 256 axis-parallel whose origin lies on a cluster box's face, so
    that (lo - o) * (1 / 0) is NaN for that box."""
    rng = np.random.default_rng(seed)
    c, r = scene_arrays["centers"], np.abs(scene_arrays["radii"])
    o = c[rng.integers(0, len(c), 1024)] + rng.normal(size=(1024, 3)) * 8
    o[:, 1] = np.abs(o[:, 1]) + 0.05
    d = c[rng.integers(0, len(c), 1024)] - o
    for k in range(512, 1024):
        d[k] = 0.0
        d[k, k % 3] = 1.0 if (k // 3) % 2 else -1.0
    for k in range(768, 1024):
        box = boxes[k % len(boxes)]
        axis = 2 if k % 3 == 0 else 0   # a zero component of d
        o[k, axis] = box[axis] if (k // 2) % 2 else box[4 + axis]
    inside = (np.linalg.norm(o[:, None] - c[None], axis=-1) < r).any(axis=1)
    o[inside, 1] += 20.0
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(v, np.float32) for v in (*o.T, *d.T)]


@pytest.mark.parametrize("culled", [True, False], ids=["culled", "unculled"])
def test_one_tile_matches_jax_closure(culled):
    """The plain intersect against the JAX closure on hand-made rays,
    covering the shifted frame and axis-parallel rays.  The winners
    must agree bit for bit.  ``t`` agrees to float noise only: XLA:CPU
    contracts multiply-adds into FMAs (measured) and the port does not,
    and the quadratic's cancellation magnifies that rounding."""
    scene = get_scene("procedural", n=48, seed=3)
    a = {k: np.asarray(getattr(scene, k)) for k in KEYS}
    hint = np.array([13.0, 2.0, 3.0])
    if culled:
        baked = bake.bake_culled(a, 4, camera_hint=hint)
        fn = jpk.baked_culled_intersect(*(a[k] for k in KEYS),
                                        cluster_size=4, camera_hint=hint)
        ref_fn = tbk.culled_intersect_reference
    else:
        baked = bake.bake_unculled(a)
        fn = jpk.baked_intersect(*(a[k] for k in KEYS))
        ref_fn = tbk.baked_intersect_reference
    boxes = bake.bake_culled(a, 4, camera_hint=hint).cluster_boxes.numpy()
    rays = _tile_rays(a, boxes)
    port = [v.numpy() for v in ref_fn(baked, *map(torch.from_numpy,
                                                   rays))[:11]]
    ref = _jax_tile(fn, rays)
    hit = ref[0] < jpk.T_FAR
    np.testing.assert_array_equal(port[0] < jpk.T_FAR, hit)
    assert hit[:512].mean() > 0.9 and hit[512:].any()
    # cx, cy, cz, inv_r sign, albedo, mat_type of every winner.
    for k in (1, 2, 3, 4, 5, 6, 7, 10):
        np.testing.assert_array_equal(port[k][hit].view(np.int32),
                                      ref[k][hit].view(np.int32))
    rel = np.abs(port[0] - ref[0])[hit] / ref[0][hit]
    assert np.quantile(rel, 0.9) < 1e-4 and rel.max() < 1e-2
    # The face-plane rays do produce NaN box entries, which skip the box.
    ox, oy, oz, dx, dy, dz = (torch.from_numpy(v[768:]) for v in rays)
    c_min, _ = tbk._box_range(torch.from_numpy(boxes[:, 0:3]),
                              torch.from_numpy(boxes[:, 4:7]), ox, oy, oz,
                              1.0 / dx, 1.0 / dy, 1.0 / dz)
    assert torch.isnan(c_min).any()


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("change,match", [
    # The winner hint renders on the baked path (test_torch_textures.py);
    # on the dynamic culled path the reference refuses it
    # (models/fused.py:329-334).
    pytest.param({"intersector": "bruteforce", "baked_clusters": 8,
                  "winner_hint": True}, "reference",
                 id="winner_hint=True,baked_clusters=4"),
    # Once refused, now ported: num_devices is read only by
    # parallel.render_sharded, so a render renders on one device, the
    # same bits as num_devices=1 (match None), as in the reference.
    pytest.param({"num_devices": 2}, None, id="num_devices=2"),
    pytest.param({"intersector": "bruteforce", "baked_clusters": 16,
                  "winner_hint": True}, "reference",
                 id="intersector=bruteforce,baked_clusters=16,"
                    "winner_hint=True"),
])
def test_baked_refusals(change, match):
    if match is None:
        scene, cc = get_scene("book_cover"), _cover_camera()
        res = Renderer(scene, cc, BASE.replace(**change), device="cpu").render()
        ref = Renderer(scene, cc, BASE, device="cpu").render()
        np.testing.assert_array_equal(res.accumulated, ref.accumulated)
        assert res.rays_traced == ref.rays_traced >= 32 * 16 * 2
        return
    with pytest.raises(NotImplementedError, match=match):
        Renderer(get_scene("book_cover"), _cover_camera(),
                 BASE.replace(**change), device="cpu")


@pytest.mark.parametrize("change", [
    pytest.param({"recluster": 1, "baked_clusters": 4},
                 id="recluster=1,baked_clusters=4"),
    pytest.param({"recluster": 2, "baked_clusters": 0},
                 id="recluster=2,baked_clusters=0"),
])
def test_recluster_baked_matches_persistent(change):
    """Once refused: the segments over the baked tables, culled and
    unculled (the reference takes both), render what the persistent
    baked kernel renders, by the statistical rule."""
    scene, cc = get_scene("procedural", n=96, seed=3), _cover_camera()
    cfg = BASE.replace(**change)
    seg = torch_render(scene, cc, cfg, device="cpu")
    pers = torch_render(scene, cc, cfg.replace(recluster=0), device="cpu")
    check_parity(seg.accumulated / 2, pers.accumulated / 2, seg.rays_traced,
                 pers.rays_traced)


def test_baked_refuses_textures_and_triangles():
    """Textures and triangles are refused only on the plain brute-force
    kernel (no clusters), as the reference refuses them; the baked path
    takes both."""
    with pytest.raises(NotImplementedError, match="reference"):
        Renderer(get_scene("book_checker"), _cover_camera(),
                 BASE.replace(intersector="bruteforce"), device="cpu")
    r = Renderer(get_scene("book_checker"), _cover_camera(), BASE,
                 device="cpu")
    assert "tex_kind" in r.scene_arrays
    arrays = {"centers": torch.zeros((1, 3)), "tri_v0": torch.zeros(1)}
    tfused.check_supported(BASE.replace(baked_clusters=16), arrays)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item"):
        tfused.check_supported(BASE.replace(intersector="bruteforce"),
                               arrays)


def test_auto_is_resolved_by_the_cli():
    with pytest.raises(ValueError, match="resolve_intersector"):
        Renderer(get_scene("book_cover"), _cover_camera(),
                 BASE.replace(intersector="auto"), device="cpu")
