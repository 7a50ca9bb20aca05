"""The port's slice as a whole: ``renderer.render`` with the fused engine
on the CPU against the JAX package's ``render`` with ``engine="fused"``
(Pallas in interpret mode), held to the statistical parity rule."""

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.models import fused as jfused
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.models import get_engine
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.renderer import Renderer
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    book_one_final,
    get_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

BASE = RenderConfig(width=32, height=16, samples_per_pixel=2,
                    samples_per_frame=2, max_bounces=8, engine="fused")


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


@pytest.fixture(scope="module")
def cover():
    return get_scene("book_cover")


def test_book_cover_matches_jax(cover):
    t, _ = _both(cover, _cover_camera(), BASE)
    assert t.accumulated.shape == (16, 32, 3)
    assert t.image.mean() > 0.05


def test_book_one_final_matches_jax():
    # The reference camera: thin lens on.
    _both(book_one_final(seed=42), CameraController.book_one_final(), BASE)


def test_nonsquare_padding_matches_jax(cover):
    # 100x27 = 2700 pixels: not a multiple of 128, so padding lanes.
    _both(cover, _cover_camera(), BASE.replace(width=100, height=27))


@pytest.mark.parametrize("knobs", [
    {"lane_split": 2},
    {"lane_rotate": False},
    {"lane_rotate": True, "lane_rotate_cols": 2, "block_tiles": 0},
], ids=["split2", "rotate-off", "rotate-cols2-linear"])
def test_scheduling_knobs_stay_inside_rule(cover, knobs):
    _both(cover, _cover_camera(), BASE.replace(**knobs))


def test_progressive_equals_batched(cover):
    cc = _cover_camera()
    batched = torch_render(cover, cc, BASE, device="cpu")
    progressive = torch_render(cover, cc, BASE.replace(samples_per_frame=1),
                               device="cpu")
    np.testing.assert_allclose(progressive.accumulated, batched.accumulated,
                               rtol=0, atol=1e-6)


def test_restart_on_camera_change(cover):
    r = Renderer(cover, _cover_camera(), BASE.replace(samples_per_frame=1),
                 device="cpu")
    r.render_frame()
    assert r.progress.accumulated_samples == 1
    r.camera_changed()
    assert r.progress.accumulated_samples == 0
    r.resize(8, 4)
    res = r.render()
    assert res.accumulated.shape == (4, 8, 3) and res.samples == 2


@pytest.mark.parametrize("block", [32, 7])
@pytest.mark.parametrize("size", [(32, 16), (100, 27), (1920, 1080)])
def test_block_perm_bit_exact(size, block):
    jp, ji = jfused._block_perm(*size, block)
    tp, ti = tfused._block_perm(*size, block)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)
    assert tp.dtype == jp.dtype and ti.dtype == ji.dtype


# The winner hint now runs on the baked path; on the dynamic culled path
# the reference itself refuses it (models/fused.py:329-334).
HINT_ON_DYNAMIC = {"intersector": "bruteforce", "winner_hint": True,
                   "baked_clusters": 16}
ONE_DEVICE = "renders as num_devices=1"


@pytest.mark.parametrize("change,match", [
    pytest.param(HINT_ON_DYNAMIC, "reference",
                 id="intersector=baked,winner_hint=True,baked_clusters=16"),
    # The reference's own refusal (its models/fused.py:338-343).
    pytest.param({"intersector": "bvh"}, "reference", id="intersector=bvh"),
    # The reference's own refusal (models/fused.py:359-364): recluster
    # needs a culling intersector.
    pytest.param({"recluster": 1, "intersector": "bruteforce"},
                 "culling intersector",
                 id="recluster=1,intersector=bruteforce"),
    pytest.param({"winner_hint": True, "baked_clusters": 4}, "reference",
                 id="winner_hint=True,baked_clusters=4"),
    # Once refused, now ported: num_devices is read only by
    # parallel.render_sharded, so a render renders on one device, the
    # same bits as num_devices=1 (ONE_DEVICE), as in the reference.
    pytest.param({"num_devices": 2}, ONE_DEVICE, id="num_devices=2"),
    # Once refused, now ported: the BVH on the megakernel and the
    # wavefront engine run (match None), bit-identical to each other.
    pytest.param({"engine": "megakernel", "intersector": "bvh"}, None,
                 id="engine=megakernel"),
    pytest.param({"engine": "wavefront"}, None, id="engine=wavefront"),
])
def test_refusals(cover, change, match):
    if match == ONE_DEVICE:
        res = Renderer(cover, _cover_camera(), BASE.replace(**change),
                       device="cpu").render()
        ref = Renderer(cover, _cover_camera(), BASE, device="cpu").render()
        np.testing.assert_array_equal(res.accumulated, ref.accumulated)
        assert res.rays_traced == ref.rays_traced >= 32 * 16 * 2
        return
    if match is None:
        cfg = BASE.replace(width=8, height=8, samples_per_pixel=1,
                           samples_per_frame=1, **change)
        res = Renderer(cover, _cover_camera(), cfg, device="cpu").render()
        other = "wavefront" if cfg.engine == "megakernel" else "megakernel"
        ref = Renderer(cover, _cover_camera(), cfg.replace(engine=other),
                       device="cpu").render()
        assert res.image.shape == (8, 8, 3) and res.image.mean() > 0.1
        np.testing.assert_array_equal(res.accumulated, ref.accumulated)
        assert res.rays_traced == ref.rays_traced >= 64
        return
    with pytest.raises(NotImplementedError, match=match):
        Renderer(cover, _cover_camera(), BASE.replace(**change), device="cpu")


@pytest.mark.parametrize("change", [
    pytest.param({"intersector": "baked", "recluster": 1},
                 id="intersector=baked,recluster=1"),
    pytest.param({"intersector": "bruteforce", "baked_clusters": 8,
                  "recluster": 2},
                 id="intersector=bruteforce,baked_clusters=8,recluster=2"),
])
def test_recluster_matches_persistent(cover, change):
    """Once refused: the segmented path renders what the persistent path
    renders, by the statistical rule, with the same ray counts up to the
    two raygens' ulps (the reference's tests/test_fused.py:565-577)."""
    cfg = BASE.replace(**change)
    seg = torch_render(cover, _cover_camera(), cfg, device="cpu")
    pers = torch_render(cover, _cover_camera(), cfg.replace(recluster=0),
                        device="cpu")
    check_parity(seg.accumulated / seg.samples,
                 pers.accumulated / pers.samples, seg.rays_traced,
                 pers.rays_traced)
    assert abs(seg.rays_traced - pers.rays_traced) / pers.rays_traced < 1e-3


@pytest.mark.parametrize("change", [
    {"baked_clusters": 16},
    {"baked_clusters": -1},
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_bruteforce_with_clusters_matches_jax(cover, change):
    """Brute force with clusters (explicit or auto) is the dynamic culled
    path, once refused: on book_cover every sphere is a global."""
    t, _ = _both(cover, _cover_camera(), BASE.replace(**change))
    assert t.image.mean() > 0.05


def test_refuses_textured_scene():
    """Textures render on every culled or baked path; the plain brute-force
    kernel (no clusters) refuses them, as the reference does
    (models/fused.py:322-328)."""
    with pytest.raises(NotImplementedError, match="reference"):
        Renderer(get_scene("book_checker"), _cover_camera(), BASE,
                 device="cpu")


def test_refuses_triangles_and_textures_in_engine(cover):
    arrays = {"centers": torch.zeros((1, 3))}
    for extra in ("tri_v0", "tex_kind"):
        with pytest.raises(NotImplementedError, match="reference"):
            tfused.check_supported(BASE, {**arrays, extra: torch.zeros(1)})
    # With clusters, both run on the dynamic culled path.
    for extra in ("tri_v0", "tex_kind"):
        tfused.check_supported(BASE.replace(baked_clusters=8),
                               {**arrays, extra: torch.zeros(1)})


def _spy_lane_rays(monkeypatch) -> list:
    """Record each per-lane ray plane that ``warp_trips`` reduces."""
    seen, real = [], tfk.warp_trips

    def spy(lane_rays):
        seen.append(lane_rays.clone())
        return real(lane_rays)

    monkeypatch.setattr(tfk, "warp_trips", spy)
    return seen


def test_converted_jax_scene_renders_with_stats(cover, monkeypatch):
    """Scene arrays from the JAX prepare_scene, carried over by
    convert.py, render the same as the port's own prepared scene; the
    stats report loop trips per warp and no culling.  The iterations
    equal an independent numpy reduction of the lanes' rays: the sum over
    32-lane groups, in lane order, of each group's largest count."""
    from wavefront_path_tracer_tpu.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch

    seen = _spy_lane_rays(monkeypatch)
    cc = _cover_camera()
    arrays = scene_arrays_to_torch(prepare_scene(cover, BASE), "cpu")
    assert arrays["mat_type"].dtype == torch.int32
    assert torch.equal(arrays["scene_packed"].view(torch.int32),
                       tfk.pack_scene(arrays).view(torch.int32))
    rad, rays, stats = tfused.render_samples_with_stats(
        arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(BASE.width, BASE.height), BASE, BASE.frame,
        0, BASE.samples_per_pixel)
    ref = torch_render(cover, cc, BASE, device="cpu")
    np.testing.assert_array_equal(rad.reshape(16, 32, 3).numpy(),
                                  ref.accumulated)
    assert int(rays) == ref.rays_traced
    lane_rays = seen[0].numpy()
    assert lane_rays.shape == (1024,) and lane_rays.sum() == int(rays)
    want = lane_rays.reshape(-1, 32).max(axis=1).sum()
    assert int(stats["iterations"]) == want
    assert int(rays) / 32 <= want < int(rays)
    assert int(stats["supers_entered"]) == int(stats["clusters_entered"]) == 0


@pytest.mark.parametrize("change", [
    {},
    {"intersector": "baked", "baked_clusters": 16},
], ids=["bruteforce", "baked-cull16"])
def test_iterations_match_jax_tiles(cover, monkeypatch, change):
    """Grouped as the reference groups lanes into a tile (tile_rows x
    128 = 1024 lanes, lane rotation off, so that each lane traces its own
    pixel), the port's loop trips come within the 1% that the rays get of
    the JAX kernel's `niter` summed over its two tiles, at 50 bounces so
    that no tile runs into the cap: a tile's trips are its largest lane's
    ray count, as a warp's are."""
    from wavefront_path_tracer_tpu.renderer import prepare_scene as jprep
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene

    cfg = BASE.replace(width=64, height=32, lane_rotate=False,
                       max_bounces=50, **change)
    monkeypatch.setattr(tfk, "WARP", cfg.tile_rows * 128)
    cc = _cover_camera()
    view, inv_proj = cc.view_matrix(), cc.inverse_projection(64, 32)
    _, rays_t, st_t = tfused.render_samples_with_stats(
        prepare_scene(cover, cfg, "cpu"), cc.gpu_camera(), view, inv_proj,
        cfg, 0, 0, 2)
    _, rays_j, st_j = jfused.render_samples_with_stats(
        jprep(cover, cfg), cc.gpu_camera(), view, inv_proj, cfg, 0, 0, 2)
    rays_t, rays_j = int(rays_t), float(rays_j)
    it_t, it_j = int(st_t["iterations"]), float(st_j["iterations"])
    assert abs(rays_t - rays_j) / rays_j < 0.01
    assert abs(it_t - it_j) / it_j < 0.01, (it_t, it_j)
    # Below the cap of 2 tiles x 2 samples x 50 bounces: the tiles' trips
    # are their longest lanes', not the cap's.
    assert it_j < 2 * 2 * cfg.max_bounces
    assert it_j < rays_j / 100


def test_get_engine_unknown():
    with pytest.raises(KeyError):
        get_engine("nope")
