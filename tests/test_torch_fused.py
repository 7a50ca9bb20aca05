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


@pytest.mark.parametrize("change", [
    {"intersector": "baked", "recluster": 1},
    {"intersector": "baked", "winner_hint": True, "baked_clusters": 16},
    {"intersector": "bvh"},
    {"baked_clusters": 16},
    {"baked_clusters": -1},
    {"recluster": 1, "intersector": "bruteforce"},
    {"winner_hint": True, "baked_clusters": 4},
    {"num_devices": 2},
    {"engine": "megakernel"},
    {"engine": "wavefront"},
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_refusals(cover, change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(cover, _cover_camera(), BASE.replace(**change), device="cpu")


def test_refuses_textured_scene():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(get_scene("book_checker"), _cover_camera(), BASE,
                 device="cpu")


def test_refuses_triangles_and_textures_in_engine(cover):
    arrays = {"centers": torch.zeros((1, 3))}
    for extra in ("tri_v0", "tex_kind"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfused.check_supported(BASE, {**arrays, extra: torch.zeros(1)})


def test_converted_jax_scene_renders_with_stats(cover):
    """Scene arrays from the JAX prepare_scene, carried over by
    convert.py, render the same as the port's own prepared scene; the
    stats report per-lane iterations (one per ray) and no culling."""
    from wavefront_path_tracer_tpu.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.convert import scene_arrays_to_torch

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
    assert int(rays) == ref.rays_traced == int(stats["iterations"])
    assert int(stats["supers_entered"]) == int(stats["clusters_entered"]) == 0


def test_get_engine_unknown():
    with pytest.raises(KeyError):
        get_engine("nope")
