"""The port's wavefront engine on the CPU: against the JAX package's
wavefront engine by the parity rule (``utils/parity.py``), and bit for
bit against the port's own megakernel, as the JAX package's
``tests/test_engines.py`` holds its two engines.

The scene is book_cover (four spheres) at 64x36@4 spp, 12 bounces, the
JAX engine tests' size.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.models import wavefront as jwavefront
from wavefront_path_tracer_tpu.renderer import prepare_scene as jprepare
from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu.scene import CameraController as JCamera
from wavefront_path_tracer_tpu.scene import book_cover as jbook_cover
from wavefront_path_tracer_tpu.utils.config import RenderConfig as JConfig
from wavefront_path_tracer_tpu_torch import renderer as trenderer
from wavefront_path_tracer_tpu_torch.models import get_engine
from wavefront_path_tracer_tpu_torch.models import wavefront as twavefront
from wavefront_path_tracer_tpu_torch.renderer import (
    Renderer,
    prepare_scene,
    render,
)
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    get_scene,
    mesh_terrain_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity
from wavefront_path_tracer_tpu_torch.utils.profiling import KernelTimer

torch.set_num_threads(2)

SIZE = dict(width=64, height=36, samples_per_pixel=4, samples_per_frame=4,
            max_bounces=12, intersector="bruteforce")
BASE = RenderConfig(engine="wavefront", **SIZE)
STAGES = {"generate", "extend", "miss", "shade", "compact"}


def _camera(cls=CameraController):
    cc = cls.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 20.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


def _render(cfg, scene="book_cover", **kw):
    return render(get_scene(scene), _camera(), cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def oracle():
    return _render(BASE.replace(engine="megakernel"))


@pytest.fixture(scope="module")
def wavefront():
    return _render(BASE)


def test_registered():
    assert get_engine("wavefront") is twavefront


@pytest.mark.parametrize("intersector", ["bruteforce", "bvh"])
def test_matches_jax_wavefront(intersector):
    """The port against the JAX package's wavefront engine: the parity
    rule's image limits, rays within 1%."""
    cfg = dict(SIZE, intersector=intersector)
    ref = jax_render(jbook_cover(), _camera(JCamera),
                     JConfig(engine="wavefront", **cfg))
    port = _render(RenderConfig(engine="wavefront", **cfg))
    check_parity(port.accumulated / 4, ref.accumulated / 4,
                 port.rays_traced, ref.rays_traced)
    assert port.rays_traced > 64 * 36 * 4


@pytest.mark.parametrize("change", [
    pytest.param({}, id="bruteforce"),
    pytest.param({"intersector": "bvh"}, id="bvh"),
    pytest.param({"ray_chunk": 512}, id="ray_chunk"),
    pytest.param({"material_split": True}, id="material_split"),
    pytest.param({"rr_start_bounce": 2}, id="roulette"),
    pytest.param({"clamp": 0.5}, id="clamp"),
    pytest.param({"sampler": "stratified"}, id="stratified"),
])
def test_bit_identical_to_megakernel(change, oracle, wavefront):
    """Same draws, same per-lane arithmetic: the image and the ray count
    of the port's megakernel, bit for bit."""
    wf = wavefront if not change else _render(BASE.replace(**change))
    mk = oracle if not change or change == {"ray_chunk": 512} else _render(
        BASE.replace(engine="megakernel", **change))
    np.testing.assert_array_equal(wf.accumulated, mk.accumulated)
    assert wf.rays_traced == mk.rays_traced


def test_negative_radius_bubble_bit_identical():
    """book_bubble's inside-out sphere through both engines."""
    cfg = BASE.replace(samples_per_pixel=8, samples_per_frame=8)
    mk = _render(cfg.replace(engine="megakernel"), "book_bubble")
    wf = _render(cfg, "book_bubble")
    assert np.isfinite(wf.accumulated).all()
    np.testing.assert_array_equal(wf.accumulated, mk.accumulated)


def test_bvh_against_bruteforce(wavefront):
    """Across intersectors only roundings separate the renders."""
    bvh = _render(BASE.replace(intersector="bvh"))
    check_parity(bvh.accumulated / 4, wavefront.accumulated / 4,
                 bvh.rays_traced, wavefront.rays_traced)


def test_terrain_triangle_bvh():
    """A mesh through the triangle BVH (tri_bvh_* tables), against the
    brute-force sweep by the parity rule and bit for bit against the
    megakernel on the same BVH."""
    scene, tris = mesh_terrain_scene(n_quads=6)
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2,
                       samples_per_frame=2, max_bounces=8,
                       engine="wavefront")
    brute = render(scene, cc, cfg, tris, device="cpu")
    r = Renderer(scene, cc, cfg.replace(intersector="bvh"), tris,
                 device="cpu")
    assert "tri_bvh_min" in r.scene_arrays
    bvh = r.render()
    mk = render(scene, cc, cfg.replace(intersector="bvh",
                                       engine="megakernel"), tris,
                device="cpu")
    check_parity(bvh.accumulated / 2, brute.accumulated / 2,
                 bvh.rays_traced, brute.rays_traced)
    np.testing.assert_array_equal(bvh.accumulated, mk.accumulated)


def test_progressive_equals_batch(wavefront):
    """Four frames of one sample sum to the one frame of four, bit for
    bit (the frame salt is fixed; batches differ by sample_base)."""
    prog = _render(BASE.replace(samples_per_frame=1))
    assert prog.samples == wavefront.samples == 4
    np.testing.assert_array_equal(prog.accumulated, wavefront.accumulated)


def test_restart_on_camera_change():
    r = Renderer(get_scene("book_cover"), _camera(), BASE, device="cpu")
    r.render_frame()
    assert r.progress.accumulated_samples == 4
    r.camera_changed()
    assert r.progress.accumulated_samples == 0
    assert not r._accum.any()


def test_drain_threshold_biases_but_runs(wavefront):
    drained = _render(BASE.replace(drain_threshold=64))
    assert np.isfinite(drained.accumulated).all()
    # An early drain loses energy and rays against exact termination.
    assert drained.accumulated.sum() <= wavefront.accumulated.sum() + 1e-3
    assert drained.rays_traced < wavefront.rays_traced


def test_bounce_histogram_equals_jax():
    cc = _camera()
    cfg = RenderConfig(**SIZE)
    jcfg = JConfig(**SIZE)
    ja = jprepare(jbook_cover(), jcfg)
    ta = prepare_scene(get_scene("book_cover"), cfg, "cpu")
    view = cc.view_matrix()
    inv_proj = cc.inverse_projection(cfg.width, cfg.height)
    ref = np.asarray(jwavefront.bounce_histogram(
        ja, _camera(JCamera).gpu_camera(), jnp.asarray(view),
        jnp.asarray(inv_proj), jcfg, jnp.uint32(0), jnp.uint32(0)))
    hist = twavefront.bounce_histogram(ta, cc.gpu_camera(), view, inv_proj,
                                       cfg, 0, 0)
    assert hist.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(), ref)
    assert hist[0] == cfg.num_pixels and hist[-1] < hist[0]


@pytest.mark.parametrize("change", [
    pytest.param({}, id="default"),
    pytest.param({"material_split": True, "rr_start_bounce": 2},
                 id="material_split_roulette"),
])
def test_staged_equals_render_samples(change):
    """The host-stepped, timed loop gives render_samples' bits, and times
    the reference's stages."""
    cfg = BASE.replace(**change)
    cc = _camera()
    arrays = prepare_scene(get_scene("book_cover"), cfg, "cpu")
    args = (arrays, cc.gpu_camera(), cc.view_matrix(),
            cc.inverse_projection(cfg.width, cfg.height), cfg, 0, 0, 2)
    rad, rays = twavefront.render_samples(*args)
    timer = KernelTimer()
    srad, srays = twavefront.render_samples_staged(*args, timer=timer)
    assert torch.equal(rad, srad) and int(rays) == int(srays)
    stages = set(timer.averages_us())
    assert stages == STAGES | ({"split"} if change else set())
    assert all(v >= 0.0 for v in timer.averages_us().values())


def test_renderer_stage_timer():
    """Renderer(stage_timer=...) times the wavefront engine's stages and
    reports the fused engine's in-kernel counters."""
    timer = KernelTimer()
    wf = Renderer(get_scene("book_cover"), _camera(), BASE, device="cpu",
                  stage_timer=timer).render()
    assert set(timer.averages_us()) == STAGES and wf.kernel_stats is None
    fused = Renderer(get_scene("book_cover"), _camera(), BASE.replace(
        engine="fused", intersector="baked", baked_clusters=2),
        device="cpu", stage_timer=KernelTimer()).render()
    assert set(fused.kernel_stats) == {"iterations", "supers_entered",
                                       "clusters_entered"}
    assert fused.kernel_stats["iterations"] > 0


def test_material_split_prefix_sort_keeps_jax_order():
    """Sorting the live prefix alone gives its lanes the order that the
    JAX engine's sort of the whole queue gives them (dead lanes keyed 3,
    after every live lane)."""
    rng = np.random.default_rng(31)
    capacity, count = 2000, 1234
    hit = rng.random(capacity) < 0.7
    hit[count:] = False                         # hit & live, as in JAX
    mat = rng.integers(0, 3, capacity).astype(np.int32)
    key = jnp.where(jnp.asarray(hit), jnp.asarray(mat), jnp.int32(3))
    _, full = jax.lax.sort_key_val(key, jnp.arange(capacity,
                                                   dtype=jnp.int32),
                                   is_stable=True)
    prefix = twavefront.material_order(torch.from_numpy(hit[:count]),
                                       torch.from_numpy(mat[:count]))
    np.testing.assert_array_equal(prefix.numpy(), np.asarray(full)[:count])


def test_bvh_off_cpu_warns(monkeypatch):
    """The BVH on the XLA-style engines off the CPU warns with the card's
    measured rate; the device check is patched, as the JAX package's
    test patches its backend."""
    monkeypatch.setattr(trenderer, "off_cpu", lambda device: True)
    for engine in ("wavefront", "megakernel"):
        with pytest.warns(RuntimeWarning, match="Mrays/s"):
            Renderer(get_scene("book_cover"), _camera(),
                     BASE.replace(engine=engine, intersector="bvh"),
                     device="cpu")


def test_bvh_on_cpu_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        Renderer(get_scene("book_cover"), _camera(),
                 BASE.replace(intersector="bvh"), device="cpu")
