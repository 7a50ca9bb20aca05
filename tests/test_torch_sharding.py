"""The port's sharded rendering (``parallel/sharding.py``) on the CPU, at
the JAX package's ``tests/test_sharding.py`` sizes (book_cover, 64x32,
4 spp, 8 bounces) on a mesh of eight copies of the CPU, the counterpart
of its eight virtual XLA devices.

Each of that file's tests has its counterpart here, held to its own rule
against the port's one-device render: tile sharding bit for bit, sample
sharding within rtol 1e-5, atol 1e-6 (the sum over sample shards
reorders float adds).  The dynamic culled path is held bit for bit too:
the port culls per ray, so a tile's rays are those of the whole image.
The port's sharded XLA-style engines are held to the JAX package's
``render_samples_sharded`` on the same mesh shapes by the parity rule.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.parallel.sharding import (
    make_mesh as jmake_mesh,
)
from wavefront_path_tracer_tpu.parallel.sharding import (
    render_samples_sharded as jrender_samples_sharded,
)
from wavefront_path_tracer_tpu.renderer import prepare_scene as jprepare
from wavefront_path_tracer_tpu.scene import CameraController as JCamera
from wavefront_path_tracer_tpu.scene import book_cover as jbook_cover
from wavefront_path_tracer_tpu.utils.config import RenderConfig as JConfig
from wavefront_path_tracer_tpu_torch import bench
from wavefront_path_tracer_tpu_torch.parallel import (
    make_mesh,
    render_samples_sharded,
    shard_pixels,
)
from wavefront_path_tracer_tpu_torch.parallel.dryrun import dryrun_multichip
from wavefront_path_tracer_tpu_torch.parallel.sharding import render_sharded
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene, render
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    book_cover,
    get_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8
SIZE = dict(width=64, height=32, samples_per_pixel=4, samples_per_frame=4,
            max_bounces=8)
CFG = RenderConfig(engine="wavefront", **SIZE)


def _camera(cls=CameraController):
    cc = cls.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.defocus_angle_deg = 0.0
    return cc


def _sharded(scene, cfg, mesh):
    """(radiance (P, 3) numpy, rays) of the sharded render."""
    cc = _camera()
    arrays = prepare_scene(scene, cfg, "cpu")
    rad, rays = render_samples_sharded(
        mesh, arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(cfg.width, cfg.height), cfg, cfg.frame, 0,
        cfg.samples_per_pixel)
    assert rad.device == mesh.devices[0][0] and rays.dtype == torch.int64
    return rad.numpy(), int(rays)


def _single(scene, cfg):
    return render(scene, _camera(), cfg, device="cpu")


@pytest.fixture(scope="module")
def cover():
    return book_cover()


def test_eight_device_mesh(cover):
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.shape == {"tiles": 8, "samples": 1}
    assert make_mesh(8, sample_axis=4, devices=CPU8).shape == {
        "tiles": 2, "samples": 4}
    assert shard_pixels(CFG, 8) == 64 * 32 // 8


def test_make_mesh_has_no_fallback():
    """More devices than present raise, naming their count; without
    ``devices`` the mesh takes the CUDA cards, never the CPU."""
    with pytest.raises(ValueError, match="9 devices was asked for, and 8 "
                                         "are present"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(AssertionError, match="sample_axis 3"):
        make_mesh(8, sample_axis=3, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1)


def test_tile_sharding_matches_single_device(cover):
    single = _single(cover, CFG)
    rad, rays = _sharded(cover, CFG, make_mesh(8, sample_axis=1,
                                               devices=CPU8))
    # Pure pixel parallelism: no reduction reordered, so bit for bit.
    np.testing.assert_array_equal(rad, single.accumulated.reshape(-1, 3))
    assert rays == single.rays_traced


def test_sample_sharding_matches(cover):
    single = _single(cover, CFG)
    rad, rays = _sharded(cover, CFG, make_mesh(8, sample_axis=4,
                                               devices=CPU8))
    # The sum over sample shards reorders float adds: close, not equal.
    np.testing.assert_allclose(rad, single.accumulated.reshape(-1, 3),
                               rtol=1e-5, atol=1e-6)
    assert rays == single.rays_traced


def test_megakernel_engine_shards_too(cover):
    cfg = CFG.replace(engine="megakernel")
    single = _single(cover, cfg)
    rad, _ = _sharded(cover, cfg, make_mesh(4, sample_axis=2, devices=CPU8))
    np.testing.assert_allclose(rad, single.accumulated.reshape(-1, 3),
                               rtol=1e-5, atol=1e-6)


def test_indivisible_pixels_rejected(cover):
    cfg = CFG.replace(width=9, height=7)  # 63 pixels not divisible by 8
    with pytest.raises(AssertionError, match="tiles"):
        _sharded(cover, cfg, make_mesh(8, sample_axis=1, devices=CPU8))


def test_fused_engine_shards(cover):
    """The fused engine (the brute-force kernel's plain version here),
    pixel and sample parallel."""
    cfg = CFG.replace(engine="fused")
    single = _single(cover, cfg)
    rad, rays = _sharded(cover, cfg, make_mesh(8, sample_axis=2,
                                               devices=CPU8))
    np.testing.assert_allclose(rad, single.accumulated.reshape(-1, 3),
                               rtol=1e-5, atol=1e-6)
    assert rays == single.rays_traced


@pytest.mark.parametrize("change", [
    pytest.param({}, id="baked"),
    pytest.param({"baked_clusters": 16, "recluster": 2},
                 id="baked_clusters=16,recluster=2"),
])
def test_fused_baked_engine_shards(cover, change):
    """Fused/baked over four tiles in block order, and (new) the
    segmented path over them: each tile sorts its own rays."""
    cfg = CFG.replace(engine="fused", intersector="baked", **change)
    single = _single(cover, cfg)
    rad, rays = _sharded(cover, cfg, make_mesh(4, sample_axis=1,
                                               devices=CPU8))
    np.testing.assert_array_equal(rad, single.accumulated.reshape(-1, 3))
    assert rays == single.rays_traced


def test_sharded_fused_dynamic_culled():
    """The dynamic culled tables, one set for the mesh's device: the JAX
    test's rule, and bit for bit."""
    scene = get_scene("procedural", n=96, seed=3)
    cfg = CFG.replace(engine="fused", intersector="bruteforce",
                      baked_clusters=8)
    single = _single(scene, cfg).accumulated.reshape(-1, 3)
    rad, _ = _sharded(scene, cfg, make_mesh(4, sample_axis=1, devices=CPU8))
    d = np.abs(rad - single).max(axis=-1)
    assert (d > 1e-3).mean() < 0.01
    np.testing.assert_array_equal(rad, single)


def test_sharded_respects_clamp(cover):
    """Config knobs (here the firefly clamp) flow through the sharded path
    as through a one-device render."""
    cfg = CFG.replace(clamp=0.2)
    rad, _ = _sharded(cover, cfg, make_mesh(8, sample_axis=1, devices=CPU8))
    single = _single(cover, cfg)
    np.testing.assert_array_equal(rad, single.accumulated.reshape(-1, 3))
    assert (rad <= cfg.samples_per_pixel * 0.2 + 1e-5).all()


def test_render_sharded(cover):
    """The one-shot entry point: (the (H, W, 3) radiance sum, spp)."""
    cfg = CFG.replace(engine="fused", intersector="baked")
    image, spp = render_sharded(cover, _camera(), cfg,
                                make_mesh(4, sample_axis=2, devices=CPU8))
    assert image.shape == (32, 64, 3) and spp == 4
    np.testing.assert_allclose(image, _single(cover, cfg).accumulated,
                               rtol=1e-5, atol=1e-6)


def test_dryrun_multichip():
    """The reference's four dry-run passes and the terrain pass, over
    eight copies of the CPU (a 4x2 mesh), each against its one-device
    render."""
    out = io.StringIO()
    with redirect_stdout(out):
        passes = dryrun_multichip(8, devices=CPU8)
    assert [p["pass"] for p in passes] == [
        "fused/bruteforce", "baked/cull8/block8", "recluster=2/cull8",
        "wavefront/bvh", "terrain dynamic/cull16"]
    assert all(p["mesh"] == {"tiles": 4, "samples": 2} and p["rays"] > 0
               for p in passes)
    assert out.getvalue().count("dryrun_multichip ok") == 5


def _bench_line(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(argv)
    assert rc == 0
    return json.loads([ln for ln in out.getvalue().splitlines()
                       if ln.startswith("{")][-1])


def test_bench_mesh_1x1():
    """``bench --mesh 1x1`` renders the headline's rays through the
    sharded path: no counters, no mesh rows, the config tagged."""
    tiny = ["--worker", "--device", "cpu", "--width", "16", "--height", "8",
            "--spp", "1", "--max-bounces", "2"]
    plain = _bench_line([*tiny, "--no-mesh-row"])
    meshed = _bench_line([*tiny, "--mesh", "1x1"])
    assert meshed["counters"] == {"rays": plain["counters"]["rays"]}
    assert meshed["metric"].endswith(
        "(16x8@1spp/fused/baked/cull16/mesh1x1, book_one_final)")
    assert "mesh" not in meshed and "device_utilization" not in meshed
    assert len(meshed["run_seconds"]) == 3


@pytest.mark.parametrize("engine,n,sample_axis", [
    ("wavefront", 8, 1),
    ("megakernel", 4, 2),
])
def test_sharded_matches_jax(engine, n, sample_axis):
    """The port's sharded render against the JAX package's on the same
    mesh shape over its eight virtual devices, by the parity rule."""
    assert len(jax.devices()) == 8
    jcfg = JConfig(engine=engine, **SIZE)
    jcc = _camera(JCamera)
    jrad = jrender_samples_sharded(
        jmake_mesh(n, sample_axis=sample_axis), jprepare(jbook_cover(), jcfg),
        jcc.gpu_camera(), jnp.asarray(jcc.view_matrix()),
        jnp.asarray(jcc.inverse_projection(64, 32)), jcfg, jnp.uint32(0),
        jnp.uint32(0), 4)
    rad, _ = _sharded(book_cover(), CFG.replace(engine=engine),
                      make_mesh(n, sample_axis=sample_axis, devices=CPU8))
    check_parity(rad / 4, np.asarray(jrad) / 4)
