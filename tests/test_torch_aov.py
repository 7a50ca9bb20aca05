"""The port's AOV passes (``wavefront_path_tracer_tpu_torch/aov.py``)
against the JAX package's ``aov.render_aovs`` on the same per-(pixel,
sample) streams, on the CPU.

The first-hit winners are the same, so albedo and coverage agree within
1e-5.  XLA on the CPU contracts multiply-adds, so the hit distance ``t``
differs by roundings: depth is held to 2e-5 relative (the BVH tests'
tolerance for ``t``), except at pixels where a sample's first hit grazes
its surface (|cos| < 0.2 between the ray and the normal: the near root of
the quadratic, or a triangle's determinant, is ill-conditioned there), where
it is held to the megakernel tests' 1e-3 relative.  A normal is
(p - c) / r with p = o + t d, so the relative error of ``t`` moves it by
up to that error times t / r: 2e-5 x 14 / 0.5 = 5.6e-4 for the book's
small spheres seen from the book camera, and normals are held to 5e-4.
Measured at 32x18@4spp: normals within 2.6e-4 (9.1e-5 away from grazing
hits), depth within 4e-6 relative away from them and 3.5e-5 at them.
"""

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu import aov as jaov
from wavefront_path_tracer_tpu.scene import CameraController as JCamera
from wavefront_path_tracer_tpu.scene.mesh import mesh_demo_scene as jmesh
from wavefront_path_tracer_tpu.scene.scene import book_cover as jbook
from wavefront_path_tracer_tpu.utils.config import RenderConfig as JConfig
from wavefront_path_tracer_tpu.utils.image import read_png
from wavefront_path_tracer_tpu_torch import aov
from wavefront_path_tracer_tpu_torch.ops.hit import intersect_and_resolve
from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
from wavefront_path_tracer_tpu_torch.scene import (
    CameraController,
    book_cover,
    mesh_demo_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

W, H, SPP = 32, 18, 4
KW = dict(width=W, height=H, samples_per_pixel=SPP, samples_per_frame=SPP,
          max_bounces=4, engine="megakernel", intersector="bruteforce")
GRAZING_COS = 0.2
T_RTOL, T_RTOL_GRAZING = 2e-5, 1e-3
NORMAL_ATOL = 5e-4
ATOL = 1e-5


def _scenes(name):
    if name == "book_cover":
        return (book_cover(), None), (jbook(), None)
    return mesh_demo_scene(), jmesh()


def _grazing(scene, tris, cfg):
    """(H, W) mask of the pixels where some sample's first hit has
    |cos| < GRAZING_COS between its ray and its normal."""
    cc = CameraController.book_one_final()
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    pix = torch.arange(cfg.num_pixels)
    graze = torch.zeros(cfg.num_pixels, dtype=torch.bool)
    for s in range(SPP):
        o, d = generate_rays(pix, W, H, 0, s, cc.gpu_camera(),
                             cc.view_matrix(), cc.inverse_projection(W, H))
        _t, hit, normal, *_ = intersect_and_resolve(o, d, arrays, cfg)
        graze |= hit & ((normal * d).sum(-1).abs() < GRAZING_COS)
    return graze.reshape(H, W).numpy()


@pytest.mark.parametrize("name", ["book_cover", "mesh_demo"])
def test_aovs_match_jax(name):
    (scene, tris), (jscene, jtris) = _scenes(name)
    cfg = RenderConfig(**KW)
    port = aov.render_aovs(scene, CameraController.book_one_final(), cfg,
                           tris, device="cpu")
    ref = jaov.render_aovs(jscene, JCamera.book_one_final(), JConfig(**KW),
                           jtris)
    assert set(port) == set(ref) == {"albedo", "normal", "depth",
                                     "coverage"}
    for key in port:
        assert port[key].shape == ref[key].shape
        assert port[key].dtype == np.float32
    np.testing.assert_allclose(port["coverage"], ref["coverage"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(port["albedo"], ref["albedo"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(port["normal"], ref["normal"], rtol=0,
                               atol=NORMAL_ATOL)
    graze = _grazing(scene, tris, cfg)
    assert 0 < graze.mean() < 0.5
    np.testing.assert_allclose(port["depth"][~graze], ref["depth"][~graze],
                               rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(port["depth"][graze], ref["depth"][graze],
                               rtol=T_RTOL_GRAZING, atol=0)
    assert 0.2 < port["coverage"].mean() < 1.0


def test_aovs_reuse_renderer_tables_and_chunks():
    """With a renderer's tables (baked: the AOVs take brute force over
    the same spheres) and pixel chunks smaller than the frame, the planes
    are the same bits."""
    from wavefront_path_tracer_tpu_torch.renderer import Renderer

    cc = CameraController.book_one_final()
    cfg = RenderConfig(**KW)
    whole = aov.render_aovs(book_cover(), cc, cfg, device="cpu")
    baked = cfg.replace(engine="fused", intersector="baked",
                        baked_clusters=2, ray_chunk=100)
    r = Renderer(book_cover(), cc, baked, device="cpu")
    chunked = aov.render_aovs(None, cc, baked,
                              scene_arrays=r.scene_arrays)
    for key in whole:
        np.testing.assert_array_equal(chunked[key], whole[key])


def test_aovs_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aov.render_aovs(book_cover(), CameraController.book_one_final(),
                        RenderConfig(**KW))


def test_write_aovs_files(tmp_path):
    """The reference's files, byte for byte, from the same planes."""
    aovs = aov.render_aovs(book_cover(), CameraController.book_one_final(),
                           RenderConfig(**KW), spp=2, device="cpu")
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    paths = aov.write_aovs(str(tmp_path / "port" / "x"), aovs)
    ref_paths = jaov.write_aovs(str(tmp_path / "ref" / "x"), aovs)
    assert [p.split("/")[-1] for p in paths] == [
        "x.aov.npz", "x.albedo.png", "x.normal.png", "x.depth.png"]
    assert [p.split("/")[-1] for p in ref_paths] == [
        p.split("/")[-1] for p in paths]
    loaded = np.load(paths[0])
    for key in aovs:
        np.testing.assert_array_equal(loaded[key], aovs[key])
    for p, q in zip(paths[1:], ref_paths[1:]):
        assert open(p, "rb").read() == open(q, "rb").read()
        assert read_png(p).shape == (H, W, 3)
