"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc and skip without
one.  This file imports no JAX, so on a machine without JAX it runs
without the suite's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import bake
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.renderer import render
from wavefront_path_tracer_tpu_torch.scene import CameraController, get_scene
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _planes(width, height, device):
    perm, _ = tfused._block_perm(width, height, 32)
    perm_t = torch.from_numpy(perm.astype(np.int64)).to(device)
    return perm_t, tfused.lane_planes(perm_t, width, 8)


@pytest.mark.parametrize("opts", [
    {},
    {"rr_start": 2, "clamp": 0.5, "sampler": "stratified"},
])
def test_kernel_matches_plain(device, opts):
    scene = get_scene("book_cover")
    arrays = {k: getattr(scene, k) for k in ("centers", "radii", "albedo",
                                             "fuzz", "refract_idx",
                                             "mat_type")}
    cc = CameraController.book_one_final()
    cfg = RenderConfig(width=96, height=54, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(96, 54),
        cfg)).to(device)
    _, planes = _planes(96, 54, device)
    table = tfk.pack_scene(arrays, device=device)
    salts = (0, 0, 50, 4)
    before = tfk.LAUNCHES
    k = tfk.fused_render_persistent(table, 5, salts, cam, *planes, **opts)
    torch.cuda.synchronize()
    assert tfk.LAUNCHES == before + 1
    p = tfk.fused_render_persistent_reference(table, 5, salts, cam, *planes,
                                              **opts)
    # Built without FMA contraction, the kernel is bit-identical.
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(k[3][0]) == int(p[3][0])


def test_render_on_cuda_launches_kernel(device):
    before = tfk.LAUNCHES
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=4,
                       samples_per_frame=2, max_bounces=12, engine="fused")
    res = render(get_scene("book_cover"), CameraController.book_one_final(),
                 cfg, device=device)
    assert tfk.LAUNCHES == before + 2
    assert res.accumulated_dev.device.type == "cuda"
    assert np.isfinite(res.accumulated).all() and res.image.mean() > 0.05


def test_wrapper_rejects_cpu_cuda_mix(device):
    scene = get_scene("book_cover")
    table = tfk.pack_scene({k: getattr(scene, k) for k in (
        "centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")})
    _, planes = _planes(16, 16, device)
    cam = torch.zeros(24, device=device)
    with pytest.raises(ValueError, match="one device"):
        tfk.fused_render_persistent(table, 5, (0, 0, 4, 1), cam, *planes)


@pytest.mark.parametrize("clusters", [16, 2, 0],
                         ids=["culled16", "culled2", "unculled"])
def test_baked_kernel_matches_plain(device, clusters):
    """Radiance words, rays and both cull counters bit-identical."""
    scene = get_scene("book_one_final")
    arrays = {k: getattr(scene, k) for k in ("centers", "radii", "albedo",
                                             "fuzz", "refract_idx",
                                             "mat_type")}
    cc = CameraController.book_one_final()
    eye = tfused._concrete_eye(cc.view_matrix())
    baked = (bake.bake_culled(arrays, clusters, camera_hint=eye,
                              device=device) if clusters
             else bake.bake_unculled(arrays, device=device))
    cfg = RenderConfig(width=64, height=36, engine="fused")
    cam = torch.from_numpy(tfused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(64, 36),
        cfg)).to(device)
    _, planes = _planes(64, 36, device)
    salts = (0, 0, 50, 2)
    key = "culled" if clusters else "unculled"
    before = tbk.LAUNCHES[key]
    k = tbk.fused_render_baked(baked, salts, cam, *planes)
    torch.cuda.synchronize()
    assert tbk.LAUNCHES[key] == before + 1
    p = tbk.fused_render_baked_reference(baked, salts, cam, *planes)
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert k[3].tolist() == p[3].tolist()
    if clusters:
        assert int(k[3][3]) > 0
    assert clusters != 2 or int(k[3][2]) > 0
