"""The port's fused kernel module against the JAX Pallas kernel (CPU).

The JAX side runs ``fused_render_persistent`` in interpret mode, as the
JAX package's fused engine does on the CPU; the port side runs the plain
PyTorch version, which is what its wrapper runs on CPU tensors.  Inputs
are made with numpy from a seed and handed to both.  Images are held to
the statistical rule of ``utils/parity.py`` (the JAX package's own rule,
on sample-averaged images) and rays agree within 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.ops import pallas_kernels as jpk
from wavefront_path_tracer_tpu.scene import CameraController
from wavefront_path_tracer_tpu.scene.scene import book_cover, book_one_final
from wavefront_path_tracer_tpu_torch.models import fused as tfused
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)

KEYS = ("centers", "radii", "albedo", "fuzz", "refract_idx", "mat_type")
WIDTH, HEIGHT = 40, 45          # 1800 pixels: 2 tiles of 1024, 248 padding
SPP, BOUNCES = 2, 8


def _arrays(scene):
    return {k: np.asarray(getattr(scene, k)) for k in KEYS}


def random_scene(seed=7, n=40):
    """Seeded spheres: diffuse, fuzzy metal and glass, with a
    negative-radius bubble inside one glass sphere, on a ground sphere."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([
        [[0.0, -1000.0, 0.0], [0.0, 0.6, 0.0], [0.0, 0.6, 0.0]],
        np.stack([rng.uniform(-3, 3, n - 3), rng.uniform(0.1, 1.5, n - 3),
                  rng.uniform(-3, 1, n - 3)], axis=-1)]).astype(np.float32)
    radii = np.concatenate([[1000.0, 0.6, -0.5],
                            rng.uniform(0.1, 0.45, n - 3)]).astype(np.float32)
    mat = np.concatenate([[0, 2, 2], rng.integers(0, 3, n - 3)]).astype(
        np.int32)
    albedo = rng.uniform(0.1, 0.95, (n, 3)).astype(np.float32)
    fuzz = np.where(mat == 1, rng.uniform(0.0, 0.5, n), 0.0).astype(
        np.float32)
    ior = np.where(mat == 2, 1.5, 1.0).astype(np.float32)
    return {"centers": centers, "radii": radii, "albedo": albedo,
            "fuzz": fuzz, "refract_idx": ior, "mat_type": mat}


def _camera(defocus: bool):
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 4.0], [0.0, 0.3, -1.0])
    cc.vfov_deg = 40.0
    cc.defocus_angle_deg = 2.0 if defocus else 0.0
    cc.focus_distance = 5.0
    return cc


def _inputs(arrays, defocus, split=1):
    """numpy planes, camera and salts, shared by both sides."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, engine="fused")
    cc = _camera(defocus)
    cam = tfused.camera_params(cc.gpu_camera(), cc.view_matrix(),
                               cc.inverse_projection(WIDTH, HEIGHT), cfg)
    perm, _ = tfused._block_perm(WIDTH, HEIGHT, 32)
    pix = np.tile(perm.astype(np.int64), split)
    n_lanes = pix.shape[0]
    rows = -(-n_lanes // 1024) * 8
    pad = rows * 128 - n_lanes

    def plane(x, dtype):
        return np.concatenate([x, np.zeros(pad, x.dtype)]).astype(
            dtype).reshape(rows, 128)

    per_lane = SPP // split
    soff = np.repeat(np.arange(split) * per_lane, perm.shape[0])
    planes = (plane(pix, np.uint32), plane(pix % WIDTH, np.float32),
              plane(pix // WIDTH, np.float32),
              plane(np.ones(n_lanes), np.float32), plane(soff, np.uint32))
    salts = (3, 5, BOUNCES, per_lane)
    return cam, planes, salts


def _run_both(arrays, defocus, split=1, **kw):
    cam, planes, salts = _inputs(arrays, defocus, split)
    n = arrays["centers"].shape[0]
    j = jpk.fused_render_persistent(
        jpk.pack_scene({k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.int32(n), jnp.asarray(salts, jnp.uint32), jnp.asarray(cam),
        *(jnp.asarray(p) for p in planes), rows=8, interpret=True, **kw)
    t = tfk.fused_render_persistent(
        tfk.pack_scene(arrays), n, salts, torch.from_numpy(cam),
        *(torch.from_numpy(p.view(np.int32) if p.dtype == np.uint32 else p)
          for p in planes), **kw)
    valid = planes[3].reshape(-1) > 0
    j_rad = np.stack([np.asarray(x).reshape(-1) for x in j[:3]], -1)[valid]
    t_rad = np.stack([x.numpy().reshape(-1) for x in t[:3]], -1)[valid]
    j_rays = float(np.asarray(j[3])[:, 0].sum())
    t_rays = float(t[3][0])
    return t_rad / SPP * split, j_rad / SPP * split, t_rays, j_rays


SCENES = {"book_cover": lambda: _arrays(book_cover()),
          "random40": random_scene}

# Each option takes both of its values across the cases.
OPTIONS = [
    dict(rr_start=0, clamp=0.0, sampler="random", defocus=True),
    dict(rr_start=3, clamp=0.5, sampler="stratified", defocus=False),
    dict(rr_start=0, clamp=0.5, sampler="stratified", defocus=True),
    dict(rr_start=3, clamp=0.0, sampler="random", defocus=False),
]


@pytest.mark.parametrize("opts", OPTIONS,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_reference_matches_jax_kernel(scene, opts):
    opts = dict(opts)
    defocus = opts.pop("defocus")
    t_rad, j_rad, t_rays, j_rays = _run_both(SCENES[scene](), defocus,
                                             **opts)
    check_parity(t_rad, j_rad, t_rays, j_rays)
    assert t_rays > 0


def test_reference_matches_jax_kernel_lane_split():
    """soff != 0: each pixel's samples are split over two lanes."""
    t_rad, j_rad, t_rays, j_rays = _run_both(random_scene(), True, split=2)
    check_parity(t_rad, j_rad, t_rays, j_rays)


@pytest.mark.parametrize("scene", ["book_cover", "book_one_final",
                                   "random40"])
def test_pack_scene_byte_identical(scene):
    arrays = {"book_cover": lambda: _arrays(book_cover()),
              "book_one_final": lambda: _arrays(book_one_final(seed=42)),
              "random40": random_scene}[scene]()
    want = np.asarray(jpk.pack_scene(
        {k: jnp.asarray(v) for k, v in arrays.items()}))
    got = tfk.pack_scene(arrays).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.isnan(got[arrays["radii"].shape[0]:]).all()


def test_nan_padding_row_never_wins():
    """A table whose only rows are NaN padding gives misses everywhere."""
    table = torch.full((8, 16), float("nan"))
    o = torch.zeros(4)
    d = torch.tensor([0.0, 0.0, 1.0, 1.0])
    best_t = tfk.intersect_tile(table, 8, o, o, o, 1.0 - d, o, d)[0]
    assert (best_t == tfk.T_FAR).all()


def test_first_index_wins_ties():
    arrays = random_scene()
    dup = {k: np.concatenate([v[1:2], v[1:2]]) for k, v in arrays.items()}
    dup["albedo"][1] = [0.0, 0.0, 0.0]
    table = tfk.pack_scene(dup)
    one = torch.ones(1)
    res = tfk.intersect_tile(table, 2, 0.0 * one, 0.6 * one, 5.0 * one,
                             0.0 * one, 0.0 * one, -one)
    assert res[0].item() < tfk.T_FAR
    assert res[5].item() == pytest.approx(float(arrays["albedo"][1][0]))


def test_wrapper_rejects_bad_planes():
    arrays = random_scene()
    cam, planes, salts = _inputs(arrays, False)
    tplanes = [torch.from_numpy(p.astype(np.float32)) for p in planes]
    with pytest.raises(ValueError, match="pix"):
        tfk.fused_render_persistent(tfk.pack_scene(arrays), 40, salts,
                                    torch.from_numpy(cam), *tplanes)
