"""The port's own copies of the JAX package's numpy-only host modules
(scenes, cameras, RenderConfig, image helpers) equal the originals."""

import dataclasses

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu.scene import camera as jcamera
from wavefront_path_tracer_tpu.scene import scene as jscene
from wavefront_path_tracer_tpu.utils import config as jconfig
from wavefront_path_tracer_tpu.utils import image as jimage
from wavefront_path_tracer_tpu_torch.renderer import Renderer
from wavefront_path_tracer_tpu_torch.scene import camera as tcamera
from wavefront_path_tracer_tpu_torch.scene import scene as tscene
from wavefront_path_tracer_tpu_torch.utils import config as tconfig
from wavefront_path_tracer_tpu_torch.utils import image as timage

SCENE_ARGS = {
    "book_cover": [{}],
    "book_bubble": [{}],
    "book_one_final": [{}, {"seed": 7}],
    "procedural": [{"n": 300, "seed": 3}, {"n": 64, "seed": 1,
                                           "extent": 9.0}],
    "cornell_spheres": [{}],
    "book_checker": [{}],
}


def test_same_scene_names():
    assert sorted(tscene._SCENES) == sorted(jscene._SCENES) == \
        sorted(SCENE_ARGS)
    assert tscene.SCENE_CAMERAS == jscene.SCENE_CAMERAS


@pytest.mark.parametrize("name", sorted(SCENE_ARGS))
def test_scene_tables_byte_identical(name):
    for kwargs in SCENE_ARGS[name]:
        port = tscene.get_scene(name, **kwargs)
        ref = jscene.get_scene(name, **kwargs)
        assert port._fields == ref._fields
        for field in ref._fields:
            a, b = getattr(port, field), getattr(ref, field)
            if b is None:
                assert a is None, field
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert a.tobytes() == b.tobytes(), field


VIEWS = {
    "reference": {},
    "cover": {"look_from": [-2.0, 2.0, 1.0], "look_at": [0.0, 0.0, -1.0],
              "vfov": 35.0, "defocus": 0.0},
    "cornell": {"look_from": [0.0, 2.5, 9.5], "look_at": [0.0, 1.7, 0.0],
                "vfov": 36.0, "defocus": 2.0},
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_camera_matrices_equal(view):
    v = VIEWS[view]
    out = []
    for mod in (tcamera, jcamera):
        cc = mod.CameraController.book_one_final()
        if v:
            cc.camera = cc.camera.look_at(v["look_from"], v["look_at"])
            cc.vfov_deg = v["vfov"]
            cc.defocus_angle_deg = v["defocus"]
        out.append((cc.view_matrix(), cc.camera.view_matrix(),
                    cc.inverse_projection(400, 225), cc.gpu_camera()))
    for a, b in zip(out[0][:3], out[1][:3]):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(out[0][3]) == dataclasses.asdict(out[1][3])


# The refusals of RenderConfig.__post_init__ (utils/config.py:150-200).
REFUSED = [
    {"rr_start_bounce": -1},
    {"drain_threshold": -1},
    {"rr_floor": 0.0},
    {"rr_floor": 1.5},
    {"tex_lut_max": 3},
    {"clamp": -0.1},
    {"stop_delta": -1.0},
    {"sampler": "sobol"},
    {"baked_clusters": -2},
    {"recluster": -1},
    {"recluster": 3},
    {"recluster": 1, "winner_hint": True, "baked_clusters": 4},
    {"winner_hint": True},
]
ACCEPTED = [
    {},
    {"rr_start_bounce": 3, "rr_floor": 1.0, "clamp": 0.5},
    {"sampler": "stratified", "baked_clusters": -1},
    {"recluster": 2, "baked_clusters": 16, "intersector": "baked"},
    {"winner_hint": True, "baked_clusters": 4},
]


@pytest.mark.parametrize("kwargs", REFUSED,
                         ids=lambda k: ",".join(f"{a}={b}"
                                                for a, b in k.items()))
def test_config_refuses_as_reference(kwargs):
    with pytest.raises(ValueError) as port:
        tconfig.RenderConfig(**kwargs)
    with pytest.raises(ValueError) as ref:
        jconfig.RenderConfig(**kwargs)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kwargs", ACCEPTED,
                         ids=lambda k: ",".join(f"{a}={b}"
                                                for a, b in k.items())
                         or "defaults")
def test_config_accepts_as_reference(kwargs):
    port = tconfig.RenderConfig(**kwargs)
    ref = jconfig.RenderConfig(**kwargs)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.num_pixels == ref.num_pixels
    assert dataclasses.asdict(port.replace(width=7)) == \
        dataclasses.asdict(ref.replace(width=7))


def test_image_helpers_equal(tmp_path):
    rng = np.random.default_rng(0)
    acc = rng.uniform(0.0, 3.0, (9, 16, 3)).astype(np.float32)
    other = rng.uniform(0.0, 1.0, (9, 16, 3)).astype(np.float32)
    disp = timage.display_transform(acc, 4)
    np.testing.assert_array_equal(disp, jimage.display_transform(acc, 4))
    assert timage.rmse(acc, other) == jimage.rmse(acc, other)
    timage.write_png(str(tmp_path / "t.png"), disp)
    jimage.write_png(str(tmp_path / "j.png"), disp)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(timage.read_png(str(tmp_path / "t.png")),
                                  jimage.read_png(str(tmp_path / "j.png")))


def test_renderer_defaults_to_cuda(monkeypatch):
    """No ``device`` means the card; on a machine without one that
    raises (there is no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.RenderConfig(width=8, height=8, samples_per_pixel=1,
                               engine="fused")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(tscene.book_cover(),
                 tcamera.CameraController.book_one_final(), cfg)
