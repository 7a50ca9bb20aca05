"""The knot's stage table, the turntable and its GIF writer, and the
cross-run spread of ``probes/`` and ``examples/`` on the CPU, against
the reference's scripts, the JAX megakernel and Pillow's GIF reader
(present in this test environment only: the port does not use it)."""

import contextlib
import io
import math

import numpy as np
import pytest
import torch
from PIL import Image

from wavefront_path_tracer_tpu.renderer import render as jax_render
from wavefront_path_tracer_tpu.scene import camera as jcamera
from wavefront_path_tracer_tpu_torch.examples import turntable
from wavefront_path_tracer_tpu_torch.probes import knotprobe, variance10
from wavefront_path_tracer_tpu_torch.renderer import render as torch_render
from wavefront_path_tracer_tpu_torch.scene import get_scene, knot_scene
from wavefront_path_tracer_tpu_torch.utils import image as timage
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.parity import check_parity

torch.set_num_threads(2)


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args)
    return result, out.getvalue()


def test_knotprobe_runs_on_a_small_knot():
    args = knotprobe.build_parser().parse_args(
        ["300", "16x8", "1", "--device", "cpu"])
    rec, text = _quiet(knotprobe.run, args)
    assert rec["tris"] == knot_scene(300)[1].num_triangles
    assert [r["stage"] for r in rec["rows"]] == [
        "generate (raygen)", "extend: primitive tests", "extend: cull conds",
        "extend: global sweep", "shade (BSDF)", "miss (sky accumulate)",
        "loop bookkeeping", "other (winner selects, unprobed)"]
    assert rec["base_seconds"] > 0
    assert all(r["share"] >= 0 for r in rec["rows"])
    assert text.startswith("base ") and "(300 tris, 16x8@1)" in text
    defaults = knotprobe.build_parser().parse_args([])
    assert (defaults.tris, defaults.size, defaults.spp) == (50000, "400x224",
                                                            4)
    assert knotprobe.REPS == 2


def _reference_orbit(args, k):
    """The camera of frame ``k`` as ``examples/turntable.py`` builds it,
    with the JAX package's controller."""
    cx, cy, cz = args.center
    th = 2.0 * math.pi * k / args.frames
    cc = jcamera.CameraController.book_one_final()
    cc.camera = cc.camera.look_at(
        [cx + args.radius * math.cos(th), cy + args.elevation,
         cz + args.radius * math.sin(th)], [cx, cy, cz])
    cc.vfov_deg = args.vfov
    cc.defocus_angle_deg = 0.0
    return cc


def test_turntable_orbit_matches_reference():
    args = turntable.build_parser().parse_args(
        ["--frames", "7", "--radius", "2.5", "--elevation", "0.7",
         "--center", "0.5", "0", "-1.5", "--vfov", "30"])
    for k in range(args.frames):
        port, ref = turntable.orbit_camera(args, k), _reference_orbit(args, k)
        np.testing.assert_array_equal(port.view_matrix(), ref.view_matrix())
        np.testing.assert_array_equal(port.inverse_projection(320, 180),
                                      ref.inverse_projection(320, 180))
        assert repr(port.gpu_camera()) == repr(ref.gpu_camera())
    d = turntable.build_parser().parse_args([])
    assert (d.scene, d.frames, d.width, d.height, d.spp, d.engine,
            d.intersector, d.clusters, d.out, d.ms_per_frame, d.device) == (
        "book_cover", 24, 320, 180, 64, "fused", "baked", 0,
        "turntable.gif", 80, "cuda")


def test_turntable_frame_matches_jax_megakernel():
    """Frame 2 of 5 through the port's default path (the fused engine
    over the unculled bake, 16 bounces) against the JAX megakernel on the
    same streams, by the parity rule."""
    args = turntable.build_parser().parse_args(["--frames", "5"])
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=4,
                       samples_per_frame=4, max_bounces=16, engine="fused",
                       intersector="baked", baked_clusters=0)
    scene = get_scene("book_cover")
    t = torch_render(scene, turntable.orbit_camera(args, 2), cfg,
                     device="cpu")
    j = jax_render(scene, _reference_orbit(args, 2),
                   cfg.replace(engine="megakernel", intersector="bruteforce"))
    check_parity(t.accumulated / 4, j.accumulated / 4, t.rays_traced,
                 j.rays_traced)


def test_turntable_gif_decodes(tmp_path):
    out = tmp_path / "orbit" / "t.gif"
    args = turntable.build_parser().parse_args(
        ["--frames", "3", "--width", "24", "--height", "12", "--spp", "2",
         "--ms-per-frame", "120", "--out", str(out), "--device", "cpu"])
    rec, text = _quiet(turntable.run, args)
    assert text.count("frame ") == 3 and "wrote " in text
    info = timage.read_gif_info(str(out))
    assert info == {"width": 24, "height": 12, "frames": 3,
                    "delays_ms": [120] * 3, "loop": 0}
    with Image.open(out) as im:
        assert im.n_frames == 3 and im.info["loop"] == 0
        for k, (palette, index) in enumerate(rec["quantised"]):
            im.seek(k)
            assert im.info["duration"] == 120
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          palette[index])
            # A frame of at most 256 colours keeps them exactly.
            if len(np.unique(rec["frames"][k].reshape(-1, 3), axis=0)) <= 256:
                np.testing.assert_array_equal(palette[index],
                                              rec["frames"][k])


@pytest.mark.parametrize("shape", [(128, 96), (7, 5)])
def test_gif_writer_round_trips_through_pillow(tmp_path, shape):
    """A noise frame (more than 4,096 codes, so the LZW table fills and
    clears), a flat one and a gradient, quantised and read back."""
    h, w = shape
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
              np.full((h, w, 3), 77, np.uint8),
              np.linspace(0.0, 1.0, h * w * 3, dtype=np.float32).reshape(
                  h, w, 3)]
    path = tmp_path / "x.gif"
    quantised = timage.write_gif(str(path), frames, ms_per_frame=40)
    assert timage.read_gif_info(str(path))["frames"] == 3
    with Image.open(path) as im:
        assert im.n_frames == 3
        for k, (palette, index) in enumerate(quantised):
            im.seek(k)
            assert len(palette) <= 256 and im.info["duration"] == 40
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          palette[index])
    # The flat frame is exact; the noise frame stays close.
    np.testing.assert_array_equal(quantised[1][0][quantised[1][1]],
                                  frames[1])
    err = np.abs(quantised[0][0][quantised[0][1]].astype(int)
                 - frames[0].astype(int))
    assert err.mean() < 24
    with pytest.raises(ValueError, match="not a GIF"):
        (tmp_path / "y.gif").write_bytes(b"GIF12x")
        timage.read_gif_info(str(tmp_path / "y.gif"))


def test_variance10_in_process_and_a_child():
    args = variance10.build_parser().parse_args(
        ["--runs", "3", "--procs", "1", "--width", "16", "--height", "8",
         "--spp", "1", "--device", "cpu"])
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rec, text = _quiet(variance10.run, args)
    assert len(rec["rates"]) == 3 and all(r > 0 for r in rec["rates"])
    assert "library load" in err.getvalue()
    assert rec["warm"]["min"] <= rec["warm"]["max"]
    first, warm = rec["processes"][0]
    assert first > 0 and warm > 0 and "cross-process warm" in text
    defaults = variance10.build_parser().parse_args([])
    assert (defaults.runs, defaults.procs, defaults.scene, defaults.width,
            defaults.height, defaults.spp) == (10, 3, "cornell_spheres",
                                               400, 224, 64)
