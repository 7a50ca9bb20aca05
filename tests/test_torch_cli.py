"""The port's command line on the CPU."""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wavefront_path_tracer_tpu import cli as jcli
from wavefront_path_tracer_tpu.utils.image import read_png
from wavefront_path_tracer_tpu_torch import cli
from wavefront_path_tracer_tpu_torch.scene import (
    get_scene,
    mesh_demo_scene,
    mesh_terrain_scene,
    torus_knot,
)

torch.set_num_threads(2)


def test_cli_writes_png(tmp_path):
    out = tmp_path / "r.png"
    assert cli.main(["--device", "cpu", "--scene", "book_cover",
                     "--width", "16", "--height", "9", "--spp", "1",
                     "--max-bounces", "8", "--out", str(out),
                     "--quiet"]) == 0
    img = read_png(str(out))
    assert img.shape == (9, 16, 3)
    assert img.mean() > 10


def test_cli_baked_culled_writes_png(tmp_path):
    out = tmp_path / "b.png"
    renderer, result = cli.run(
        ["--device", "cpu", "--scene", "book_one_final", "--width", "16",
         "--height", "9", "--spp", "1", "--max-bounces", "8",
         "--intersector", "baked", "--clusters", "16", "--out", str(out),
         "--quiet"])
    assert renderer.config.intersector == "baked"
    assert renderer.config.baked_clusters == 16
    img = read_png(str(out))
    assert img.shape == (9, 16, 3) and img.mean() > 10


@pytest.mark.parametrize("scene,clusters", [
    ("book_one_final", 0),
    ("procedural", 0),
    ("book_cover", 8),
    ("book_cover", -1),
    ("mesh_demo", 0),
    ("mesh_terrain", 0),
    ("mesh_terrain", 16),
])
def test_auto_resolves_as_reference(scene, clusters):
    tris = None
    if scene == "mesh_demo":
        s, tris = mesh_demo_scene()
    elif scene == "mesh_terrain":
        s, tris = mesh_terrain_scene()       # 5,003 primitives
    else:
        kwargs = {"n": 2500, "seed": 1} if scene == "procedural" else {}
        s = get_scene(scene, **kwargs)
    for intersector in ("auto", "baked", "bruteforce"):
        port = cli.resolve_intersector(intersector, clusters, s, tris)
        ref = jcli.resolve_intersector("fused", intersector, clusters, s,
                                       tris)
        assert port[:2] == ref[:2]
        assert port[2] == ref[2]
    args = cli.build_parser().parse_args(["--clusters", "auto"])
    assert args.clusters == -1


@pytest.mark.parametrize("argv", [
    ["--intersector", "baked", "--scene", "mesh_demo"],
    ["--clusters", "16"],
    ["--obj", "x.obj"],
    ["--scene", "mesh_demo"],
], ids=lambda a: "_".join(a).strip("-"))
def test_cli_mesh_and_culled_paths_write_png(argv, tmp_path):
    """What the port once refused: the dynamic culled path (brute force
    with clusters), the mesh scenes and an OBJ file (a knot the test
    writes with the port's torus_knot)."""
    if argv[0] == "--obj":
        obj = tmp_path / "x.obj"
        verts, faces = torus_knot(200)
        obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in verts)
                       + "".join(f"f {a + 1} {b + 1} {c + 1}\n"
                                 for a, b, c in faces))
        argv = ["--obj", str(obj), "--look-from", "0", "1.5", "4",
                "--look-at", "0", "0", "0", "--vfov", "40"]
    out = tmp_path / "r.png"
    renderer, _ = cli.run(["--device", "cpu", "--width", "16", "--height",
                           "9", "--spp", "1", "--max-bounces", "8",
                           "--out", str(out), "--quiet", *argv])
    img = read_png(str(out))
    assert img.shape == (9, 16, 3) and img.mean() > 10
    if "--clusters" in argv:
        assert renderer.config.intersector == "bruteforce"
    else:
        assert "tri_v0" in renderer.scene_arrays


@pytest.mark.parametrize("argv", [
    ["--recluster", "2", "--intersector", "baked", "--clusters", "16"],
    ["--recluster", "1", "--intersector", "baked", "--clusters", "0"],
    ["--recluster", "2", "--intersector", "bruteforce", "--clusters", "16"],
    ["--recluster", "2", "--scene", "mesh_demo", "--intersector", "baked",
     "--clusters", "16"],
    ["--recluster", "2", "--scene", "book_checker", "--intersector",
     "baked", "--clusters", "16"],
], ids=["recluster_2", "recluster_1_unculled", "recluster_2_dynamic",
        "recluster_2_mesh", "recluster_2_textured"])
def test_cli_recluster_writes_png(argv, tmp_path):
    """What the port once refused: ``--recluster K`` on each culling
    intersector, on meshes and on textured scenes."""
    out = tmp_path / "r.png"
    renderer, result = cli.run(["--device", "cpu", "--width", "16",
                                "--height", "9", "--spp", "1",
                                "--max-bounces", "8", "--out", str(out),
                                "--quiet", *argv])
    img = read_png(str(out))
    assert img.shape == (9, 16, 3) and img.mean() > 10
    assert renderer.config.recluster == int(argv[1])
    assert result.rays_traced > 16 * 9


SCENE_JSON = str(Path(__file__).resolve().parents[1] / "examples"
                 / "scene.json")
# What still refuses: what the reference refuses itself: the BVH on the
# fused engine (its cli.py:275-279), textures on the plain brute-force
# kernel (no clusters) and the winner hint off the baked path (its
# models/fused.py:322-334), and the hint without clusters (its
# RenderConfig).  A case whose refusal is None was refused once and runs
# now.
_HINT = (NotImplementedError, "intersector='baked'")
_TEX = (NotImplementedError, "carries no texture")


@pytest.mark.parametrize("argv,refusal", [
    pytest.param(["--intersector", "auto", "--winner-hint", "--scene",
                  "procedural", "--spheres", "2500"], _HINT,
                 id="intersector_auto_--winner-hint"),
    # Ported: the BVH on the wavefront engine runs.
    pytest.param(["--intersector", "bvh", "--engine", "wavefront"], None,
                 id="intersector_bvh"),
    # The reference's own refusal (its cli.py:275-279).
    pytest.param(["--intersector", "bvh"],
                 (NotImplementedError, "fused has no bvh"),
                 id="intersector_bvh_engine_fused"),
    # The reference's own refusal: recluster needs a culling intersector.
    pytest.param(["--recluster", "2", "--intersector", "bruteforce"],
                 (NotImplementedError, "culling intersector"),
                 id="recluster_2_bruteforce_clusters_0"),
    pytest.param(["--recluster", "3", "--intersector", "baked"],
                 (ValueError, "recluster must be <= 2"),
                 id="recluster_3"),
    pytest.param(["--winner-hint"], (ValueError, "requires baked_clusters"),
                 id="winner-hint"),
    pytest.param(["--scene-file", SCENE_JSON], _TEX, id="scene-file_s.json"),
    pytest.param(["--tex-lut", "512", "--scene", "book_checker"], _TEX,
                 id="tex-lut_512"),
    # Ported: the live window, the interactive session and the AOVs.
    pytest.param(["--serve", "0"], None, id="serve_0"),
    pytest.param(["--interactive"], None, id="interactive"),
    pytest.param(["--aov", "out"], None, id="aov_out"),
    pytest.param(["--scene", "book_checker"], _TEX, id="scene_book_checker"),
])
def test_cli_refusals(argv, refusal, tmp_path, monkeypatch):
    out = tmp_path / "r.png"
    if refusal is None:
        # Once refused, now runs: the flag at 8x8@1 spp (the interactive
        # session with no input renders to its budget and ends).
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        renderer, result = cli.run(["--device", "cpu", "--out", str(out),
                                    "--width", "8", "--height", "8",
                                    "--spp", "1", "--quiet", *argv])
        assert read_png(str(out)).shape == (8, 8, 3)
        if "--intersector" in argv:
            assert renderer.config.intersector == "bvh"
            assert "bvh_min" in renderer.scene_arrays
        if "--aov" in argv:
            assert read_png(str(tmp_path / "out.depth.png")).shape == (
                8, 8, 3)
        if "--interactive" in argv:
            assert result is None
            assert renderer.progress.accumulated_samples == 1
            return
        assert result.rays_traced >= 64 and np.isfinite(result.image).all()
        return
    error, match = refusal
    with pytest.raises(error, match=match):
        cli.main(["--device", "cpu", "--out", str(out), *argv])


@pytest.mark.parametrize("argv", [
    ["--scene", "book_checker", "--intersector", "baked", "--clusters",
     "16"],
    ["--scene", "book_checker", "--intersector", "baked", "--clusters",
     "16", "--winner-hint"],
    ["--scene", "book_checker", "--intersector", "bruteforce", "--clusters",
     "16", "--tex-lut", "512"],
    ["--scene-file", SCENE_JSON, "--intersector", "auto"],
], ids=["book_checker", "winner_hint", "tex_lut", "scene_file"])
def test_cli_texture_paths_write_png(argv, tmp_path):
    """What the port once refused: book_checker on the baked and dynamic
    culled paths, the winner hint, a LUT budget and a scene file (whose
    camera block wins over the reference camera)."""
    out = tmp_path / "r.png"
    renderer, result = cli.run(["--device", "cpu", "--width", "16",
                                "--height", "9", "--spp", "1",
                                "--max-bounces", "8", "--out", str(out),
                                "--quiet", *argv])
    img = read_png(str(out))
    assert img.shape == (9, 16, 3) and img.mean() > 10
    assert "tex_kind" in renderer.scene_arrays
    cfg = renderer.config
    assert cfg.winner_hint == ("--winner-hint" in argv)
    assert cfg.tex_lut_max == (512 if "--tex-lut" in argv else 8192)
    if "--scene-file" in argv:
        assert (cfg.intersector, cfg.baked_clusters) == ("baked", -1)
        assert renderer.camera.vfov_deg == 32.0
        assert renderer.camera.defocus_angle_deg == 0.0


def test_scene_file_camera_layers_as_reference(tmp_path):
    """Flag > scene-file camera > reference camera, field by field, and a
    scene file takes no named scene's default view."""
    args = cli.build_parser().parse_args(
        ["--scene-file", SCENE_JSON, "--scene", "book_cover", "--vfov",
         "50"])
    _scene, _tris, file_cam = cli.build_scene(args)
    cc = cli.build_camera(args, file_cam)
    assert cc.vfov_deg == 50.0                  # the flag
    assert cc.defocus_angle_deg == 0.0          # the file
    assert cc.focus_distance == 10.0            # the reference default
    np.testing.assert_allclose(cc.camera.position, [0.0, 1.5, 6.0])


def test_default_camera_is_reference_camera():
    cc = cli.build_camera(cli.build_parser().parse_args([]))
    assert cc.vfov_deg == 20.0 and cc.defocus_angle_deg == 0.6
    assert cc.focus_distance == 10.0


# --- the app layer's flags, held to the JAX CLI --------------------------

APP = ["--scene", "book_cover", "--width", "16", "--height", "9",
       "--max-bounces", "4", "--quiet"]


@pytest.mark.parametrize("tonemap", ["gamma2", "reinhard", "aces"])
def test_cli_tonemap_matches_jax(tonemap, tmp_path):
    from wavefront_path_tracer_tpu.utils.image import (
        display_transform,
        to_u8,
    )

    out = tmp_path / "t.png"
    renderer, result = cli.run(["--device", "cpu", *APP, "--spp", "2",
                                "--tonemap", tonemap, "--out", str(out)])
    expect = to_u8(display_transform(result.accumulated, result.samples,
                                     tonemap))
    np.testing.assert_array_equal(read_png(str(out)), expect)


def test_cli_until_delta_stops_as_jax(tmp_path):
    """The same image-change threshold stops both CLIs after the same
    number of samples (the JAX CLI's count read from its checkpoint)."""
    argv = [*APP, "--engine", "megakernel", "--spp", "16", "--spf", "1",
            "--until-delta", "0.01"]
    _renderer, result = cli.run(["--device", "cpu", *argv,
                                 "--out", str(tmp_path / "p.png")])
    ck = tmp_path / "j.npz"
    assert jcli.main(argv + ["--checkpoint", str(ck), "--out",
                             str(tmp_path / "j.png")]) == 0
    assert 1 < result.samples < 16
    assert result.samples == int(np.load(ck)["samples"])


def test_cli_checkpoint_resume_bit_for_bit(tmp_path):
    """Two samples with a checkpoint, then a resume to four, gives the
    accumulator of one uninterrupted render of four, bit for bit; a
    checkpoint of another size is refused, and one whose budget is met
    renders nothing (exit 1)."""
    base = ["--device", "cpu", *APP, "--spf", "1"]
    one, two, whole = (str(tmp_path / f"{n}.npz")
                       for n in ("one", "two", "whole"))
    out = str(tmp_path / "o.png")
    cli.run(base + ["--spp", "2", "--checkpoint", one, "--out", out])
    renderer, result = cli.run(base + ["--spp", "4", "--resume", one,
                                       "--checkpoint", two, "--out", out])
    ref_renderer, ref = cli.run(base + ["--spp", "4", "--checkpoint", whole,
                                        "--out", out])
    assert result.samples == ref.samples == 4
    np.testing.assert_array_equal(result.accumulated.view(np.uint32),
                                  ref.accumulated.view(np.uint32))
    a, b = np.load(two), np.load(whole)
    np.testing.assert_array_equal(a["accumulated"].view(np.uint32),
                                  b["accumulated"].view(np.uint32))
    assert int(a["samples"]) == int(b["samples"]) == 4
    assert int(a["frame"]) == int(b["frame"])
    with pytest.raises(ValueError, match="refusing to blend"):
        cli.run(["--device", "cpu", *APP, "--width", "32", "--spp", "4",
                 "--resume", one, "--out", out])
    assert cli.main(base + ["--spp", "4", "--resume", whole,
                            "--out", out]) == 1


def test_cli_preview_rewritten_each_frame(tmp_path, monkeypatch, capsys):
    """--preview rewrites its PNG after every frame batch, beside an
    auto-refresh page; --preview-term draws each frame in the terminal."""
    from wavefront_path_tracer_tpu_torch.utils import image

    prev = str(tmp_path / "prev.png")
    writes = []
    real = image.write_png

    def spy(path, img):
        writes.append(path)
        real(path, img)

    monkeypatch.setattr(image, "write_png", spy)
    cli.run(["--device", "cpu", *APP, "--spp", "3", "--spf", "1",
             "--preview", prev, "--preview-term",
             "--out", str(tmp_path / "o.png")])
    assert writes.count(prev) == 3
    assert read_png(prev).shape == (9, 16, 3)
    assert (tmp_path / "prev.html").exists()
    assert capsys.readouterr().err.count("\x1b[H\x1b[2J") == 3


def test_cli_platform_maps_to_device(tmp_path):
    renderer, result = cli.run(["--platform", "cpu", "--device", "cuda",
                                *APP, "--spp", "1",
                                "--out", str(tmp_path / "o.png")])
    assert renderer.device.type == "cpu" and result.samples == 1
    for platform, device in (("gpu", "cuda"), ("cuda", "cuda"),
                             ("cpu", "cpu")):
        args = cli.build_parser().parse_args(["--platform", platform])
        cli.check_args(args)
        assert args.device == device
    with pytest.raises(ValueError, match="'tpu' is not a platform"):
        cli.main(["--platform", "tpu"])
