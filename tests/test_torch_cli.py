"""The port's command line on the CPU."""

import pytest
import torch

from wavefront_path_tracer_tpu import cli as jcli
from wavefront_path_tracer_tpu.utils.image import read_png
from wavefront_path_tracer_tpu_torch import cli
from wavefront_path_tracer_tpu_torch.scene import get_scene

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
])
def test_auto_resolves_as_reference(scene, clusters):
    kwargs = {"n": 2500, "seed": 1} if scene == "procedural" else {}
    s = get_scene(scene, **kwargs)
    for intersector in ("auto", "baked", "bruteforce"):
        port = cli.resolve_intersector(intersector, clusters, s)
        ref = jcli.resolve_intersector("fused", intersector, clusters, s,
                                       None)
        assert port[:2] == ref[:2]
        assert port[2] == ref[2]
    args = cli.build_parser().parse_args(["--clusters", "auto"])
    assert args.clusters == -1


@pytest.mark.parametrize("argv", [
    ["--intersector", "baked", "--scene", "mesh_demo"],
    ["--intersector", "auto", "--winner-hint"],
    ["--intersector", "bvh"],
    ["--clusters", "16"],
    ["--recluster", "2"],
    ["--winner-hint"],
    ["--obj", "x.obj"],
    ["--scene-file", "s.json"],
    ["--tex-lut", "512"],
    ["--serve", "0"],
    ["--interactive"],
    ["--aov", "out"],
    ["--scene", "mesh_demo"],
    ["--scene", "book_checker"],
], ids=lambda a: "_".join(a).strip("-"))
def test_cli_refusals(argv, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--device", "cpu", "--out", str(tmp_path / "r.png"),
                  *argv])


def test_default_camera_is_reference_camera():
    cc = cli.build_camera(cli.build_parser().parse_args([]))
    assert cc.vfov_deg == 20.0 and cc.defocus_angle_deg == 0.6
    assert cc.focus_distance == 10.0
