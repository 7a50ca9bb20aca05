"""The port's command line on the CPU."""

import pytest
import torch

from wavefront_path_tracer_tpu.utils.image import read_png
from wavefront_path_tracer_tpu_torch import cli

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


@pytest.mark.parametrize("argv", [
    ["--intersector", "baked"],
    ["--intersector", "auto"],
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
