"""The port's bench (``wavefront_path_tracer_tpu_torch/bench.py``) on the
CPU: its rows and scene plumbing against the root ``bench.py`` (the JAX
package's), its pair count against one made by hand from the counters and
the tables, its JSON line, and its failures, which exit 1 and never carry
a stored number as ``value``."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench as jbench  # noqa: E402

from wavefront_path_tracer_tpu_torch import bench  # noqa: E402
from wavefront_path_tracer_tpu_torch.models import fused  # noqa: E402
from wavefront_path_tracer_tpu_torch.renderer import (  # noqa: E402
    prepare_scene,
)
from wavefront_path_tracer_tpu_torch.utils.config import (  # noqa: E402
    RenderConfig,
)

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--width", "16", "--height", "8", "--spp", "1",
        "--max-bounces", "2"]


def _line(argv):
    """(exit code, the JSON line) of ``bench.main(argv)``."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.getvalue()
    return rc, json.loads(lines[0])


def test_rows_and_knot_names_match_reference():
    assert bench.MESH_ROWS == jbench.MESH_ROWS
    for name in ("mesh_knot", "mesh_knot50k", "mesh_knot1k",
                 "mesh_knot120k"):
        assert bench.knot_tris(name) == jbench.knot_tris(name)
    for bad in ("mesh_knot500", "mesh_knotk", "mesh_knot5k0",
                "mesh_knot_5k", "knot50k"):
        with pytest.raises(ValueError):
            jbench.knot_tris(bad)
        with pytest.raises(ValueError, match="bad knot scene name"):
            bench.knot_tris(bad)
    defaults = bench.build_parser().parse_args([])
    ref = jbench.build_parser().parse_args([])
    for key in ("scene", "width", "height", "spp", "engine", "intersector",
                "max_bounces", "clusters", "block_tiles", "lane_split",
                "rotate_cols", "rr", "winner_hint", "all", "no_mesh_row",
                "attempts", "timeout"):
        assert getattr(defaults, key) == getattr(ref, key), key


@pytest.mark.parametrize("scene", ["book_cover", "mesh_knot1k"])
def test_bench_once_rays_match_reference(scene):
    """The same scene, camera and configuration as the reference bench:
    rays within the parity rule's 1% on the megakernel (the knot's view
    too, which must frame the knot: more than 1.5 rays a pixel)."""
    port = bench.bench_once(scene, 64, 32, 1, "megakernel", "bruteforce",
                            max_bounces=4, device="cpu")
    ref = jbench.bench_once(scene, 64, 32, 1, "megakernel", "bruteforce",
                            max_bounces=4)
    assert port["scene"] == scene and port["config"] == ref["config"]
    assert abs(port["rays"] - ref["rays"]) <= 0.01 * ref["rays"]
    assert port["rays"] / (64 * 32) > 1.5
    assert port["mrays_per_s"] > 0 and len(port["run_seconds"]) == 3
    assert port["counters"] == {"rays": port["rays"]}
    assert port["device_seconds"] is None and port["forms"] == {}
    assert port["device_utilization"] is None


def test_pair_count_by_hand():
    """fused/baked/cull16 through the plain versions: every ray tests the
    bake's globals, and each cluster entry its cluster's spheres, counted
    here from the bake's ranges; the utilization is that count at the C6
    ceiling over the wall time."""
    r = bench.bench_once("book_one_final", 32, 16, 1, "fused", "baked",
                         max_bounces=4, clusters=16, device="cpu")
    c = r["counters"]
    assert set(c) == {"rays", "iterations", "supers_entered",
                      "clusters_entered"}
    assert c["rays"] > 32 * 16 and c["clusters_entered"] > 0
    assert r["lane_occupancy"] == c["rays"] / (32 * c["iterations"])
    assert r["forms"] == {}        # no kernel launches on the CPU

    cfg = RenderConfig(width=32, height=16, samples_per_pixel=1,
                       engine="fused", intersector="baked",
                       baked_clusters=16)
    scene, tris, cc = bench.build_scene("book_one_final")
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    baked = fused._baked_scene(arrays, 16, camera_pos=cc.view_matrix()[:3, 3])
    ranges = baked.cluster_ranges.numpy()
    n_globals = len(scene.radii) - int(ranges[:, 1].sum())
    assert n_globals == baked.n_globals
    by_hand = (c["rays"] * n_globals + c["clusters_entered"]
               * ranges[:, 1].sum() / len(ranges))
    assert r["pairs"]["triangle"] == 0.0
    np.testing.assert_allclose(r["pairs"]["sphere"], by_hand, rtol=1e-12)
    np.testing.assert_allclose(
        r["device_utilization"],
        by_hand / bench.PAIR_CEILING["sphere"] / r["seconds"], rtol=1e-12)
    np.testing.assert_allclose(r["pairs_per_s"], by_hand / r["seconds"],
                               rtol=1e-12)


def test_pair_count_dynamic_mesh_by_hand(monkeypatch):
    """fused/bruteforce/cull16 on a small terrain (the dynamic culled
    path): the real globals per ray at the sphere ceiling, each cluster
    entry's triangles at the triangle ceiling."""
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        mesh_terrain_scene,
    )

    scene, tris = mesh_terrain_scene(n_quads=4)
    monkeypatch.setattr(bench, "build_scene", lambda name: (
        scene, tris, CameraController.book_one_final()))
    r = bench.bench_once("mesh_terrain", 16, 8, 1, "fused", "bruteforce",
                         max_bounces=4, clusters=16, device="cpu")
    c = r["counters"]
    cfg = RenderConfig(width=16, height=8, engine="fused",
                       baked_clusters=16)
    arrays = prepare_scene(scene, cfg, "cpu", tris)
    tab = fused._dyn_tables(arrays, 16, camera_pos=np.asarray(
        CameraController.book_one_final().view_matrix())[:3, 3])
    assert tab.n_clusters == 0 and tab.n_tri_clusters > 0
    real_globals = int(torch.isfinite(tab.spheres[:tab.n_globals, 0]).sum())
    assert real_globals == len(scene.radii)
    tri = c["clusters_entered"] * len(tris.v0) / tab.n_tri_clusters
    assert r["pairs"] == {"sphere": c["rays"] * real_globals,
                          "triangle": tri}
    np.testing.assert_allclose(
        r["device_utilization"],
        (c["rays"] * real_globals / bench.PAIR_CEILING["sphere"]
         + tri / bench.PAIR_CEILING["triangle"]) / r["seconds"], rtol=1e-12)


def test_json_line_keys(monkeypatch):
    monkeypatch.setattr(bench, "MESH_ROWS", [
        ("knot1k_dynamic", "mesh_knot1k", 16, 8, 1, "bruteforce")])
    rc, line = _line(["--worker", *TINY])
    assert rc == 0
    for key in ("metric", "value", "unit", "vs_baseline", "pairs_per_s",
                "device_utilization", "utilization_note", "mesh", "seconds",
                "run_seconds", "counters", "lane_occupancy", "card",
                "device"):
        assert key in line, key
    assert "fused/baked/cull16, book_one_final" in line["metric"]
    # value is rounded to 0.01 Mrays/s, which a 16x8 frame on a loaded
    # host may not reach: the rays say that the headline ran.
    assert line["value"] >= 0 and line["unit"] == "Mrays/s"
    assert line["counters"]["rays"] > 16 * 8
    assert "C6 562.55" in line["utilization_note"]
    assert "T1 334.07" in line["utilization_note"]
    assert line["card"] == "cpu" and line["device"]["type"] == "cpu"
    row = line["mesh"]["knot1k_dynamic"]
    assert row["config"] == "16x8@1spp/fused/bruteforce/cull16, mesh_knot1k"
    for key in ("value", "unit", "counters", "device_utilization"):
        assert key in row, key
    assert row["counters"]["clusters_entered"] > 0


def test_failing_worker_reports_no_value(tmp_path, monkeypatch):
    """Every attempt of a worker that raises fails; the line has no value,
    the last good record only under ``last_good``, and the bench exits
    1.  Nothing is recorded from a failed or a CPU run."""
    record = {"metric": "stored", "value": 1234.5, "card": "a card",
              "recorded_at": "2026-01-01 00:00:00 UTC"}
    path = tmp_path / "last_good.json"
    path.write_text(json.dumps(record))
    monkeypatch.setattr(bench, "LAST_GOOD_PATH", str(path))
    monkeypatch.setattr(bench, "RETRY_DELAY_S", 0.0)
    rc, line = _line(["--scene", "no_such_scene", "--attempts", "2",
                      "--no-mesh-row", *TINY])
    assert rc == 1
    assert line["value"] is None and line["failed_attempts"] == 2
    assert "2 bench attempts failed" in line["error"]
    assert line["last_good"] == record
    assert json.loads(path.read_text()) == record
    assert not bench._is_headline(bench.build_parser().parse_args(
        ["--device", "cpu"]))
    assert bench._is_headline(bench.build_parser().parse_args([]))


def test_worker_of_an_ended_orchestrator_exits():
    """A worker that names an orchestrator other than its parent (the
    orchestrator ended before the worker asked to die with it) renders
    nothing and exits nonzero."""
    import subprocess

    env = dict(os.environ, **{bench.ORCHESTRATOR_ENV: "0"})
    proc = subprocess.run(
        [sys.executable, "-m", "wavefront_path_tracer_tpu_torch.bench",
         "--worker", *TINY], env=env, capture_output=True, text=True,
        timeout=120, cwd=bench.ROOT)
    assert proc.returncode != 0
    assert "its orchestrator has ended" in proc.stderr
    assert not proc.stdout.strip()


def test_failing_mesh_row_exits_1(monkeypatch):
    monkeypatch.setattr(bench, "MESH_ROWS", [
        ("bad_row", "mesh_knotk", 16, 8, 1, "bruteforce")])
    rc, line = _line(["--worker", *TINY])
    assert rc == 1
    assert line["value"] is not None and line["counters"]["rays"] > 16 * 8
    assert "bad knot scene name" in line["mesh"]["bad_row"]["error"]


def test_mesh_flag_refused():
    """Once refused by name: now a mesh larger than the devices present is
    refused, naming their count (one, under --device cpu), and so is a
    malformed one; there is no fallback."""
    with pytest.raises(SystemExit, match="4 devices was asked for, and 1 "
                                         r"is present \(cpu\)"):
        bench.main(["--mesh", "2x2", *TINY])
    with pytest.raises(SystemExit, match="TILESxSAMPLES"):
        bench.main(["--mesh", "2by2", *TINY])
