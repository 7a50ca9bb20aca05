"""The port imports neither JAX nor the JAX package (nor the repository's
``examples/``), hides no device, and builds for sm_90a."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from wavefront_path_tracer_tpu_torch.ops import _build
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as tdk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.renderer import (
    Renderer,
    prepare_scene,
    render,
)
from wavefront_path_tracer_tpu_torch.scene import CameraController, book_cover
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = RenderConfig(width=8, height=8, samples_per_pixel=1, max_bounces=4,
                   engine="fused")


def test_port_never_imports_jax():
    script = textwrap.dedent("""
        import sys
        # Any import of jax or of the JAX package now fails.
        sys.modules["jax"] = None
        sys.modules["wavefront_path_tracer_tpu"] = None
        sys.modules["examples"] = None
        # Nor Pillow, which the card's Python does not have.
        sys.modules["PIL"] = None
        # Nor any module of exp/ (its scripts import each other by name).
        for name in ("exp", "micro_r2", "tripair", "hbm_bw", "pair_ceiling",
                     "bf16_issue", "micro_slope"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        import wavefront_path_tracer_tpu_torch.aov
        import wavefront_path_tracer_tpu_torch.app
        import wavefront_path_tracer_tpu_torch.bench
        import wavefront_path_tracer_tpu_torch.cli
        import wavefront_path_tracer_tpu_torch.convert
        import wavefront_path_tracer_tpu_torch.models.megakernel
        import wavefront_path_tracer_tpu_torch.models.wavefront
        import wavefront_path_tracer_tpu_torch.native.bvh_native
        import wavefront_path_tracer_tpu_torch.ops._build
        import wavefront_path_tracer_tpu_torch.ops.bake
        import wavefront_path_tracer_tpu_torch.ops.baked_kernels
        import wavefront_path_tracer_tpu_torch.ops.dyn_tables
        import wavefront_path_tracer_tpu_torch.ops.dynculled_kernels
        import wavefront_path_tracer_tpu_torch.ops.fused_kernels
        import wavefront_path_tracer_tpu_torch.ops.stage_probes
        import wavefront_path_tracer_tpu_torch.ops.bsdf
        import wavefront_path_tracer_tpu_torch.ops.bvh_traverse
        import wavefront_path_tracer_tpu_torch.ops.compact
        import wavefront_path_tracer_tpu_torch.ops.hit
        import wavefront_path_tracer_tpu_torch.ops.intersect
        import wavefront_path_tracer_tpu_torch.ops.texture
        import wavefront_path_tracer_tpu_torch.ops.triangle
        import wavefront_path_tracer_tpu_torch.parallel
        import wavefront_path_tracer_tpu_torch.parallel.dryrun
        import wavefront_path_tracer_tpu_torch.parallel.multihost
        import wavefront_path_tracer_tpu_torch.parallel.sharding
        import wavefront_path_tracer_tpu_torch.profile_frame
        import wavefront_path_tracer_tpu_torch.probes._slope
        import wavefront_path_tracer_tpu_torch.probes._stage
        import wavefront_path_tracer_tpu_torch.probes.dynprobe
        import wavefront_path_tracer_tpu_torch.probes.iterprobe
        import wavefront_path_tracer_tpu_torch.probes.bf16_issue
        import wavefront_path_tracer_tpu_torch.probes.hbm_bw
        import wavefront_path_tracer_tpu_torch.probes.matmul_r2
        import wavefront_path_tracer_tpu_torch.probes.micro_r2
        import wavefront_path_tracer_tpu_torch.probes.micro_slope
        import wavefront_path_tracer_tpu_torch.probes.pair_ceiling
        import wavefront_path_tracer_tpu_torch.probes.run_pairs
        import wavefront_path_tracer_tpu_torch.probes.tripair
        import wavefront_path_tracer_tpu_torch.probes.gate_sweep
        import wavefront_path_tracer_tpu_torch.probes.make_golden
        import wavefront_path_tracer_tpu_torch.probes.matsplit_ab
        import wavefront_path_tracer_tpu_torch.probes.clamp_bias
        import wavefront_path_tracer_tpu_torch.probes.variance10
        import wavefront_path_tracer_tpu_torch.probes.texlut
        import wavefront_path_tracer_tpu_torch.probes.bounce0
        import wavefront_path_tracer_tpu_torch.probes.knotprobe
        import wavefront_path_tracer_tpu_torch.examples.turntable
        import wavefront_path_tracer_tpu_torch.utils.child
        import wavefront_path_tracer_tpu_torch.utils.image
        import wavefront_path_tracer_tpu_torch.utils.parity
        import wavefront_path_tracer_tpu_torch.utils.preview
        import wavefront_path_tracer_tpu_torch.utils.preview_server
        import wavefront_path_tracer_tpu_torch.utils.profiling
        import wavefront_path_tracer_tpu_torch.scene.bvh
        import wavefront_path_tracer_tpu_torch.validate
        from wavefront_path_tracer_tpu_torch.renderer import (
            prepare_scene, render)
        from wavefront_path_tracer_tpu_torch.scene import (
            CameraController, book_cover, mesh_terrain_scene)
        from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
        cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                           max_bounces=4, engine="fused")
        cc = CameraController.book_one_final()
        for extra in ({}, {"intersector": "baked", "baked_clusters": 2}):
            res = render(book_cover(), cc, cfg.replace(**extra), device="cpu")
            assert res.image.shape == (8, 8, 3)
        scene, tris = mesh_terrain_scene(n_quads=3)
        for extra in ({"baked_clusters": 8},
                      {"intersector": "baked", "baked_clusters": 2}):
            res = render(scene, cc, cfg.replace(**extra), tris, device="cpu")
            assert res.image.shape == (8, 8, 3)
        res = render(scene, cc, cfg.replace(engine="megakernel"), tris,
                     device="cpu")
        assert res.image.shape == (8, 8, 3)
        for extra in ({"engine": "wavefront"},
                      {"engine": "wavefront", "intersector": "bvh"},
                      {"engine": "megakernel", "intersector": "bvh"}):
            res = render(scene, cc, cfg.replace(**extra), tris, device="cpu")
            assert res.image.shape == (8, 8, 3)
            res = render(book_cover(), cc, cfg.replace(**extra),
                         device="cpu")
            assert res.image.shape == (8, 8, 3)
        from wavefront_path_tracer_tpu_torch.parallel.sharding import (
            make_mesh, render_sharded)
        img, spp = render_sharded(book_cover(), cc, cfg,
                                  make_mesh(4, devices=["cpu"] * 4))
        assert img.shape == (8, 8, 3) and spp == 1
        from wavefront_path_tracer_tpu_torch.aov import render_aovs
        from wavefront_path_tracer_tpu_torch.app import InteractiveSession
        aovs = render_aovs(scene, cc, cfg.replace(engine="megakernel"), tris,
                           spp=1, device="cpu")
        assert aovs["depth"].shape == (8, 8)
        session = InteractiveSession(book_cover(), cc, cfg, device="cpu")
        assert session.step().samples == 1
        from wavefront_path_tracer_tpu_torch.probes import (
            bf16_issue, hbm_bw, matmul_r2, micro_r2, micro_slope,
            pair_ceiling, tripair)
        import contextlib, io
        for probe in (bf16_issue, hbm_bw, matmul_r2, micro_r2, micro_slope,
                      pair_ceiling, tripair):
            with contextlib.redirect_stdout(io.StringIO()):
                assert probe.main(["--device", "cpu"]) == 0
        from wavefront_path_tracer_tpu_torch.probes import dynprobe, iterprobe
        for probe, variant in ((iterprobe, "dbl_cond"),
                               (dynprobe, "dyn_dbl_cond")):
            with contextlib.redirect_stdout(io.StringIO()):
                assert probe.main(["--device", "cpu", "--width", "8",
                                   "--height", "8", "--spp", "1",
                                   "--reps", "1", "--variants",
                                   "full," + variant]) == 0
        from wavefront_path_tracer_tpu_torch.models.fused import stage_timing
        cfg_s = cfg.replace(intersector="baked", baked_clusters=16)
        base, rows = stage_timing(
            prepare_scene(book_cover(), cfg_s, "cpu"), cc.gpu_camera(),
            cc.view_matrix(), cc.inverse_projection(8, 8), cfg_s,
            n_samples=1, reps=1)
        assert base > 0 and len(rows) == 7
        from wavefront_path_tracer_tpu_torch.utils.image import (
            encode_gif, read_gif_info)
        import numpy as np
        data, _q = encode_gif([np.zeros((4, 4, 3), np.uint8)] * 2)
        assert data.startswith(b"GIF89a") and data.endswith(b";")
        for name in ("jax", "wavefront_path_tracer_tpu", "examples", "PIL",
                     "micro_r2", "tripair", "hbm_bw", "pair_ceiling",
                     "bf16_issue", "micro_slope"):
            assert sys.modules[name] is None
            assert not [m for m in sys.modules if m.startswith(name + ".")]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# An import of the JAX package (the port's own ``_torch`` name excepted).
_JAX_PACKAGE_IMPORT = re.compile(
    r"import wavefront_path_tracer_tpu(?!_torch)"
    r"|from wavefront_path_tracer_tpu(?!_torch)[. ]")


def test_no_file_imports_the_jax_package():
    files = sorted((ROOT / "wavefront_path_tracer_tpu_torch").rglob("*"))
    files = [f for f in files if f.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for name in ("micro_r2", "run_pairs", "micro_slope", "bf16_issue",
                 "matmul_r2"):
        assert ROOT / f"wavefront_path_tracer_tpu_torch/probes/{name}.py" in files
    offenders = [f"{f.relative_to(ROOT)}:{n}"
                 for f in files
                 for n, line in enumerate(f.read_text().splitlines(), 1)
                 if _JAX_PACKAGE_IMPORT.search(line)
                 or re.search(r"^\s*(import|from) (jax|examples|exp|PIL)\b",
                              line)
                 or re.search(r"^\s*import (micro_r2|tripair|hbm_bw|"
                              r"pair_ceiling|bf16_issue|micro_slope)\b",
                              line)
                 or re.search(r"sys\.path.*exp", line)]
    assert not offenders, offenders


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(book_cover(), CameraController.book_one_final(), CFG,
                 device="cuda")


def test_no_launches_on_cpu():
    before = tfk.LAUNCHES
    render(book_cover(), CameraController.book_one_final(), CFG, device="cpu")
    render(book_cover(), CameraController.book_one_final(),
           CFG.replace(intersector="baked", baked_clusters=2), device="cpu")
    render(book_cover(), CameraController.book_one_final(),
           CFG.replace(baked_clusters=8), device="cpu")
    render(book_cover(), CameraController.book_one_final(),
           CFG.replace(baked_clusters=8, recluster=2), device="cpu")
    render(book_cover(), CameraController.book_one_final(),
           CFG.replace(intersector="baked", recluster=1), device="cpu")
    from wavefront_path_tracer_tpu_torch.models.fused import stage_timing
    cc = CameraController.book_one_final()
    for extra in ({"intersector": "baked", "baked_clusters": 16},
                  {"baked_clusters": 16}):
        cfg = CFG.replace(**extra)
        stage_timing(prepare_scene(book_cover(), cfg, "cpu"),
                     cc.gpu_camera(), cc.view_matrix(),
                     cc.inverse_projection(8, 8), cfg, n_samples=1, reps=1)
    assert tfk.LAUNCHES == before == 0
    assert tbk.LAUNCHES == {"culled": 0, "unculled": 0, "segment_culled": 0,
                            "segment_unculled": 0}
    assert tdk.LAUNCHES == tdk.SEGMENT_LAUNCHES == 0
    assert not any(n for counts in tbk.PROBE_LAUNCHES.values()
                   for n in counts.values())
    assert not any(tdk.PROBE_LAUNCHES.values())


def test_build_flags(monkeypatch):
    cmd = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in flag or "fast-math" in flag for flag in cmd)
    assert "-fmad=false" in cmd      # bit-identical to the plain version
    assert [p.name for p in _build.sources()] == [
        "baked.cu", "dynculled.cu", "persistent.cu", "probe_designs.cu",
        "probe_issue.cu", "probe_mma.cu", "probe_pairs.cu",
        "probe_stream.cu", "probe_tripair.cu"]
    # The stage probes' kernels are a library of their own, built only
    # where a probe is launched.
    assert [p.name for p in _build.sources(_build.PROBE_LIB_NAME)] == [
        "baked_probe.cu", "baked_probe2.cu", "baked_probe_seg.cu",
        "baked_probe_seg2.cu", "baked_probe_unculled.cu",
        "dynculled_probe.cu", "dynculled_probe_seg.cu",
        "dynculled_probe_seg_tris.cu", "dynculled_probe_tris.cu"]
    assert _build._digest(_build.LIB_NAME) != _build._digest(
        _build.PROBE_LIB_NAME)
    with pytest.raises(ValueError, match="unknown library"):
        _build.sources("libother.so")
    assert [p.name for p in _build.headers()] == [
        "baked.cuh", "common.cuh", "dynculled.cuh", "fastmath.cuh",
        "probe_math.cuh"]
    for name, fn in (("persistent.cu", "wpt_persistent_launch"),
                     ("baked.cu", "wpt_baked_launch"),
                     ("baked.cu", "wpt_baked_segment_launch"),
                     ("dynculled.cu", "wpt_dynculled_launch"),
                     ("dynculled.cu", "wpt_dynculled_segment_launch"),
                     ("probe_pairs.cu", "wpt_probe_pair_launch"),
                     ("probe_pairs.cu", "wpt_probe_gated_launch"),
                     ("probe_tripair.cu", "wpt_probe_tripair_launch"),
                     ("probe_stream.cu", "wpt_probe_stream_launch"),
                     ("probe_designs.cu", "wpt_probe_design_launch"),
                     ("probe_designs.cu", "wpt_probe_sin_mismatches"),
                     ("probe_issue.cu", "wpt_probe_issue_launch"),
                     ("probe_mma.cu", "wpt_probe_mma_copies"),
                     ("probe_mma.cu", "wpt_probe_mma_launch")):
        src = (_build.CSRC / name).read_text()
        assert f'extern "C" int {fn}' in src
        # The probes stand alone; the render kernels share the bounce step
        # (baked.cu and dynculled.cu through their headers, which hold the
        # kernels and return cudaGetLastError()).
        header = {"baked.cu": "baked.cuh", "dynculled.cu": "dynculled.cuh"}
        if name in header:
            assert f'#include "{header[name]}"' in src
            src = (_build.CSRC / header[name]).read_text()
        assert "cudaGetLastError" in src
        assert ('#include "common.cuh"' in src) != name.startswith("probe_")
    for name, header in (("baked_probe.cu", "baked.cuh"),
                         ("baked_probe2.cu", "baked.cuh"),
                         ("baked_probe_seg.cu", "baked.cuh"),
                         ("baked_probe_seg2.cu", "baked.cuh"),
                         ("baked_probe_unculled.cu", "baked.cuh"),
                         ("dynculled_probe.cu", "dynculled.cuh"),
                         ("dynculled_probe_seg.cu", "dynculled.cuh"),
                         ("dynculled_probe_seg_tris.cu", "dynculled.cuh"),
                         ("dynculled_probe_tris.cu", "dynculled.cuh")):
        src = (_build.CSRC / name).read_text()
        assert f'#include "{header}"' in src and "probe_launch_" in src
    # The shipped entry points reach the probe kernels through the
    # dispatch functions that the probes' library hands them.
    for kind in ("baked", "dynculled"):
        src = (_build.CSRC / f"{kind}.cu").read_text()
        assert f'extern "C" void wpt_{kind}_set_probes' in src
        assert "probe_launch_" not in src
        src = (_build.CSRC / f"{kind}_probe.cu").read_text()
        for fn in ("probe_dispatch", "segment_probe_dispatch"):
            assert f'extern "C" int wpt_{kind}_{fn}' in src
    # One nvcc per source, all with the flags; one more links the objects.
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build.compile_command(_build.CSRC / "baked.cu", Path("b.o"))
    assert cmd[0] == "nvcc" and "-c" in cmd and "-fmad=false" in cmd
    link = _build.link_command([Path("a.o"), Path("b.o")], Path("k.so"))
    assert "-shared" in link and link[-2:] == ["a.o", "b.o"]
