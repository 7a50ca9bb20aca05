"""The port imports neither JAX nor the JAX package, hides no device,
and builds for sm_90a."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from wavefront_path_tracer_tpu_torch.ops import _build
from wavefront_path_tracer_tpu_torch.ops import baked_kernels as tbk
from wavefront_path_tracer_tpu_torch.ops import fused_kernels as tfk
from wavefront_path_tracer_tpu_torch.renderer import Renderer, render
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
        import torch
        torch.set_num_threads(1)
        import wavefront_path_tracer_tpu_torch.cli
        import wavefront_path_tracer_tpu_torch.convert
        import wavefront_path_tracer_tpu_torch.ops._build
        import wavefront_path_tracer_tpu_torch.ops.bake
        import wavefront_path_tracer_tpu_torch.ops.baked_kernels
        import wavefront_path_tracer_tpu_torch.ops.fused_kernels
        import wavefront_path_tracer_tpu_torch.profile_frame
        import wavefront_path_tracer_tpu_torch.utils.image
        import wavefront_path_tracer_tpu_torch.utils.parity
        from wavefront_path_tracer_tpu_torch.renderer import render
        from wavefront_path_tracer_tpu_torch.scene import (
            CameraController, book_cover)
        from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
        cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                           max_bounces=4, engine="fused")
        cc = CameraController.book_one_final()
        for extra in ({}, {"intersector": "baked", "baked_clusters": 2}):
            res = render(book_cover(), cc, cfg.replace(**extra), device="cpu")
            assert res.image.shape == (8, 8, 3)
        for name in ("jax", "wavefront_path_tracer_tpu"):
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
    offenders = [f"{f.relative_to(ROOT)}:{n}"
                 for f in files
                 for n, line in enumerate(f.read_text().splitlines(), 1)
                 if _JAX_PACKAGE_IMPORT.search(line)
                 or re.search(r"^\s*(import|from) jax\b", line)]
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
    assert tfk.LAUNCHES == before == 0
    assert tbk.LAUNCHES == {"culled": 0, "unculled": 0}


def test_build_flags(monkeypatch):
    cmd = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in flag or "fast-math" in flag for flag in cmd)
    assert "-fmad=false" in cmd      # bit-identical to the plain version
    assert [p.name for p in _build.sources()] == ["baked.cu", "persistent.cu"]
    assert [p.name for p in _build.headers()] == ["common.cuh"]
    for name, fn in (("persistent.cu", "wpt_persistent_launch"),
                     ("baked.cu", "wpt_baked_launch")):
        src = (_build.CSRC / name).read_text()
        assert f'extern "C" int {fn}' in src
        assert "cudaGetLastError" in src
        assert '#include "common.cuh"' in src
    # One nvcc per source, all with the flags; one more links the objects.
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build.compile_command(_build.CSRC / "baked.cu", Path("b.o"))
    assert cmd[0] == "nvcc" and "-c" in cmd and "-fmad=false" in cmd
    link = _build.link_command([Path("a.o"), Path("b.o")], Path("k.so"))
    assert "-shared" in link and link[-2:] == ["a.o", "b.o"]
