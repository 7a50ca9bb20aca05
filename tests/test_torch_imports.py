"""The port imports no JAX, hides no device, and builds for sm_90a."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from wavefront_path_tracer_tpu_torch.ops import _build
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
        sys.modules["jax"] = None      # any import of jax now fails
        import torch
        torch.set_num_threads(1)
        import wavefront_path_tracer_tpu_torch.cli
        import wavefront_path_tracer_tpu_torch.convert
        from wavefront_path_tracer_tpu_torch.renderer import render
        from wavefront_path_tracer_tpu_torch.scene import (
            CameraController, book_cover)
        from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
        cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                           max_bounces=4, engine="fused")
        res = render(book_cover(), CameraController.book_one_final(), cfg,
                     device="cpu")
        assert res.image.shape == (8, 8, 3)
        assert sys.modules["jax"] is None
        assert not [m for m in sys.modules if m.startswith("jax.")]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(book_cover(), CameraController.book_one_final(), CFG,
                 device="cuda")


def test_no_launches_on_cpu():
    before = tfk.LAUNCHES
    render(book_cover(), CameraController.book_one_final(), CFG, device="cpu")
    assert tfk.LAUNCHES == before == 0


def test_build_flags():
    cmd = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in flag or "fast-math" in flag for flag in cmd)
    assert "-fmad=false" in cmd      # bit-identical to the plain version
    assert [p.name for p in _build.sources()] == ["persistent.cu"]
    src = (_build.CSRC / "persistent.cu").read_text()
    assert 'extern "C" int wpt_persistent_launch' in src
    assert "cudaGetLastError" in src
