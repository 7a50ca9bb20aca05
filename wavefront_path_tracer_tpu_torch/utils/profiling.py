"""Instrumentation: per-stage timing, frames per second, throughput.

Port of ``wavefront_path_tracer_tpu/utils/profiling.py``, the analog of
the reference's observability:

* ``KernelTimer``: named stages with a 10-deep running average, as the
  reference's GPU timestamp queries keep them (``query_gpu.rs:17``).
  Stages are host wall-clock intervals that end by synchronising the
  device of the tensor given as ``block_on``, as ``block_until_ready``
  ends them in the reference package; for the device's own kernel times
  use ``trace_to``.
* ``FramesPerSecond``: a 10-frame moving average
  (``wavefront_common/src/frames_per_second.rs``).
* ``RenderStats``: per-frame ray and bounce accounting and Mrays/s.
* ``trace_to``: a ``torch.profiler`` trace with CPU and CUDA activity,
  written into a directory as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Dict

import torch

RUNNING_AVG_LENGTH = 10  # matches query_gpu.rs:17


class _RunningAverage:
    def __init__(self, length: int = RUNNING_AVG_LENGTH):
        self._window = collections.deque(maxlen=length)

    def update(self, value: float) -> None:
        self._window.append(value)

    @property
    def average(self) -> float:
        return sum(self._window) / len(self._window) if self._window else 0.0


def block_until_ready(x) -> None:
    """Wait for the device of tensor ``x`` (or of the first tensor in a
    tuple or list of them) to finish its queued work; a no-op on the
    CPU, where every op has finished when it returns."""
    if isinstance(x, (tuple, list)):
        x = next((t for t in x if isinstance(t, torch.Tensor)), None)
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class KernelTimer:
    """Wall-clock stage timer with running averages per stage name."""

    def __init__(self) -> None:
        self._stages: Dict[str, _RunningAverage] = {}

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self._stages.setdefault(name, _RunningAverage()).update(dt)

    def record(self, name: str, seconds: float) -> None:
        self._stages.setdefault(name, _RunningAverage()).update(seconds)

    def averages_us(self) -> Dict[str, float]:
        """Per-stage averaged microseconds (the reference prints us)."""
        return {k: v.average * 1e6 for k, v in self._stages.items()}

    def report(self) -> str:
        return "  ".join(f"{k}: {v:.0f}us"
                         for k, v in self.averages_us().items())


class FramesPerSecond:
    """10-frame moving-average FPS (frames_per_second.rs:9-27)."""

    def __init__(self) -> None:
        self._avg = _RunningAverage()
        self._last = None

    def update(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._avg.update(now - self._last)
        self._last = now

    def get_avg_fps(self) -> float:
        dt = self._avg.average
        return 1.0 / dt if dt > 0 else 0.0


@dataclasses.dataclass
class RenderStats:
    """Per-frame accounting for throughput reports."""

    rays_traced: float = 0.0
    seconds: float = 0.0
    samples: int = 0
    pixels: int = 0

    @property
    def mrays_per_s(self) -> float:
        if self.seconds <= 0:
            return 0.0
        return self.rays_traced / self.seconds / 1e6

    @property
    def avg_bounces(self) -> float:
        paths = self.samples * self.pixels
        return self.rays_traced / paths if paths else 0.0

    def report(self) -> str:
        return (
            f"{self.rays_traced/1e6:.1f} Mrays in {self.seconds:.3f}s "
            f"= {self.mrays_per_s:.1f} Mrays/s "
            f"(avg {self.avg_bounces:.2f} bounces/path)"
        )


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
