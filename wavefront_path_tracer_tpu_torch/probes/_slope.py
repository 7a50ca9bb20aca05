"""The probes' slope timer, device choice and card description.

A probe's kernel takes its rep (or pass) count at run time, so one build
serves both points of a slope.  Each point is timed with CUDA events,
the minimum over :data:`RUNS` calls after a warm-up call, and a rate is
the extra work over the extra seconds: the launch, the output and
everything else that does not grow with the count cancel
(``exp/pair_ceiling.py``, ``exp/hbm_bw.py``).
"""

from __future__ import annotations

import subprocess

import torch

RUNS = 5
MIN_WINDOW = 0.02          # s: the least slope window a rate rests on
# The card's published peaks (H100 SXM at 700 W): a reading above either
# measures code motion, not the card.
PEAK_FP32 = 67e12          # FLOP/s, FP32 outside the tensor cores
PEAK_TF32 = 495e12         # FLOP/s, TF32 tensor cores, dense
PEAK_BF16 = 989e12         # FLOP/s, bf16 tensor cores, dense
PEAK_BYTES = 3.35e12       # B/s, HBM3


def device(name: str) -> torch.device:
    """The device a probe runs on: ``cuda`` needs a card and raises
    without one (no fallback); ``cpu`` runs the plain versions."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"--device is cuda or cpu, not {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("this probe measures the card and needs CUDA; "
                           "pass --device cpu for the plain versions")
    return torch.device("cuda", torch.cuda.current_device())


def card() -> str:
    """``name, power limit, max SM clock`` as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fp32_issue_rate(sm_count: int, mhz: float) -> float:
    """Thread instructions a second at full issue on ``sm_count`` SMs at
    ``mhz``: 4 warp instructions a clock an SM, 128 thread instructions.
    It is also the FP32 rate of code built ``-fmad=false``, where each
    FP32 operation is one instruction (the 67 TFLOP/s spec,
    :data:`PEAK_FP32`, counts an FFMA as two): 33.45e12 on 132 SMs at
    1980 MHz."""
    return sm_count * 4 * 32 * mhz * 1e6


def issue_rate(card_line: str) -> float:
    """:func:`fp32_issue_rate` of the current card at the maximum SM
    clock, the last field of :func:`card` (e.g. ``1980 MHz``)."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    mhz = float(card_line.rsplit(",", 1)[1].split()[0])
    return fp32_issue_rate(props.multi_processor_count, mhz)


def time_call(fn) -> float:
    """Seconds of one call of ``fn`` on the card: CUDA events around it,
    the minimum over :data:`RUNS` calls after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def slope(run, lo: int, hi: int) -> dict:
    """Time ``run(count)`` at ``lo`` and ``hi``: {lo, hi, lo_s, hi_s,
    window_s, unit_s}, where unit_s is the seconds one more unit of count
    adds.  A window under :data:`MIN_WINDOW` s is widened (``hi`` raised)
    until it is not, and the counts used are returned."""
    if not hi > lo:
        raise ValueError(f"the slope needs hi > lo, got {lo}, {hi}")
    lo_s = time_call(lambda: run(lo))
    hi_s = time_call(lambda: run(hi))
    for _ in range(4):
        if hi_s - lo_s >= MIN_WINDOW:
            break
        grow = 2.0 * MIN_WINDOW / max(hi_s - lo_s, MIN_WINDOW / 64)
        hi = lo + int((hi - lo) * grow) + 1
        hi_s = time_call(lambda: run(hi))
    window = hi_s - lo_s
    if not window > 0.0:
        raise AssertionError(f"the slope window is {window!r} s: the "
                             f"count does not add time")
    return {"lo": lo, "hi": hi, "lo_s": lo_s, "hi_s": hi_s,
            "window_s": window, "unit_s": window / (hi - lo)}


def check_rays(rays: torch.Tensor) -> None:
    """Raise unless ``rays`` is a contiguous (6, N) float32 tensor (o xyz,
    d xyz planes) that starts on a 16-byte boundary."""
    if (rays.dim() != 2 or rays.shape[0] != 6 or rays.dtype != torch.float32
            or not rays.is_contiguous()):
        raise ValueError(f"rays must be a contiguous (6, N) float32 "
                         f"tensor, got {rays.dtype} {tuple(rays.shape)}")
    if rays.data_ptr() % 16:
        raise ValueError("rays must be 16-byte aligned")


def one_device(*tensors) -> torch.device:
    """The one device all ``tensors`` lie on; raises if they differ or it
    is neither the CPU nor a CUDA card."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"the probes run on cpu or cuda, not {dev}")
    return dev


def launch(fn_name: str, *args) -> None:
    """Call the C entry point ``fn_name`` of the kernel library with
    ``args`` and the current stream; raise on a nonzero CUDA error."""
    from wavefront_path_tracer_tpu_torch.ops._build import load_library

    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(load_library(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")
