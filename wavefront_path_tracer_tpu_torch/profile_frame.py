"""Profile one frame of the port's main path on a CUDA card.

    python -m wavefront_path_tracer_tpu_torch.profile_frame [CLI flags]

Runs the CLI once to warm up (scene, size and samples as given; the
defaults are book_one_final at 1920x1080, 32 spp in one frame, 50
bounces), then one more frame of the same configuration under
``torch.profiler``, and prints one JSON line: the frame's wall time, the
device time of each kernel and copy, the share of the frame in which the
device was busy (the union of device activity intervals over the
frame's wall time), and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wavefront_path_tracer_tpu_torch import cli

    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--device", "cuda", "--width", "1920", "--height", "1080",
                "--spp", "32", "--spf", "32", "--max-bounces", "50",
                "--quiet", "--out", os.path.join(tmp, "frame.png"),
                *(sys.argv[1:] if argv is None else argv)]
        renderer, _ = cli.run(args)
    renderer.reset_accumulation()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = renderer.render_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    device_events = [e for e in prof.events()
                     if e.device_type.name == "CUDA"]
    busy_ms = _union_us((e.time_range.start, e.time_range.end)
                        for e in device_events) / 1e3
    per_name: dict[str, float] = {}
    for e in device_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time / 1e3
    top = dict(sorted(per_name.items(), key=lambda kv: -kv[1])[:8])
    print(json.dumps({
        "card": card,
        "frame_ms": wall_ms,
        "rays": result.rays_traced,
        "mrays_per_s": result.rays_traced / wall_ms / 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ms_by_name": top,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
