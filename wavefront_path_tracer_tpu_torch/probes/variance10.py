"""The spread of one timed render within a process and across processes
(the port of ``exp/variance10.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.variance10 \
        [--runs 10] [--procs 3] [--scene cornell_spheres] [--width 400] \
        [--height 224] [--spp 64] [--device cuda|cpu]

The same render, the fused engine over the baked culled kernel in
clusters of 16 (block order, 50 bounces, the book's camera, ``--spp``
samples in one launch), ``--runs`` times in this process and then once
warm in each of ``--procs`` fresh processes (each renders twice and
reports its second run; each dies with this one), to separate the
candidate causes of a spread:

* the warm spread in one process: clocks and device noise;
* the first run of a process: the kernels' library load and the bake;
* a drift from the first half of the runs to the second: heat.

Each run's time is wall seconds between ``torch.cuda.synchronize()``
calls, its rate the rays the kernel counted over it (the reference
waited on the ray count instead).  Prints a line a run, the in-process
band, the drift and the cross-process band; writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from wavefront_path_tracer_tpu_torch.utils import child

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHILD_TIMEOUT = 1500


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--procs", type=int, default=3,
                    help="additional cross-process single runs")
    ap.add_argument("--scene", default="cornell_spheres")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=224)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (cuda, or cpu)")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    return ap


def in_process_runs(args) -> list[float]:
    """Mrays/s of ``args.runs`` renders in this process, the first with
    the library's load and the bake."""
    import torch

    from wavefront_path_tracer_tpu_torch.models.fused import render_samples
    from wavefront_path_tracer_tpu_torch.renderer import (
        prepare_scene,
        resolve_device,
    )
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    device = resolve_device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, samples_per_frame=args.spp,
                       max_bounces=50, engine="fused", intersector="baked",
                       baked_clusters=16, block_tiles=32)
    scene = get_scene(args.scene)
    cc = CameraController.book_one_final()
    arrays = prepare_scene(scene, cfg, device)
    view = cc.view_matrix()
    inv_proj = cc.inverse_projection(cfg.width, cfg.height)
    cam = cc.gpu_camera()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rates = []
    for i in range(args.runs):
        sync()
        t0 = time.perf_counter()
        _rad, rays = render_samples(arrays, cam, view, inv_proj, cfg, i, 0,
                                    args.spp)
        sync()
        dt = time.perf_counter() - t0
        rates.append(float(rays) / dt / 1e6)
        print(f"run {i:2d}: {rates[-1]:7.1f} Mrays/s ({dt:.2f}s)"
              + ("   [includes the library load and the bake]" if i == 0
                 else ""), file=sys.stderr, flush=True)
    return rates


def run(args) -> dict:
    """{rates (in-process), warm: {min, median, max, band, stdev},
    drift, processes: [[first, warm], ...], cross_band}."""
    rates = in_process_runs(args)
    out = {"rates": rates, "processes": []}
    warm = rates[1:]
    if warm:
        out["warm"] = {"min": min(warm), "median": statistics.median(warm),
                       "max": max(warm),
                       "band": 100 * (max(warm) / min(warm) - 1),
                       "stdev": statistics.pstdev(warm)}
        print(f"\nin-process warm ({len(warm)} runs): "
              f"min {min(warm):.1f}  median {statistics.median(warm):.1f}  "
              f"max {max(warm):.1f}  band {out['warm']['band']:.1f}%  "
              f"stdev {statistics.pstdev(warm):.1f}")
    half = len(warm) // 2
    if half >= 2:
        d = statistics.median(warm[half:]) - statistics.median(warm[:half])
        out["drift"] = d
        print(f"drift (2nd-half median - 1st-half): {d:+.1f} Mrays/s "
              f"({'thermal suspect' if d < -5 else 'no thermal drift'})")

    proc_warm = []
    for p in range(args.procs):
        cmd = [sys.executable, "-m",
               "wavefront_path_tracer_tpu_torch.probes.variance10",
               "--_child", "--scene", args.scene,
               "--width", str(args.width), "--height", str(args.height),
               "--spp", str(args.spp), "--device", args.device]
        res = child.run(cmd, stdout=subprocess.PIPE, text=True,
                        timeout=CHILD_TIMEOUT, cwd=ROOT)
        if res.returncode != 0:
            raise RuntimeError(f"process {p}: exit {res.returncode}")
        vals = json.loads(res.stdout.strip().splitlines()[-1])
        out["processes"].append(vals)
        proc_warm.append(vals[-1])
        print(f"process {p}: first {vals[0]:.1f}  warm {vals[-1]:.1f}")
    if proc_warm:
        out["cross_band"] = 100 * (max(proc_warm) / min(proc_warm) - 1)
        print(f"cross-process warm: min {min(proc_warm):.1f}  "
              f"max {max(proc_warm):.1f}  band {out['cross_band']:.1f}%")
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args._child:
        args.runs = 2  # one with the load, one warm
        print(json.dumps(in_process_runs(args)))
        return 0
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
