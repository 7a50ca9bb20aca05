"""Profile one frame of the port's main path on a CUDA card.

    python -m wavefront_path_tracer_tpu_torch.profile_frame [CLI flags]
    python -m wavefront_path_tracer_tpu_torch.profile_frame --row NAME \
        [--recluster K]
    python -m wavefront_path_tracer_tpu_torch.profile_frame --row NAME \
        --divergence LANES [--spp N] [--device cpu]
    python -m wavefront_path_tracer_tpu_torch.profile_frame --cell NAME \
        --trips BLOCKS [--spp N] [--device cpu]

Runs the CLI once to warm up (scene, size, samples and intersector as
given, e.g. ``--intersector baked --clusters 16`` for the headline path,
with ``--recluster K`` for its segmented form;
the defaults are book_one_final at 1920x1080, 32 spp in one frame, 50
bounces, brute force), or renders one frame of a mesh row (``--row``,
one of :data:`MESH_ROWS`, built as the reference's ``bench.py`` builds
it), then one more frame of the same configuration under
``torch.profiler``, and prints one JSON line: the frame's wall time, the
device time of each kernel and copy, the share of the frame in which the
device was busy (the union of device activity intervals over the
frame's wall time) and the rest, the host gap, the number of device
kernels and copies, the number of host calls that waited for the device,
and the card's name and power limit.

With ``--divergence LANES`` it traces no frame: it prints how the warps of
the row's culled sweep diverge over its clusters (``warp_divergence`` of
the row's kernel module), counted from the plain version over a window of
LANES lanes (whole 32x32 image blocks) at the middle of the row's lane
order, at the row's samples a pixel or ``--spp N``, on the card or, with
``--device cpu``, on the host.

With ``--trips BLOCKS`` it traces no frame either: it prints the loop
trips of an unculled cell (one of :data:`LOOP_CELLS`) under the two loop
forms' count model, from the plain version one sample at a time over
BLOCKS 32x32 image blocks spread evenly over the lane order
(:func:`loop_trips`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time


# The reference's mesh rows (bench.py:52-56, built by bench_once with
# clusters of 16, 50 bounces): name -> (scene, width, height, spp,
# intersector).
MESH_ROWS = {
    "terrain_baked": ("mesh_terrain", 800, 448, 32, "baked"),
    "terrain_dynamic": ("mesh_terrain", 800, 448, 32, "bruteforce"),
    "knot50k_dynamic": ("mesh_knot50k", 800, 448, 8, "bruteforce"),
}


def row_renderer(name: str, device="cuda", **config):
    """A :class:`Renderer` of the mesh row ``name`` as ``bench.py:
    bench_once`` builds it: ``mesh_terrain_scene()`` (seed 7) under the
    book camera, or the 50k-triangle knot under its own camera; one
    frame of all the row's samples, 50 bounces, clusters of 16, block
    order.  ``config`` overrides fields of the :class:`RenderConfig`."""
    from wavefront_path_tracer_tpu_torch.renderer import Renderer

    scene, tris, cc, cfg = _row(name)
    return Renderer(scene, cc, cfg.replace(**config), tris, device=device)


def _row(name: str):
    """(scene, triangles, camera, RenderConfig) of the mesh row ``name``
    (:func:`row_renderer`)."""
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        knot_camera,
        knot_scene,
        mesh_terrain_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    scene_name, width, height, spp, intersector = MESH_ROWS[name]
    if scene_name == "mesh_terrain":
        scene, tris = mesh_terrain_scene()
        cc = CameraController.book_one_final()
    else:
        scene, tris = knot_scene(50000)
        cc = knot_camera()
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       samples_per_frame=spp, max_bounces=50, engine="fused",
                       intersector=intersector, baked_clusters=16,
                       block_tiles=32)
    return scene, tris, cc, cfg


def row_divergence(name: str, lanes: int, device="cuda",
                   spp: int = 0) -> dict:
    """``warp_divergence`` of the mesh row ``name``'s plain version, at the
    row's samples a pixel or ``spp``, over a window of ``lanes`` lanes
    (whole 32x32 image blocks) at the middle of the frame's lane order,
    its inputs built as ``models/fused.py`` builds them; with the window's
    lanes and samples."""
    import numpy as np
    import torch

    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene

    scene, tris, cc, cfg = _row(name)
    if spp:
        cfg = cfg.replace(samples_per_pixel=spp, samples_per_frame=spp)
    if lanes <= 0 or lanes % 1024:
        raise ValueError("the window is whole 32x32 blocks of lanes")
    arrays = prepare_scene(scene, cfg, device, tris)
    eye = fused._concrete_eye(cc.view_matrix())
    if cfg.intersector == "baked":
        module = bk
        tables = fused._baked_scene(arrays, 16, camera_pos=eye)
    else:
        module = dk
        tables = fused._dyn_tables(arrays, 16, camera_pos=eye)
    w, h, spp = cfg.width, cfg.height, cfg.samples_per_pixel
    perm, _ = fused._block_perm(w, h, 32)
    planes = fused.lane_planes(
        torch.from_numpy(perm.astype(np.int64)).to(device), w,
        cfg.tile_rows, 1, spp)
    cam = torch.from_numpy(fused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h),
        cfg)).to(device)
    lo = planes[0].numel() // 2 // 1024 * 1024 - lanes // 2
    window = [p.reshape(-1)[lo:lo + lanes].reshape(-1, 128) for p in planes]
    counts = module.warp_divergence(tables, (0, 0, cfg.max_bounces, spp),
                                    cam, *window)
    return {**counts, "lanes": [lo, lo + lanes], "spp": spp}


# The unculled cells that time the loop forms (chip_smoke.py phase loop):
# name -> (scene, width, height, spp, intersector), 50 bounces; the book
# scenes under the CLI's camera for them, terrain (mesh_terrain_scene(),
# seed 7) under the book camera.
LOOP_CELLS = {
    "persistent_book": ("book_one_final", 1920, 1080, 32, "bruteforce"),
    "unculled_book": ("book_one_final", 1920, 1080, 32, "baked"),
    "unculled_book_checker": ("book_checker", 1920, 1080, 32, "baked"),
    "unculled_terrain": ("mesh_terrain", 800, 448, 32, "baked"),
}


def loop_trips(cell: str, blocks: int, device="cuda", spp: int = 0) -> dict:
    """The count model of the unculled kernels' two loop forms over
    ``blocks`` 32x32 image blocks (1,024 lanes each) spread evenly over
    the lane order of the cell ``cell`` (:data:`LOOP_CELLS`), at its
    samples a pixel or ``spp``: each lane's rays in each sample from the
    plain version (``fused_kernels.sample_rays``), then the trips of a loop
    whose lanes regroup at every sample end (``sample_trips``) and of the
    loop of trips (``warp_trips`` of the summed rays, trace_warp's)."""
    import numpy as np
    import torch

    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import fused_kernels as fk
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
        mesh_terrain_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    scene_name, w, h, cell_spp, intersector = LOOP_CELLS[cell]
    spp = spp or cell_spp
    tris = None
    if scene_name == "mesh_terrain":
        scene, tris = mesh_terrain_scene()
        cc = CameraController.book_one_final()
    else:
        scene = get_scene(scene_name, seed=42)
        argv = [] if scene_name == "book_one_final" else ["--scene",
                                                          scene_name]
        cc = build_camera(build_parser().parse_args(argv))
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       samples_per_frame=spp, max_bounces=50, engine="fused")
    arrays = prepare_scene(scene, cfg, device, tris)
    kw = {}
    if intersector == "bruteforce":
        table, n = arrays["scene_packed"], len(scene.radii)

        def intersect(*ray):
            return fk.intersect_tile(table, n, *ray) + (None, None)
    else:
        baked = fused._baked_scene(
            arrays, 0, camera_pos=fused._concrete_eye(cc.view_matrix()))
        if baked.textured:
            kw["images"] = baked.images

        def intersect(*ray):
            return bk.baked_intersect_reference(baked, *ray)
    perm, _ = fused._block_perm(w, h, 32)
    planes = fused.lane_planes(
        torch.from_numpy(perm.astype(np.int64)).to(device), w,
        cfg.tile_rows, 1, spp)
    cam = torch.from_numpy(fused.camera_params(
        cc.gpu_camera(), cc.view_matrix(), cc.inverse_projection(w, h),
        cfg)).to(device)
    n_blocks = planes[0].numel() // 1024
    if not 0 < blocks <= n_blocks:
        raise ValueError(f"blocks must be 1..{n_blocks}")
    starts = [(2 * k + 1) * n_blocks // (2 * blocks) * 1024
              for k in range(blocks)]
    window = [torch.cat([p.reshape(-1)[lo:lo + 1024] for lo in starts])
              .reshape(-1, 128) for p in planes]
    per = fk.sample_rays(intersect, (0, 0, cfg.max_bounces, spp), cam,
                         *window, **kw)
    rays = int(per.sum())
    by_sample = int(fk.sample_trips(per))
    warp = int(fk.warp_trips(per.sum(dim=0)))
    return {"cell": cell, "spp": spp, "blocks": starts, "rays": rays,
            "sample_trips": by_sample, "warp_trips": warp,
            "warp_over_sample": warp / max(by_sample, 1),
            "fullness_sample": rays / max(32 * by_sample, 1),
            "fullness_warp": rays / max(32 * warp, 1)}


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

    argv = sys.argv[1:] if argv is None else list(argv)
    if "--trips" in argv:
        import argparse

        ap = argparse.ArgumentParser(prog="profile_frame")
        ap.add_argument("--cell", choices=sorted(LOOP_CELLS), required=True)
        ap.add_argument("--trips", type=int, required=True)
        ap.add_argument("--spp", type=int, default=0)
        ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        args = ap.parse_args(argv)
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("profile_frame needs a CUDA card (or --device "
                             "cpu)")
        t0 = time.perf_counter()
        rep = loop_trips(args.cell, args.trips, args.device, args.spp)
        print(json.dumps({"device": args.device, **rep,
                          "seconds": time.perf_counter() - t0}))
        return 0
    if "--divergence" in argv:
        import argparse

        ap = argparse.ArgumentParser(prog="profile_frame")
        ap.add_argument("--row", choices=sorted(MESH_ROWS), required=True)
        ap.add_argument("--divergence", type=int, required=True)
        ap.add_argument("--spp", type=int, default=0)
        ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        args = ap.parse_args(argv)
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("profile_frame needs a CUDA card (or --device "
                             "cpu)")
        t0 = time.perf_counter()
        rep = row_divergence(args.row, args.divergence, args.device,
                             args.spp)
        print(json.dumps({"row": args.row, "device": args.device, **rep,
                          "seconds": time.perf_counter() - t0}))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if argv[:1] == ["--row"]:
        config = {}
        if argv[2:3] == ["--recluster"]:
            config["recluster"] = int(argv[3])
        renderer = row_renderer(argv[1], **config)
        renderer.render_frame()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            renderer, _ = cli.run([
                "--device", "cuda", "--width", "1920", "--height", "1080",
                "--spp", "32", "--spf", "32", "--max-bounces", "50",
                "--quiet", "--out", os.path.join(tmp, "frame.png"), *argv])
    renderer.reset_accumulation()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = renderer.render_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = prof.events()
    device_events = [e for e in events if e.device_type.name == "CUDA"]
    # Host calls that wait for the device (stream or device synchronize,
    # as a blocking copy or a read-back issues), the closing one included.
    waits = sum(1 for e in events if e.device_type.name == "CPU"
                and e.name.startswith("cuda") and "Synchronize" in e.name)
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
        "host_gap_ms": wall_ms - busy_ms,
        "device_ops": len(device_events),
        "host_waits": waits,
        "device_ms_by_name": top,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
