"""Profile one frame of the port's main path on a CUDA card.

    python -m wavefront_path_tracer_tpu_torch.profile_frame [CLI flags]
    python -m wavefront_path_tracer_tpu_torch.profile_frame --row NAME \
        [--recluster K]
    python -m wavefront_path_tracer_tpu_torch.profile_frame --row NAME \
        --divergence LANES [--spp N] [--recluster K] [--device cpu]
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
``--device cpu``, on the host.  With ``--recluster K`` it counts the
segment kernel's warps instead (``segment_divergence``): LANES / 1024
blocks spread over the frame rendered through the segmented path, its
coherence sort included, launch by launch and summed by the launch's
index in the schedule, with the pair steps of the two sweep forms and the
model's time ratio (:func:`segment_model`).  ``--row headline`` is book_one_final at
1920x1080, 32 spp, baked/16, under the CLI's default view.

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


# The rows whose warp divergence ``--divergence`` counts: the mesh rows
# and the headline (book_one_final under the CLI's default view).
DIVERGENCE_ROWS = {**MESH_ROWS,
                   "headline": ("book_one_final", 1920, 1080, 32, "baked")}


def _row(name: str):
    """(scene, triangles, camera, RenderConfig) of the row ``name``
    (:data:`DIVERGENCE_ROWS`; :func:`row_renderer`)."""
    from wavefront_path_tracer_tpu_torch.cli import build_camera, build_parser
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
        knot_camera,
        knot_scene,
        mesh_terrain_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    scene_name, width, height, spp, intersector = DIVERGENCE_ROWS[name]
    tris = None
    if scene_name == "book_one_final":
        scene = get_scene(scene_name, seed=42)
        cc = build_camera(build_parser().parse_args([]))
    elif scene_name == "mesh_terrain":
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
    """``warp_divergence`` of the row ``name``'s plain version, at the
    row's samples a pixel or ``spp``, over a window of ``lanes`` lanes
    (whole 32x32 image blocks) at the middle of the frame's lane order,
    its inputs built as ``models/fused.py`` builds them; with the window's
    lanes and samples."""
    import numpy as np
    import torch

    from wavefront_path_tracer_tpu_torch.models import fused

    if lanes <= 0 or lanes % 1024:
        raise ValueError("the window is whole 32x32 blocks of lanes")
    arrays, cc, cfg, tables, module = _row_tables(name, device)
    if spp:
        cfg = cfg.replace(samples_per_pixel=spp, samples_per_frame=spp)
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


def _row_tables(name: str, device):
    """(scene arrays, camera, RenderConfig, the culled tables, their
    kernel module) of the row ``name``, built as ``models/fused.py``
    builds them (clusters of 16, the camera's hint)."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops import baked_kernels as bk
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene

    scene, tris, cc, cfg = _row(name)
    arrays = prepare_scene(scene, cfg, device, tris)
    eye = fused._concrete_eye(cc.view_matrix())
    if cfg.intersector == "baked":
        return (arrays, cc, cfg,
                fused._baked_scene(arrays, 16, camera_pos=eye), bk)
    return arrays, cc, cfg, fused._dyn_tables(arrays, 16, camera_pos=eye), dk


# The model's FP32 operations (chip_smoke.py's FLOPS_*, counted from the
# sources): a pair test by primitive, a box test, and what a ray costs a
# trip besides its sweep (shade, throughput and miss 120, the shifted ray
# 19, a slab exit 22).  A cooperative pass adds its ray fetch and shuffle
# tree, about half a sphere pair's issue.
_PAIR_OPS = {"sphere": 17.5, "triangle": 46.0}
_BOX_OPS, _RAY_OPS, _PASS_OPS = 24.0, 161.0, 9.0


def segment_model(tables, sums: dict) -> dict:
    """The count model of the two segment forms' time: the FP32 operations
    that a warp issues over the counted trips, as the serial form and as
    the shipped one would (``fold_steps``), everything but the folds the
    same in both: per trip a ray's fixed work and the globals' pairs, the
    box tests (a flat sweep tests every cluster box; a rolled dynamic
    sweep every super box and the 16 children of each super that some lane
    entered; a two-level bake every super box and, as an upper estimate,
    the 8 children of a super for each union cluster), and the folds'
    pair steps at the pair's operations.  Returns the two sums, the pair
    share of the serial form's and the ratio shipped / serial, which is
    the predicted time ratio where issue bounds the kernel."""
    trips = sums["trips"]
    if hasattr(tables, "items"):
        n_globals, n_clusters = tables.n_globals, int(
            tables.cluster_boxes.shape[0] + tables.tri_cluster_boxes.shape[0])
        n_supers = int(tables.super_boxes.shape[0]
                       + tables.tri_super_boxes.shape[0])
        pair = _PAIR_OPS["triangle" if tables.n_triangles else "sphere"]
        boxes = (trips * n_clusters if not n_supers else
                 trips * n_supers + 8 * sums["union_pairs"])
    else:
        sph = tables.spheres[:tables.n_globals, 0]
        n_globals = int((sph == sph).sum())
        pair = _PAIR_OPS["triangle" if tables.n_tri_clusters else "sphere"]
        if sums.get("super_boxes_per_ray"):
            boxes = (trips * sums["super_boxes_per_ray"]
                     + 16 * sums["union_supers"])
        else:
            boxes = trips * (tables.n_clusters + tables.n_tri_clusters)
    fixed = trips * (_RAY_OPS + n_globals * _PAIR_OPS["sphere"]) \
        + boxes * _BOX_OPS
    serial = fixed + sums["serial_steps"] * pair
    coop = fixed + sums["coop_steps"] * pair + sums["coop_passes"] * _PASS_OPS
    return {"model_serial_ops": serial, "model_coop_ops": coop,
            "model_pair_share": sums["serial_steps"] * pair / max(serial, 1),
            "model_coop_over_serial": coop / max(serial, 1)}


_SUMMED = ("rays", "trips", "issued_pairs", "useful_pairs", "serial_steps",
           "coop_steps", "coop_passes", "union_pairs", "reach_pairs",
           "union_supers")


def _sum_launches(launches: list[dict]) -> dict:
    """The launches' counts summed: their rays, trips, lane-pairs, pair
    steps and passes, the (trip, cluster) pairs some lane entered
    (``union_pairs``) and of them those the cooperative fold takes
    (``reach_pairs``), the union supers of the trips, and the histogram of
    entering lanes; with the ratios that follow from the sums."""
    sums = {k: 0 for k in _SUMMED}
    hist = None
    for rep in launches:
        union = rep["union_clusters_per_trip"] * rep["trips"]
        rep = {**rep, "union_pairs": union,
               "reach_pairs": rep["reach"] * union,
               "union_supers": rep.get("union_supers_per_trip", 0.0)
               * rep["trips"]}
        for k in _SUMMED:
            sums[k] += rep[k]
        hist = rep["entering_lanes"] if hist is None else [
            a + b for a, b in zip(hist, rep["entering_lanes"])]
    sums["super_boxes_per_ray"] = launches[0].get("super_boxes_per_ray", 0)
    trips = max(sums["trips"], 1)
    return {**sums, "entering_lanes": hist,
            "warp_fullness": sums["rays"] / (32 * trips),
            "union_clusters_per_trip": sums["union_pairs"] / trips,
            "useful_share": sums["useful_pairs"]
            / max(sums["issued_pairs"], 1),
            "reach": sums["reach_pairs"] / max(sums["union_pairs"], 1),
            "fold_steps_coop_over_serial": sums["coop_steps"]
            / max(sums["serial_steps"], 1)}


def row_segment_divergence(name: str, lanes: int, device="cuda",
                           spp: int = 0, recluster: int = 2) -> dict:
    """``segment_divergence`` of the row ``name``'s segmented path at
    recluster ``recluster``: the pixels of ``lanes`` / 1024 32x32 image
    blocks spread evenly over the frame's block order (as
    :func:`loop_trips` spreads them; all of them at most), rendered
    through ``models/fused.py`` ``_recluster`` with the counting plain
    segment (the coherence sort included), at the row's samples a pixel
    or ``spp``.  Returns the launches' counts, their sums by the launch's
    index in the segment schedule (every sample's i-th launch) and over
    the frame, each with :func:`segment_model`'s ratio."""
    import numpy as np
    import torch

    from wavefront_path_tracer_tpu_torch.models import fused

    if lanes <= 0 or lanes % 1024:
        raise ValueError("the window is whole 32x32 blocks of lanes")
    arrays, cc, cfg, tables, module = _row_tables(name, device)
    spp = spp or cfg.samples_per_pixel
    cfg = cfg.replace(samples_per_pixel=spp, samples_per_frame=spp,
                      recluster=recluster)
    w, h = cfg.width, cfg.height
    perm, _ = fused._block_perm(w, h, 32)
    n_blocks = -(-w * h // 1024)
    blocks = min(lanes // 1024, n_blocks)
    starts = [(2 * k + 1) * n_blocks // (2 * blocks) * 1024
              for k in range(blocks)]
    pixel_idx = torch.from_numpy(np.concatenate(
        [perm[lo:lo + 1024] for lo in starts]).astype(np.int64)).to(device)
    view, inv_proj = cc.view_matrix(), cc.inverse_projection(w, h)

    def run(segment):
        fused._recluster(segment, fused.coherence_order, tables, pixel_idx,
                         arrays, cc.gpu_camera(), view, inv_proj, cfg, 0, 0,
                         spp, False)

    launches = module.segment_divergence(tables, run)
    ks = fused._segment_schedule(recluster, cfg.max_bounces)
    by_index = []
    for i, k in enumerate(ks):
        sums = _sum_launches(launches[i::len(ks)])
        by_index.append({"index": i, "k_iters": k, **sums,
                         **segment_model(tables, sums)})
    total = _sum_launches(launches)
    return {"blocks": starts, "pixels": pixel_idx.numel(), "spp": spp,
            "recluster": recluster, "schedule": list(ks),
            "by_index": by_index, "total": {**total,
                                            **segment_model(tables, total)},
            "launches": launches}


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
        ap.add_argument("--row", choices=sorted(DIVERGENCE_ROWS),
                        required=True)
        ap.add_argument("--divergence", type=int, required=True)
        ap.add_argument("--spp", type=int, default=0)
        ap.add_argument("--recluster", type=int, default=0)
        ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        args = ap.parse_args(argv)
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("profile_frame needs a CUDA card (or --device "
                             "cpu)")
        t0 = time.perf_counter()
        if args.recluster:
            rep = row_segment_divergence(args.row, args.divergence,
                                         args.device, args.spp,
                                         args.recluster)
        else:
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
