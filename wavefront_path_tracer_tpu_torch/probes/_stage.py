"""The shared runner of :mod:`.iterprobe` and :mod:`.dynprobe`: one fused
render per variant (the unprobed kernel, "full", or one differential
stage probe of ``ops/stage_probes.py``) at the scripts' configurations,
each probe timed in turns with the unprobed render, beside ptxas's
registers and spill bytes of its kernel and the card's name and power
limit.  And :func:`segment_shares`, the segment kernels' probes timed
over a segmented frame's launches (``chip_smoke.py`` phase segstage).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.ops import stage_probes
from wavefront_path_tracer_tpu_torch.probes import _slope

# Device cycles of the spin queued ahead of each timed segment launch
# (about 0.5 ms at 1.98 GHz): segment_frame.
SEGMENT_SPIN = 1_000_000


def parser(doc: str, *, variants: str, scene: str, intersector: str,
           clusters: int, width: int, height: int,
           spp: int) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--variants", default=variants,
                    help="comma-separated: full (the unprobed kernel) and "
                    "probe names of ops/stage_probes.py")
    ap.add_argument("--scene", default=scene)
    ap.add_argument("--intersector", default=intersector,
                    choices=("baked", "bruteforce"))
    ap.add_argument("--clusters", type=int, default=clusters)
    ap.add_argument("--width", type=int, default=width)
    ap.add_argument("--height", type=int, default=height)
    ap.add_argument("--spp", type=int, default=spp)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed turns of each probe and the base render")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    return ap


def resources(kernel: str, triangles: bool, textured: bool,
              variant: str) -> dict:
    """ptxas's registers, stack and spill bytes of a variant's kernel from
    its library's build report ({} where the report does not name it)."""
    from wavefront_path_tracer_tpu_torch.ops import _build

    bits = 0 if variant == "full" else stage_probes.PROBES[variant]
    symbol = stage_probes.kernel_symbol(kernel, triangles, textured, bits)
    report = _build.build(_build.PROBE_LIB_NAME if bits
                          else _build.LIB_NAME)[1]
    for rep in _build.ptxas_kernels(report, symbol):
        return {k: rep.get(k) for k in ("registers", "stack", "spill_stores",
                                        "spill_loads")}
    return {}


def run(args) -> list[dict]:
    """Render every variant of ``args`` (:func:`parser`'s) and print one
    line each: Mrays/s (models/fused.py time_probes: the least of
    ``args.reps`` runs after one warm run) and, for a probe, its share
    against the unprobed render timed in turns with it, with ptxas's
    registers and spills of its kernel, beside the card."""
    from wavefront_path_tracer_tpu_torch.bench import fused_kernel
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    variants = [v for v in args.variants.split(",") if v]
    kernel = fused_kernel(args.intersector, args.clusters)
    for variant in variants:
        # Raises ValueError, naming it, for a name that is not the kernel's
        # (with the reason for the reference's names the port lacks).
        if variant != "full":
            stage_probes.probe_bits(variant, kernel)
    dev = _slope.device(args.device)
    card = _slope.card() if dev.type == "cuda" else (
        "cpu: the plain versions' times, not the card's")
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       samples_per_frame=args.spp, max_bounces=50,
                       engine="fused", intersector=args.intersector,
                       baked_clusters=args.clusters, block_tiles=32)
    cc = CameraController.book_one_final()
    arrays = prepare_scene(get_scene(args.scene), cfg, dev)
    view = cc.view_matrix()
    tables = fused.scene_tables(cfg, arrays, view)
    tab = tables.get("baked") or tables.get("dyn")
    triangles = bool(getattr(tab, "n_triangles", 0)
                     or getattr(tab, "n_tri_clusters", 0))
    textured = bool(getattr(tab, "textured", False))
    print(f"{args.scene} {args.width}x{args.height}@{args.spp} spp, "
          f"{args.intersector}/{args.clusters} ({kernel} kernel, "
          f"triangles {triangles}, textured {textured}), {args.reps} turns "
          f"[{card}]", flush=True)
    rays, base, turns = fused.time_probes(
        arrays, cc.gpu_camera(), view,
        cc.inverse_projection(args.width, args.height), cfg,
        [v for v in variants if v != "full"], args.spp, args.reps)
    times = {probe: (t_base, t_probe) for probe, t_base, t_probe in turns}
    out = []
    for variant in variants:
        t_base, t_var = times.get(variant, (base, base))
        rec = {"variant": variant, "kernel": kernel, "rays": rays,
               "seconds": t_var, "base_seconds": t_base,
               "mrays_per_s": rays / t_var / 1e6,
               "share": (t_var - t_base) / t_base, "card": card}
        if dev.type == "cuda":
            rec.update(resources(kernel, triangles, textured, variant))
        spill = (f"  [{rec['registers']} registers, {rec['spill_stores']} / "
                 f"{rec['spill_loads']} bytes spilled]"
                 if "registers" in rec else "")
        share = ("" if variant == "full"
                 else f"  share {rec['share'] * 100:+.1f}% (base "
                      f"{rays / t_base / 1e6:.1f} Mrays/s in its turns)")
        print(f"{variant:16s}: {rec['mrays_per_s']:8.1f} Mrays/s "
              f"({t_var:.4f} s){share}{spill}  [{card}]", flush=True)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(ap: argparse.ArgumentParser, argv=None) -> int:
    args = ap.parse_args(argv)
    try:
        run(args)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    return 0


def segment_frame(tables: dict, pix, scene_arrays, cam, view, inv_proj,
                  config, n_samples: int, probe=frozenset(), segment=None):
    """One segmented frame (``models/fused.py`` ``_recluster`` with the
    coherence sort over ``segment``, by default the segment wrapper of
    ``tables``, a dict of :func:`models.fused.scene_tables`) of the pixels
    ``pix``, with ``probe`` passed to every segment launch: (radiance,
    [rays, iterations, supers, clusters], each launch's ms in issue
    order).  On
    the card a launch is timed by CUDA events behind a device spin of
    :data:`SEGMENT_SPIN` cycles, so that the host has queued the launch
    and its end event before the start event runs and the events bracket
    the kernel alone (the segmented loop's host work would otherwise
    leave the device waiting inside them); on the CPU by the host
    clock."""
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops.baked_kernels import (
        fused_segment_baked,
    )
    from wavefront_path_tracer_tpu_torch.ops.dynculled_kernels import (
        fused_segment_dynculled,
    )

    if "baked" in tables:
        tab, wrapper = tables["baked"], fused_segment_baked
    else:
        tab, wrapper = tables["dyn"], fused_segment_dynculled
    segment = segment or wrapper
    cuda = pix.device.type == "cuda"
    marks = []

    def timed(*args, **kw):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SEGMENT_SPIN)
            start.record()
            out = segment(*args, **kw)
            end.record()
            marks.append((start, end))
        else:
            t0 = time.perf_counter()
            out = segment(*args, **kw)
            marks.append((time.perf_counter() - t0) * 1e3)
        return out

    radiance, rays, stats = fused._recluster(
        timed, fused.coherence_order, tab, pix, scene_arrays, cam, view,
        inv_proj, config, 0, 0, n_samples, True, probe=probe)
    if cuda:
        torch.cuda.synchronize(pix.device)
        ms = [a.elapsed_time(b) for a, b in marks]
    else:
        ms = marks
    counts = [int(rays)] + [int(stats[k]) for k in (
        "iterations", "supers_entered", "clusters_entered")]
    return radiance, counts, ms


def segment_shares(scene_arrays, cam, view, inv_proj, config, probes,
                   n_samples: int, reps: int = 3):
    """Each segment probe's share of a segmented frame's segment-kernel
    time: the sum of a frame's launch times (:func:`segment_frame`), not
    its wall time, which the host's work between launches sets at K > 0.
    ``config`` has ``recluster`` > 0 and a culled path (baked with
    clusters, or brute force with clusters); ``probes`` are names of its
    segment kernel (``ops/stage_probes.py`` KERNEL_PROBES
    "segment_culled" or "segment_dynculled").  After one frame of each,
    the base frame and each probed frame run in turns (base, probe,
    base, probe, ...), ``reps`` of each, and the least sum of each is
    kept; every probed frame must keep the base's radiance words and
    counters (``models/fused.py`` ``_check_probe_render``, which raises
    RuntimeError), so each probe launches in 1 + ``reps`` frames.
    Returns (the base's [rays, iterations, supers, clusters], its least
    ms over every turn, [(probe, least base ms of its turns, least probe
    ms), ...])."""
    from wavefront_path_tracer_tpu_torch.models import fused

    if config.recluster <= 0:
        raise ValueError("segment_shares times the segment kernels: "
                         "recluster must be > 0")
    device = scene_arrays["centers"].device
    tables = fused.scene_tables(config, scene_arrays, view)
    if not tables:
        raise ValueError("the segment probes need a culled path (baked, or "
                         "brute force with clusters)")
    if config.block_tiles:
        perm, _ = fused._block_perm(config.width, config.height,
                                    config.block_tiles)
        pix = torch.from_numpy(perm.astype(np.int64)).to(device)
    else:
        pix = torch.arange(config.num_pixels, dtype=torch.int64,
                           device=device)

    def frame(probe=frozenset()):
        return segment_frame(tables, pix, scene_arrays, cam, view,
                             inv_proj, config, n_samples, probe)

    def probed(probe) -> float:
        rad, stats, ms = frame(probe)
        fused._check_probe_render(probe, rad, stats, base_rad, base_stats,
                                  n_samples)
        return sum(ms)

    base_rad, base_stats, _ = frame()
    base = float("inf")
    turns = []
    for probe in probes:
        probed(probe)                     # its first frame, checked
        t_base = t_probe = float("inf")
        for _ in range(reps):
            t_base = min(t_base, sum(frame()[2]))
            t_probe = min(t_probe, probed(probe))
        turns.append((probe, t_base, t_probe))
        base = min(base, t_base)
    return base_stats, base, turns
