"""The shared runner of :mod:`.iterprobe` and :mod:`.dynprobe`: one fused
render per variant (the unprobed kernel, "full", or one differential
stage probe of ``ops/stage_probes.py``) at the scripts' configurations,
each probe timed in turns with the unprobed render, beside ptxas's
registers and spill bytes of its kernel and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import sys

from wavefront_path_tracer_tpu_torch.ops import stage_probes
from wavefront_path_tracer_tpu_torch.probes import _slope


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
    the build's report ({} where the report does not name it)."""
    from wavefront_path_tracer_tpu_torch.ops import _build

    bits = 0 if variant == "full" else stage_probes.PROBES[variant]
    symbol = stage_probes.kernel_symbol(kernel, triangles, textured, bits)
    for rep in _build.ptxas_kernels(_build.build()[1], symbol):
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
