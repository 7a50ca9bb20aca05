"""Knot-scene throughput and cull counters (the port of
``exp/knotbench.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.knotbench \
        [TRIS] [WxH] [SPP] [KEY=VALUE ...] [--reps 3] [--device cuda|cpu]

e.g. ``... knotbench 50000 800x448 32 recluster=2``.  The torus knot of
about TRIS triangles (``scene/mesh.py`` ``knot_scene``, default 50,000)
from the knot's view at WxH (800x448) and SPP samples (32) in one frame,
50 bounces, through the fused engine, brute force with clusters of 16
(the dynamic culled kernel); each KEY=VALUE sets a ``RenderConfig``
field (``recluster=2`` runs the segmented path, the dynamic segment
kernel).  The tables, the kernels' build and the first render are timed
apart (the reference's compile and first render), then the least of
``--reps`` renders: Mrays/s, the counters (iterations: loop trips per
warp of 32 lanes; supers and clusters entered: per ray), the radiance
sum, and the card's name and power limit, then one JSON record.
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tris", nargs="?", type=int, default=50000)
    ap.add_argument("size", nargs="?", default="800x448")
    ap.add_argument("spp", nargs="?", type=int, default=32)
    ap.add_argument("extra", nargs="*", default=[],
                    help="RenderConfig fields as KEY=VALUE")
    _hier.add_device_args(ap)
    return ap


def _value(text: str):
    if text.lstrip("-").isdigit():
        return int(text)
    try:
        return float(text)
    except ValueError:
        return text


def run(args) -> dict:
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.scene import knot_camera, knot_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    w, h = (int(v) for v in args.size.split("x"))
    extra = {}
    for kv in args.extra:
        key, value = kv.split("=")
        extra[key] = _value(value)
    base = dict(width=w, height=h, samples_per_pixel=args.spp,
                samples_per_frame=args.spp, max_bounces=50, engine="fused",
                intersector="bruteforce", baked_clusters=16)
    cfg = RenderConfig(**{**base, **extra})
    scene, triangles = knot_scene(args.tris)
    cc = knot_camera()
    arrays = prepare_scene(scene, cfg, dev, triangles)
    view, cam = cc.view_matrix(), cc.gpu_camera()
    inv_proj = cc.inverse_projection(w, h)

    # The tables, into the render path's cache.
    _, table_s = _hier.timed(lambda: fused.scene_tables(cfg, arrays, view),
                             dev)
    build_s = _hier.build_seconds(dev)

    def once():
        return _hier.timed(lambda: fused.render_samples_with_stats(
            arrays, cam, view, inv_proj, cfg, 0, 0, args.spp), dev)

    _, first_s = once()
    best = float("inf")
    for _ in range(args.reps):
        (rad, rays, stats), seconds = once()
        best = min(best, seconds)
    rays = int(rays)
    st = {k: int(v) for k, v in stats.items()}
    rec = {"tris": triangles.num_triangles, "width": w, "height": h,
           "spp": args.spp, "extra": extra, "rays": rays,
           "seconds": best, "mrays_per_s": rays / best / 1e6,
           "table_seconds": table_s, "build_seconds": build_s,
           "first_seconds": first_s, **st,
           "radiance_abs_sum": float(rad.abs().double().sum()),
           "card": card}
    print(f"knot {args.tris} tris {w}x{h}@{args.spp}: {rays / 1e6:.1f} Mrays "
          f"in {best:.4f} s = {rec['mrays_per_s']:.2f} Mrays/s (tables "
          f"{table_s:.2f} s, build {build_s:.2f} s, first render "
          f"{first_s:.3f} s) [{card}]", flush=True)
    print(f"  iterations={st['iterations']} "
          f"supers_entered={st['supers_entered']} "
          f"clusters_entered={st['clusters_entered']} "
          f"sum|rad|={rec['radiance_abs_sum']:.1f} [{card}]", flush=True)
    _hier.emit(rec)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
