"""Each stage's share of the dynamic culled kernel's time on the torus
knot, by the differential stage probes (the port of
``exp/knotprobe.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.knotprobe \
        [TRIS] [WxH] [SPP] [--device cuda|cpu]

The knot of ``scene/mesh.py`` ``knot_scene`` (default 50,000 triangles
over a ground sphere; the reference's ``exp/meshscale.py`` ``build``)
from the reference's view (from (0, 1.5, 4) at the origin, 40 degrees,
no defocus) at 400x224 and 4 spp, 50 bounces, brute force with clusters
of 16: the dynamic culled kernel over runtime tables with triangles.
``models/fused.py`` ``stage_timing`` runs each stage probe of that
kernel (the triangle kernels of ``csrc/dynculled_probe_tris.cu``) in
turns with the unprobed render, two turns, checks each probed
render against the base (radiance words and counters), and gives each
stage's share of the base's time; printed with the base's milliseconds
and the card's name and power limit.
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope

REPS = 2                   # timed turns of each probe, the reference's


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tris", nargs="?", type=int, default=50000)
    ap.add_argument("size", nargs="?", default="400x224", help="WxH")
    ap.add_argument("spp", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    return ap


def run(args) -> dict:
    from wavefront_path_tracer_tpu_torch.models.fused import stage_timing
    from wavefront_path_tracer_tpu_torch.renderer import prepare_scene
    from wavefront_path_tracer_tpu_torch.scene import knot_camera, knot_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    w, h = (int(v) for v in args.size.split("x"))
    scene, triangles = knot_scene(args.tris)
    cc = knot_camera()
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=args.spp,
                       samples_per_frame=args.spp, max_bounces=50,
                       engine="fused", intersector="bruteforce",
                       baked_clusters=16)
    arrays = prepare_scene(scene, cfg, dev, triangles)
    base, rows = stage_timing(
        arrays, cc.gpu_camera(), cc.view_matrix(),
        cc.inverse_projection(w, h), cfg, n_samples=args.spp, reps=REPS)
    print(f"base {base * 1e3:.1f} ms ({args.tris} tris, {w}x{h}@{args.spp})"
          f" [{card}]")
    for label, secs, share in rows:
        print(f"  {label:36s} {secs * 1e3:8.1f} ms  {share * 100:5.1f}%")
    rec = {"tris": triangles.num_triangles, "size": [w, h],
           "spp": args.spp, "base_seconds": base,
           "rows": [{"stage": label, "seconds": secs, "share": share}
                    for label, secs, share in rows], "card": card}
    _hier.emit(rec)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
