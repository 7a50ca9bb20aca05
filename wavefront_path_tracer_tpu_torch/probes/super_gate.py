"""The two-level sweep against the flat one at the headline (the port of
``exp/super_gate.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.super_gate \
        [--configs 48x8,0x8,0x4] [--clusters 16] \
        [--global-radius-factor 10.0[,F...]] [--width 1920] [--height 1080] \
        [--spp 32] [--reps 3] [--device cuda|cpu]

book_one_final in clusters of 16 has 31 clusters: under the default
super gate (48) the baked culled kernel (``csrc/baked.cuh``) sweeps them
flat.  Each configuration GATExFACTOR bakes the scene with
``super_gate=GATE`` and ``super_factor=FACTOR``; a gate below the
cluster count turns on the two-level sweep (supers of FACTOR clusters,
each entered by its box first).  With several global radius factors
every configuration runs at each of them (a sphere above F x the median
radius is a global, swept first; the book's ground is one at 10, its
three big spheres too at 3, every sphere at 0).  Every configuration
renders the
reference's headline (1080p, 32 spp, 50 bounces, block order, the
book's camera) in turns with the others, the least of ``--reps``: a line
each with Mrays/s, seconds, the hierarchy, supers and clusters entered a
ray and the card's name and power limit, then its JSON record.
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="48x8,0x8,0x4",
                    help="comma-separated SUPER_GATExSUPER_FACTOR")
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--global-radius-factor", default="10.0",
                    help="comma-separated global radius factors")
    ap.add_argument("--scene", default="book_one_final")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=32)
    _hier.add_device_args(ap)
    return ap


def run(args) -> list[dict]:
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    fr = _hier.frame(get_scene(args.scene), CameraController.book_one_final(),
                     dev, width=args.width, height=args.height,
                     spp=args.spp, intersector="baked",
                     baked_clusters=args.clusters)
    factors = [float(f) for f in args.global_radius_factor.split(",")]
    configs = [(gate, factor, grf) for grf in factors
               for gate, factor in _hier.parse_pairs(args.configs)]
    bakes = [_hier.bake(fr, args.clusters, super_gate=gate,
                        super_factor=factor, global_radius_factor=grf)
             for gate, factor, grf in configs]
    print(f"{args.scene} {args.width}x{args.height}@{args.spp} spp, baked "
          f"culled in clusters of {args.clusters}, {args.reps} turns "
          f"[{card}]", flush=True)
    records = _hier.time_turns(fr, [b for b, _ in bakes], args.reps)
    for (gate, factor, grf), (baked, bake_s), rec in zip(configs, bakes,
                                                          records):
        label = f"gate={gate} super_factor={factor}"
        if len(factors) > 1:
            label += f" global_radius_factor={grf:g}"
        rec.update(config=label, super_gate=gate, super_factor=factor,
                   global_radius_factor=grf, bake_seconds=bake_s, card=card,
                   **_hier.describe(baked))
        print(_hier.line(label, rec, card), flush=True)
        _hier.emit(rec)
    return records


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
