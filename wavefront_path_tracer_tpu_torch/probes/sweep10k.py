"""Cluster size and super factor on the 10,000-sphere scene (the port of
``exp/sweep10k.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.sweep10k \
        [--configs 16x8,32x8,64x8,32x16] [--scene procedural] \
        [--width 1920] [--height 1080] [--spp 32] [--reps 3] \
        [--device cuda|cpu]

The headline's cluster 16 and super factor 8 were chosen on 390
spheres; ``procedural`` (10,000 spheres) has 625 clusters of 16, far
above the super gate (48), so the baked culled kernel sweeps it super by
super.  Each configuration CLUSTERxFACTOR bakes the scene with
``cluster_size=CLUSTER`` and ``super_factor=FACTOR`` and renders 1080p
at 32 spp (50 bounces, block order, the book's camera) in turns with the
others, the least of ``--reps``.  Where the reference printed its
compile seconds, a line gives the bake's seconds (``ops/bake.py``, on
the host) and, once, the kernels' build (``ops/_build.py``: 0 where the
library was built before), with the first render's seconds; then Mrays/s,
the hierarchy, supers and clusters entered a ray, the card's name and
power limit, and the JSON record.
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="16x8,32x8,64x8,32x16",
                    help="comma-separated CLUSTER_SIZExSUPER_FACTOR")
    ap.add_argument("--scene", default="procedural")
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
    build_s = _hier.build_seconds(dev)
    configs = _hier.parse_pairs(args.configs)
    fr = _hier.frame(get_scene(args.scene), CameraController.book_one_final(),
                     dev, width=args.width, height=args.height,
                     spp=args.spp, intersector="baked",
                     baked_clusters=configs[0][0])
    bakes = [_hier.bake(fr, cs, super_factor=sf) for cs, sf in configs]
    print(f"{args.scene} ({fr.host['centers'].shape[0]} spheres) "
          f"{args.width}x{args.height}@{args.spp} spp, baked culled; kernels' "
          f"build {build_s:.2f} s; {args.reps} turns [{card}]", flush=True)
    records = _hier.time_turns(fr, [b for b, _ in bakes], args.reps)
    for (cs, sf), (baked, bake_s), rec in zip(configs, bakes, records):
        label = f"cluster {cs} x super {sf}"
        rec.update(config=label, cluster_size=cs, super_factor=sf,
                   bake_seconds=bake_s, build_seconds=build_s, card=card,
                   **_hier.describe(baked))
        print(f"{label}: bake {bake_s:.3f} s, first render "
              f"{rec['first_seconds']:.3f} s [{card}]", flush=True)
        print(_hier.line(label, rec, card), flush=True)
        _hier.emit(rec)
    return records


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
