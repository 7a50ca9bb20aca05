"""Cluster size of the dynamic culled intersect (the port of
``exp/dynsweep.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.dynsweep \
        [--clusters 8,16,32,64] [--scene book_one_final] [--width 400] \
        [--height 224] [--spp 64] [--reps 3] [--device cuda|cpu]

The dynamic culled kernel (``csrc/dynculled.cu``, brute force with
clusters) reads its tables at run time, so its cluster size is a table
parameter, not a bake's.  Each cluster size packs the scene's tables
(``ops/dyn_tables.py``: up to 64 clusters a flat sweep, above that supers
of 16 in a rolled one) and renders the reference's 400x224 at 64 spp (50
bounces, block order, the book's camera) in turns with the others, the
least of ``--reps``: a line each with Mrays/s, seconds, the tables'
seconds, the hierarchy, supers and clusters entered a ray, the radiance
checksum and the card's name and power limit, then its JSON record.
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", default="8,16,32,64")
    ap.add_argument("--scene", default="book_one_final")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=224)
    ap.add_argument("--spp", type=int, default=64)
    _hier.add_device_args(ap)
    return ap


def run(args) -> list[dict]:
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    sizes = [int(c) for c in args.clusters.split(",")]
    fr = _hier.frame(get_scene(args.scene), CameraController.book_one_final(),
                     dev, width=args.width, height=args.height,
                     spp=args.spp, intersector="bruteforce",
                     baked_clusters=sizes[0])
    tables = [_hier.dynamic(fr, cs) for cs in sizes]
    print(f"{args.scene} {args.width}x{args.height}@{args.spp} spp, dynamic "
          f"culled, {args.reps} turns [{card}]", flush=True)
    records = _hier.time_turns(fr, [t for t, _ in tables], args.reps)
    for cs, (tab, table_s), rec in zip(sizes, tables, records):
        label = f"clusters {cs:3d}"
        rec.update(config=label, cluster_size=cs, table_seconds=table_s,
                   card=card, **_hier.describe(tab))
        print(f"{_hier.line(label, rec, card)} tables {table_s:.3f} s, "
              f"chk {rec['checksum']:.6e}", flush=True)
        _hier.emit(rec)
    return records


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
