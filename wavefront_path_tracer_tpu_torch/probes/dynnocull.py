"""The dynamic culled kernel with every sphere a global, against its
clustered tables (the port of ``exp/dynnocull.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.dynnocull \
        [--clusters 16] [--scene book_one_final] [--width 400] \
        [--height 224] [--spp 64] [--reps 3] [--device cuda|cpu]

``global_radius_factor=0`` makes every sphere of positive radius a
global, so the tables have no cluster (``n_clusters == 0``) and the
kernel sweeps the whole table in its globals phase, with no box cond:
the upper bound of a sweep without culling.  It renders the reference's
400x224 at 64 spp (50 bounces, block order, the book's camera) in turns
with the default clustered tables (factor 10, clusters of
``--clusters``), the least of ``--reps``, so the line says whether the
cull pays for itself on the card: Mrays/s, seconds, the hierarchy,
supers and clusters entered a ray, the radiance checksum and the card's
name and power limit, then its JSON record.  The two checksums agree up
to the order of equal hits.
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", type=int, default=16)
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
    fr = _hier.frame(get_scene(args.scene), CameraController.book_one_final(),
                     dev, width=args.width, height=args.height,
                     spp=args.spp, intersector="bruteforce",
                     baked_clusters=args.clusters)
    factors = (("nocull unrolled", 0.0), ("culled", 10.0))
    tables = [_hier.dynamic(fr, args.clusters, f) for _, f in factors]
    print(f"{args.scene} {args.width}x{args.height}@{args.spp} spp, dynamic "
          f"culled tables of {args.clusters}, {args.reps} turns [{card}]",
          flush=True)
    records = _hier.time_turns(fr, [t for t, _ in tables], args.reps)
    for (label, factor), (tab, table_s), rec in zip(factors, tables,
                                                     records):
        rec.update(config=label, cluster_size=args.clusters,
                   global_radius_factor=factor, table_seconds=table_s,
                   card=card, **_hier.describe(tab))
        print(f"{_hier.line(label, rec, card)} chk {rec['checksum']:.6e}",
              flush=True)
        _hier.emit(rec)
    return records


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
