"""How often the culled sweep enters its supers and clusters, a warp at
a time and in all (the port of ``exp/cullstats.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.cullstats \
        [--scene book_one_final] [--width 400] [--height 224] [--spp 8] \
        [--clusters 16] [--intersector baked|bruteforce] \
        [--device cuda|cpu]

One render of the scene (50 bounces, block order, the book's camera)
through the baked culled kernel (``--intersector baked``) or the dynamic
culled one (``bruteforce``), with the counters each lane of the kernel
keeps (``lane_counts``: its rays, supers and clusters entered).  The
reference's counters were a tile's: one entry a tile of tile_rows x 128
lanes in lockstep, against a maximum of its loop iterations x nodes.  The
port's kernels count per ray, so a block here is a warp of 32 lanes (its
iterations are its loop trips, its largest lane's rays) and the maximum
of its entries is its rays x nodes; the clusters' share is then also the
share of a brute-force sweep's clustered pair tests that the entered
clusters cost.  Printed, over the warps that hold a pixel: the
hierarchy, the warps' rays and trips, supers and clusters entered
against that maximum, the lane overhead (trips x 32 over rays), the five
warps that entered the most clusters, and the card's name and power
limit; then one JSON record.
"""

from __future__ import annotations

import argparse

import torch

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope

WARP = 32


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="book_one_final")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=224)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--intersector", default="baked",
                    choices=("baked", "bruteforce"))
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    return ap


def warp_counts(lanes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(W, 4) int64 per warp of 32 lanes in lane order that holds a valid
    lane: rays, trips (the largest lane's rays), supers and clusters
    entered, from a wrapper's (3, R, 128) ``lane_counts`` and the lanes'
    ``valid`` plane."""
    flat = lanes.reshape(3, -1, WARP)
    out = torch.stack([flat[0].sum(1), flat[0].amax(1), flat[1].sum(1),
                       flat[2].sum(1)], dim=1)
    return out[(valid.reshape(-1, WARP) > 0).any(1)]


def run(args) -> dict:
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops.baked_kernels import (
        fused_render_baked,
    )
    from wavefront_path_tracer_tpu_torch.ops.dynculled_kernels import (
        fused_render_dynculled,
    )
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    fr = _hier.frame(get_scene(args.scene), CameraController.book_one_final(),
                     dev, width=args.width, height=args.height,
                     spp=args.spp, intersector=args.intersector,
                     baked_clusters=args.clusters)
    cfg = fr.config
    planes = fused.lane_planes(fr.pix, cfg.width, cfg.tile_rows)
    salts = (0, 0, cfg.max_bounces, args.spp)
    if args.intersector == "baked":
        tables, _ = _hier.bake(fr, args.clusters)
        launch = fused_render_baked
    else:
        tables, _ = _hier.dynamic(fr, args.clusters)
        launch = fused_render_dynculled
    before = _hier.launches(tables)
    *_, stats, lanes = launch(tables, salts, fr.cam_params, *planes,
                              lane_counts=True)
    per_warp = warp_counts(lanes, planes[3]).cpu()
    stats = [int(v) for v in stats]
    hier = _hier.describe(tables)
    rays, trips, sup, clu = (int(v) for v in per_warp.sum(0))
    if [rays, trips, sup, clu] != stats:
        raise RuntimeError(f"the lanes' counters sum to {[rays, trips, sup, clu]}, "
                           f"the launch's to {stats}")
    n_sup = hier["supers"] if hier["two_level"] else 0
    n_clu = hier["clusters"]
    print(f"hierarchy: {hier['globals']} globals, {n_sup} supers swept, "
          f"{n_clu} clusters of {args.clusters} ({args.intersector}) "
          f"[{card}]", flush=True)
    print(f"warps={per_warp.shape[0]} rays={rays / 1e6:.4f}M trips: "
          f"total={trips} mean/warp={trips / per_warp.shape[0]:.1f} "
          f"[{card}]", flush=True)
    rec = {"scene": args.scene, "intersector": args.intersector,
           "cluster_size": args.clusters, "warps": per_warp.shape[0],
           "rays": rays, "iterations": trips, "supers_entered": sup,
           "clusters_entered": clu, "launches": _hier.launches(tables)
           - before, "card": card, **hier}
    if n_sup:
        rec["supers_share"] = sup / (rays * n_sup)
        print(f"supers entered: {sup} / {rays * n_sup} "
              f"({100 * rec['supers_share']:.1f}%) [{card}]", flush=True)
    if n_clu:
        rec["clusters_share"] = clu / (rays * n_clu)
        rec["lane_overhead"] = trips * WARP / rays
        print(f"clusters entered: {clu} / {rays * n_clu} "
              f"({100 * rec['clusters_share']:.1f}%; trips x {WARP} lanes "
              f"vs rays: {rec['lane_overhead']:.2f}x lane overhead) "
              f"[{card}]", flush=True)
    worst = torch.argsort(per_warp[:, 3], descending=True, stable=True)[:5]
    for w in worst.tolist():
        r, t, s, c = per_warp[w].tolist()
        print(f"  warp {w}: rays={r} trips={t} supers={s} clusters={c} "
              f"[{card}]", flush=True)
    _hier.emit(rec)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
