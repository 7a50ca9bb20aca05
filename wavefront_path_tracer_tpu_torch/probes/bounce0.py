"""The headroom of a bake-time frustum shortlist at bounce 0 (the port of
``exp/bounce0.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.bounce0 \
        [--scene book_one_final] [--width 256] [--height 128] [--spp 4] \
        [--clusters 16] [--block-tiles 32] [--device cuda|cpu]

The lever: at bake time, intersect each pixel block's primary-ray
frustum with the cluster boxes and keep a static shortlist a block, so
that primary rays sweep with no cond at run time.  This compares, on one
render at ``max_bounces=1`` (every ray is a bounce-0 ray) through the
baked culled kernel (block order, the book's camera):

* **measured**: the clusters the kernel's cull enters at bounce 0, from
  the counters each lane keeps (``fused_render_baked(...,
  lane_counts=True)``), summed a warp at a time;
* **shortlist**: the smallest correct static list, per group of lanes
  every cluster some primary ray of the group hits inside the slab
  (:func:`slab_entries`), united over the samples' jitter, since a
  static list must cover every sample.

A static list cannot know the running nearest hit, while the cull enters
a cluster only where it can still improve the ray's hit, so the list is
at least the frustum-visible set.  Where it asks for at least the
entries the cull makes, its whole value is the cond pass it deletes
(the stage table's "extend: cull conds" row).

The departure from the reference: its counters were a 1024-lane tile's,
a consensus entry for the whole tile in lockstep, and its shortlist a
32x32 block's.  The card culls per thread, with a warp vote a cluster,
and has no tile consensus.  So the entries are the lanes' own, read a
warp of 32 lanes at a time, and the shortlist is computed at that same
granularity (each lane of a warp would test every cluster on its warp's
list: the list's lane tests are compared with the lanes' entries); the
reference's 32x32-block shortlist is printed beside it.
"""

from __future__ import annotations

import argparse

import numpy as np

from wavefront_path_tracer_tpu_torch.ops.bake import T_MIN
from wavefront_path_tracer_tpu_torch.probes import _hier, _slope, cullstats

WARP = 32
BLOCK = 1024               # a 32x32 pixel block in block order
CHUNK = 65536              # rays a slab test at a time


def slab_entries(o, d, boxes):
    """(rays, boxes) bool: ray hits box at positive t (slab method),
    the bake-time-computable half of the kernel's cluster cond."""
    inv = 1.0 / d  # (N, 3)
    lo = boxes[:, 0][None]  # (1, B, 3)
    hi = boxes[:, 1][None]
    t0 = (lo - o[:, None]) * inv[:, None]
    t1 = (hi - o[:, None]) * inv[:, None]
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    return (tmin <= tmax) & (tmax > T_MIN)


def shortlist(rays, boxes, lanes: int):
    """The static shortlists of groups of ``lanes`` consecutive rays in
    lane order, from ``rays``, a list over samples of (origins,
    directions), each (P, 3): (union (G, B) bool, the clusters each
    group's rays hit in any sample; visible (G,) float, the mean over
    samples of the clusters the group hits in that sample)."""
    n_rays = rays[0][0].shape[0]
    groups = -(-n_rays // lanes)
    union = np.zeros((groups, boxes.shape[0]), bool)
    visible = np.zeros(groups, np.float64)
    step = max(lanes, CHUNK // lanes * lanes)
    for o, d in rays:
        for start in range(0, n_rays, step):
            hit = slab_entries(o[start:start + step], d[start:start + step],
                               boxes)
            pad = -hit.shape[0] % lanes
            hit = np.concatenate([hit, np.zeros((pad, hit.shape[1]), bool)])
            blk = hit.reshape(-1, lanes, hit.shape[1]).any(axis=1)
            g = start // lanes
            union[g:g + blk.shape[0]] |= blk
            visible[g:g + blk.shape[0]] += blk.sum(axis=1) / len(rays)
    return union, visible


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="book_one_final")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--block-tiles", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    return ap


def run(args) -> dict:
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops.baked_kernels import (
        fused_render_baked,
    )
    from wavefront_path_tracer_tpu_torch.ops.raygen import generate_rays
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    fr = _hier.frame(get_scene(args.scene), CameraController.book_one_final(),
                     dev, width=args.width, height=args.height,
                     spp=args.spp, intersector="baked",
                     baked_clusters=args.clusters,
                     block_tiles=args.block_tiles, max_bounces=1)
    cfg = fr.config
    tables, _ = _hier.bake(fr, args.clusters)
    boxes = np.asarray([[b[0], b[1]] for b in tables.cluster_aabbs],
                       np.float32).reshape(-1, 2, 3)     # (B, 2, 3)
    n_clu = boxes.shape[0]
    print(f"hierarchy: {n_clu} clusters of {args.clusters} "
          f"(+{tables.n_globals} globals swept unconditionally) [{card}]",
          flush=True)

    # --- measured: the lanes' cluster entries at bounce 0 ------------
    planes = fused.lane_planes(fr.pix, cfg.width, cfg.tile_rows)
    before = _hier.launches(tables)
    *_, stats, lanes = fused_render_baked(
        tables, (0, 0, cfg.max_bounces, args.spp), fr.cam_params, *planes,
        lane_counts=True)
    per_warp = cullstats.warp_counts(lanes, planes[3]).cpu().numpy()
    rays, trips, _sup, entered = (int(v) for v in per_warp.sum(0))
    n_warps = per_warp.shape[0]
    print(f"measured (per-lane cull @ bounce 0): {entered} entries by "
          f"{rays} rays over {trips} trips / {n_warps} warps -> "
          f"{entered / max(rays, 1):.2f} clusters/ray, "
          f"{entered / max(trips, 1):.2f} lane entries/warp trip [{card}]",
          flush=True)

    # --- bake-time shortlist: frustum-visible set per group -----------
    samples = []
    for s in range(args.spp):
        o, d = generate_rays(fr.pix, cfg.width, cfg.height, 0, s,
                             fr.cc.gpu_camera(), fr.cc.view_matrix(),
                             fr.cc.inverse_projection(cfg.width, cfg.height))
        samples.append((o.cpu().numpy().astype(np.float64),
                        d.cpu().numpy().astype(np.float64)))
    union_w, visible_w = shortlist(samples, boxes, WARP)
    union_b, visible_b = shortlist(samples, boxes, BLOCK)
    n_blocks = union_b.shape[0]
    print(f"frustum-visible (per-sample mean): warps {visible_w.sum():.1f} "
          f"entries ({visible_w.sum() / n_warps:.2f}/warp); 32x32 blocks "
          f"{visible_b.sum():.1f} ({visible_b.sum() / n_blocks:.2f}/block)")
    print(f"bake-time shortlist (union over jitter): warps "
          f"{union_w.sum():.0f} entries/sample-iteration "
          f"({union_w.sum() / n_warps:.2f}/warp); 32x32 blocks "
          f"{union_b.sum():.0f} ({union_b.sum() / n_blocks:.2f}/block)")

    # One ray a lane a sample at max_bounces=1: per-sample totals compare.
    valid = planes[3].reshape(-1, WARP).sum(1).cpu().numpy()[:n_warps]
    meas_per_sample = entered / args.spp
    lane_tests = float((valid * union_w.sum(axis=1)).sum())
    print(f"\nper-sample lane entries at bounce 0: per-lane cull "
          f"{meas_per_sample:.1f} vs static warp shortlist "
          f"{lane_tests:.1f} ({lane_tests / max(meas_per_sample, 1e-9):.2f}x)"
          f" [{card}]")
    if lane_tests >= meas_per_sample:
        print("-> the static shortlist tests AT LEAST as many clusters as "
              "the cull already enters; the lever's value is bounded by "
              "the deleted cond pass.")
    rec = {"scene": args.scene, "clusters": n_clu,
           "globals": tables.n_globals, "rays": rays, "trips": trips,
           "warps": n_warps, "entries": entered,
           "stats": [int(v) for v in stats],
           "visible_per_sample_warps": float(visible_w.sum()),
           "visible_per_sample_blocks": float(visible_b.sum()),
           "shortlist_warps": int(union_w.sum()),
           "shortlist_blocks": int(union_b.sum()), "blocks": n_blocks,
           "entries_per_sample": meas_per_sample,
           "shortlist_lane_tests_per_sample": lane_tests,
           "launches": _hier.launches(tables) - before, "card": card}
    _hier.emit(rec)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
