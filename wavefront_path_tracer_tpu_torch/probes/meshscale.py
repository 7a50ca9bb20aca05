"""Where the dynamic culled path's time goes as the triangle count grows
(the port of ``exp/meshscale.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.meshscale \
        [TRIS ...] [--width 256] [--height 128] [--spp 4] \
        [--bounces 8] [--clusters 16] [--reps 3] [--device cuda|cpu]

For each triangle count (default 2,000 and 8,000) the torus knot of
``scene/mesh.py`` (``knot_scene``: a ground sphere under the knot) is
rendered through ``Renderer``'s fused engine, brute force with clusters
(the dynamic culled kernel), from the knot's view at 256x128, 4 spp, 8
bounces.  Cold is split where the reference's was one compile: the
tables (``ops/dyn_tables.py``, host), the kernels' build (once a
process, 0 where the library was built before) and the first launch;
warm is the least of ``--reps`` renders after it.  A line each with the
triangles, clusters, the cold parts, warm seconds and Mrays/s (the
rays the kernel counted, where the reference estimated them) and the
card's name and power limit, then its JSON record.
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tris", nargs="*", type=int, default=[2000, 8000])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=16)
    _hier.add_device_args(ap)
    return ap


def run(args) -> list[dict]:
    from wavefront_path_tracer_tpu_torch.models import fused
    from wavefront_path_tracer_tpu_torch.ops import dynculled_kernels as dk
    from wavefront_path_tracer_tpu_torch.renderer import Renderer
    from wavefront_path_tracer_tpu_torch.scene import knot_camera, knot_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    cc = knot_camera()
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       samples_per_frame=args.spp,
                       max_bounces=args.bounces, engine="fused",
                       intersector="bruteforce",
                       baked_clusters=args.clusters)
    out = []
    for tris in args.tris:
        scene, triangles = knot_scene(tris)
        r = Renderer(scene, cc, cfg, triangles, device=dev)
        tab, table_s = _hier.timed(lambda: fused._dyn_tables(
            r.scene_arrays, args.clusters,
            camera_pos=fused._concrete_eye(cc.view_matrix())), dev)
        build_s = _hier.build_seconds(dev)
        before = dk.LAUNCHES
        _, first_s = _hier.timed(r.render, dev)
        warm = float("inf")
        for _ in range(args.reps):
            r.reset_accumulation()
            res, seconds = _hier.timed(r.render, dev)
            warm = min(warm, seconds)
        n_t = triangles.num_triangles
        rec = {"tris": n_t, "clusters": tab.n_tri_clusters,
               "supers": tab.n_tri_supers, "table_seconds": table_s,
               "build_seconds": build_s, "first_seconds": first_s,
               "cold_seconds": table_s + build_s + first_s,
               "warm_seconds": warm, "rays": res.rays_traced,
               "mrays_per_s": res.rays_traced / warm / 1e6,
               "launches": dk.LAUNCHES - before, "card": card}
        print(f"tris={n_t:6d} clusters={tab.n_tri_clusters:5d} "
              f"supers={tab.n_tri_supers:4d}  cold {rec['cold_seconds']:.3f} s "
              f"(tables {table_s:.3f}, build {build_s:.3f}, first "
              f"{first_s:.4f})  warm {warm:.4f} s  "
              f"{rec['mrays_per_s']:.2f} Mrays/s warm [{card}]", flush=True)
        _hier.emit(rec)
        out.append(rec)
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
