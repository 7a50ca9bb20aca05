"""Command-line renderer for the PyTorch port.

A subset of ``python -m wavefront_path_tracer_tpu.cli``: the fused engine
with the brute-force intersector, on a torch device.  Flags of the
reference CLI that this port does not carry yet are refused with the
ROADMAP.md item that will bring them.

Example::

    python -m wavefront_path_tracer_tpu_torch.cli --device cuda \\
        --scene book_one_final --width 1920 --height 1080 --spp 32 \\
        --spf 32 --out render.png
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# Reference-CLI flags this slice refuses: flag -> (dest, ROADMAP item).
_REFUSED = {
    "--clusters": ("clusters", "queue 2 item 3 (dynamic culled intersect)"),
    "--recluster": ("recluster", "queue 2 item 6 (recluster segments)"),
    "--winner-hint": ("winner_hint", "queue 2 item 2 (baked culled "
                                     "intersect)"),
    "--obj": ("obj", "queue 2 item 3 (triangle meshes)"),
    "--scene-file": ("scene_file", "queue 1 item 9 (cli and app layer)"),
    "--tex-lut": ("tex_lut", "queue 2 item 5 (textures)"),
    "--serve": ("serve", "queue 1 item 9 (preview server)"),
    "--interactive": ("interactive", "queue 1 item 9 (app layer)"),
    "--aov": ("aov", "queue 1 item 9 (aov.py)"),
}
_REFUSED_INTERSECTORS = {
    "baked": "queue 2 items 2 and 4 (baked intersects)",
    "auto": "queue 2 items 2 and 3 (the intersects auto picks from)",
    "bvh": "queue 1 item 8 (BVH traversal on the XLA-style engines)",
}
_REFUSED_SCENES = {
    "mesh_demo": "queue 2 item 3 (triangle meshes)",
    "mesh_terrain": "queue 2 item 3 (triangle meshes)",
    "book_checker": "queue 2 item 5 (textures)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wavefront_path_tracer_tpu_torch",
        description="Path tracer, PyTorch/CUDA port (fused engine)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; there "
                        "is no fallback to the CPU)")
    p.add_argument("--scene", default="book_one_final",
                   help="book_cover | book_one_final | book_bubble | "
                        "procedural | cornell_spheres")
    p.add_argument("--scene-seed", type=int, default=42)
    p.add_argument("--spheres", type=int, default=10000,
                   help="sphere count for --scene procedural")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=225)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument("--spf", type=int, default=1, help="samples per frame batch")
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--frame", type=int, default=0, help="RNG frame salt")
    p.add_argument("--intersector", default="bruteforce",
                   choices=["bruteforce", "bvh", "baked", "auto"],
                   help="only bruteforce is ported")
    p.add_argument("--sampler", default="random",
                   choices=("random", "stratified"))
    p.add_argument("--rr", type=int, default=0, metavar="BOUNCE",
                   help="Russian roulette from this surface event (0 = off)")
    p.add_argument("--rr-floor", type=float, default=0.05, metavar="P")
    p.add_argument("--clamp", type=float, default=0.0,
                   help="per-sample radiance clamp (0 = off)")
    p.add_argument("--block-tiles", type=int, default=32,
                   help="NxN pixel blocks per lane group (0 = linear order)")
    p.add_argument("--look-from", type=float, nargs=3, default=None)
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--vfov", type=float, default=None)
    p.add_argument("--defocus-angle", type=float, default=None)
    p.add_argument("--focus-distance", default=None,
                   help="thin-lens focus distance, or 'auto'")
    p.add_argument("--out", default="render.png")
    p.add_argument("--quiet", action="store_true")
    # Refused: parsed so the refusal can name what will bring them.
    p.add_argument("--clusters", default=None, help=argparse.SUPPRESS)
    p.add_argument("--recluster", default=None, help=argparse.SUPPRESS)
    p.add_argument("--winner-hint", action="store_true", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--obj", default=None, help=argparse.SUPPRESS)
    p.add_argument("--scene-file", default=None, help=argparse.SUPPRESS)
    p.add_argument("--tex-lut", default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve", default=None, help=argparse.SUPPRESS)
    p.add_argument("--interactive", action="store_true", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--aov", default=None, help=argparse.SUPPRESS)
    return p


def check_args(args) -> None:
    """Raise NotImplementedError for what this slice does not carry."""
    for flag, (dest, item) in _REFUSED.items():
        value = getattr(args, dest)
        if value is not None and not (flag == "--clusters"
                                      and str(value) == "0"):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md {item})")
    if args.intersector in _REFUSED_INTERSECTORS:
        raise NotImplementedError(
            f"--intersector {args.intersector} is not ported yet (ROADMAP.md "
            f"{_REFUSED_INTERSECTORS[args.intersector]}); use bruteforce")
    if args.scene in _REFUSED_SCENES:
        raise NotImplementedError(
            f"--scene {args.scene} is not ported yet (ROADMAP.md "
            f"{_REFUSED_SCENES[args.scene]})")


def build_camera(args):
    """The reference CLI's camera: explicit flag > the named scene's
    default view > the reference camera (cli.py:290-322)."""
    from wavefront_path_tracer_tpu_torch.scene import (
        SCENE_CAMERAS,
        CameraController,
    )

    scene_cam = SCENE_CAMERAS.get(args.scene, {})
    ref_cam = {"look_from": [13.0, 2.0, 3.0], "look_at": [0.0, 0.0, 0.0],
               "vfov": 20.0, "defocus_angle": 0.6}

    def cam_field(name, cli_value):
        if cli_value is not None:
            return cli_value
        for layer in (scene_cam, ref_cam):
            if name in layer:
                return layer[name]
        return None

    look_from = cam_field("look_from", args.look_from)
    look_at = cam_field("look_at", args.look_at)
    focus = (args.focus_distance if args.focus_distance is not None
             else scene_cam.get("focus_distance", 10.0))
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at(look_from, look_at)
    cc.vfov_deg = float(cam_field("vfov", args.vfov))
    cc.defocus_angle_deg = float(cam_field("defocus_angle",
                                           args.defocus_angle))
    if str(focus).lower() == "auto":
        cc.focus_distance = float(np.linalg.norm(
            np.asarray(look_at, np.float64)
            - np.asarray(look_from, np.float64)))
    else:
        cc.focus_distance = float(focus)
    return cc


def build_scene(args):
    from wavefront_path_tracer_tpu_torch.scene import get_scene

    kwargs = {}
    if args.scene == "book_one_final":
        kwargs["seed"] = args.scene_seed
    elif args.scene == "procedural":
        kwargs = {"n": args.spheres, "seed": args.scene_seed}
    return get_scene(args.scene, **kwargs)


def run(argv=None):
    """Parse, render and write the PNG; returns (renderer, last result).
    Raises NotImplementedError for refused flags."""
    args = build_parser().parse_args(argv)
    check_args(args)

    from wavefront_path_tracer_tpu_torch.renderer import Renderer
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import (
        display_transform,
        write_png,
    )

    cfg = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, samples_per_frame=args.spf,
        max_bounces=args.max_bounces, frame=args.frame,
        engine="fused", intersector=args.intersector,
        block_tiles=args.block_tiles, sampler=args.sampler,
        rr_start_bounce=args.rr, rr_floor=args.rr_floor, clamp=args.clamp,
    )
    renderer = Renderer(build_scene(args), build_camera(args), cfg,
                        device=args.device)
    t_start = time.perf_counter()
    rays = 0.0
    busy = 0.0
    result = None
    while True:
        r = renderer.render_frame()
        if r is None:
            break
        result = r
        rays += r.rays_traced
        busy += r.wall_time_s
        if not args.quiet:
            print(f"{r.samples}/{cfg.samples_per_pixel} spp  "
                  f"{r.mrays_per_s:8.1f} Mrays/s", file=sys.stderr)
    if result is None:
        raise ValueError("nothing to render: --spp must be positive")
    write_png(args.out, display_transform(result.accumulated, result.samples))
    if not args.quiet:
        total = time.perf_counter() - t_start
        print(f"wrote {args.out}: {cfg.width}x{cfg.height} @ "
              f"{result.samples} spp in {total:.2f}s on {renderer.device} "
              f"({rays / max(busy, 1e-9) / 1e6:.1f} Mrays/s)",
              file=sys.stderr)
    return renderer, result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        sys.exit(2)
