"""Turntable animation: orbit the camera around a scene and write a GIF
(the port of ``examples/turntable.py``).

    python -m wavefront_path_tracer_tpu_torch.examples.turntable \
        --scene book_cover --frames 24 --width 320 --height 180 \
        --spp 64 --out turntable.gif [--device cuda|cpu]

Camera parameters are inputs of every engine, so moving the camera
renders again without building anything again (the reference's
interactive camera, in batch form).  Frame k looks at ``--center`` from
the orbit point at angle 2 pi k / frames, ``--radius`` out and
``--elevation`` up, at ``--vfov`` degrees without defocus; each frame is
one ``render()`` of 16 bounces (by default the fused engine over the
unculled bake, one kernel launch a frame).  A line a frame gives its
wall seconds (the scene's upload and the cached bake included, as in
the reference) and Mrays/s; a last line the mean, least and most seconds
of the frames after the first (the first also loads the kernels' library
on the card).

The GIF is written by ``utils/image.py`` ``write_gif`` (no Pillow: a
GIF89a of 256-colour frames, LZW, the loop extension, ``--ms-per-frame``
a frame).  Its quantiser is a median cut of its own, so a frame's
palette differs from the one Pillow's writer would choose.
"""

from __future__ import annotations

import argparse
import math
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="book_cover")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--engine", default="fused")
    p.add_argument("--intersector", default="baked")
    p.add_argument("--clusters", type=int, default=0)
    p.add_argument("--radius", type=float, default=3.0)
    p.add_argument("--elevation", type=float, default=1.2)
    p.add_argument("--center", type=float, nargs=3, default=[0.0, 0.0, -1.0])
    p.add_argument("--vfov", type=float, default=40.0)
    p.add_argument("--out", default="turntable.gif")
    p.add_argument("--ms-per-frame", type=int, default=80)
    p.add_argument("--device", default="cuda",
                   help="torch device of the renders (cuda, or cpu)")
    return p


def orbit_camera(args, k: int):
    """Frame ``k``'s camera on the orbit."""
    from wavefront_path_tracer_tpu_torch.scene import CameraController

    cx, cy, cz = args.center
    th = 2.0 * math.pi * k / args.frames
    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at(
        [cx + args.radius * math.cos(th), cy + args.elevation,
         cz + args.radius * math.sin(th)], [cx, cy, cz])
    cc.vfov_deg = args.vfov
    cc.defocus_angle_deg = 0.0
    return cc


def run(args) -> dict:
    """Render the orbit and write the GIF; {out, seconds (a frame each),
    mrays_per_s, frames: the (H, W, 3) uint8 frames, quantised: each
    frame's (palette, index) as written}."""
    from wavefront_path_tracer_tpu_torch.renderer import (
        render,
        resolve_device,
    )
    from wavefront_path_tracer_tpu_torch.scene import get_scene
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import to_u8, write_gif

    device = resolve_device(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       samples_per_frame=args.spp, max_bounces=16,
                       engine=args.engine, intersector=args.intersector,
                       baked_clusters=args.clusters)
    scene = get_scene(args.scene)
    frames, seconds, rates = [], [], []
    for k in range(args.frames):
        cc = orbit_camera(args, k)
        t0 = time.perf_counter()
        r = render(scene, cc, cfg, device=device)
        dt = time.perf_counter() - t0
        frames.append(to_u8(r.image))
        seconds.append(dt)
        rates.append(r.mrays_per_s)
        print(f"frame {k + 1}/{args.frames}: {dt:.2f}s "
              f"({r.mrays_per_s:.0f} Mrays/s)", flush=True)

    quantised = write_gif(args.out, frames, args.ms_per_frame, loop=0)
    print(f"wrote {args.out}: {args.frames} frames "
          f"{args.width}x{args.height} @ {args.spp} spp")
    if len(seconds) > 1:
        later = seconds[1:]
        print(f"frames after the first: {sum(later) / len(later):.6f} s "
              f"mean, {min(later):.6f}-{max(later):.6f} s; the first "
              f"{seconds[0]:.3f} s")
    return {"out": args.out, "seconds": seconds, "mrays_per_s": rates,
            "frames": frames, "quantised": quantised}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
