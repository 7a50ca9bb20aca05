"""The firefly clamp's bias (the port of ``exp/clamp_bias.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.clamp_bias \
        [--spp 256] [--width 160] [--height 90] [--rr 0] \
        [--device cuda|cpu]

``--clamp`` is a biased control of variance; this measures what each
level costs in mean radiance and in display-image RMSE on book_cover
(the reference's camera: from (-2, 2, 1) at (0, 0, -1), 35 degrees, no
defocus), through the megakernel oracle with the brute-force intersector
at 50 bounces, 64 samples a frame: the unclamped render, then clamps 4,
2, 1, 0.5 and 0.25, one line each.  The reference forces the CPU; the
port renders on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse

LEVELS = (4.0, 2.0, 1.0, 0.5, 0.25)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=90)
    ap.add_argument("--rr", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (cuda, or cpu)")
    return ap


def camera():
    """book_cover's view in the reference's clamp_bias."""
    from wavefront_path_tracer_tpu_torch.scene import CameraController

    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 35.0
    cc.defocus_angle_deg = 0.0
    return cc


def run(args) -> list[dict]:
    """[{clamp, mean_drop, display_rmse}] of each level, printed as the
    reference's table."""
    from wavefront_path_tracer_tpu_torch.renderer import (
        render,
        resolve_device,
    )
    from wavefront_path_tracer_tpu_torch.scene import book_cover
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    device = resolve_device(args.device)
    cc = camera()
    scene = book_cover()

    def run_one(clamp):
        cfg = RenderConfig(width=args.width, height=args.height,
                           samples_per_pixel=args.spp,
                           samples_per_frame=min(args.spp, 64),
                           max_bounces=50, engine="megakernel",
                           intersector="bruteforce", clamp=clamp,
                           rr_start_bounce=args.rr)
        return render(scene, cc, cfg, device=device)

    ref = run_one(0.0)
    print(f"{'clamp':>7} {'mean drop':>10} {'display RMSE':>13}")
    out = []
    for c in LEVELS:
        r = run_one(c)
        drop = 1.0 - r.accumulated.mean() / ref.accumulated.mean()
        err = rmse(r.image, ref.image)
        print(f"{c:>7.2f} {100 * drop:>9.2f}% {err:>13.2e}")
        out.append({"clamp": c, "mean_drop": float(drop),
                    "display_rmse": err})
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
