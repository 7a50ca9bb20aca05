"""Image-texture fidelity of the fused engine against its LUT budget (the
port of ``exp/texlut.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.texlut \
        [BUDGET ...] [--width 400] [--height 224] [--spp 64] \
        [--device cuda|cpu]

The fused engine samples an image texture from a mean-pooled LUT of at
most ``tex_lut_max`` texels with 10:10:10 RGB packing (``ops/textures.py``,
the texture step of ``csrc/common.cuh``); the megakernel samples the
full image.  For each budget (default 512, 2048, 8192, 32768) the RMSE of
the fused render, baked unculled (``baked_clusters=0``) with the texture
step, against the megakernel oracle, on a three-sphere scene whose
middle sphere wears a 256x128 texture with smooth, medium and
high-frequency content (:func:`test_texture`), from (-2, 2, 1) at (0, 0,
-1), 20 degrees, 400x224 at 64 spp and 50 bounces; and the wall seconds
of a warm ``render()`` (scene upload and the cached bake included, as in
the reference): the fidelity and cost curve behind the ``tex_lut_max``
default.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

BUDGETS = (512, 2048, 8192, 32768)


def test_texture(h: int = 128, w: int = 256) -> np.ndarray:
    """Realistically mixed content: smooth latitude gradient + medium
    'continents' (low-freq sin bands) + high-frequency grid lines."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    u /= w
    v /= h
    smooth = np.stack([0.2 + 0.6 * v, 0.3 + 0.4 * u, 0.7 - 0.4 * v], -1)
    continents = 0.25 * np.sin(6.28 * 3 * u)[..., None] * np.sin(
        6.28 * 2 * v)[..., None]
    grid = 0.15 * (((u * 32).astype(int) + (v * 16).astype(int)) % 2
                   )[..., None]
    return np.clip(smooth + continents + grid, 0.0, 1.0).astype(np.float32)


def build_scene():
    """The ground, the textured sphere and a metal sphere."""
    from wavefront_path_tracer_tpu_torch.scene.scene import SceneBuilder

    img = test_texture()
    b = SceneBuilder()
    b.sphere([0.0, -100.5, -1.0], 100.0, b.lambertian([0.4, 0.4, 0.4]))
    b.sphere([0.0, 0.0, -1.2], 0.5, b.lambertian([1.0, 1.0, 1.0],
                                                 texture=img))
    b.sphere([1.0, 0.0, -1.0], 0.5, b.metal([0.8, 0.6, 0.2], 0.05))
    return b.build()


def camera():
    """The reference's view of :func:`build_scene`."""
    from wavefront_path_tracer_tpu_torch.scene import CameraController

    cc = CameraController.book_one_final()
    cc.camera = cc.camera.look_at([-2.0, 2.0, 1.0], [0.0, 0.0, -1.0])
    cc.vfov_deg = 20.0
    cc.defocus_angle_deg = 0.0
    cc.focus_distance = 3.4
    return cc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("budgets", nargs="*", type=int, default=list(BUDGETS))
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=224)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (cuda, or cpu)")
    return ap


def run(args) -> dict:
    """{oracle_mean, rows: [{budget, rmse, seconds}]}."""
    from wavefront_path_tracer_tpu_torch.renderer import (
        render,
        resolve_device,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    device = resolve_device(args.device)
    scene = build_scene()
    cc = camera()
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp,
                       samples_per_frame=args.spp, max_bounces=50,
                       engine="megakernel", intersector="bruteforce")
    mk = render(scene, cc, cfg, device=device)
    print(f"oracle mean {mk.image.mean():.4f}")
    out = {"oracle_mean": float(mk.image.mean()), "rows": []}
    for budget in args.budgets:
        fcfg = cfg.replace(engine="fused", intersector="baked",
                           baked_clusters=0, tex_lut_max=budget)
        r = render(scene, cc, fcfg, device=device)  # build, bake
        t0 = time.perf_counter()
        r = render(scene, cc, fcfg, device=device)
        dt = time.perf_counter() - t0
        err = rmse(r.image, mk.image)
        print(f"tex_lut_max={budget:6d}: rmse {err:.2e}"
              f"  warm render {dt:.2f}s")
        out["rows"].append({"budget": budget, "rmse": err, "seconds": dt})
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
