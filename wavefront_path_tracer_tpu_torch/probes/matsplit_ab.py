"""material_split A/B of the wavefront engine (the port of
``exp/matsplit_ab.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.matsplit_ab \
        [width height spp reps] [--device cuda|cpu]

The wavefront engine can partition the shade queue by the material each
lane is about to shade (the extend winner), so that the shade stage runs
over contiguous same-material segments: on a SIMT card that buys
coherence, if the split pays for its sort.  A/B: wavefront/bruteforce on
cornell_spheres (65 spheres, heavy dielectric and metal mix) and
book_one_final, each from the CLI's view for the scene, material_split
off and on, the same streams (bit-identical radiance by construction:
the A/B RMSE must print exactly 0.0).  Each setting renders once warm,
then ``reps`` times timed (wall seconds between
``torch.cuda.synchronize()`` calls, averaged); its Mrays/s are the rays
counted over that time.  Defaults: 400x224, 16 spp, 3 reps, 50 bounces.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

SCENES = ("cornell_spheres", "book_one_final")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("width", 400), ("height", 224), ("spp", 16),
                          ("reps", 3)):
        ap.add_argument(name, nargs="?", type=int, default=default)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renders (cuda, or cpu)")
    return ap


def bench_one(scene_name: str, w: int, h: int, spp: int, reps: int,
              device) -> dict:
    """Both settings on one scene: {scene, mrays_per_s: {False, True},
    seconds: {...}, rmse, ratio (split / no split)}."""
    import torch

    from wavefront_path_tracer_tpu_torch.renderer import render
    from wavefront_path_tracer_tpu_torch.scene import (
        SCENE_CAMERAS,
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    scene = get_scene(scene_name)
    cc = CameraController.book_one_final()
    view = SCENE_CAMERAS.get(scene_name)
    if view:  # the per-scene default view the CLI applies
        cc.camera = cc.camera.look_at(view["look_from"], view["look_at"])
        cc.vfov_deg = float(view["vfov"])
        cc.defocus_angle_deg = float(view["defocus_angle"])
    rows, seconds = {}, {}
    for split in (False, True):
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           samples_per_frame=spp, max_bounces=50,
                           engine="wavefront", intersector="bruteforce",
                           material_split=split)
        res = render(scene, cc, cfg, device=device)  # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = render(scene, cc, cfg, device=device)
        sync()
        dt = (time.perf_counter() - t0) / reps
        mrays = res.rays_traced / dt / 1e6
        rows[split] = (mrays, np.asarray(res.image))
        seconds[split] = dt
        print(f"{scene_name:16s} material_split={split!s:5s}: "
              f"{mrays:7.2f} Mrays/s  ({dt:.2f}s/render)", flush=True)
    err = rmse(rows[False][1], rows[True][1])
    ratio = rows[True][0] / rows[False][0]
    print(f"{scene_name:16s} A/B rmse {err:.2e} "
          f"(must be 0.0: bit-identical by construction)  "
          f"split/nosplit = {ratio:.3f}x", flush=True)
    return {"scene": scene_name, "rmse": err, "ratio": ratio,
            "mrays_per_s": {str(k): v[0] for k, v in rows.items()},
            "seconds": {str(k): v for k, v in seconds.items()}}


def run(args) -> list[dict]:
    from wavefront_path_tracer_tpu_torch.renderer import resolve_device

    device = resolve_device(args.device)
    return [bench_one(name, args.width, args.height, args.spp, args.reps,
                      device) for name in SCENES]


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
