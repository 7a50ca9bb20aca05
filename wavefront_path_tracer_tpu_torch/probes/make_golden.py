"""Render the golden oracle artifact in batches, with progress and
resume (the port of ``exp/make_golden.py``).

    GOLDEN_SPP=1000 GOLDEN_BATCH=50 \
    python -m wavefront_path_tracer_tpu_torch.probes.make_golden \
        [OUT] [--device cuda|cpu] [--compare FILE]

The gate's oracle, the megakernel with the brute-force intersector on
book_one_final at 400x225, ``GOLDEN_SPP`` samples (default 1000) and 50
bounces, rendered ``GOLDEN_BATCH`` samples a frame (default 50), with a
checkpoint after each frame, so that an interrupted run resumes where it
stopped: the accumulator goes back to the renderer's device and the run
goes on bit for bit as if it had not stopped.  The output is the npz
artifact that ``validate --oracle-cache`` reads (its image, metadata and
platform).  Two departures from the reference: the render runs on the
card unless ``--device`` names another (the reference forces the CPU,
where the committed golden was made; the card's render is another float
evaluation of the same streams, within the golden gate of it), and
nothing is written under ``golden/``: the default OUT is
``build/golden/oracle_book_400x225_1000spp.npz``, and the checkpoint
lives in ``build/make_golden/`` under a name made from OUT's path, with
its samples, batch, size and device checked on resume.  ``--compare
FILE`` prints the display RMSE of the new image against another
artifact's, such as the committed golden.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPP = int(os.environ.get("GOLDEN_SPP", "1000"))
BATCH = int(os.environ.get("GOLDEN_BATCH", "50"))
SCENE, WIDTH, HEIGHT, BOUNCES = "book_one_final", 400, 225, 50
OUT = os.path.join(ROOT, "build", "golden",
                   "oracle_book_400x225_1000spp.npz")
CKPT_DIR = os.path.join(ROOT, "build", "make_golden")
GOLDEN_DIR = os.path.join(ROOT, "golden")


def checkpoint_path(out: str) -> str:
    """The checkpoint of a render to ``out``: in :data:`CKPT_DIR`, named
    by ``out``'s absolute path."""
    name = os.path.abspath(out).strip(os.sep).replace(os.sep, "__")
    return os.path.join(CKPT_DIR, name + ".ckpt.npz")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=OUT,
                    help="the artifact to write (not under golden/)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (cuda, or cpu)")
    ap.add_argument("--compare", default=None,
                    help="an artifact (e.g. the committed golden) to print "
                         "the display RMSE of the new image against")
    return ap


def run(args) -> dict:
    """Render (or resume) and write the artifact; {out, spp, seconds,
    resumed_at, and with ``--compare`` rmse}."""
    import torch

    from wavefront_path_tracer_tpu_torch.renderer import (
        Renderer,
        resolve_device,
    )
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import (
        load_checkpoint,
        rmse,
        save_checkpoint,
    )

    out = args.out
    golden = os.path.realpath(GOLDEN_DIR)
    if os.path.commonpath([os.path.realpath(out), golden]) == golden:
        raise SystemExit(f"{out}: make_golden writes nothing under golden/")
    device = resolve_device(args.device)
    ckpt = checkpoint_path(out)
    ckpt_meta = {"spp": SPP, "batch": BATCH, "size": f"{WIDTH}x{HEIGHT}",
                 "bounces": BOUNCES, "device": device.type}
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=SPP,
                       samples_per_frame=BATCH, max_bounces=BOUNCES,
                       engine="megakernel", intersector="bruteforce")
    scene = get_scene(SCENE)
    cc = CameraController.book_one_final()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    os.makedirs(CKPT_DIR, exist_ok=True)
    r = Renderer(scene, cc, cfg, device=device)
    resumed_at = 0
    if os.path.exists(ckpt):
        acc, samples, frame = load_checkpoint(ckpt, expect_meta=ckpt_meta)
        r._accum = torch.from_numpy(
            np.asarray(acc, np.float32).reshape(-1, 3)).to(device)
        r.progress.accumulated_samples = samples
        r.progress.frame = frame
        resumed_at = samples
        print(f"resumed at {samples} spp", flush=True)
    t0 = time.time()
    image = None
    while True:
        res = r.render_frame()
        if res is None:
            break
        save_checkpoint(ckpt, r._accum.cpu().numpy(),
                        r.progress.accumulated_samples, r.progress.frame,
                        meta=ckpt_meta)
        el = time.time() - t0
        done = r.progress.accumulated_samples
        print(f"{done}/{SPP} spp  {el:.0f}s  ({res.mrays_per_s:.2f} Mrays/s)",
              flush=True)
        image = res.image
    if image is None:          # a checkpoint that had every sample
        image = np.sqrt(np.clip(r._accum.cpu().numpy().reshape(
            cfg.height, cfg.width, 3) / SPP, 0.0, None))

    meta = {"scene": SCENE, "width": WIDTH, "height": HEIGHT,
            "spp": SPP, "max_bounces": BOUNCES, "engine": "megakernel",
            "intersector": "bruteforce"}
    np.savez_compressed(out, image=np.asarray(image),
                        meta=np.asarray(json.dumps(meta)),
                        platform=np.asarray(device.type))
    os.remove(ckpt)
    print(f"wrote {out}", flush=True)
    rec = {"out": out, "spp": SPP, "seconds": time.time() - t0,
           "resumed_at": resumed_at}
    if args.compare:
        rec["rmse"] = rmse(image, np.load(args.compare)["image"])
        print(f"display RMSE against {args.compare}: {rec['rmse']:.4e}",
              flush=True)
    return rec


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
