"""Correctness gate: display RMSE between an engine under test and the
megakernel oracle.

Port of ``wavefront_path_tracer_tpu/validate.py``, with the same flags,
the same JSON line and the same exit code, on torch devices:
``--device``, ``--test-device`` and ``--oracle-device`` take the place of
the reference's ``--platform``, ``--test-platform`` and
``--oracle-platform`` (default ``cuda``; there is no fallback to the
CPU).  A golden artifact (``--oracle-cache``) holds the oracle's display
image with its metadata; one whose metadata differs from the gate's is
refused.  The committed ``golden/*.npz`` artifacts load as they are.

    # gate the fused engine against the committed 1000-spp golden image
    python -m wavefront_path_tracer_tpu_torch.validate --spp 1000 \\
        --engine fused --intersector baked --clusters 16 \\
        --oracle-cache golden/oracle_book_400x225_1000spp.npz

    # same-stream gate: both engines on the card, equal spp
    python -m wavefront_path_tracer_tpu_torch.validate --width 400 \\
        --height 224 --spp 64 --gate 2e-3 --oracle-spf 64 \\
        --engine fused --intersector baked --clusters 16

Exit code 0 iff RMSE < --gate (default 1e-3).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

def _oracle_meta(args) -> dict:
    meta = {
        "scene": args.scene, "width": args.width, "height": args.height,
        "spp": args.spp, "max_bounces": args.max_bounces,
        "engine": args.oracle_engine, "intersector": args.oracle_intersector,
    }
    # Recorded only when not the default, so that artifacts written
    # before the key existed stay valid.
    sampler = _oracle_sampler(args)
    if sampler != "random":
        meta["sampler"] = sampler
    return meta


def _oracle_sampler(args) -> str:
    """The oracle's AA sampler: the test sampler unless
    ``--oracle-sampler`` names another.  A same-stream gate needs both
    engines to integrate with the same estimator, so that the Monte
    Carlo noise cancels; a different oracle sampler makes it a bias gate
    that floors at the noise."""
    return args.oracle_sampler or args.sampler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wavefront_path_tracer_tpu_torch.validate",
        description="Display RMSE of an engine against the megakernel "
                    "oracle (PyTorch port)")
    p.add_argument("--scene", default="book_one_final")
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=225)
    p.add_argument("--spp", type=int, default=100)
    p.add_argument("--max-bounces", type=int, default=50)
    p.add_argument("--engine", default="fused",
                   help="fused | megakernel | wavefront")
    p.add_argument("--intersector", default="baked")
    p.add_argument("--clusters", type=int, default=0)
    p.add_argument("--rr", type=int, default=0,
                   help="Russian roulette start bounce for the engine "
                        "under test (0 = off)")
    p.add_argument("--rr-floor", type=float, default=0.05,
                   help="roulette survival floor for the engine under test")
    p.add_argument("--winner-hint", action="store_true",
                   help="fused/baked: winner-cluster shortlist prepass")
    p.add_argument("--lane-split", type=int, default=1,
                   help="fused: sample budget split over K duplicate lanes")
    p.add_argument("--rotate-cols", type=int, default=1,
                   help="fused: column phases for per-sample lane rotation")
    p.add_argument("--recluster", type=int, default=0,
                   help="fused: ray-coherence re-clustering segment length")
    p.add_argument("--material-split", action="store_true",
                   help="wavefront: partition the shade queue by "
                        "material")
    p.add_argument("--sampler", default="random",
                   help="AA sampler for the engine under test "
                        "(random | stratified)")
    p.add_argument("--tex-lut", type=int, default=None,
                   help="fused: image-texture LUT texel budget (default: "
                        "the RenderConfig default)")
    p.add_argument("--test-device", default=None,
                   help="torch device for the engine under test "
                        "(default: --device)")
    p.add_argument("--oracle-engine", default="megakernel")
    p.add_argument("--oracle-intersector", default="bruteforce")
    p.add_argument("--oracle-sampler", default=None,
                   help="AA sampler for the oracle render (default: the "
                        "--sampler value, so that same-stream gates "
                        "compare equal estimators)")
    p.add_argument("--oracle-device", default=None,
                   help="torch device for the oracle render (default: "
                        "--device)")
    p.add_argument("--oracle-spf", type=int, default=10,
                   help="oracle samples per frame")
    p.add_argument("--oracle-cache", default=None,
                   help="npz golden artifact: loaded if present (metadata "
                        "checked), else the oracle render is saved to it")
    p.add_argument("--oracle-only", action="store_true",
                   help="produce or refresh the golden artifact and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device for both renders (default cuda)")
    p.add_argument("--gate", type=float, default=1e-3)
    p.add_argument("--save-prefix", default=None,
                   help="write <prefix>_test.png / <prefix>_oracle.png")
    return p


def run(argv=None) -> dict:
    """Parse and gate; returns {"row": the JSON line's dict, "test": the
    engine's RenderResult (None with --oracle-only), "oracle_image": the
    oracle's display image}.  Raises NotImplementedError for what the
    port does not carry and ValueError for a golden artifact rendered
    otherwise."""
    args = build_parser().parse_args(argv)

    import numpy as np

    from wavefront_path_tracer_tpu_torch.renderer import render, resolve_device
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse, write_png

    scene = get_scene(args.scene)
    cc = CameraController.book_one_final()
    base = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, samples_per_frame=args.spp,
        max_bounces=args.max_bounces,
    )

    # --- oracle image: golden artifact or fresh render ---
    meta = _oracle_meta(args)
    if args.oracle_cache and os.path.exists(args.oracle_cache):
        z = np.load(args.oracle_cache, allow_pickle=False)
        stored = json.loads(str(z["meta"]))
        if stored != meta:
            raise ValueError(
                f"golden artifact {args.oracle_cache} was rendered with "
                f"{stored}, but this gate needs {meta}; delete it or pass "
                "matching flags")
        oracle_image = z["image"]
        oracle_platform = str(z["platform"])
        print(f"loaded golden oracle ({oracle_platform}) from "
              f"{args.oracle_cache}", file=sys.stderr)
    else:
        device = resolve_device(args.oracle_device or args.device)
        oracle_platform = device.type
        t0 = time.time()
        oracle = render(scene, cc, base.replace(
            engine=args.oracle_engine, intersector=args.oracle_intersector,
            sampler=_oracle_sampler(args),
            samples_per_frame=min(args.oracle_spf, args.spp)),
            device=device)
        oracle_image = oracle.image
        print(f"oracle done in {time.time() - t0:.1f}s ({oracle_platform})",
              file=sys.stderr)
        if args.oracle_cache:
            os.makedirs(os.path.dirname(args.oracle_cache) or ".",
                        exist_ok=True)
            np.savez_compressed(
                args.oracle_cache, image=np.asarray(oracle_image),
                meta=np.asarray(json.dumps(meta)),
                platform=np.asarray(oracle_platform))
            print(f"saved golden oracle to {args.oracle_cache}",
                  file=sys.stderr)
    if args.oracle_only:
        return {"row": None, "test": None, "oracle_image": oracle_image}

    # --- engine under test ---
    t0 = time.time()
    test = render(scene, cc, base.replace(
        engine=args.engine, intersector=args.intersector,
        baked_clusters=args.clusters, rr_start_bounce=args.rr,
        rr_floor=args.rr_floor, winner_hint=args.winner_hint,
        lane_split=args.lane_split, lane_rotate_cols=args.rotate_cols,
        recluster=args.recluster, material_split=args.material_split,
        sampler=args.sampler,
        **({} if args.tex_lut is None else {"tex_lut_max": args.tex_lut}),
        samples_per_frame=min(args.spp, 200)),
        device=resolve_device(args.test_device or args.device))
    print(f"test engine done in {time.time() - t0:.1f}s "
          f"({test.mrays_per_s:.1f} Mrays/s)", file=sys.stderr)

    err = rmse(test.image, oracle_image)
    if args.save_prefix:
        write_png(f"{args.save_prefix}_test.png", test.image)
        write_png(f"{args.save_prefix}_oracle.png", oracle_image)

    variant = "".join(
        f"/{tag}" for tag, on in (
            (f"cull{args.clusters}", args.clusters),
            (f"rr{args.rr}", args.rr),
            ("winner-hint", args.winner_hint),
            (f"split{args.lane_split}", args.lane_split > 1),
            (f"cols{args.rotate_cols}", args.rotate_cols > 1),
            (f"recluster{args.recluster}", args.recluster),
            ("matsplit", args.material_split),
            (args.sampler, args.sampler != "random"),
        ) if on)
    row = {
        "scene": args.scene,
        "config": f"{args.width}x{args.height}@{args.spp}spp",
        "engine": f"{args.engine}/{args.intersector}{variant}",
        "oracle": f"{args.oracle_engine}/{args.oracle_intersector}"
                  f"@{oracle_platform}",
        "rmse": err,
        "gate": args.gate,
        "pass": bool(err < args.gate),
        "test_mrays_per_s": round(test.mrays_per_s, 2),
    }
    return {"row": row, "test": test, "oracle_image": oracle_image}


def main(argv=None) -> int:
    out = run(argv)
    if out["row"] is None:
        return 0
    print(json.dumps(out["row"]))
    return 0 if out["row"]["pass"] else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        sys.exit(2)
