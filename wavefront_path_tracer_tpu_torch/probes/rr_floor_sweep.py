"""The Russian-roulette (start, floor) frontier at the headline (the port
of ``exp/rr_floor_sweep.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.rr_floor_sweep \
        [--golden PATH] \
        [--gate-spp 1000] [--gate-spf 200] [--time-size 1920x1080] \
        [--time-spp 1000] [--reps 3] [--device cuda|cpu]

book_one_final from the book's camera through the fused engine, baked
and culled in clusters of 16, 50 bounces.  Each candidate
(``rr_start_bounce``, ``rr_floor``) is first gated: rendered at the
golden's size (400x225 for the checkout's
``golden/oracle_book_400x225_1000spp.npz``, the default ``--golden``) and ``--gate-spp`` samples, ``--gate-spf`` a
frame, its display image within RMSE 1e-3 of the golden artifact.  The
reference's candidates and order: the incumbent (5, 0.05); then (3,
0.25), and after it (2, 0.30) if it passed, else (4, 0.25).  The
incumbent and every candidate that passed are then timed at
``--time-size`` and ``--time-spp`` samples in one frame, in turns, the
least of ``--reps`` after one warm render each, so that the incumbent is
re-timed in the same process.  A line per gate and per timing with the
card's name and power limit, then the JSON of all results.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from wavefront_path_tracer_tpu_torch.probes import _hier, _slope

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "golden", "oracle_book_400x225_1000spp.npz")
GATE = 1e-3
INCUMBENT = (5, 0.05)
BASE = dict(engine="fused", intersector="baked", baked_clusters=16,
            max_bounces=50)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--golden", default=GOLDEN)
    ap.add_argument("--gate-spp", type=int, default=1000)
    ap.add_argument("--gate-spf", type=int, default=200)
    ap.add_argument("--time-size", default="1920x1080")
    ap.add_argument("--time-spp", type=int, default=1000)
    _hier.add_device_args(ap)
    return ap


def _key(rr: int, floor: float) -> str:
    return f"rr{rr}_f{floor:g}"


def run(args) -> dict:
    from wavefront_path_tracer_tpu_torch.renderer import Renderer
    from wavefront_path_tracer_tpu_torch.scene import (
        CameraController,
        get_scene,
    )
    from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
    from wavefront_path_tracer_tpu_torch.utils.image import rmse

    dev = _slope.device(args.device)
    card = _hier.card(dev)
    scene = get_scene("book_one_final")
    cc = CameraController.book_one_final()
    golden = np.load(args.golden, allow_pickle=False)["image"]
    gh, gw = golden.shape[:2]
    tw, th = (int(v) for v in args.time_size.split("x"))

    def gate(rr, floor) -> float:
        cfg = RenderConfig(width=gw, height=gh,
                           samples_per_pixel=args.gate_spp,
                           samples_per_frame=args.gate_spf,
                           rr_start_bounce=rr, rr_floor=floor, **BASE)
        t0 = time.perf_counter()
        r = Renderer(scene, cc, cfg, device=dev).render()
        err = rmse(r.image, golden)
        print(f"gate rr={rr} floor={floor}: rmse={err:.3e} "
              f"({'PASS' if err < GATE else 'fail'}) in "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        return err

    results = {_key(*INCUMBENT): {"rmse": gate(*INCUMBENT)}}
    passed = [INCUMBENT]
    err3 = gate(3, 0.25)
    results[_key(3, 0.25)] = {"rmse": err3}
    nxt = (2, 0.30) if err3 < GATE else (4, 0.25)
    if err3 < GATE:
        passed.append((3, 0.25))
    err = gate(*nxt)
    results[_key(*nxt)] = {"rmse": err}
    if err < GATE:
        passed.append(nxt)

    renderers = [Renderer(scene, cc, RenderConfig(
        width=tw, height=th, samples_per_pixel=args.time_spp,
        samples_per_frame=args.time_spp, rr_start_bounce=rr,
        rr_floor=floor, **BASE), device=dev) for rr, floor in passed]
    for r in renderers:
        r.render()                                # warm
    best = [float("inf")] * len(renderers)
    mrays = [0.0] * len(renderers)
    for _ in range(args.reps):
        for i, r in enumerate(renderers):
            r.reset_accumulation()
            res = r.render()
            if res.wall_time_s < best[i]:
                best[i], mrays[i] = res.wall_time_s, res.mrays_per_s
    for (rr, floor), t, rate in zip(passed, best, mrays):
        results[_key(rr, floor)].update(t=t, mrays_per_s=rate)
        print(f"{tw}x{th}@{args.time_spp}spp rr={rr} floor={floor}: "
              f"{t:.4f} s ({rate:.1f} Mrays/s) [{card}]", flush=True)
    results["card"] = card
    print(json.dumps(results), flush=True)
    return results


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
