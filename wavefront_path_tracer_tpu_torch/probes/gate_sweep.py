"""The correctness gate over every production variant of the fused
engine, on the card (the port of ``exp/gate_sweep.py``).

    python -m wavefront_path_tracer_tpu_torch.probes.gate_sweep \
        [--only NAME,...] [--list] [--timeout 1800] [--spp 64] \
        [--out build/gate_sweep/GATE_SWEEP.json] \
        [--cache-dir build/gate_sweep] [--device cuda|cpu]

The reference's sixteen rows with its gates, in two classes:

* **same-stream rows**: a fused variant against the port's megakernel
  oracle, both on ``--device`` at ``--spp`` (400x224; book_one_final
  unless the row names a scene).  Every engine shares the per-(pixel,
  sample, bounce) random streams, so the two images differ only by the
  order of float operations and the Monte Carlo noise cancels: a tight
  gate (2e-3, 3e-3 textured) at few samples;
* **golden rows**: 400x225 at 1000 spp against the committed CPU golden
  ``golden/oracle_book_400x225_1000spp.npz`` (gate 1e-3; 4e-3 for the
  stratified sampler, which integrates other samples), read only.

Each row runs the port's ``validate`` in a process of its own on
``--device``, with a timeout, and that process dies with the sweep; a
row that fails is recorded with ok false.  The rows go to ``--out``
after each one, so a killed sweep keeps the finished rows; with
``--only`` the other rows already in ``--out`` are kept.  Unlike the
reference, the sweep writes nothing under ``golden/``: the same-stream
rows on the default scene and sampler share one megakernel oracle,
rendered on ``--device`` and cached in ``--cache-dir`` under a name that
carries its size, samples and device; the other same-stream rows render
theirs in their own process.  ``--list`` prints the rows.  Exit code 0
iff every row that ran passed (a golden row is skipped, not failed,
where the golden artifact is absent).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

from wavefront_path_tracer_tpu_torch.utils import child

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(ROOT, "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "oracle_book_400x225_1000spp.npz")
OUT = os.path.join(ROOT, "build", "gate_sweep", "GATE_SWEEP.json")
CACHE_DIR = os.path.join(ROOT, "build", "gate_sweep")

# Same-stream rows: (name, extra validate args, gate), the reference's.
# The gates are its calibration: at 64 spp a fused variant floors where
# the two sweeps resolve t-ties differently (a few samples flip winner),
# 1.3-1.4e-3 on the TPU, well under 2e-3 and far under a real fault
# (0.09); texture rows get 3e-3 for the LUT's 10:10:10 packing and mean
# pooling on top.
SAME_STREAM = [
    ("baked_cull16", ["--intersector", "baked", "--clusters", "16"], 2e-3),
    ("dynculled", ["--intersector", "bruteforce", "--clusters", "16"],
     2e-3),
    ("winner_hint", ["--intersector", "baked", "--clusters", "16",
                     "--winner-hint"], 2e-3),
    ("lane_split2", ["--intersector", "baked", "--clusters", "16",
                     "--lane-split", "2"], 2e-3),
    ("rotate_cols2", ["--intersector", "baked", "--clusters", "16",
                      "--rotate-cols", "2"], 2e-3),
    ("recluster2", ["--intersector", "baked", "--clusters", "16",
                    "--recluster", "2"], 2e-3),
    ("recluster2_dyn", ["--intersector", "bruteforce", "--clusters", "16",
                        "--recluster", "2"], 2e-3),
    ("wavefront_matsplit", ["--engine", "wavefront",
                            "--intersector", "bruteforce",
                            "--material-split"], 2e-3),
    ("stratified_ss", ["--intersector", "baked", "--clusters", "16",
                       "--sampler", "stratified"], 2e-3),
    ("negradius_baked", ["--scene", "book_bubble",
                         "--intersector", "baked", "--clusters", "16"],
     2e-3),
    ("textures_baked", ["--scene", "book_checker",
                        "--intersector", "baked", "--clusters", "16"],
     3e-3),
    ("textures_dyn", ["--scene", "book_checker",
                      "--intersector", "bruteforce", "--clusters", "16"],
     3e-3),
]

# Golden rows: the full spec against the committed CPU artifact.  The
# stratified row compares two independent quadratures (the golden is a
# random-sampler render), so it floors at the 1000-spp noise; its 4e-3
# is a bias detector.
GOLDEN_ROWS = [
    ("golden_baked_cull16", ["--intersector", "baked", "--clusters", "16"],
     1e-3),
    ("golden_rr5", ["--intersector", "baked", "--clusters", "16",
                    "--rr", "5"], 1e-3),
    ("golden_stratified", ["--intersector", "baked", "--clusters", "16",
                           "--sampler", "stratified",
                           "--oracle-sampler", "random"], 4e-3),
    ("golden_recluster2", ["--intersector", "baked", "--clusters", "16",
                           "--recluster", "2"], 1e-3),
]

SS_W, SS_H, SS_SPP = 400, 224, 64
NOTE = ("same-stream rows: fused variant vs the port's megakernel oracle, "
        "both on the same device at equal spp (shared random streams -> "
        "the Monte Carlo noise cancels; catches kernel faults). golden "
        "rows: the full spec vs the committed CPU 1000-spp artifact.")


def oracle_cache(cache_dir: str, spp: int, device: str) -> str:
    """The shared same-stream oracle's file in ``cache_dir``."""
    tag = re.sub(r"[^A-Za-z0-9]+", "_", device)
    return os.path.join(os.path.abspath(cache_dir),
                        f"megakernel_book_one_final_{SS_W}x{SS_H}_{spp}spp_"
                        f"{tag}.npz")


def run_row(name: str, args: list[str], gate: float, *, spp: int,
            width: int, height: int, oracle: list[str], timeout: int,
            device: str = "cuda") -> dict:
    """One row: the port's validate in a process of its own; its JSON
    line with the row's name, ok and wall seconds, or {ok: false, pass:
    false, error} where it timed out or printed no JSON line."""
    cmd = [sys.executable, "-m", "wavefront_path_tracer_tpu_torch.validate",
           "--width", str(width), "--height", str(height),
           "--spp", str(spp), "--gate", repr(gate), "--engine", "fused",
           "--device", device, *oracle, *args]
    t0 = time.time()
    try:
        p = child.run(cmd, capture_output=True, text=True, timeout=timeout,
                      cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {"name": name, "ok": False, "pass": False,
                "error": f"timeout after {timeout}s"}
    dt = time.time() - t0
    line = (p.stdout.strip().splitlines() or [""])[-1]
    try:
        row = json.loads(line)
    except json.JSONDecodeError:
        tail = (p.stderr or p.stdout or "")[-400:]
        return {"name": name, "ok": False, "pass": False,
                "error": f"rc={p.returncode}: {tail}"}
    row.update(name=name, ok=True, wall_s=round(dt, 1))
    return row


def _under_golden(path: str) -> bool:
    path = os.path.realpath(path)
    return os.path.commonpath([path, os.path.realpath(GOLDEN_DIR)]) == \
        os.path.realpath(GOLDEN_DIR)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma list of row names to (re)run; other "
                         "existing rows are kept")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="per-row timeout in seconds")
    ap.add_argument("--spp", type=int, default=SS_SPP,
                    help="same-stream rows' sample budget")
    ap.add_argument("--out", default=OUT,
                    help="the rows' JSON file (not under golden/)")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="where the shared same-stream oracle is cached "
                         "(not under golden/)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every render (cuda, or cpu)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    opts = ap.parse_args(argv)
    spec = ([(n, a, g, "ss") for n, a, g in SAME_STREAM]
            + [(n, a, g, "golden") for n, a, g in GOLDEN_ROWS])
    if opts.list:
        for n, _a, g, kind in spec:
            print(f"{n:22s} gate {g:g}  ({kind})")
        return 0
    for flag, path in (("--out", opts.out), ("--cache-dir", opts.cache_dir)):
        if _under_golden(path):
            ap.error(f"{flag} {path}: the sweep writes nothing under "
                     f"golden/")

    only = set(opts.only.split(",")) if opts.only else None
    if only:
        known = {n for n, _a, _g, _k in spec}
        unknown = sorted(only - known)
        if unknown:
            ap.error(f"--only names not in the sweep: {unknown} "
                     f"(see --list)")
    existing = {}
    if only and os.path.exists(opts.out):
        with open(opts.out) as f:
            existing = {r["name"]: r for r in json.load(f)["rows"]}
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)

    def flush(results):
        n_pass = sum(1 for r in results if r.get("pass"))
        n_skip = sum(1 for r in results if r.get("skipped"))
        # A skipped row (golden artifact absent) was not run: it counts
        # neither as passed nor as failed.
        summary = {
            "rows": results,
            "passed": n_pass,
            "skipped": n_skip,
            "total": len(results),
            "all_pass": n_pass == len(results) - n_skip,
            "complete": len(results) == len(spec) and n_skip == 0,
            "device": opts.device,
            "note": NOTE,
        }
        with open(opts.out, "w") as f:
            json.dump(summary, f, indent=1)
        return summary

    results = []
    for name, args, gate, kind in spec:
        if only and name not in only:
            if name in existing:
                results.append(existing[name])
            continue
        if kind == "golden":
            if not os.path.exists(GOLDEN):
                results.append({"name": name, "ok": False, "pass": False,
                                "skipped": True,
                                "error": f"golden artifact {GOLDEN} absent"
                                         " (run probes/make_golden.py)"})
                continue
            row = run_row(name, args, gate, spp=1000, width=400,
                          height=225, oracle=["--oracle-cache", GOLDEN],
                          timeout=opts.timeout, device=opts.device)
        else:
            # Rows on another scene, or with another sampler (whose oracle
            # runs with the test sampler), render their oracle themselves:
            # the shared file's metadata would refuse them.
            oracle = ["--oracle-spf", str(opts.spp)]
            if "--scene" not in args and "--sampler" not in args:
                oracle += ["--oracle-cache", oracle_cache(
                    opts.cache_dir, opts.spp, opts.device)]
            row = run_row(name, args, gate, spp=opts.spp, width=SS_W,
                          height=SS_H, oracle=oracle, timeout=opts.timeout,
                          device=opts.device)
        results.append(row)
        print(json.dumps(row), flush=True)
        flush(results)

    # The rows kept from --out after the last row run are written here.
    summary = flush(results)
    n_skip = summary["skipped"]
    msg = f"{summary['passed']}/{len(results) - n_skip} gates pass"
    if n_skip:
        msg += f" ({n_skip} golden rows skipped: artifact absent)"
    print(f"{msg} -> {opts.out}", file=sys.stderr)
    return 0 if summary["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
