"""Slope timing of the decision-relevant micro_r2 kernels (the port of
``exp/micro_slope.py``, its ``_build`` at line 56).

    python -m wavefront_path_tracer_tpu_torch.probes.micro_slope \
        [W8 C45 C7 A2 C8 C9] [--reps-lo 2000] [--reps-hi 18000] \
        [--device cuda|cpu]

The reference rebuilt each kernel at REPS 2000 and 18000, since its rep
count was fixed when the kernel was traced, and timed the slope.  Here
the rep count is a kernel argument, so one build serves both points: this
entry runs ``micro_r2``'s command line (``micro_r2.run``) at the
reference's names and rep points.  Defaults as the reference's: W8 (the
tile-gated pattern of ``run_gated``), C45 (``run_pairs``'s dynamic
ray-major design with ten selects, its table in device memory, shared
memory and the constant bank), C7 (sphere major, ten selects, 8 lanes or
one a ray, the table in the same three places), C8 and C9 (the row-gated
pattern, every gating and the worklist).
"""

from __future__ import annotations

import argparse

from wavefront_path_tracer_tpu_torch.probes import micro_r2

REPS_LO = 2000
REPS_HI = 18000
DEFAULT_NAMES = ("W8", "C45", "C7", "C8", "C9")
NAMES = ("W8", "C45", "C7", "A2", "C8", "C9")


def run(argv=None) -> list:
    """The probe as its command line runs it: ``micro_r2.run`` at these
    names and rep points; its readings."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help="one of " + " ".join(NAMES))
    ap.add_argument("--reps-lo", type=int, default=REPS_LO)
    ap.add_argument("--reps-hi", type=int, default=REPS_HI)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    which = args.variants or list(DEFAULT_NAMES)
    unknown = [v for v in which if v not in NAMES]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {' '.join(NAMES)}")
    return micro_r2.run([*which, "--reps-lo", str(args.reps_lo),
                         "--reps-hi", str(args.reps_hi), "--device",
                         args.device])


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
