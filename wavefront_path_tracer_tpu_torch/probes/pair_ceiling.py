"""The slope-timed sphere-pair issue ceiling on the card (the port of
``exp/pair_ceiling.py``, its ``measure`` at line 89).

    python -m wavefront_path_tracer_tpu_torch.probes.pair_ceiling \
        [--reps-lo 50] [--reps-hi 350] [--device cuda|cpu]

Per ray, for ``reps`` reps: the slimmed quadratic (micro_r2
``_sm_sweep_rows``) against all 400 spheres of ``PACKED_SM``, the
(t, index) carry and the per-ray minimum, dx bumped by 1e-6 a rep so that
nothing leaves the rep loop; the output is the sum over reps of
t_min + i_min.  Two variants, one kernel each (``csrc/probe_pairs.cu``):

- ``C6``: the table read from device memory through L1 (``__ldg``), as
  the reference's dynamic sphere-major table;
- ``A2``: the table's four columns in the constant bank, read as
  broadcasts by a sweep unrolled by 8, the nearest analog of the
  reference's baked immediates (unrolled in full, ptxas hoisted every
  term out of the rep loop and spilled them).

Both carry several rays a thread, each table word loaded once for them,
and take the branchless square root of ``csrc/probe_math.cuh``.

The reference's 1024 rays fill eight warps, not the card, so they are
repeated (``micro_r2.RAY_COPIES`` copies, 132 x 2048 threads); copy 0's
output is the reference's.  Printed: Gpairs/s by slope, the FP32
operation rate that 18 operations a pair imply, the thread instructions
a pair takes if the SMs issue every clock (4 warp instructions a clock
an SM at the maximum SM clock), and the slope window, beside the card's
name, power limit and maximum SM clock.
"""

from __future__ import annotations

import argparse
import json

import torch

from wavefront_path_tracer_tpu_torch.probes import _slope
from wavefront_path_tracer_tpu_torch.probes import micro_r2 as m

VARIANTS = ("C6", "A2")
REPS = (50, 350)
# FP32 operations a pair (the slimmed quadratic, both roots: nb 6, c_q 7,
# disc 2, sqrt 1, the roots 2) and a ray a rep (the bump and dx 2, d / 2
# 3, dd_o 5, oo2 5, the output 2); compares and selects not counted.
FLOPS_PAIR = 18
FLOPS_RAY_REP = 17

# Kernel launches on CUDA tensors by pair_sweep, by variant.
LAUNCHES = {v: 0 for v in VARIANTS}


def pair_sweep_reference(tab, rays, reps: int):
    """Plain PyTorch version of :func:`pair_sweep` over any (S, 24)
    table: each rep one (N, S) matrix of the pairs' arithmetic in the
    kernel's order, then the first minimum, which is what the kernel's
    strict-< carry keeps."""
    out = torch.empty(rays.shape[1], dtype=torch.float32, device=rays.device)
    for lo in range(0, rays.shape[1], m._CHUNK):
        ox, oy, oz, dx0, dy, dz = rays[:, lo:lo + m._CHUNK]
        acc = torch.zeros_like(ox)
        bump = torch.zeros((), dtype=torch.float32, device=rays.device)
        for _ in range(reps):
            bump = bump + 1e-6
            t = m.slim_t(m.slim_ray(ox, oy, oz, dx0 + bump, dy, dz), tab)
            best, idx = m._first_min(t)
            acc = acc + (best + idx.to(torch.float32))
        out[lo:lo + ox.shape[0]] = acc
    return out


def pair_sweep(tab, rays, reps: int, variant: str = "C6"):
    """The pair ceiling's function over ``tab`` ((400, 24) float32,
    ``micro_r2.PACKED_SM``) and ``rays`` ((6, N) float32): (N,) float32,
    per ray the sum over ``reps`` of t_min + i_min.

    On CPU tensors this is the plain version (any sphere and ray count);
    on CUDA tensors it launches the ``variant`` kernel (C6 or A2) of
    ``csrc/probe_pairs.cu``, bit-identical to the plain version, over
    whole copies of the reference's 1024 rays (its blocks cover them);
    any other device raises."""
    if variant not in VARIANTS:
        raise ValueError(f"variant is one of {VARIANTS}")
    _slope.check_rays(rays)
    if (tab.dim() != 2 or tab.shape[1] != 24 or tab.dtype != torch.float32
            or not tab.is_contiguous()):
        raise ValueError("tab must be a contiguous (S, 24) float32 table")
    dev = _slope.one_device(tab, rays)
    if dev.type == "cpu":
        return pair_sweep_reference(tab, rays, reps)
    if tab.shape[0] != m.S:
        raise ValueError(f"the kernel sweeps {m.S} spheres")
    if rays.shape[1] % (m.ROWS * 128):
        raise ValueError("the kernel takes whole copies of 1024 rays")
    out = torch.empty(rays.shape[1], dtype=torch.float32, device=dev)
    tab4 = (tab[:, [16, 17, 18, 14]].contiguous() if variant == "A2"
            else None)
    _slope.launch("wpt_probe_pair_launch", tab.data_ptr(),
                  tab4.data_ptr() if tab4 is not None else None,
                  rays.data_ptr(), rays.shape[1], int(reps), out.data_ptr())
    LAUNCHES[variant] += 1
    return out


def measure(variant: str, reps=REPS, device="cuda") -> dict:
    """Slope-time :func:`pair_sweep` on the card at full width: Gpairs/s,
    the FP32 rate it implies, the slope window and copy 0's checksum at
    2 reps."""
    tab = torch.from_numpy(m.PACKED_SM).to(device)
    rays = m.ray_planes(device, m.RAY_COPIES)
    sl = _slope.slope(lambda r: pair_sweep(tab, rays, r, variant), *reps)
    pairs = m.S * rays.shape[1]
    rate = pairs / sl["unit_s"]
    out = pair_sweep(tab, rays, 2, variant)
    return {"variant": variant, "reps": [sl["lo"], sl["hi"]],
            "gpairs": rate / 1e9, "fp32_rate": rate * FLOPS_PAIR,
            "window_ms": sl["window_s"] * 1e3,
            "single_lo_gpairs": sl["lo"] * pairs / sl["lo_s"] / 1e9,
            "checksum": float(out[:m.ROWS * 128].double().sum())}


def run(argv=None) -> list:
    """The probe as its command line runs it: prints its table and
    returns its readings (the plain versions' checksums with
    ``--device cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps-lo", type=int, default=REPS[0])
    ap.add_argument("--reps-hi", type=int, default=REPS[1])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _slope.device(args.device)
    if dev.type == "cpu":
        out = pair_sweep(torch.from_numpy(m.PACKED_SM), m.ray_planes(), 2)
        checksum = float(out.double().sum())
        print(f"plain version, S={m.S}, 1024 rays, 2 reps: checksum "
              f"{checksum!r} (times: not measured on the CPU)")
        return [{"variant": "plain", "checksum": checksum}]
    card = _slope.card()
    print(f"S={m.S} rays={m.ROWS * 128}x{m.RAY_COPIES} reps "
          f"{args.reps_lo}->{args.reps_hi} [{card}]")
    readings = []
    issue = _slope.issue_rate(card)
    for variant in VARIANTS:
        r = measure(variant, (args.reps_lo, args.reps_hi), dev)
        r["instructions_per_pair"] = issue / (r["gpairs"] * 1e9)
        print(f"| {variant} | slope {r['gpairs']:8.2f} Gpairs/s | "
              f"{r['fp32_rate'] / 1e12:6.2f} TFLOP/s FP32 at {FLOPS_PAIR} "
              f"a pair | {r['instructions_per_pair']:5.1f} thread "
              f"instructions a pair at full issue | single call (lo) "
              f"{r['single_lo_gpairs']:8.2f} Gpairs/s | slope window "
              f"{r['window_ms']:7.1f} ms | [{card}]", flush=True)
        print(json.dumps(r), flush=True)
        readings.append(r)
    return readings


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
