"""The port's copy of ``exp/micro_r2.py``'s module data, its cond-gated
sweeps (``run_gated``, micro_r2.py:1106) on the card, and its command
line.

    python -m wavefront_path_tracer_tpu_torch.probes.micro_r2 \
        [A B C C2 C3 Q Q2 Q4 Q8 W W5 W6 W7 C4 C5 C45 C6 C7 A2 C8 C9 D ...] \
        [--reps-lo N] [--reps-hi N] [--device cuda|cpu]

The names are the reference's (exp/micro_r2.py:1236-1293, default A B C
C2 C3 D): the intersect-loop designs of ``run_pairs`` (``run_pairs.py``;
W runs W, W0 and W2, C6 C6 and C6d, A2 A2 and A2d), the gated sweeps
below (C8: the W8 and C8 patterns under every gating; C9: C8's pattern
under the worklist; W8: its pattern), and D, ``matmul_bench``'s rows
(``matmul_r2.py``).

The data are the reference's draws, in its order and with its float64
steps, byte for byte (``tests/test_torch_probes.py`` holds them equal):
400 spheres from RandomState(0) (``centers``, ``radii``, ``attrs``, the
(S, 16) ``packed`` table and ``SPH``), the six (8, 128) ray planes, and
``PACKED_SM``, the (S, 24) sphere-major table (c, r, ten attributes,
kappa = |c|^2 - r^2, 1/r, 2c).

``run_gated``'s function: per ray, the nearest hit over the spheres of
the clusters (25 of 16) entered for the ray's row of 128, under a fixed
pseudo-random entry pattern (RandomState(7)), its t + attr0 + attr9
summed over reps.  Two patterns and forms, as the reference draws them:

- ``W8``: 25 conds, 12 entered, the same for every row; the generic
  quadratic and the winner's ten attributes carried by selects
  (``make_kernel_w8``);
- ``C8``: 200 (cluster, row) conds, 37 entered; the slimmed quadratic
  over ``PACKED_SM`` with a (t, index) carry and a decode of the two
  attributes (``make_kernel_c8``; C9, ``make_kernel_c9``, is the same
  function over the same pattern).

Three Hopper gatings run each (``csrc/probe_pairs.cu``): a per-thread
branch (the port's shipped cull), a warp vote (``__any_sync``) and a warp
worklist (``__ballot_sync`` and ``__ffs``).  A thread carries several
rays of one row and a warp's rays lie in one row, so a thread's rays
share one cond and the three enter the same clusters: the entered pairs
of :func:`pairs_per_rep`.  The probe prints ns a rep and
effective Gpairs/s (entered pairs over time), as ``run_gated`` does, by
slope.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from wavefront_path_tracer_tpu_torch.probes import _slope

S = 400            # spheres
ROWS = 8
T_MIN = 0.001
T_FAR = 1e30

rng = np.random.RandomState(0)
centers = rng.uniform(-10, 10, (S, 3)).astype(np.float32)
radii = rng.uniform(0.2, 1.0, (S,)).astype(np.float32)
attrs = rng.uniform(0.1, 1.0, (S, 10)).astype(np.float32)  # ar..mt etc.
# packed dynamic table (S,16): c xyz, r, attrs 10
packed = np.zeros((S, 16), np.float32)
packed[:, 0:3] = centers
packed[:, 3] = radii
packed[:, 4:14] = attrs

SPH = [tuple(float(v) for v in row) for row in packed[:, :14]]

ox0 = rng.uniform(-1, 1, (ROWS, 128)).astype(np.float32)
oy0 = rng.uniform(-1, 1, (ROWS, 128)).astype(np.float32)
oz0 = rng.uniform(-1, 1, (ROWS, 128)).astype(np.float32)
d = rng.normal(size=(3, ROWS, 128)).astype(np.float32)
d /= np.linalg.norm(d, axis=0, keepdims=True)
dx0, dy0, dz0 = d[0], d[1], d[2]


def _packed_sm():
    """Sphere-major table: (S, 24) f32 — c xyz, r, attrs 10, kappa,
    inv_r, 2c xyz (the pack_culled_scene column layout, widened)."""
    t = np.zeros((S, 24), np.float32)
    t[:, :16] = packed
    c64 = centers.astype(np.float64)
    t[:, 14] = (np.sum(c64 * c64, axis=1) - radii.astype(np.float64) ** 2)
    t[:, 15] = 1.0 / radii
    t[:, 16:19] = 2.0 * c64
    return t


PACKED_SM = _packed_sm()

# Threads that fill the card: 132 SMs x 2048 resident threads, as copies
# of the reference's 1024 rays (copy 0's output is the reference's).
RAY_COPIES = 132 * 2048 // (ROWS * 128)
CLUSTERS, CLUSTER_SIZE = 25, 16
# (name, conds, entered, generic quadratic): run_gated's two patterns.
PATTERNS = {"W8": (25, 12, True), "C8": (200, 37, False)}
GATINGS = ("thread", "vote", "worklist")
REPS = (200, 1400)
FLOPS_GENERIC = 21         # micro_r2.quadratic: FP32 adds, muls, max, sqrt
FLOPS_SLIM = 18            # the slimmed quadratic, both roots
_CHUNK = 16384             # rays per pass of a plain version (bounds memory)

# Kernel launches on CUDA tensors by gated_sweep, by (pattern, gating).
LAUNCHES = {(p, g): 0 for p in PATTERNS for g in GATINGS}


def ray_planes(device="cpu", copies: int = 1) -> torch.Tensor:
    """The six ray planes as a (6, 1024 x copies) float32 tensor (o xyz,
    d xyz; each plane row-major), the 1024 rays repeated ``copies``
    times."""
    planes = np.stack([p.reshape(-1) for p in
                       (ox0, oy0, oz0, dx0, dy0, dz0)])
    return torch.from_numpy(np.tile(planes, (1, copies))).to(device)


def entry_pattern(n_conds: int, entered: int) -> np.ndarray:
    """The reference's fixed pattern: ``entered`` of ``n_conds`` conds
    set, drawn from RandomState(7) (micro_r2.py:1109-1111)."""
    rs = np.random.RandomState(7)
    cond = np.zeros(n_conds, np.int32)
    cond[rs.choice(n_conds, entered, replace=False)] = 1
    return cond


def cond_table(pattern: str, n_clusters: int = CLUSTERS,
               entered: int | None = None) -> np.ndarray:
    """The pattern as (cluster, row) conds, int32 at c * 8 + row: ``W8``
    draws one cond a cluster and repeats it on every row, ``C8`` draws
    one a (cluster, row).  ``n_clusters`` and ``entered`` cut it down
    (the CPU tests)."""
    n_conds, full_entered, _generic = PATTERNS[pattern]
    if entered is None:
        entered = full_entered
    if pattern == "W8":
        return np.repeat(entry_pattern(n_clusters, entered), ROWS)
    return entry_pattern(n_clusters * ROWS, entered)


def _first_min(t: torch.Tensor):
    """(best t, index of its first occurrence or -1 where nothing beat
    T_FAR) along dim 1: a strict-< carry over the columns in order."""
    best = t.min(dim=1).values
    cols = torch.arange(t.shape[1], device=t.device)
    idx = torch.where(t == best[:, None], cols, t.shape[1]).min(dim=1).values
    return best, torch.where(best < T_FAR, idx, -1)


def slim_t(ray, tab):
    """The slimmed quadratic (micro_r2._sm_sweep_rows) of rays against
    table rows: ``ray`` the (ox, oy, oz, hdx, hdy, hdz, dd_o, oo2) terms
    as (N,) tensors, ``tab`` (S, 24) rows; (N, S) t, T_FAR for a miss."""
    ox, oy, oz, hdx, hdy, hdz, dd_o, oo2 = (v[:, None] for v in ray)
    tcx, tcy, tcz, kappa = (tab[:, k][None, :] for k in (16, 17, 18, 14))
    nb = (hdx * tcx + hdy * tcy + hdz * tcz) - dd_o
    c_q = (oo2 + kappa) - (ox * tcx + oy * tcy + oz * tcz)
    disc = nb * nb - c_q
    sq = torch.sqrt(disc)              # NaN when disc < 0
    t1 = nb - sq
    t2 = nb + sq
    return torch.where(t1 > T_MIN, t1, torch.where(t2 > T_MIN, t2, T_FAR))


def slim_ray(ox, oy, oz, dx, dy, dz):
    """The ray terms of :func:`slim_t`, in the kernels' order."""
    return (ox, oy, oz, 0.5 * dx, 0.5 * dy, 0.5 * dz,
            dx * ox + dy * oy + dz * oz, ox * ox + oy * oy + oz * oz)


def generic_t(ox, oy, oz, dx, dy, dz, tab):
    """micro_r2.quadratic of (N,) rays against (S, >= 4) rows (c xyz, r):
    (N, S) t, T_FAR for a miss."""
    ox, oy, oz, dx, dy, dz = (v[:, None] for v in (ox, oy, oz, dx, dy, dz))
    cx, cy, cz, r = (tab[:, k][None, :] for k in range(4))
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b_q = dx * ocx + dy * ocy + dz * ocz
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b_q * b_q - c_q
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b_q - sq
    t2 = -b_q + sq
    t = torch.where(t1 > T_MIN, t1, torch.where(t2 > T_MIN, t2, T_FAR))
    return torch.where(disc >= 0.0, t, T_FAR)


def gated_reference(tab, cond, rays, reps: int, generic: bool):
    """Plain PyTorch version of :func:`gated_sweep`: the same function
    over any number of clusters (``cond`` (n_clusters x 8,), ``tab`` at
    least n_clusters x 16 rows) and rays ((6, N), ray k in row
    (k % 1024) // 128).  The sweep over the entered spheres is one (N, S)
    matrix a rep: each pair's arithmetic in the kernel's order, then the
    first minimum, which is what the kernel's strict-< carry keeps."""
    n = rays.shape[1]
    n_sph = cond.shape[0] // ROWS * CLUSTER_SIZE
    tab = tab[:n_sph]
    cols = torch.arange(n_sph, device=tab.device)
    out = torch.empty(n, dtype=torch.float32, device=rays.device)
    for lo in range(0, n, _CHUNK):
        ox, oy, oz, dx0, dy, dz = rays[:, lo:lo + _CHUNK]
        row = (torch.arange(lo, lo + ox.shape[0], device=rays.device)
               % (ROWS * 128)) // 128
        entered = cond[(cols // CLUSTER_SIZE)[None, :] * ROWS
                       + row[:, None]] != 0
        acc = torch.zeros_like(ox)
        dxm = dx0
        bump = torch.zeros((), dtype=torch.float32, device=rays.device)
        for _ in range(reps):
            if generic:
                dxm = dxm + 1e-6
                t = generic_t(ox, oy, oz, dxm, dy, dz, tab)
            else:
                bump = bump + 1e-6
                t = slim_t(slim_ray(ox, oy, oz, dx0 + bump, dy, dz), tab)
            best, idx = _first_min(torch.where(entered, t, T_FAR))
            win = tab[idx.clamp_min(0)]
            a0 = torch.where(idx >= 0, win[:, 4], 0.0)
            a9 = torch.where(idx >= 0, win[:, 13], 0.0)
            # The two forms add the attributes in their references' orders.
            acc = (acc + best + a0 + a9 if generic
                   else acc + (best + (a0 + a9)))
        out[lo:lo + ox.shape[0]] = acc
    return out


def gated_sweep(tab, cond, rays, reps: int, pattern: str,
                gating: str = "thread"):
    """``run_gated``'s function (module docstring) for ``pattern`` (W8 or
    C8) over ``tab`` (400, 24) float32 (:data:`PACKED_SM`), ``cond`` (200,)
    int32 (:func:`cond_table`) and ``rays`` (6, N) float32 with N a
    multiple of 1024; (N,) float32.

    On CPU tensors this is the plain version (any cluster count); on CUDA
    tensors it launches ``csrc/probe_pairs.cu`` with ``gating`` (thread,
    vote or worklist), bit-identical to the plain version; any other
    device raises."""
    if pattern not in PATTERNS:
        raise ValueError(f"pattern is one of {sorted(PATTERNS)}")
    if gating not in GATINGS:
        raise ValueError(f"gating is one of {GATINGS}")
    _slope.check_rays(rays)
    for name, t, dtype in (("tab", tab, torch.float32),
                           ("cond", cond, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    dev = _slope.one_device(tab, cond, rays)
    generic = PATTERNS[pattern][2]
    if dev.type == "cpu":
        return gated_reference(tab, cond, rays, reps, generic)
    n = rays.shape[1]
    if tab.shape != (S, 24) or cond.shape != (CLUSTERS * ROWS,):
        raise ValueError(f"the kernel takes a ({S}, 24) table and "
                         f"({CLUSTERS * ROWS},) conds")
    if n % (ROWS * 128):
        raise ValueError("the kernel takes whole copies of 1024 rays")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _slope.launch("wpt_probe_gated_launch", tab.data_ptr(), cond.data_ptr(),
                  rays.data_ptr(), n, int(reps), int(generic),
                  GATINGS.index(gating), out.data_ptr())
    LAUNCHES[(pattern, gating)] += 1
    return out


def pairs_per_rep(pattern: str, n_rays: int) -> int:
    """Entered pairs a rep over ``n_rays`` rays (whole copies of 1024):
    the effective pairs of ``run_gated``'s metric."""
    cond = cond_table(pattern)
    per_copy = int(cond.sum()) * CLUSTER_SIZE * 128
    return per_copy * n_rays // (ROWS * 128)


def measure_gated(pattern: str, gating: str, reps=REPS,
                  device="cuda") -> dict:
    """Slope-time :func:`gated_sweep` on the card at full width: ns a rep,
    effective Gpairs/s and the FP32 rate those pairs imply."""
    tab = torch.from_numpy(PACKED_SM).to(device)
    cond = torch.from_numpy(cond_table(pattern)).to(device)
    rays = ray_planes(device, RAY_COPIES)
    sl = _slope.slope(lambda r: gated_sweep(tab, cond, rays, r, pattern,
                                            gating), *reps)
    pairs = pairs_per_rep(pattern, rays.shape[1])
    flops = FLOPS_GENERIC if PATTERNS[pattern][2] else FLOPS_SLIM
    rate = pairs / sl["unit_s"]
    out = gated_sweep(tab, cond, rays, 2, pattern, gating)
    return {"pattern": pattern, "gating": gating,
            "reps": [sl["lo"], sl["hi"]],
            "ns_per_rep": sl["unit_s"] * 1e9, "gpairs_eff": rate / 1e9,
            "fp32_rate": rate * flops, "window_ms": sl["window_s"] * 1e3,
            "checksum": float(out[:ROWS * 128].double().sum())}


# The reference's command-line names (exp/micro_r2.py:1236-1293): each
# runs these run_pairs designs ("D": matmul_bench's rows; "C8", "C9", "W8":
# run_gated's patterns and the gatings that stand for them here).
NAMES = {
    "A": ("A",), "B": ("B",), "C": ("C",), "C2": ("C2",), "C3": ("C3",),
    "Q": ("Q",), "Q2": ("Q2",), "Q4": ("Q4",), "Q8": ("Q8",),
    "W": ("W", "W0", "W2"), "W0": ("W0",), "W2": ("W2",), "W5": ("W5",),
    "W6": ("W6",), "W7": ("W7",), "C4": ("C4",), "C5": ("C5",),
    "C45": ("C45",), "C6": ("C6", "C6d"), "C6d": ("C6d",), "C7": ("C7",),
    "A2": ("A2", "A2d"), "A2d": ("A2d",), "D": (), "W8": (), "C8": (),
    "C9": (),
}
GATED_NAMES = {"W8": (("W8", GATINGS),),
               "C8": (("W8", GATINGS), ("C8", GATINGS)),
               "C9": (("C8", ("worklist",)),)}
DEFAULT_NAMES = ("A", "B", "C", "C2", "C3", "D")


def _print_design(r: dict, card: str) -> None:
    print(f"{r['design']:4s} {r['place']:6s} {r['lanes']} lane(s)/ray: "
          f"{r['gpairs']:8.2f} Gpairs/s by slope ({r['ns_per_rep']:.1f} "
          f"ns/rep, {r['fp32_rate'] / 1e12:.2f} TFLOP/s FP32, single call "
          f"(lo) {r['single_lo_gpairs']:.2f} Gpairs/s, slope window "
          f"{r['window_ms']:.1f} ms, checksum {r['checksum']:.6e}) "
          f"[{card}]", flush=True)
    print(json.dumps(r), flush=True)


def run(argv=None) -> list:
    """The probe as its command line runs it: the reference's variant
    names (:data:`NAMES`; default A B C C2 C3 D), each design in every
    form it runs in (table place, lanes a ray), slope-timed; prints its
    table and returns its readings (the plain versions' checksums with
    ``--device cpu``)."""
    from wavefront_path_tracer_tpu_torch.probes import matmul_r2
    from wavefront_path_tracer_tpu_torch.probes import run_pairs as rp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help="the reference's names: " + " ".join(NAMES))
    ap.add_argument("--reps-lo", type=int, default=None,
                    help="slope's low rep count (default: each probe's)")
    ap.add_argument("--reps-hi", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    which = args.variants or list(DEFAULT_NAMES)
    unknown = [v for v in which if v not in NAMES]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {' '.join(NAMES)}")
    designs = list(dict.fromkeys(d for v in which for d in NAMES[v]))
    gated = list(dict.fromkeys((p, g) for v in which
                               for p, gs in GATED_NAMES.get(v, ())
                               for g in gs))
    dev = _slope.device(args.device)

    def reps(default):
        return (args.reps_lo or default[0], args.reps_hi or default[1])

    readings = []
    if dev.type == "cpu":
        rays = ray_planes()
        for design in designs:
            out = rp.design_sweep(rp.table_for(design), rays, 2, design)
            checksum = float(out.double().sum())
            print(f"{design} plain version, 2 reps, 1024 rays: checksum "
                  f"{checksum!r} (times: not measured on the CPU)")
            readings.append({"design": design, "checksum": checksum})
        for pattern in dict.fromkeys(p for p, _g in gated):
            out = gated_sweep(torch.from_numpy(PACKED_SM),
                              torch.from_numpy(cond_table(pattern)), rays, 2,
                              pattern)
            checksum = float(out.double().sum())
            print(f"{pattern} plain version, 2 reps, 1024 rays: checksum "
                  f"{checksum!r} (times: not measured on the CPU)")
            readings.append({"pattern": pattern, "checksum": checksum})
        if "D" in which:
            readings += matmul_r2.run(["--device", "cpu"])
        return readings
    card = _slope.card()
    print(f"S={S} rays={ROWS * 128}x{RAY_COPIES} variants {which} [{card}]",
          flush=True)
    for design in designs:
        for place, lanes in rp.forms(design):
            r = rp.measure(design, place, lanes, reps(rp.REPS), dev)
            _print_design(r, card)
            readings.append(r)
    for pattern, gating in gated:
        r = measure_gated(pattern, gating, reps(REPS), dev)
        print(f"{pattern} {gating:8s}: {r['ns_per_rep']:.1f} ns/rep "
              f"({r['gpairs_eff']:.1f} Gpairs/s eff, "
              f"{r['fp32_rate'] / 1e12:.2f} TFLOP/s FP32, slope window "
              f"{r['window_ms']:.1f} ms, checksum {r['checksum']:.6e}) "
              f"[{card}]", flush=True)
        print(json.dumps(r), flush=True)
        readings.append(r)
    if "D" in which:
        flags = []
        for flag, value in (("--reps-lo", args.reps_lo),
                            ("--reps-hi", args.reps_hi)):
            if value is not None:
                flags += [flag, str(value)]
        readings += matmul_r2.run(flags)
    return readings


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
